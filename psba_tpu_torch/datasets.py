"""Dataset registry for the reference project's bundled problems (the
port's copy of psba_tpu.datasets: the same REGISTRY, DatasetSpec, load and
names).

Complete (cams + pts) datasets load directly; the large BAL problems ship
cameras only, so the registry synthesizes a geometrically consistent
points / observations set at the published point count
(io.synthetic.synthesize_points_for_cams). Point counts come from the BAL
dataset names (e.g. Venice-52-64053 = 52 cameras, 64,053 points). Results
on synthesized sets measure speed and scaling; error parity with the
reference means something only on the complete datasets.

The data directory is $PSBA_DATA, by default the checkout's `data/`. The
cache of synthesized points lives under the temporary directory in files
of the port's own name, so the two packages never read each other's cache.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from pathlib import Path

DATA_DIR = os.environ.get(
    "PSBA_DATA", str(Path(__file__).resolve().parent.parent / "data"))

# the varK intrinsics shared by the 3/5/7/9-camera fixed-K files (these
# are prefixes of the same scene; see data/7camsvarK.txt)
_SHARED_K = (851.57945, 330.24755, 262.195, 1.00169, 0.0)


@dataclasses.dataclass(frozen=True)
class DatasetSpec:
    name: str
    cams: str
    pts: str | None = None                 # None => synthesize
    shared_K: tuple | None = None
    synth_pts: int = 0
    synth_mean_obs: float = 5.0
    complete: bool = True                  # cams + pts both bundled


REGISTRY = {
    s.name: s
    for s in [
        DatasetSpec("3cams", "3cams.txt", "3pts.txt", shared_K=_SHARED_K),
        DatasetSpec("5cams", "5cams.txt", "5pts.txt", shared_K=_SHARED_K),
        DatasetSpec("7cams", "7cams.txt", "7pts.txt", shared_K=_SHARED_K),
        DatasetSpec("7camsvarK", "7camsvarK.txt", "7pts.txt"),
        DatasetSpec("9cams", "9cams.txt", "9pts.txt", shared_K=_SHARED_K),
        DatasetSpec("9camsvarK", "9camsvarK.txt", "9pts.txt"),
        DatasetSpec("54cams", "54cams.txt", "54pts.txt", shared_K=_SHARED_K),
        DatasetSpec("54camsvarK", "54camsvarK.txt", "54pts.txt"),
        DatasetSpec("54camsvarKD", "54camsvarKD.txt", "54pts.txt"),
        DatasetSpec(
            "trafalgar21", "Trafalgar-21-11315-cams.txt",
            "Trafalgar-21-11315-pts.txt",
        ),
        DatasetSpec("trafalgar50", "Trafalgar-50-20431-cams.txt",
                    synth_pts=20431, complete=False),
        DatasetSpec("dubrovnik16", "Dubrovnik-16-22106-cams.txt",
                    synth_pts=22106, complete=False),
        DatasetSpec("dubrovnik88", "Dubrovnik-88-64298-cams.txt",
                    synth_pts=64298, complete=False),
        DatasetSpec("rome93", "Rome-93-61203-cams.txt",
                    synth_pts=61203, complete=False),
        DatasetSpec("venice52", "Venice-52-64053-cams.txt",
                    synth_pts=64053, complete=False),
        DatasetSpec("ladybug138", "Ladybug-138-19878-cams.txt",
                    synth_pts=19878, complete=False),
    ]
}

_CACHE_DIR = os.path.join(tempfile.gettempdir(), "psba_tpu_torch_datasets")


def load(name: str, data_dir: str | None = None, seed: int = 0,
         cache_dir: str | None = _CACHE_DIR):
    """Load a registered dataset as a BAProblem.

    Synthesized point sets are cached to disk (deterministic per seed) so
    repeated runs do not pay for their generation."""
    import numpy as np

    from psba_tpu_torch.io import load_problem
    from psba_tpu_torch.io.synthetic import synthesize_points_for_cams
    from psba_tpu_torch.problem import BAProblem

    spec = REGISTRY[name]
    d = data_dir or DATA_DIR
    cams_path = os.path.join(d, spec.cams)
    if not os.path.exists(cams_path):
        raise FileNotFoundError(
            f"dataset {name!r}: {cams_path} not found (set $PSBA_DATA to "
            "the directory of the reference's data files)")
    if spec.pts is not None:
        return load_problem(
            cams_path, os.path.join(d, spec.pts), shared_K=spec.shared_K
        )
    cache = None
    if cache_dir:
        cache = os.path.join(cache_dir, f"{name}_s{seed}_v2_torch.npz")
        if os.path.exists(cache):
            with np.load(cache) as z:
                prob = BAProblem(
                    K=z["K"], q0=z["q0"], cams=z["cams"], pts=z["pts"],
                    obs=z["obs"], cam_idx=z["cam_idx"], pt_idx=z["pt_idx"],
                )
                prob.validate()
                return prob
    prob = synthesize_points_for_cams(
        cams_path, n_pts=spec.synth_pts, mean_obs=spec.synth_mean_obs,
        seed=seed,
    )
    if cache:
        os.makedirs(cache_dir, exist_ok=True)
        np.savez(
            cache, K=prob.K, q0=prob.q0, cams=prob.cams, pts=prob.pts,
            obs=prob.obs, cam_idx=prob.cam_idx, pt_idx=prob.pt_idx,
        )
    return prob


def names():
    return sorted(REGISTRY)
