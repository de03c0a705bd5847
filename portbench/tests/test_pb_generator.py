"""The frozen ring generator gives BAL's camera, point and observation
counts, views per point from one multiset whatever the seed, the same
arrays for the same seed, and takes seeds above 32 bits."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from portbench import harness  # noqa: E402
from portbench.gen.ring import ring_problem, views_per_point  # noqa: E402


def generate(config, seed):
    cfg = harness.cell(f"{config}.lm")["config"]
    return cfg, ring_problem(cfg["n_cams"], cfg["n_pts"], cfg["n_obs"],
                             seed, "cpu", cfg["assumed"])


@pytest.mark.parametrize("config, n_obs, most", [
    ("ladybug138", 85_217, 31),               # BAL: 85,217
    ("final961", 1_692_975, 98),              # BAL: 1,692,975
])
def test_bal_counts(config, n_obs, most):
    cfg, a = generate(config, 2 ** 33 + 7)
    C, P = cfg["n_cams"], cfg["n_pts"]
    assert cfg["n_obs"] == n_obs
    assert a["K"].shape == (C, 5) and a["cams"].shape == (C, 6)
    assert a["pts"].shape == (P, 3)
    assert len(a["obs"]) == n_obs
    views = np.bincount(a["pt_idx"], minlength=P)
    assert views.min() >= 2 and views.max() <= most
    assert views.max() >= 2 * n_obs / P       # a tail, not a cap
    key = a["pt_idx"].astype(np.int64) * C + a["cam_idx"]
    assert np.all(np.diff(key) > 0)           # by point, then camera
    assert a["cam_idx"].min() >= 0 and a["cam_idx"].max() < C
    for k in ("K", "q0", "cams", "pts", "obs"):
        assert np.array_equal(a[k], a[k].astype(np.float32).astype(
            np.float64))


def test_views_per_point_sum_and_shape():
    g = torch.Generator().manual_seed(3)
    visible = torch.full((1000,), 50, dtype=torch.int64)
    visible[:10] = 2
    k = views_per_point(visible, 4300, g)
    assert int(k.sum()) == 4300 and bool((k <= visible).all())
    assert int(k.min()) == 2 and int(k.max()) > 10
    with pytest.raises(ValueError):
        views_per_point(visible, 1999, g)


def test_same_seed_same_arrays_other_seed_same_work():
    _, a = generate("ladybug138", 123)
    _, b = generate("ladybug138", 123)
    _, c = generate("ladybug138", 124)
    for k in a:
        assert np.array_equal(a[k], b[k])
    assert not np.array_equal(a["pts"], c["pts"])
    assert len(a["obs"]) == len(c["obs"])
    pairs = [int((np.bincount(x["pt_idx"]) ** 2).sum()) for x in (a, c)]
    assert abs(pairs[0] - pairs[1]) < 0.005 * pairs[0]
