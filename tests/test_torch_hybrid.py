"""Port against reference: the default hybrid solve (LM -> TR -> ...) on CPU
tensors, and the TR phase's start, checkpoint and resume.

psba_tpu_torch.solve (plain PyTorch versions, device="cpu") against
psba_tpu.solvers.hybrid.solve(backend="pallas") in float32 with the default
SolverConfig, on the 6-camera synthetic problem and tests/data/mini_bal.txt.

What is compared, and why not more: both runs hand over to TR at the same
iteration, and TR's first act on these problems is the GMW bootstrap of
lambda, because the reduced camera system S is singular at lambda = 0 (the
seven gauge directions of bundle adjustment). Its pivots along those
directions are float32 rounding noise: a 1e-7 relative perturbation of S
moves the bootstrapped lambda by a factor of five on mini_bal. So the two
packages' lambdas differ and so do the TR steps after them, and with them
the length of the first TR phase: on the 6-camera problem its steps sit at
the float32 floor (rho of +-inf or -7), and float32 rounding alone (both
packages solve the same clustered problem at these sizes) moves its end by
one iteration. The test holds the phases through the switch to TR, the
first TR phase's name and flag with its end within one iteration, the LM
rows before it (ex_l2 to 1e-4, float32 sums in another order), a positive
bootstrapped lambda in both, and final_l2 to 1e-3. TR rows themselves are
held to 1e-4 from a state with lambda > 0 in tests/test_torch_tr.py.
"""

import dataclasses
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu import constants as CC
from psba_tpu.solvers import SolverConfig as JSolverConfig
from psba_tpu.solvers.hybrid import solve as jsolve
from psba_tpu_torch.solvers import SolverConfig
from psba_tpu_torch.solvers.hybrid import solve
from psba_tpu_torch.utils import checkpoint as ckpt

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")


def _problems(name):
    """(psba_tpu problem, psba_tpu_torch problem) read from the same input
    by each package's own reader."""
    import psba_tpu.io as jio
    import psba_tpu_torch.io as tio

    if name == "synth":
        return (jio.synthetic_problem(n_cams=6, n_pts=150, seed=3),
                tio.synthetic_problem(n_cams=6, n_pts=150, seed=3))
    return jio.bal_to_problem(MINI_BAL), tio.bal_to_problem(MINI_BAL)


def _cfg(**kw):
    return SolverConfig.for_dtype(torch.float32, record_history=True, **kw)


def _solve(prob, cfg, **kw):
    return solve(prob, cfg, dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("name", ["synth", "mini_bal"])
def test_default_solve_matches_reference(name):
    jprob, tprob = _problems(name)
    ref = jsolve(jprob, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", record_history=True),
        dtype=jnp.float32)
    res = _solve(tprob, _cfg())
    assert res.resolved_damping == ref.resolved_damping == "additive"
    names = [ph for ph, _, _ in ref.phases]
    k = names.index("tr")
    assert res.phases[:k] == ref.phases[:k]
    assert res.phases[k][0] == ref.phases[k][0]
    assert res.phases[k][2] == ref.phases[k][2]
    assert abs(res.phases[k][1] - ref.phases[k][1]) <= 1
    tr_start = ref.phases[k - 1][1]
    np.testing.assert_array_equal(res.history[:tr_start, 0],
                                  ref.history[:tr_start, 0])
    np.testing.assert_allclose(res.history[:tr_start, 1],
                               ref.history[:tr_start, 1], rtol=1e-4)
    # TR rows carry a delta, LM rows NaN; the bootstrap fired in both
    assert np.isnan(res.history[:tr_start, 4]).all()
    assert not np.isnan(res.history[tr_start:res.phases[k][1], 4]).any()
    print("first TR lambda: port", res.history[tr_start, 3], "reference",
          ref.history[tr_start, 3])
    assert res.history[tr_start, 3] > 0 and ref.history[tr_start, 3] > 0
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-3)
    assert res.final_l2 < res.initial_l2
    lines = res.format_history().splitlines()
    assert "Delta=" in lines[tr_start] and "mu=" in lines[0]


def test_gmw_bootstrap_reads_rounding_noise(monkeypatch):
    """Why the TR rows above are not compared: the S handed to the GMW
    bootstrap at TR entry on mini_bal has seven eigenvalues at float32
    rounding level (the gauge) against a largest of ~5e7, and relative
    perturbations of S of 1e-7 spread the bootstrapped lambda over more
    than a factor of two."""
    from psba_tpu_torch.solvers import tr as ttr

    seen = []
    real = ttr.gmw_bootstrap_lambda

    def record(S):
        seen.append(S.clone())
        return real(S)

    monkeypatch.setattr(ttr, "gmw_bootstrap_lambda", record)
    _jprob, prob = _problems("mini_bal")
    _solve(prob, _cfg(max_iters=15))
    S = seen[0]
    ev = torch.linalg.eigvalsh(S.double())
    small = ev.abs() < 1e-6 * ev.max()
    print("eigenvalues", ev[:9].tolist(), "largest", float(ev.max()))
    assert int(small.sum()) == 7
    rng = np.random.default_rng(0)
    lams = [float(real(S))]
    for _ in range(5):
        N = torch.from_numpy(rng.standard_normal(S.shape)).float()
        lams.append(float(real(S * (1 + 1e-7 * (N + N.T) / 2))))
    print("bootstrapped lambda, S and five perturbations:", lams)
    assert min(lams) > 0 and max(lams) > 2 * min(lams)


def test_start_tr_gmw_bootstrap():
    """TR from the start on a problem whose lambda = 0 system is singular
    (an unobserved camera has U = 0 exactly) takes the Cholesky failure ->
    GMW bootstrap, goes on with lambda > 0 and descends (the reference's
    tests/test_tr_branches.py::test_tr_inloop_gmw_bootstrap, in float32)."""
    _jprob, p = _problems("synth")
    prob = dataclasses.replace(
        p, K=np.concatenate([p.K, p.K[:1]]),
        q0=np.concatenate([p.q0, p.q0[:1]]),
        cams=np.concatenate([p.cams, p.cams[:1]]),
    )
    prob.validate()
    res = _solve(prob, _cfg(max_iters=10), start="tr")
    assert res.phases[0][0] == "tr"
    assert np.isfinite(res.final_l2) and res.final_l2 < res.initial_l2
    assert np.nanmax(res.history[:, 3]) > 0.0
    assert res.flag != CC.ITER_ERR


def test_chunked_checkpoint_through_tr_is_exact(tmp_path):
    """Chunks of two iterations across LM -> TR -> LM follow the unchunked
    trajectory exactly (the TR aux vector carries delta, lambda, nu and the
    counters over each boundary)."""
    _jprob, prob = _problems("synth")
    whole = _solve(prob, _cfg())
    assert "tr" in [ph for ph, _, _ in whole.phases]
    chunked = _solve(prob, _cfg(), checkpoint_dir=str(tmp_path),
                     checkpoint_every=2)
    assert chunked.phases == whole.phases
    np.testing.assert_array_equal(chunked.history, whole.history)
    np.testing.assert_array_equal(chunked.cams, whole.cams)
    np.testing.assert_array_equal(chunked.pts, whole.pts)


def test_resume_into_tr(tmp_path):
    """A checkpoint written mid-TR (phase "tr" with its aux vector) resumes
    into TR with the saved delta / lambda; the rest of the run follows the
    uninterrupted one (ex_l2 is recomputed from the restored parameters on
    resume, so to 1e-5 rather than bit for bit)."""
    _jprob, prob = _problems("mini_bal")
    cfg = _cfg(max_iters=17)
    whole = _solve(prob, cfg, checkpoint_dir=str(tmp_path / "a"),
                   checkpoint_every=1)
    tr0 = next(it for ph, it, _ in whole.phases if ph == "lm") + 1
    name = f"ckpt_{tr0:05d}.npz"
    d = tmp_path / "a"
    with np.load(d / name) as z:
        assert "aux" in z.files
    with open(d / "latest", "w") as f:
        f.write(name)
    _cams, _pts, meta = ckpt.load_latest(str(d))
    assert meta["phase"] == "tr" and meta["itno"] == tr0
    resumed = _solve(prob, cfg, checkpoint_dir=str(d), checkpoint_every=1)
    assert resumed.phases[0][0] == "tr"
    assert resumed.phases == [p for p in whole.phases if p[1] > tr0]
    assert resumed.flag == whole.flag
    np.testing.assert_allclose(resumed.final_l2, whole.final_l2, rtol=1e-5)
    rows = slice(tr0, whole.iterations)
    np.testing.assert_array_equal(resumed.history[rows, 3:5],
                                  whole.history[rows, 3:5])
    np.testing.assert_allclose(resumed.history[rows, 1],
                               whole.history[rows, 1], rtol=1e-5)
    assert os.path.exists(d / "latest")
