"""Port against reference: the LM phase end to end, on CPU tensors, and the
boundaries of the port.

psba_tpu_torch.solve (plain PyTorch versions of the kernels, device="cpu")
against psba_tpu.solvers.hybrid.solve with backend="pallas" (the dense3
path, its Pallas kernels in interpret mode), both in float32 with the LM->TR
switch disabled. Tolerances: the first five history rows' ex_l2 to 1e-4
relative and final_l2 to 1e-3 (float32 sums taken in another order); the
parameters to 1e-3 of their scale. Plus the port's boundaries: it never
imports jax or psba_tpu, `solve` needs a device where there is no card, and
s_precision="high" runs.
"""

import os
import subprocess
import sys
import zlib
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

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def prob_mini_bal():
    from psba_tpu.io import bal_to_problem

    return bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))


def _port(prob):
    """The port's BAProblem with the arrays of a psba_tpu one."""
    from psba_tpu_torch.problem import BAProblem

    return BAProblem(K=prob.K, q0=prob.q0, cams=prob.cams, pts=prob.pts,
                     obs=prob.obs, cam_idx=prob.cam_idx, pt_idx=prob.pt_idx)


def _cfg(**kw):
    return SolverConfig.for_dtype(torch.float32, lm_switch_count=10_000,
                                  record_history=True, **kw)


def _solve(prob, cfg, **kw):
    return solve(_port(prob), cfg, dtype=torch.float32, device="cpu", **kw)


@pytest.mark.parametrize("fixture", ["prob_synth", "prob_mini_bal"])
def test_solve_matches_reference(fixture, request):
    prob = request.getfixturevalue(fixture)
    ref = jsolve(prob, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", lm_switch_count=10_000,
        record_history=True), dtype=jnp.float32)
    res = _solve(prob, _cfg())
    assert res.flag == ref.flag
    assert res.resolved_damping == ref.resolved_damping
    np.testing.assert_allclose(res.history[:5, 0], ref.history[:5, 0])
    np.testing.assert_allclose(res.history[:5, 1], ref.history[:5, 1],
                               rtol=1e-4)
    np.testing.assert_allclose(res.initial_l2, ref.initial_l2, rtol=1e-5)
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-3)
    assert res.final_l2 < res.initial_l2
    for got, want in ((res.cams, ref.cams), (res.pts, ref.pts)):
        assert got.shape == want.shape
        assert np.max(np.abs(got - want)) <= 1e-3 * np.max(np.abs(want))


def test_marquardt_damping_runs(prob_synth):
    """Explicit Marquardt damping converges like the reference's."""
    ref = jsolve(prob_synth, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", damping="marquardt",
        record_history=True), dtype=jnp.float32)
    res = _solve(prob_synth, _cfg(damping="marquardt"))
    assert res.flag == ref.flag
    # Marquardt lands on the optimum in two steps here; the DP_NO_CHANGE
    # stop after that is decided by steps at the float32 noise floor, so
    # only the rows both runs made are compared
    n = min(res.iterations, ref.iterations, 5)
    assert n >= 2
    np.testing.assert_allclose(res.history[:n, 1], ref.history[:n, 1],
                               rtol=1e-4)
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-3)


@pytest.mark.parametrize("fixture", ["prob_synth", "prob_mini_bal"])
def test_damping_probe_matches_reference(fixture, request):
    """The damping probe (max and min-positive of diag J^T J, summed per
    camera and per point) against the reference's in float64 to 1e-6
    relative, and the damping mode both packages resolve from it: at the
    default tau, and at a tau that puts tau * max / min past 1 / eps."""
    from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
    from psba_tpu.solvers.types import _diag_minmax as j_diag_minmax
    from psba_tpu.solvers.types import resolve_damping as j_resolve
    from psba_tpu_torch.solvers.types import (
        ProblemArrays,
        _diag_minmax,
        resolve_damping,
    )

    prob = request.getfixturevalue(fixture)
    jpa = JProblemArrays.from_problem(prob, dtype=jnp.float64)
    jc = jnp.asarray(prob.cams, jnp.float64)
    jp = jnp.asarray(prob.pts, jnp.float64)
    ref = j_diag_minmax(jpa.K, jpa.q0, jc, jp, jpa.cam_idx, jpa.pt_idx,
                        jpa.valid, False, prob.n_cams, prob.n_pts)
    pa = ProblemArrays.from_problem(_port(prob), dtype=torch.float64,
                                    device="cpu")
    tc = torch.as_tensor(prob.cams, dtype=torch.float64)
    tp = torch.as_tensor(prob.pts, dtype=torch.float64)
    got = _diag_minmax(pa.K, pa.q0, tc, tp, pa.cam_idx, pa.pt_idx, False)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(float(g), float(r), rtol=1e-6)
    ratio = float(ref[0]) / float(ref[1])
    for tau in (1e-3, 4.0 / (np.finfo(np.float64).eps * ratio)):
        want = j_resolve(JSolverConfig(tau=tau), jpa, jc, jp).damping
        have = resolve_damping(SolverConfig(tau=tau), pa, tc, tp).damping
        assert have == want, (tau, have, want)
    assert want == "marquardt"


def test_state_carries_across(prob_mini_bal):
    """convert.from_reference puts the reference's state into the port:
    OptState.init then gives the reference's initial error."""
    from psba_tpu.solvers.types import OptState as JOptState
    from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
    from psba_tpu_torch.convert import from_reference, to_numpy
    from psba_tpu_torch.solvers.types import OptState

    jpa = JProblemArrays.from_problem(prob_mini_bal, dtype=jnp.float64,
                                      schur="dense")
    jst = JOptState.init(jpa, jnp.asarray(prob_mini_bal.cams),
                         jnp.asarray(prob_mini_bal.pts))
    pa_np = {k: np.asarray(getattr(jpa, k)) for k in (
        "K", "q0", "obs", "cam_idx", "pt_idx", "obs_du", "obs_dv",
        "valid_d")}
    pa, cams, pts = from_reference(pa_np, np.asarray(jst.cams),
                                   np.asarray(jst.pts), device="cpu")
    st = OptState.init(pa, cams, pts)
    np.testing.assert_allclose(float(st.ex_l2), float(jst.ex_l2), rtol=1e-12)
    back = to_numpy(st)
    np.testing.assert_array_equal(back["cams"], np.asarray(jst.cams))
    assert back["itno"] == 0 and back["flag"] == CC.ITER_CONTINUE


def test_chunked_checkpoint_run_is_exact(prob_synth, tmp_path):
    """Chunked runs (iter_cap + aux carry) follow the unchunked trajectory
    exactly, and each chunk boundary writes a resumable checkpoint."""
    whole = _solve(prob_synth, _cfg())
    chunked = _solve(prob_synth, _cfg(), checkpoint_dir=str(tmp_path),
                     checkpoint_every=2)
    assert chunked.iterations == whole.iterations
    assert chunked.flag == whole.flag
    np.testing.assert_array_equal(chunked.history, whole.history)
    np.testing.assert_array_equal(chunked.cams, whole.cams)
    cams, _pts, meta = ckpt.load_latest(str(tmp_path))
    # the dense solve clusters the points: checkpoints name the map
    _p2, newpos = _port(prob_synth).with_tile_point_order()
    order = f"tile-{zlib.crc32(np.ascontiguousarray(newpos)):08x}"
    assert meta["point_order"] == order and meta["phase"] == "lm"
    assert meta["itno"] == whole.iterations
    np.testing.assert_array_equal(cams, whole.cams)


def test_checkpoint_point_order_mismatch_raises(prob_synth, tmp_path):
    ckpt.save(str(tmp_path), prob_synth.cams, prob_synth.pts, 3,
              CC.ITER_CONTINUE, "lm", extra={"point_order": "tile-0000abcd"})
    with pytest.raises(ValueError, match="point_order|order"):
        _solve(prob_synth, _cfg(), checkpoint_dir=str(tmp_path))


@pytest.mark.parametrize("case", ["s_precision_high"])
def test_next_slices_raise(prob_synth, case):
    """The slice that used to raise here, the "high" S precision, runs: on
    the CPU it is the float32 product, so a "high" LM solve gives the
    "highest" run's bits, and TF32 stays off after it."""
    res = _solve(prob_synth, _cfg()._replace(s_precision="high"))
    ref = _solve(prob_synth, _cfg())
    assert res.flag == ref.flag and res.final_l2 == ref.final_l2
    np.testing.assert_array_equal(res.history, ref.history)
    assert res.final_l2 < res.initial_l2
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_solve_without_device_needs_a_card(prob_synth, monkeypatch):
    """With no device named, solve runs on CUDA; without a card it raises
    and says how to ask for the CPU, rather than falling back quietly."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        solve(_port(prob_synth), _cfg(), dtype=torch.float32)


def test_import_and_solve_without_jax():
    """Importing the port (its front-end and roofline model too) and
    running small CPU solves, dense ("high") and on the covisibility pairs,
    never imports jax or any module of psba_tpu."""
    code = (
        "import sys, torch\n"
        "import psba_tpu_torch\n"
        "import psba_tpu_torch.frontend, psba_tpu_torch.frontend.pipeline\n"
        "from psba_tpu_torch.utils import roofline\n"
        "assert roofline.summarize(4, 40, 100, 1.0)['mfu'] > 0\n"
        "from psba_tpu_torch.io import synthetic_problem\n"
        "p = synthetic_problem(n_cams=4, n_pts=40, seed=1)\n"
        "from psba_tpu_torch.solvers import SolverConfig\n"
        "cfg = SolverConfig.for_dtype(torch.float32, max_iters=12, "
        "s_precision='high')\n"
        "r = psba_tpu_torch.solve(p, cfg, dtype=torch.float32, "
        "device='cpu')\n"
        "assert r.final_l2 < r.initial_l2, r\n"
        "q = psba_tpu_torch.solve(p, cfg, dtype=torch.float32, "
        "device='cpu', schur='pairs')\n"
        "assert q.final_l2 < q.initial_l2, q\n"
        "bad = [m for m in sys.modules if m in ('jax', 'psba_tpu') or "
        "m.startswith(('jax.', 'jaxlib', 'psba_tpu.'))]\n"
        "assert not bad, bad\n"
        "print('ok', r.flag_name, [ph for ph, _, _ in r.phases])\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
