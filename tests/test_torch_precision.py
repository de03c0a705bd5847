"""s_precision="high": solves on the CPU against the port's own "highest"
and the reference's "high".

The port runs "high" in full float32 on every path and device, a named
deviation from the reference's Precision.HIGH (3-pass bf16, about 2^-21)
on the dense3 products; on the CPU the reference's HIGH is float32 too
(XLA computes float32 dots in float32 there). So here:
  - "high" gives the "highest" bits on the dense path (LM and TR), the pair
    encoding and the float64 XLA form;
  - a "high" solve meets the reference's "high" solve under the
    tolerances of tests/test_torch_hybrid.py and test_torch_tr.py (LM rows
    1e-4, final L2 1e-3, TR rows from lambda > 0), and two gloo ranks meet
    the reference's sharded "high" solve (1e-3);
  - the dense3 products stay float32 under "high" (the named deviation),
    also after torch.set_float32_matmul_precision("high").
The card holds the products to float64 (tests/test_torch_cuda.py,
chip_smoke.py phase 3h).
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.solvers import SolverConfig as JSolverConfig
from psba_tpu.solvers.hybrid import solve as jsolve
from psba_tpu_torch.core import schur as tsc
from psba_tpu_torch.solvers import SolverConfig
from psba_tpu_torch.solvers.hybrid import solve

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")


def _problems(name):
    """(psba_tpu problem, psba_tpu_torch problem), each from its own
    package."""
    import psba_tpu.io as jio
    import psba_tpu_torch.io as tio

    if name == "synth":
        return (jio.synthetic_problem(n_cams=6, n_pts=150, seed=3),
                tio.synthetic_problem(n_cams=6, n_pts=150, seed=3))
    return jio.bal_to_problem(MINI_BAL), tio.bal_to_problem(MINI_BAL)


# ------------------------------------------------- "high" on the CPU: bits

def _f32_cfg(prec, **kw):
    return SolverConfig.for_dtype(torch.float32, record_history=True,
                                  s_precision=prec, **kw)


def _assert_same_bits(a, b):
    assert a.phases == b.phases and a.flag == b.flag
    np.testing.assert_array_equal(a.history, b.history)
    np.testing.assert_array_equal(a.cams, b.cams)
    np.testing.assert_array_equal(a.pts, b.pts)
    assert a.final_l2 == b.final_l2


@pytest.mark.parametrize("name", ["synth", "mini_bal"])
@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_high_on_the_cpu_gives_the_highest_bits(name, schur):
    """The default solve (LM -> TR -> ...), float32: "high" and "highest"
    give the same bits on the dense path (the kernels' plain versions, a
    TR phase included) and on the pair encoding (which ignores "high")."""
    _, tp = _problems(name)
    runs = [solve(tp, _f32_cfg(prec), dtype=torch.float32, device="cpu",
                  schur=schur) for prec in ("highest", "high")]
    assert "tr" in [ph for ph, _, _ in runs[0].phases]
    _assert_same_bits(*runs)
    assert torch.backends.cuda.matmul.allow_tf32 is False


def test_high_float64_xla_form_gives_the_highest_bits():
    _, tp = _problems("mini_bal")
    runs = [solve(tp, SolverConfig.for_dtype(torch.float64,
                                             record_history=True,
                                             s_precision=prec),
                  device="cpu") for prec in ("highest", "high")]
    _assert_same_bits(*runs)


# ----------------------------------------- "high" against the reference's

@pytest.mark.parametrize("name", ["synth", "mini_bal"])
def test_high_solve_matches_reference_high(name):
    """The reference's "high" solve (dense3, Pallas in interpret mode)
    against the port's, float32, default config, as
    tests/test_torch_hybrid.py holds "highest": the phases through the
    switch to TR, the LM rows before it (ex_l2 1e-4), the first TR phase's
    flag with its end within one iteration, final L2 1e-3."""
    jp, tp = _problems(name)
    ref = jsolve(jp, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", record_history=True,
        s_precision="high"), dtype=jnp.float32)
    res = solve(tp, _f32_cfg("high"), dtype=torch.float32, device="cpu")
    names = [ph for ph, _, _ in ref.phases]
    k = names.index("tr")
    assert res.phases[:k] == ref.phases[:k]
    assert res.phases[k][0] == ref.phases[k][0]
    assert res.phases[k][2] == ref.phases[k][2]
    assert abs(res.phases[k][1] - ref.phases[k][1]) <= 1
    tr_start = ref.phases[k - 1][1]
    np.testing.assert_allclose(res.history[:tr_start, 1],
                               ref.history[:tr_start, 1], rtol=1e-4)
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-3)


def test_high_tr_rows_match_reference_high():
    """Three TR iterations from lambda = 10 > 0 (no GMW bootstrap), the
    reference's tr_run at "high" against the port's: the control columns
    equal, the rest to 1e-4 (mini_bal, as tests/test_torch_tr.py)."""
    from psba_tpu.io import bal_to_problem
    from psba_tpu.solvers.tr import tr_run_jit
    from psba_tpu.solvers.types import OptState as JOptState
    from psba_tpu_torch.convert import state_from_reference
    from psba_tpu_torch.solvers import tr as ttr
    from tests.test_torch_tr import _both, _state

    p = bal_to_problem(MINI_BAL)
    jpa, tpa = _both(p)
    cams, pts = _state(p, 3, scale=3.0)
    aux = np.array([1.0, 10.0, 10.0, 2.0, 0.0, 0.0], np.float32)
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))._replace(
        aux=jnp.asarray(aux), itno=jnp.int32(2),
        history=jnp.full((5, 6), jnp.nan, jnp.float32))
    ref = tr_run_jit(jpa, jst, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", max_iters=5, record_history=True,
        s_precision="high"))
    st = state_from_reference({k: np.asarray(v) for k, v in
                               jst._asdict().items()}, device="cpu")
    out = ttr.tr_run(tpa, st, SolverConfig.for_dtype(
        torch.float32, max_iters=5, record_history=True, s_precision="high"))
    assert out.itno == int(ref.itno) == 5 and out.flag == int(ref.flag)
    h, hr = out.history, np.asarray(ref.history)
    np.testing.assert_array_equal(h[:, [0, 3, 4]], hr[:, [0, 3, 4]])
    np.testing.assert_allclose(h[2:], hr[2:], rtol=1e-4)


def test_sharded_high_matches_reference_high():
    """Two gloo ranks, float32 "high", against the reference's
    solve_sharded at "high" on the virtual CPU mesh (its float32 sharded
    path is the XLA form, which ignores "high"): the first LM phase, the
    switch to TR, final L2 1e-3 (tests/test_torch_parallel.py)."""
    from psba_tpu.parallel.shard import solve_sharded as j_solve
    from psba_tpu_torch.parallel.shard import solve_sharded

    jp, tp = _problems("mini_bal")
    ref = j_solve(jp, JSolverConfig.for_dtype(np.float32, s_precision="high"),
                  n_devices=2, dtype=np.float32)
    got = solve_sharded(tp, SolverConfig.for_dtype(np.float32,
                                                   s_precision="high"),
                        n_devices=2, dtype=np.float32, device="cpu",
                        timeout=120)
    assert got.phases[0] == tuple(ref.phases[0])
    assert got.phases[1][0] == ref.phases[1][0] == "tr"
    np.testing.assert_allclose(got.final_l2, ref.final_l2, rtol=1e-3)


# ------------------------------------------- the named float32 deviation

def test_dense3_products_stay_float32_under_high():
    """Named deviation: the reference runs the S product, the reduced rhs
    and the back-substitution at the solver's precision (HIGH for "high",
    psba_tpu/core/schur.py:345, :359, :372); the port keeps all three in
    full float32 whatever s_precision is. They take no precision argument,
    their docstrings name the deviation, and their error against float64
    stays within what "high" promises (2^-21 of the scale)."""
    import inspect

    from psba_tpu_torch.io import synthetic_problem
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.solvers import ProblemArrays

    assert "deviation" in tsc.__doc__
    for fn in (tsc.schur_S_dense3, tsc.reduced_rhs_dense3,
               tsc.back_substitute_dense3):
        assert "precision" not in inspect.signature(fn).parameters
        assert "deviation" in fn.__doc__
    prob = synthetic_problem(n_cams=8, n_pts=300, seed=2)
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32, device="cpu")
    cams = torch.as_tensor(prob.cams, dtype=torch.float32) + 1e-3
    pts = torch.as_tensor(prob.pts, dtype=torch.float32)
    ZW0, ZW1, ZW2, Vp, gbp, _Pp, U, ga = ld.linearize_dense(
        pa.K, pa.q0, cams, pts, pa.obs_du, pa.obs_dv, pa.valid_d,
        want_u=True)
    ZW3 = (ZW0, ZW1, ZW2)
    Ud = U + torch.eye(6)
    Vinv, _ok = tsc.inv3x3_planar3(tsc.damp_v_planar(Vp, 1.0))
    S, ZY3 = tsc.schur_S_dense3(Ud, ZW3, Vinv)
    dpa = torch.randn(prob.n_cams, 6, generator=torch.Generator()
                      .manual_seed(0))
    ea = tsc.reduced_rhs_dense3(ga, gbp, ZY3)
    dpb = tsc.back_substitute_dense3(gbp, ZW3, Vinv, dpa)
    d = lambda t: tuple(x.double() for x in t)
    S64, ZY64 = tsc.schur_S_dense3(Ud.double(), d(ZW3), Vinv.double())
    ea64 = tsc.reduced_rhs_dense3(ga.double(), gbp.double(), d(ZY3))
    dpb64 = tsc.back_substitute_dense3(gbp.double(), d(ZW3), Vinv.double(),
                                       dpa.double())
    blk = torch.block_diag(*Ud.double())
    for got, want in ((blk - S.double(), blk - S64), (ea, ea64),
                      (dpb, dpb64)):
        err = float((got.double() - want).abs().max() / want.abs().max())
        assert err <= 2.0 ** -21, err


def test_high_keeps_the_float32_pin():
    """PyTorch's own "high" (torch.set_float32_matmul_precision) is
    single-pass TF32, not the reference's 3-pass HIGH: a "high" dense solve
    run after it turns TF32 off, for cuBLAS and cuDNN, and gives the bits
    of a "highest" solve."""
    _, tp = _problems("synth")
    ref = solve(tp, _f32_cfg("highest"), dtype=torch.float32, device="cpu")
    prec, cudnn = (torch.get_float32_matmul_precision(),
                   torch.backends.cudnn.allow_tf32)
    torch.set_float32_matmul_precision("high")
    torch.backends.cudnn.allow_tf32 = True
    try:
        assert torch.backends.cuda.matmul.allow_tf32 is True
        got = solve(tp, _f32_cfg("high"), dtype=torch.float32, device="cpu")
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
    finally:
        torch.set_float32_matmul_precision(prec)
        torch.backends.cudnn.allow_tf32 = cudnn
    _assert_same_bits(got, ref)
