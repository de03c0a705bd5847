"""Port against reference: the float64 path (the XLA form) and the float64
polish, on CPU tensors.

Inputs are the reference's own fixtures (tests/data/mini_bal.txt and the
6-camera synthetic problem), read by each package's reader, and states
perturbed from a seed with numpy. The JAX side runs with x64 enabled.
Tolerances, all float64:
  - each XLA-form function (assemble_blocks, inv3x3_planar, stack_blocks,
    schur_S_dense, reduced_rhs_dense, planar_gb, back_substitute_dense,
    spd_solve_xla) against the reference's to 1e-12 relative (the same
    arithmetic in another order); the XLA-form S, ea and dpb against the
    port's dense3 and pair forms on one state to 1e-12;
  - lm_run / tr_run with backend="xla" on both encodings against the
    reference's: history rows, parameters and ex to 1e-9 (float64 sums in
    another order, carried through the iterations), itno and flag equal;
  - the default float64 solve against the reference's: phases through the
    first TR phase equal, LM rows to 1e-9, final L2 to 1e-6;
  - the float32 solve with the float64 polish against the reference's:
    phases equal including "lm64", final L2 to 1e-5; a resume from a
    mid-"lm64" checkpoint to the same iterations and final L2 to 1e-6.
"""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu import constants as CC
from psba_tpu.solvers import SolverConfig as JSolverConfig
from psba_tpu.solvers.types import OptState as JOptState
from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
from psba_tpu_torch.convert import from_reference, state_from_reference
from psba_tpu_torch.core import hessian as th
from psba_tpu_torch.core import linalg as tl
from psba_tpu_torch.core import schur as ts
from psba_tpu_torch.solvers import SolverConfig, use_kernels
from psba_tpu_torch.solvers.hybrid import solve
from psba_tpu_torch.solvers.types import OptState, ProblemArrays
from psba_tpu_torch.utils import checkpoint as ckpt

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")
F64 = torch.float64
_PA = ("K", "q0", "obs", "cam_idx", "pt_idx", "obs_du", "obs_dv", "valid_d",
       "blk_idx", "pair_o1", "pair_o2", "pair_bucket")


def _problems(name):
    """(psba_tpu problem, psba_tpu_torch problem) read from the same input
    by each package's own reader."""
    import psba_tpu.io as jio
    import psba_tpu_torch.io as tio

    if name == "synth":
        return (jio.synthetic_problem(n_cams=6, n_pts=150, seed=3),
                tio.synthetic_problem(n_cams=6, n_pts=150, seed=3))
    return jio.bal_to_problem(MINI_BAL), tio.bal_to_problem(MINI_BAL)


@pytest.fixture(scope="module")
def mini():
    return _problems("mini_bal")


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a.astype(np.float64) - b)) / (
        np.max(np.abs(b)) + 1e-300)


def _state(prob, seed, scale=1.0):
    """float64 cameras and points perturbed from a seed."""
    rng = np.random.default_rng(seed)
    cams = prob.cams + scale * np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1)
    pts = prob.pts + scale * 1e-2 * rng.standard_normal(prob.pts.shape)
    return cams, pts


def _both(jprob, schur):
    """The reference's float64 ProblemArrays and the port's, carried over
    with convert.from_reference (blk_idx on the dense encoding)."""
    jpa = JProblemArrays.from_problem(jprob, dtype=jnp.float64, schur=schur)
    fields = {k: np.asarray(getattr(jpa, k)) for k in _PA
              if getattr(jpa, k) is not None}
    tpa, _, _ = from_reference(fields, np.asarray(jprob.cams),
                               np.asarray(jprob.pts), device="cpu")
    return jpa, tpa


@pytest.fixture(scope="module")
def blocks(mini):
    """The reference's Jacobians and residual of mini_bal at a perturbed
    float64 state, as numpy."""
    from psba_tpu.core.jacobian import jacobians
    from psba_tpu.core.residual import residuals

    jprob, _ = mini
    p = jprob.with_blk()
    cams, pts = _state(p, 5)
    A, B = jacobians(p.K, p.q0, cams, pts, p.cam_idx, p.pt_idx)
    ex = residuals(p.K, p.q0, cams, pts, p.obs, p.cam_idx, p.pt_idx)
    return p, np.array(A), np.array(B), np.array(ex)


# --------------------------------------------------- the XLA-form functions

@pytest.mark.parametrize("coeff", [1.0, 2.0])
def test_assemble_blocks_matches_reference(blocks, coeff):
    from psba_tpu.core.hessian import assemble_blocks

    p, A, B, ex = blocks
    ref = assemble_blocks(A, B, ex, p.cam_idx, p.pt_idx, p.n_cams, p.n_pts,
                          coeff=coeff)
    t = torch.from_numpy
    got = th.assemble_blocks(t(A), t(B), t(ex), t(p.cam_idx.astype(np.int64)),
                             t(p.pt_idx.astype(np.int64)), p.n_cams, p.n_pts,
                             coeff=coeff)
    for name, g, r in zip(("U", "V", "W", "ga", "gb"), got, ref):
        assert g.shape == r.shape and g.dtype == F64, name
        assert _rel(g, r) < 1e-12, name


def test_dense_xla_family_matches_reference(blocks):
    """stack_blocks and planar_gb exactly (a gather and a relayout);
    inv3x3_planar, schur_S_dense, reduced_rhs_dense and
    back_substitute_dense to 1e-12 on the damped blocks of one state."""
    from psba_tpu.core import schur as js
    from psba_tpu.core.hessian import assemble_blocks, damp_uv

    p, A, B, ex = blocks
    U, V, W, ga, gb = (np.array(a) for a in assemble_blocks(
        A, B, ex, p.cam_idx, p.pt_idx, p.n_cams, p.n_pts))
    U_d, V_d = (np.array(a) for a in damp_uv(U, V, 2.5))
    t = torch.from_numpy
    ZW_r = js.stack_blocks(W, p.blk_idx)
    ZW = ts.stack_blocks(t(W), t(p.blk_idx.astype(np.int64)))
    np.testing.assert_array_equal(ZW.numpy(), np.asarray(ZW_r))
    gbp = ts.planar_gb(t(gb))
    np.testing.assert_array_equal(gbp.numpy(), np.asarray(js.planar_gb(gb)))
    Vp_r, ok_r = js.inv3x3_planar(V_d)
    Vp, ok = ts.inv3x3_planar(t(V_d))
    assert bool(ok) == bool(ok_r) is True
    assert Vp.shape == Vp_r.shape and _rel(Vp, Vp_r) < 1e-12
    S_r, ZY_r = js.schur_S_dense(U_d, ZW_r, Vp_r)
    S, ZY = ts.schur_S_dense(t(U_d), ZW, Vp)
    assert _rel(S, S_r) < 1e-12 and _rel(ZY, ZY_r) < 1e-12
    ea_r = js.reduced_rhs_dense(ga, np.asarray(js.planar_gb(gb)), ZY_r)
    ea = ts.reduced_rhs_dense(t(ga), gbp, ZY)
    assert _rel(ea, ea_r) < 1e-12
    dpa = np.linalg.solve(np.asarray(S_r), np.asarray(ea_r).reshape(-1))
    ebp_r, dpb_r = js.back_substitute_dense(np.asarray(js.planar_gb(gb)),
                                            ZW_r, Vp_r, dpa.reshape(-1, 6))
    ebp, dpb = ts.back_substitute_dense(gbp, ZW, Vp, t(dpa.reshape(-1, 6)))
    assert _rel(ebp, ebp_r) < 1e-12 and _rel(dpb, dpb_r) < 1e-12


@pytest.mark.parametrize("case", ["regular", "fallback"])
def test_inv3x3_planar_matches_reference(case):
    """Random SPD blocks over nine decades of scale; "fallback" adds blocks
    whose closed-form determinant is under 1e-16 of their scale, which
    take the pivoted determinant: singular ones (ok false, zero inverse)
    in both packages."""
    from psba_tpu.core.schur import inv3x3_planar

    rng = np.random.default_rng(7)
    M = rng.standard_normal((300, 3, 3))
    V = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3)
    V *= 10.0 ** rng.uniform(-4, 5, (300, 1, 1))
    if case == "fallback":
        u = rng.standard_normal((6, 3, 2))
        V[:6] = u @ u.transpose(0, 2, 1)            # rank 2
        V[6] = np.diag([1.0, 1e-9, 1e-9])
    Vp_r, ok_r = inv3x3_planar(V)
    Vp, ok = ts.inv3x3_planar(torch.from_numpy(V))
    assert bool(ok) == bool(ok_r) == (case == "regular")
    assert _rel(Vp, Vp_r) < 1e-12
    if case == "fallback":
        assert not np.asarray(Vp_r)[..., :7].any()


@pytest.mark.parametrize("n", [18, 130, 1030])
def test_spd_solve_xla_matches_reference(n):
    """spd_solve_xla against the reference's, and spd_solve's dispatch:
    float64 goes to the XLA form at every size, counted in
    spd_solve_xla.calls and not in oversized_launches."""
    from psba_tpu.core.linalg import spd_solve_xla

    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    x_r, ok_r = spd_solve_xla(S, b)
    calls, over = tl.spd_solve_xla.calls, tl.spd_solve.oversized_launches
    x, ok = tl.spd_solve(torch.from_numpy(S), torch.from_numpy(b))
    assert tl.spd_solve_xla.calls == calls + 1
    assert tl.spd_solve.oversized_launches == over
    assert bool(ok) and bool(ok_r) and ok.dtype == torch.bool
    assert _rel(x, x_r) < 1e-12


def test_spd_solve_xla_flags_indefinite():
    S = np.eye(24)
    S[5, 5] = -2.0
    x, ok = tl.spd_solve_xla(torch.from_numpy(S), torch.ones(24, dtype=F64))
    assert not bool(ok) and torch.all(x == 0.0)


def test_xla_S_matches_dense3_and_pairs(mini):
    """The three encodings of the port's reduced system on one float64
    state: the XLA form (assemble_blocks + the dense family) against
    dense3 (the grid planes) and the pair family (stream blocks), S, ea and
    dpb to 1e-12."""
    from psba_tpu_torch.core.jacobian import jacobians
    from psba_tpu_torch.core.residual import residuals
    from psba_tpu_torch.ops import linearize_dense as tld
    from psba_tpu_torch.ops import linearize_stream as tls

    _, prob = mini
    pa_x = ProblemArrays.from_problem(prob, dtype=F64, schur="dense",
                                      device="cpu")
    pa_d = ProblemArrays.from_problem(prob, dtype=F64, schur="dense",
                                      backend="pallas", device="cpu")
    pa_p = ProblemArrays.from_problem(prob, dtype=F64, schur="pairs",
                                      backend="pallas", device="cpu")
    assert pa_x.obs_du is None and pa_x.stream is None
    cams, pts = (torch.from_numpy(a) for a in _state(prob, 6))
    C, P, mu = prob.n_cams, prob.n_pts, 3.7
    A, B = jacobians(pa_x.K, pa_x.q0, cams, pts, pa_x.cam_idx, pa_x.pt_idx)
    ex = residuals(pa_x.K, pa_x.q0, cams, pts, pa_x.obs, pa_x.cam_idx,
                   pa_x.pt_idx)
    U, V, W, ga, gb = th.assemble_blocks(A, B, ex, pa_x.cam_idx, pa_x.pt_idx,
                                         C, P)
    U_d, V_d = th.damp_uv(U, V, mu)
    Vp, ok = ts.inv3x3_planar(V_d)
    ZW, gbp = ts.stack_blocks(W, pa_x.blk_idx), ts.planar_gb(gb)
    S, ZY = ts.schur_S_dense(U_d, ZW, Vp)
    ea = ts.reduced_rhs_dense(ga, gbp, ZY)
    dpa = torch.linalg.solve(S, ea.reshape(-1)).reshape(C, 6)
    _ebp, dpb = ts.back_substitute_dense(gbp, ZW, Vp, dpa)

    ZW0, ZW1, ZW2, Vp3, gbp3, _Pp = tld.linearize_dense(
        pa_d.K, pa_d.q0, cams, pts, pa_d.obs_du, pa_d.obs_dv, pa_d.valid_d)
    ZW3 = (ZW0, ZW1, ZW2)
    Vinv3, ok3 = ts.inv3x3_planar3(ts.damp_v_planar(Vp3, mu))
    S3, ZY3 = ts.schur_S_dense3(U_d, ZW3, Vinv3)
    ea3 = ts.reduced_rhs_dense3(ga, gbp3, ZY3)
    dpb3 = ts.back_substitute_dense3(gbp3, ZW3, Vinv3, dpa)[:, :P].T

    _e, _l, Up, Vq, Wq, gap, gbq, _, _ = tls.linearize_stream(
        pa_p.K, pa_p.q0, cams, pts, pa_p.obs, pa_p.cam_idx, pa_p.pt_idx,
        None, C, P)
    Vinv, okp = ts.inv3x3(Vq + mu * torch.eye(3, dtype=F64))
    Y = ts.y_blocks(Wq, Vinv, pa_p.pt_idx)
    Sp = ts.schur_S(Up + mu * torch.eye(6, dtype=F64), Y, Wq, pa_p.pair_o1,
                    pa_p.pair_o2, pa_p.pair_bucket, C)
    eap = ts.reduced_rhs(gap, gbq, Y, pa_p.cam_idx, pa_p.pt_idx, C)
    _eb, dpbp = ts.back_substitute(gbq, Wq, Vinv, dpa, pa_p.cam_idx,
                                   pa_p.pt_idx, P)
    assert bool(ok) and bool(ok3) and bool(okp)
    for other in (S3, Sp):
        assert _rel(S, other) < 1e-12
    for other in (ea3, eap):
        assert _rel(ea, other) < 1e-12
    for other in (dpb3, dpbp):
        assert _rel(dpb, other) < 1e-12


# ------------------------------------------------------------ the backend

def test_backend_resolution(mini):
    """use_kernels: "pallas" the kernel path, "xla" the XLA form, "auto"
    the kernels in float32 and the XLA form in float64, on any device.
    Named deviation: the reference's "auto" takes the XLA form for a
    float32 run off the TPU (here, on the CPU), the port's the kernels'
    plain versions. from_problem builds the kernel path's tables only for
    it."""
    from psba_tpu.solvers.lm import use_pallas

    table = {("pallas", F64): True, ("pallas", torch.float32): True,
             ("xla", F64): False, ("xla", torch.float32): False,
             ("auto", F64): False, ("auto", torch.float32): True}
    for (backend, dt), want in table.items():
        assert use_kernels(SolverConfig(backend=backend), dt) is want
    jdt = {F64: jnp.float64, torch.float32: jnp.float32}
    for (backend, dt), want in table.items():
        ref = use_pallas(JSolverConfig(backend=backend), jdt[dt])
        if (backend, dt) == ("auto", torch.float32):
            assert ref is False and want is True      # the deviation
        else:
            assert ref == want, (backend, dt)
    with pytest.raises(ValueError, match="backend"):
        use_kernels(SolverConfig(backend="mosaic"), F64)
    _, prob = mini
    for dt in (F64, torch.float32):
        for backend in ("auto", "pallas", "xla"):
            pa = ProblemArrays.from_problem(prob, dtype=dt, schur="dense",
                                            backend=backend, device="cpu")
            k = use_kernels(SolverConfig(backend=backend), dt)
            assert (pa.obs_du is not None) is k and (pa.stream is not None) \
                is k and pa.blk_idx is not None
    xla_pa = ProblemArrays.from_problem(prob, dtype=F64, schur="dense",
                                        device="cpu")
    with pytest.raises(ValueError, match="XLA form"):
        xla_pa.need(kernels=True)


# ----------------------------------------------------- lm_run and tr_run

@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_lm_run_xla_matches_reference(mini, schur):
    """Six LM iterations with backend="xla" from one perturbed state, a
    budget short of convergence (mini_bal takes 34)."""
    from psba_tpu.solvers.lm import lm_run_jit
    from psba_tpu_torch.solvers.lm import lm_run

    jprob, _ = mini
    jpa, tpa = _both(jprob, schur)
    cams, pts = _state(jprob, 8)
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))
    kw = dict(max_iters=6, lm_switch_count=10_000, record_history=True,
              damping="additive", backend="xla")
    ref = lm_run_jit(jpa, jst, JSolverConfig.for_dtype(jnp.float64, **kw))
    st = state_from_reference({k: np.asarray(v) for k, v in
                               jst._asdict().items()}, device="cpu")
    out = lm_run(tpa, st, SolverConfig.for_dtype(F64, **kw))
    assert out.itno == int(ref.itno) == 6
    assert out.flag == int(ref.flag) == CC.ITER_CONTINUE
    hr = np.asarray(ref.history)
    np.testing.assert_array_equal(out.history[:, 0], hr[:, 0])
    np.testing.assert_allclose(out.history[:, 1:4], hr[:, 1:4], rtol=1e-9)
    np.testing.assert_allclose(float(out.ex_l2), float(ref.ex_l2), rtol=1e-9)
    for got, want in ((out.cams, ref.cams), (out.pts, ref.pts),
                      (out.ex, ref.ex)):
        assert _rel(got, want) <= 1e-9


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_tr_run_xla_matches_reference(mini, schur):
    """Three TR iterations with backend="xla", entered with lambda = 10 > 0
    (so the GMW bootstrap stays out), from one perturbed state: every
    history row, ex_l2, aux, the parameters and ex to 1e-9."""
    from psba_tpu.solvers.tr import tr_run_jit
    from psba_tpu_torch.solvers.tr import tr_run

    jprob, _ = mini
    jpa, tpa = _both(jprob, schur)
    cams, pts = _state(jprob, 3, scale=3.0)
    aux = np.array([1.0, 10.0, 10.0, 2.0, 0.0, 0.0])
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))._replace(
        aux=jnp.asarray(aux), itno=jnp.int32(2),
        history=jnp.full((5, 6), jnp.nan, jnp.float64))
    kw = dict(max_iters=5, record_history=True, backend="xla")
    ref = tr_run_jit(jpa, jst, JSolverConfig.for_dtype(jnp.float64, **kw))
    st = state_from_reference({k: np.asarray(v) for k, v in
                               jst._asdict().items()}, device="cpu")
    out = tr_run(tpa, st, SolverConfig.for_dtype(F64, **kw))
    assert out.itno == int(ref.itno) == 5 and out.flag == int(ref.flag)
    h, hr = out.history, np.asarray(ref.history)
    assert np.isnan(h[:2]).all() and not np.isnan(h[2:]).any()
    np.testing.assert_allclose(h[2:], hr[2:], rtol=1e-9)
    np.testing.assert_allclose(float(out.ex_l2), float(ref.ex_l2), rtol=1e-9)
    np.testing.assert_allclose(out.aux.numpy(), np.asarray(ref.aux),
                               rtol=1e-9)
    assert float(out.ex_l2) < float(jst.ex_l2)
    for got, want in ((out.cams, ref.cams), (out.pts, ref.pts),
                      (out.ex, ref.ex)):
        assert _rel(got, want) <= 1e-9


# ------------------------------------------------------------------ solve

@pytest.mark.parametrize("name", ["synth", "mini_bal"])
def test_default_f64_solve_matches_reference(name):
    """The default float64 solve ("auto" resolves to the XLA form in both
    packages) against the reference's: phases through the first TR phase,
    the LM rows before it to 1e-9, final L2 to 1e-6. In float64 the GMW
    bootstrap at TR entry reads the same lambda, and the two runs agree
    much further: the measured gaps are printed."""
    from psba_tpu.solvers.hybrid import solve as jsolve

    jprob, tprob = _problems(name)
    ref = jsolve(jprob, JSolverConfig.for_dtype(jnp.float64,
                                                record_history=True))
    res = solve(tprob, SolverConfig.for_dtype(F64, record_history=True),
                device="cpu")
    assert res.resolved_damping == ref.resolved_damping
    names = [ph for ph, _, _ in ref.phases]
    k = names.index("tr")
    assert res.phases[:k + 1] == ref.phases[:k + 1]
    tr_start = ref.phases[k - 1][1]
    np.testing.assert_array_equal(res.history[:tr_start, 0],
                                  ref.history[:tr_start, 0])
    np.testing.assert_allclose(res.history[:tr_start, 1:4],
                               ref.history[:tr_start, 1:4], rtol=1e-9)
    gap = abs(res.final_l2 - ref.final_l2) / ref.final_l2
    print(f"{name}: phases {res.phases} / {ref.phases}, final L2 gap "
          f"{gap:.3e}, LM rows gap "
          f"{_rel(res.history[:tr_start, 1], ref.history[:tr_start, 1]):.3e}")
    assert gap <= 1e-6
    np.testing.assert_allclose(res.initial_l2, ref.initial_l2, rtol=1e-12)
    assert res.final_l2 < res.initial_l2


def _polish_start_l2(tprob, res_main, schur):
    """L2 in float64 at the end of the float32 run: where the polish
    starts."""
    pa = ProblemArrays.from_problem(tprob, dtype=F64, schur=schur,
                                    device="cpu")
    st = OptState.init(pa, torch.from_numpy(res_main.cams.astype(np.float64)),
                       torch.from_numpy(res_main.pts.astype(np.float64)))
    return float(st.ex_l2)


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_polished_f32_solve_matches_reference(schur):
    """A float32 LM run (switch off, budget 6: short of the DP_NO_CHANGE
    stop, which float32 rounding decides) with polish_iters=3 on the
    6-camera synthetic problem against the reference's (Pallas in
    interpret mode, then its f64 polish): the phases equal, "lm64" last,
    final L2 to 1e-5; the polish ends at or below its start."""
    from psba_tpu.solvers.hybrid import solve as jsolve

    jprob, tprob = _problems("synth")
    kw = dict(max_iters=6, lm_switch_count=10_000)
    ref = jsolve(jprob, JSolverConfig.for_dtype(jnp.float32, backend="pallas",
                                                **kw),
                 dtype=jnp.float32, schur=schur, polish_iters=3)
    cfg = SolverConfig.for_dtype(torch.float32, **kw)
    res = solve(tprob, cfg, dtype=torch.float32, device="cpu", schur=schur,
                polish_iters=3)
    main = solve(tprob, cfg, dtype=torch.float32, device="cpu", schur=schur)
    assert res.phases == ref.phases
    assert res.phases[-1][0] == "lm64" and res.iterations == 9
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-5)
    assert res.phases[:-1] == main.phases
    assert res.final_l2 <= _polish_start_l2(tprob, main, schur)
    assert res.cams.dtype == np.float64


def test_polish_checkpoints_and_resume(tmp_path):
    """The counterpart of the reference's polish checkpoint test: the
    "lm64" phase checkpoints with polish_target, and a resume from a
    mid-"lm64" checkpoint reaches the same iterations and final L2
    (1e-6)."""
    _, prob = _problems("synth")
    ck = tmp_path / "ck"
    kw = dict(dtype=torch.float32, device="cpu", polish_iters=4,
              checkpoint_dir=str(ck), checkpoint_every=2)
    res = solve(prob, **kw)
    _, _, meta = ckpt.load_latest(str(ck))
    assert meta["phase"] == "lm64"
    assert meta["polish_target"] == res.iterations
    assert res.phases[-1] == ("lm64", res.iterations, res.flag)
    mid = None
    for f in sorted(ck.glob("ckpt_*.npz")):
        with np.load(f, allow_pickle=False) as z:
            m = json.loads(str(z["meta"]))
            if m.get("phase") == "lm64" and "aux" in z.files:
                mid = f
                break
    assert mid is not None, "no mid-polish checkpoint carried aux"
    (ck / "latest").write_text(mid.name)
    res2 = solve(prob, **kw)
    assert res2.iterations == res.iterations
    assert res2.phases == [("lm64", res.iterations, res.flag)]
    np.testing.assert_allclose(res2.final_l2, res.final_l2, rtol=1e-6)


def test_nan_checks_raise_on_a_nan_point(monkeypatch):
    """PSBA_DEBUG_NANS=1 (env_nan_checks) makes solve read isfinite at its
    boundaries: a NaN point raises FloatingPointError naming pts and the
    phase; with the checks off the same check does nothing."""
    import dataclasses

    from psba_tpu_torch.utils import debug

    monkeypatch.setattr(debug, "_enabled", False)
    _, prob = _problems("synth")
    pts = prob.pts.copy()
    pts[7, 1] = np.nan
    bad = dataclasses.replace(prob, pts=pts)
    debug.check_finite("init", pts=torch.from_numpy(pts))
    monkeypatch.setenv("PSBA_DEBUG_NANS", "1")
    assert debug.env_nan_checks()
    with pytest.raises(FloatingPointError, match=r"pts.*'init'"):
        solve(bad, device="cpu")
    assert debug.first_nonfinite({"pts": pts, "cams": prob.cams},
                                 names=["cams", "pts"])[:2] == ("pts", (7, 1))
