"""Port against reference: the covisibility-pair slice, on CPU tensors.

The trial-step residual (kernel 6's plain version against
residual_l2_pallas in interpret mode), the bucket sum, the pair Schur family
(inv3x3, y_blocks, schur_S, reduced_rhs, back_substitute), the pair
encoding of ProblemArrays and convert, and the pair branches of lm_run,
tr_run and solve, each fed the same numpy inputs made from a seed. Each
tolerance is stated beside its test with its reason. The JAX side runs its
XLA path in float64 where the algorithm is the point, and backend="pallas"
(interpret mode) in float32 where the kernels are.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu import constants as CC
from psba_tpu.core import schur as js
from psba_tpu.ops.linearize_pallas import residual_l2_pallas
from psba_tpu.solvers import SolverConfig as JSolverConfig
from psba_tpu.solvers.types import OptState as JOptState
from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
from psba_tpu_torch.convert import from_reference, state_from_reference
from psba_tpu_torch.core import schur as ts
from psba_tpu_torch.ops import linearize_dense as tld
from psba_tpu_torch.ops import linearize_stream as tls
from psba_tpu_torch.ops.reduce import indexed_sum
from psba_tpu_torch.solvers import SolverConfig
from psba_tpu_torch.solvers import types as ttypes
from psba_tpu_torch.solvers.types import OptState, ProblemArrays

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")
_PA = ("K", "q0", "obs", "cam_idx", "pt_idx", "pair_o1", "pair_o2",
       "pair_bucket")


def _problems(name):
    """(psba_tpu problem, psba_tpu_torch problem) read from the same input
    by each package's own reader."""
    import psba_tpu.io as jio
    import psba_tpu_torch.io as tio

    if name == "synth":
        return (jio.synthetic_problem(n_cams=6, n_pts=150, seed=3),
                tio.synthetic_problem(n_cams=6, n_pts=150, seed=3))
    return jio.bal_to_problem(MINI_BAL), tio.bal_to_problem(MINI_BAL)


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b, np.float64)
    return np.max(np.abs(a.astype(np.float64) - b)) / (
        np.max(np.abs(b)) + 1e-300)


def _state(prob, seed, dtype=np.float32, scale=1.0):
    """Cameras and points perturbed from a seed, in `dtype`."""
    rng = np.random.default_rng(seed)
    cams = (prob.cams + scale * np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1)).astype(dtype)
    pts = (prob.pts + scale * 1e-2 * rng.standard_normal(prob.pts.shape)
           ).astype(dtype)
    return cams, pts


def _both(prob, dtype):
    """The reference's pair-encoded ProblemArrays and the port's, carried
    over with convert.from_reference."""
    jpa = JProblemArrays.from_problem(prob, dtype=dtype, schur="pairs")
    tpa, _, _ = from_reference({k: np.asarray(getattr(jpa, k)) for k in _PA},
                               np.asarray(prob.cams, dtype),
                               np.asarray(prob.pts, dtype))
    return jpa, tpa


# ------------------------------------------------ kernel 6: residual_l2

@pytest.mark.parametrize("masked", [False, True])
def test_residual_l2_matches_pallas(prob_synth, masked):
    """residual_l2 (plain on the CPU) against residual_l2_pallas in float32,
    at the reference's own gates (tests/test_pallas.py): ex to 1e-3 px
    absolute (residuals of O(px) against O(1e3) projections), l2 to 1e-5
    relative; with a mask the last observations drop out of l2 and ex stays
    unmasked. int32 indices, as the kernel takes them."""
    p = prob_synth
    f32 = np.float32
    cams, pts = _state(p, 11)
    valid = (np.arange(p.n_obs) < p.n_obs - 7) if masked else None
    ex_r, l2_r = residual_l2_pallas(
        jnp.asarray(p.K, f32), jnp.asarray(p.q0, f32), jnp.asarray(cams),
        jnp.asarray(pts), jnp.asarray(p.obs, f32), jnp.asarray(p.cam_idx),
        jnp.asarray(p.pt_idx), None if valid is None else jnp.asarray(valid))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ex, l2 = tls.residual_l2(
        t(p.K.astype(f32)), t(p.q0.astype(f32)), t(cams), t(pts),
        t(p.obs.astype(f32)), t(p.cam_idx.astype(np.int32)),
        t(p.pt_idx.astype(np.int32)),
        None if valid is None else t(valid.astype(f32)))
    assert ex.shape == (p.n_obs, 2) and ex.dtype == torch.float32
    np.testing.assert_allclose(ex.numpy(), np.asarray(ex_r), atol=1e-3)
    np.testing.assert_allclose(float(l2), float(l2_r), rtol=1e-5)
    if masked:
        full = float((ex * ex).sum())
        tail = float((ex[-7:] * ex[-7:]).sum())
        np.testing.assert_allclose(float(l2), full - tail, rtol=1e-5)


# ------------------------------------------------------------ indexed_sum

def test_indexed_sum_matches_segment_sum():
    """index_add_ bucket sum against jax.ops.segment_sum, with padding
    indices at and past n_segments that must add nothing. Integer-valued
    data make every sum exact, so summation order cannot show."""
    import jax

    rng = np.random.default_rng(1)
    n = 13
    data = rng.integers(-50, 50, (400, 6, 6)).astype(np.float64)
    idx = rng.integers(0, n, 400)
    idx[::17] = n
    idx[5] = n + 3
    got = indexed_sum(torch.from_numpy(data), torch.from_numpy(idx), n)
    ref = jax.ops.segment_sum(jnp.asarray(data), jnp.asarray(idx),
                              num_segments=n)
    assert got.shape == (n, 6, 6)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ------------------------------------------------------------- inv3x3

def _spd_blocks(rng, P):
    A = rng.standard_normal((P, 3, 3))
    return A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)


@pytest.mark.parametrize("case", ["spd", "near_singular", "singular",
                                  "scaled_1e12"])
def test_inv3x3_matches_reference(case):
    """[P, 3, 3] inverse against the reference's inv3x3 in float64 to
    1e-12 relative: well-conditioned blocks; blocks whose closed-form
    determinant falls under the 1e-16 gate (pivoted fallback, still ok);
    a rank-one and a zero block (ok False both, zero inverse, the others
    unchanged); blocks with entries around 1e12."""
    rng = np.random.default_rng({"spd": 0, "near_singular": 1,
                                 "singular": 2, "scaled_1e12": 3}[case])
    V = _spd_blocks(rng, 200)
    if case == "near_singular":
        V[:4] = 1e-3 * np.diag([1.0, 1.0, 1e-8])
    elif case == "singular":
        v = rng.standard_normal(3)
        V[7] = np.outer(v, v)
        V[9] = 0.0
    elif case == "scaled_1e12":
        s = np.sqrt(10.0 ** rng.uniform(11, 13, (200, 3)))
        V = V * s[:, :, None] * s[:, None, :]
    Vi_j, ok_j = js.inv3x3(jnp.asarray(V))
    Vi_t, ok_t = ts.inv3x3(torch.from_numpy(V))
    assert Vi_t.shape == (200, 3, 3)
    assert bool(ok_t) == bool(ok_j) == (case != "singular")
    if case == "singular":
        assert np.all(Vi_t[9].numpy() == 0.0)
        keep = [p for p in range(200) if p not in (7, 9)]
        assert _rel(Vi_t[keep], np.asarray(Vi_j)[keep]) < 1e-12
        return
    for p in range(0, 200, 50):
        assert _rel(Vi_t[p], np.asarray(Vi_j)[p]) < 1e-12
    eye = np.einsum("pij,pjk->pik", V, Vi_t.numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-8)


# ------------------------------------------------- the pair Schur family

def _pair_inputs(prob, seed):
    rng = np.random.default_rng(seed)
    C, P, O = prob.n_cams, prob.n_pts, prob.n_obs
    W = rng.standard_normal((O, 6, 3))
    Vinv = np.linalg.inv(_spd_blocks(rng, P))
    A = rng.standard_normal((C, 6, 6))
    U = A @ np.swapaxes(A, 1, 2) + 100.0 * np.eye(6)
    return (W, Vinv, U, rng.standard_normal((C, 6)),
            rng.standard_normal((P, 3)), rng.standard_normal((C, 6)))


def test_pair_schur_family_matches_reference(prob_synth):
    """y_blocks, schur_S, reduced_rhs and back_substitute on the reference's
    own pair list of the 6-camera problem, float64, to 1e-12 relative (the
    same products summed in another order)."""
    p = prob_synth.with_pairs()
    W, Vinv, U, ga, gb, dpa = _pair_inputs(p, 5)
    C, P = p.n_cams, p.n_pts
    t = torch.from_numpy
    ti = lambda a: torch.from_numpy(np.asarray(a, np.int64))
    Y_j = js.y_blocks(jnp.asarray(W), jnp.asarray(Vinv), p.pt_idx)
    Y_t = ts.y_blocks(t(W), t(Vinv), ti(p.pt_idx))
    assert _rel(Y_t, Y_j) < 1e-12
    S_j = js.schur_S(jnp.asarray(U), Y_j, jnp.asarray(W), p.pair_o1,
                     p.pair_o2, p.pair_bucket, C)
    S_t = ts.schur_S(t(U), Y_t, t(W), ti(p.pair_o1), ti(p.pair_o2),
                     ti(p.pair_bucket), C)
    assert S_t.shape == (6 * C, 6 * C)
    assert _rel(S_t, S_j) < 1e-12
    ea_j = js.reduced_rhs(jnp.asarray(ga), jnp.asarray(gb), Y_j, p.cam_idx,
                          p.pt_idx, C)
    ea_t = ts.reduced_rhs(t(ga), t(gb), Y_t, ti(p.cam_idx), ti(p.pt_idx), C)
    assert _rel(ea_t, ea_j) < 1e-12
    eb_j, dpb_j = js.back_substitute(jnp.asarray(gb), jnp.asarray(W),
                                     jnp.asarray(Vinv), jnp.asarray(dpa),
                                     p.cam_idx, p.pt_idx, P)
    eb_t, dpb_t = ts.back_substitute(t(gb), t(W), t(Vinv), t(dpa),
                                     ti(p.cam_idx), ti(p.pt_idx), P)
    assert _rel(eb_t, eb_j) < 1e-12 and _rel(dpb_t, dpb_j) < 1e-12


def test_pair_S_matches_dense3_S(prob_mini_bal_t):
    """The two encodings of the port on one state, float64: the pair S, ea
    and dpb (stream blocks W, V, gb) against the dense3 S, ea and dpb (grid
    planes ZW, Vp, gbp) to 1e-10 relative. This ties the pair path to the
    dense3 path the earlier slices hold against the reference."""
    prob = prob_mini_bal_t
    f64 = torch.float64
    pa_d = ProblemArrays.from_problem(prob, dtype=f64, schur="dense")
    pa_p = ProblemArrays.from_problem(prob, dtype=f64, schur="pairs")
    cams, pts = (torch.from_numpy(a) for a in _state(prob, 6, np.float64))
    C, P, mu = prob.n_cams, prob.n_pts, 3.7
    _ex, _l2, U, V, W, ga, gb, _, _ = tls.linearize_stream(
        pa_p.K, pa_p.q0, cams, pts, pa_p.obs, pa_p.cam_idx, pa_p.pt_idx,
        None, C, P)
    ZW0, ZW1, ZW2, Vp, gbp, _Pp = tld.linearize_dense(
        pa_d.K, pa_d.q0, cams, pts, pa_d.obs_du, pa_d.obs_dv, pa_d.valid_d)
    ZW3 = (ZW0, ZW1, ZW2)
    U_d = U + mu * torch.eye(6, dtype=f64)
    Vinv, ok = ts.inv3x3(V + mu * torch.eye(3, dtype=f64))
    Vinv_p, ok_p = ts.inv3x3_planar3(ts.damp_v_planar(Vp, mu))
    assert bool(ok) and bool(ok_p)
    Y = ts.y_blocks(W, Vinv, pa_p.pt_idx)
    S = ts.schur_S(U_d, Y, W, pa_p.pair_o1, pa_p.pair_o2, pa_p.pair_bucket,
                   C)
    S3, ZY3 = ts.schur_S_dense3(U_d, ZW3, Vinv_p)
    assert _rel(S, S3) < 1e-10
    ea = ts.reduced_rhs(ga, gb, Y, pa_p.cam_idx, pa_p.pt_idx, C)
    ea3 = ts.reduced_rhs_dense3(ga, gbp, ZY3)
    assert _rel(ea, ea3) < 1e-10
    dpa = torch.linalg.solve(S, ea.reshape(-1)).reshape(C, 6)
    _eb, dpb = ts.back_substitute(gb, W, Vinv, dpa, pa_p.cam_idx,
                                  pa_p.pt_idx, P)
    dpb3 = ts.back_substitute_dense3(gbp, ZW3, Vinv_p, dpa)[:, :P].T
    assert _rel(dpb, dpb3) < 1e-10


@pytest.fixture(scope="module")
def prob_mini_bal_t():
    return _problems("mini_bal")[1]


# ------------------------------------------- ProblemArrays and convert

def test_from_problem_pairs_matches_reference(prob_synth):
    """ProblemArrays.from_problem(schur="pairs") carries the reference's
    pair arrays exactly, no dense tables, the stream tables and the int32
    index copies."""
    _jprob, tprob = _problems("synth")
    jpa = JProblemArrays.from_problem(prob_synth, schur="pairs")
    pa = ProblemArrays.from_problem(tprob, dtype=torch.float32,
                                    schur="pairs")
    assert pa.pairs and pa.obs_du is None and pa.valid_d is None
    for k in ("pair_o1", "pair_o2", "pair_bucket", "cam_idx", "pt_idx"):
        np.testing.assert_array_equal(getattr(pa, k).numpy(),
                                      np.asarray(getattr(jpa, k)), err_msg=k)
    assert pa.cam_idx32.dtype == torch.int32
    np.testing.assert_array_equal(pa.pt_idx32.numpy(), tprob.pt_idx)
    assert pa.stream.perm.shape == (tprob.n_obs,)
    dense = ProblemArrays.from_problem(tprob, schur="dense")
    assert not dense.pairs and dense.valid_d is not None
    with pytest.raises(ValueError):
        ProblemArrays.from_problem(tprob, schur="blocks")


def test_auto_takes_pairs_above_the_cap(monkeypatch):
    """schur="auto" is dense at or under DENSE_MAX_ENTRIES camera x point
    cells and pairs above, in from_problem and in solve (which then follows
    the schur="pairs" trajectory exactly)."""
    _jprob, prob = _problems("synth")
    cells = prob.n_cams * prob.n_pts
    assert not ProblemArrays.from_problem(prob).pairs
    monkeypatch.setattr(ttypes, "DENSE_MAX_ENTRIES", cells)
    assert not ProblemArrays.from_problem(prob).pairs
    monkeypatch.setattr(ttypes, "DENSE_MAX_ENTRIES", cells - 1)
    assert ProblemArrays.from_problem(prob).pairs
    from psba_tpu_torch.solvers.hybrid import solve

    cfg = SolverConfig.for_dtype(torch.float32, max_iters=6,
                                 record_history=True)
    auto = solve(prob, cfg, dtype=torch.float32, device="cpu")
    pairs = solve(prob, cfg, dtype=torch.float32, device="cpu",
                  schur="pairs")
    np.testing.assert_array_equal(auto.history, pairs.history)
    np.testing.assert_array_equal(auto.cams, pairs.cams)


def test_from_reference_with_pairs(prob_mini_bal_j):
    """convert.from_reference takes the reference's pair fields without the
    dense tables; OptState.init then gives the reference's initial error,
    and a mapping with neither encoding is refused."""
    jpa, tpa = _both(prob_mini_bal_j, jnp.float64)
    assert tpa.pairs and tpa.obs_du is None
    np.testing.assert_array_equal(tpa.pair_bucket.numpy(),
                                  np.asarray(jpa.pair_bucket))
    cams, pts = prob_mini_bal_j.cams, prob_mini_bal_j.pts
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))
    st = OptState.init(tpa, torch.from_numpy(cams), torch.from_numpy(pts))
    np.testing.assert_allclose(float(st.ex_l2), float(jst.ex_l2), rtol=1e-12)
    with pytest.raises(ValueError, match="encoding|dense|pair"):
        from_reference({k: np.asarray(getattr(jpa, k)) for k in _PA[:5]},
                       cams, pts)


@pytest.fixture(scope="module")
def prob_mini_bal_j():
    return _problems("mini_bal")[0]


# ------------------------------------------------------ lm_run / tr_run

@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_lm_run_pairs_matches_reference(prob_mini_bal_j, dtype):
    """Six LM iterations on the pair encoding of mini_bal from one perturbed
    state, a budget short of convergence (mini_bal takes 34). float64: the
    reference's XLA path; every history row, the parameters and ex to 1e-9
    (float64 sums in another order). float32: the reference's Pallas
    kernels in interpret mode; the same to 1e-4 (float32 sums in another
    order)."""
    from psba_tpu.solvers.lm import lm_run_jit
    from psba_tpu_torch.solvers.lm import lm_run

    f64 = dtype == "float64"
    jdt, tdt = (jnp.float64, torch.float64) if f64 else (jnp.float32,
                                                         torch.float32)
    p = prob_mini_bal_j
    jpa, tpa = _both(p, jdt)
    cams, pts = _state(p, 8, np.dtype(dtype))
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))
    jcfg = JSolverConfig.for_dtype(jdt, max_iters=6, lm_switch_count=10_000,
                                   record_history=True, damping="additive",
                                   backend="auto" if f64 else "pallas")
    ref = lm_run_jit(jpa, jst, jcfg)
    st = state_from_reference({k: np.asarray(v) for k, v in
                               jst._asdict().items()})
    out = lm_run(tpa, st, SolverConfig.for_dtype(
        tdt, max_iters=6, lm_switch_count=10_000, record_history=True,
        damping="additive"))
    tol = 1e-9 if f64 else 1e-4
    assert out.itno == int(ref.itno) == 6
    assert out.flag == int(ref.flag) == CC.ITER_CONTINUE
    np.testing.assert_array_equal(out.history[:, 0],
                                  np.asarray(ref.history)[:, 0])
    np.testing.assert_allclose(out.history[:, 1:4],
                               np.asarray(ref.history)[:, 1:4], rtol=tol)
    np.testing.assert_allclose(float(out.ex_l2), float(ref.ex_l2), rtol=tol)
    for got, want in ((out.cams, ref.cams), (out.pts, ref.pts),
                      (out.ex, ref.ex)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= tol * np.abs(want).max()


def test_tr_run_pairs_matches_reference(prob_mini_bal_j):
    """Three TR iterations on the pair encoding from one float32 state with
    lambda = 10 > 0 at entry (so the GMW bootstrap, rounding-noise driven
    on a gauge-singular S, stays out; see tests/test_torch_hybrid.py): the
    reference's tr_run (Pallas in interpret mode) against the port's. The
    control columns (itno, lambda, delta) equal; act, rho, p_norm, ex_l2,
    aux, the parameters and the refreshed ex to 1e-4 (float32 sums in
    another order)."""
    from psba_tpu.solvers.tr import tr_run_jit
    from psba_tpu_torch.solvers import tr as ttr

    p = prob_mini_bal_j
    jpa, tpa = _both(p, jnp.float32)
    cams, pts = _state(p, 3, scale=3.0)
    aux = np.array([1.0, 10.0, 10.0, 2.0, 0.0, 0.0], np.float32)
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))._replace(
        aux=jnp.asarray(aux), itno=jnp.int32(2),
        history=jnp.full((5, 6), jnp.nan, jnp.float32))
    ref = tr_run_jit(jpa, jst, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", max_iters=5, record_history=True))
    st = state_from_reference({k: np.asarray(v) for k, v in
                               jst._asdict().items()})
    out = ttr.tr_run(tpa, st, SolverConfig.for_dtype(
        torch.float32, max_iters=5, record_history=True))
    assert out.itno == int(ref.itno) == 5 and out.flag == int(ref.flag)
    h, hr = out.history, np.asarray(ref.history)
    np.testing.assert_array_equal(h[:, [0, 3, 4]], hr[:, [0, 3, 4]])
    np.testing.assert_allclose(h[2:], hr[2:], rtol=1e-4)
    np.testing.assert_allclose(float(out.ex_l2), float(ref.ex_l2), rtol=1e-4)
    np.testing.assert_allclose(out.aux.numpy(), np.asarray(ref.aux),
                               rtol=1e-4)
    assert float(out.ex_l2) < float(jst.ex_l2)
    for got, want in ((out.cams, ref.cams), (out.pts, ref.pts),
                      (out.ex, ref.ex)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= 1e-4 * np.abs(want).max()


# ------------------------------------------------------------------ solve

@pytest.mark.parametrize("name", ["synth", "mini_bal"])
def test_solve_pairs_matches_reference(name):
    """solve(schur="pairs") with the default config against the reference's
    solve(schur="pairs", backend="pallas"), float32, at the gates of the
    dense solve (tests/test_torch_hybrid.py): the phases up to the switch
    to TR and the switch itself, the LM rows before it to 1e-4, final L2 to
    1e-3. The GMW bootstrap at TR entry reads rounding noise, so TR rows,
    and with them the length of the TR phase, part after the first TR step
    (ROADMAP Queue 3)."""
    from psba_tpu.solvers.hybrid import solve as jsolve
    from psba_tpu_torch.solvers.hybrid import solve

    jprob, tprob = _problems(name)
    ref = jsolve(jprob, JSolverConfig.for_dtype(
        jnp.float32, backend="pallas", record_history=True),
        dtype=jnp.float32, schur="pairs")
    res = solve(tprob, SolverConfig.for_dtype(torch.float32,
                                              record_history=True),
                dtype=torch.float32, device="cpu", schur="pairs")
    names = [ph for ph, _, _ in ref.phases]
    k = names.index("tr")
    assert res.phases[:k] == ref.phases[:k]
    assert res.phases[k][0] == "tr"
    tr_start = ref.phases[k - 1][1]
    np.testing.assert_allclose(res.history[:tr_start, 1],
                               ref.history[:tr_start, 1], rtol=1e-4)
    np.testing.assert_allclose(res.final_l2, ref.final_l2, rtol=1e-3)
    assert res.final_l2 < res.initial_l2
    assert res.flag_name in ("DP_NO_CHANGE", "ERR_SMALL_ENOUGH", "CONTINUE")
