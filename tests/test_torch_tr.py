"""Port against reference: the modules of the TR slice, on CPU tensors.

jmultiply, the GMW modified Cholesky, the dogleg step selection, the two
kernels' plain versions (the observation-stream linearization and the dense
J-gram, against linearize_pallas / jgram_dense_pallas in interpret mode) and
tr_run itself, each fed the same numpy inputs made from a seed. Each
tolerance is stated beside its test with its reason.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.core import gmw as jgmw
from psba_tpu.core import jacobian as jjac
from psba_tpu.ops.linearize_pallas import linearize_pallas
from psba_tpu.ops.residual_dense import jgram_dense_pallas
from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
from psba_tpu_torch.convert import from_reference, state_from_reference
from psba_tpu_torch.core import gmw as tgmw
from psba_tpu_torch.core import jacobian as tjac
from psba_tpu_torch.ops import linearize_dense as tld
from psba_tpu_torch.ops import linearize_stream as tls
from psba_tpu_torch.ops import residual_dense as trd
from psba_tpu_torch.solvers import tr as ttr

MINI_BAL = str(Path(__file__).resolve().parent / "data" / "mini_bal.txt")
_PA = ("K", "q0", "obs", "cam_idx", "pt_idx", "obs_du", "obs_dv", "valid_d")


@pytest.fixture(scope="module")
def prob_mini_bal():
    from psba_tpu.io import bal_to_problem

    return bal_to_problem(MINI_BAL)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


def _state(prob, seed, dtype=np.float32, scale=1.0):
    """Cameras and points perturbed from a seed, in `dtype`."""
    rng = np.random.default_rng(seed)
    cams = (prob.cams + scale * np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1)).astype(dtype)
    pts = (prob.pts + scale * 1e-2 * rng.standard_normal(prob.pts.shape)
           ).astype(dtype)
    return cams, pts


def _both(prob, dtype=jnp.float32):
    jpa = JProblemArrays.from_problem(prob.with_blk(), dtype=dtype,
                                      schur="dense")
    tpa, _, _ = from_reference({k: np.asarray(getattr(jpa, k)) for k in _PA},
                               np.asarray(prob.cams, dtype),
                               np.asarray(prob.pts, dtype))
    return jpa, tpa


# ---------------------------------------------------------------- jmultiply

def test_jmultiply_matches_reference_f64(prob_synth):
    """(J x)_o in float64, to 1e-12 relative (the same products in another
    order)."""
    p = prob_synth
    cams, pts = _state(p, 0, np.float64)
    rng = np.random.default_rng(1)
    xc = rng.standard_normal((p.n_cams, 6))
    xp = rng.standard_normal((p.n_pts, 3))
    t = lambda a: torch.from_numpy(np.asarray(a))
    A, B = tjac.jacobians(t(p.K), t(p.q0), t(cams), t(pts), t(p.cam_idx),
                          t(p.pt_idx))
    got = tjac.jmultiply(A, B, t(xc), t(xp), t(p.cam_idx), t(p.pt_idx))
    ref = jjac.jmultiply(jnp.asarray(A.numpy()), jnp.asarray(B.numpy()),
                         jnp.asarray(xc), jnp.asarray(xp),
                         jnp.asarray(p.cam_idx), jnp.asarray(p.pt_idx))
    assert got.shape == (p.n_obs, 2)
    assert _rel(got.numpy(), ref) < 1e-12


# ---------------------------------------------------------------------- GMW

@pytest.mark.parametrize("n", [30, 200])
def test_gmw_matches_reference_f64(n):
    """E of the column and the blocked recurrences and the bootstrapped
    lambda, float64, to 1e-10 relative, on a symmetric indefinite matrix
    (n = 200 > BLOCKED_GMW_MIN_N takes the blocked form in the bootstrap)."""
    rng = np.random.default_rng(n)
    M = rng.standard_normal((n, n))
    A = M + M.T + 0.5 * n ** 0.5 * np.eye(n)
    ta, ja = torch.from_numpy(A), jnp.asarray(A)
    for t, j in zip(tgmw.gmw_delta_beta(ta), jgmw.gmw_delta_beta(ja)):
        np.testing.assert_allclose(float(t), float(j), rtol=1e-12)
    E_col = tgmw.gmw_perturbation(ta).numpy()
    E_blk = tgmw.gmw_perturbation_blocked(ta).numpy()
    assert _rel(E_col, jgmw.gmw_perturbation(ja)) < 1e-10
    assert _rel(E_blk, jgmw.gmw_perturbation_blocked(ja)) < 1e-10
    assert _rel(E_blk, E_col) < 1e-10
    assert (E_col >= 0).all() and E_col.max() > 0
    lam = float(tgmw.gmw_bootstrap_lambda(ta))
    np.testing.assert_allclose(lam, float(jgmw.gmw_bootstrap_lambda(ja)),
                               rtol=1e-10)
    assert (n > tgmw.BLOCKED_GMW_MIN_N) == (n == 200)


# ------------------------------------------------ dogleg step (compute_p_2)

N_C, N_P = 2, 3
DIM = 6 * N_C + 3 * N_P


def _split(v):
    v = torch.from_numpy(np.asarray(v, np.float64))
    return v[:6 * N_C].reshape(N_C, 6), v[6 * N_C:].reshape(N_P, 3)


def _model_step(pu, pb, g, Buu, Bub, Bbb, delta):
    """Independent numpy model of compute_p_2 (the reference's own test
    model, tests/test_tr_branches.py)."""
    eta = np.linalg.solve(np.array([[Buu, Bub], [Bub, Bbb]]),
                          -np.array([pu @ g, pb @ g]))
    p = eta[0] * pu + eta[1] * pb
    if np.linalg.norm(p) <= delta:
        return p, np.linalg.norm(p), "interior"
    if np.linalg.norm(pu) > delta:
        return delta * pu / np.linalg.norm(pu), delta, "scaled_pu"
    if np.linalg.norm(pb) <= delta:
        return pb, np.linalg.norm(pb), "pb"
    d = pb - pu
    a, b, c = d @ d, 2.0 * (pu @ d), pu @ pu - delta * delta
    s = (-b + np.sqrt(b * b - 4 * a * c)) / (2 * a)
    return pu + s * d, delta, "dogleg"


def _step(pu, pb, g, B, delta):
    Buu, Bub, Bbb = pu @ B @ pu, pu @ B @ pb, pb @ B @ pb
    sc = lambda x: torch.tensor(x, dtype=torch.float64)
    out_c, out_p, out_norm = ttr._subspace_step(
        ttr._dot, *_split(pu), *_split(pb), *_split(g), sc(Buu), sc(Bub),
        sc(Bbb), delta)
    got = np.concatenate([out_c.numpy().ravel(), out_p.numpy().ravel()])
    return got, float(out_norm), _model_step(pu, pb, g, Buu, Bub, Bbb, delta)


def _setup(seed):
    rng = np.random.default_rng(seed)
    M = rng.standard_normal((DIM, DIM))
    return rng, M.T @ M + 0.5 * np.eye(DIM), rng.standard_normal(DIM), \
        rng.standard_normal(DIM)


@pytest.mark.parametrize("branch", ["interior", "scaled_pu", "pb", "dogleg"])
def test_subspace_step_branches(branch):
    """Each branch of the step selection, float64, against the numpy model
    to 1e-10 (the reference's own gate for the same cases)."""
    rng, B, pu, pb = _setup({"interior": 1, "scaled_pu": 2, "pb": 3,
                             "dogleg": 4}[branch])
    if branch == "interior":
        g, delta = rng.standard_normal(DIM), 1e9
    elif branch == "scaled_pu":
        g, delta = -B @ (5.0 * pu + 5.0 * pb), 0.5 * np.linalg.norm(pu)
    elif branch == "pb":
        pu, pb = 0.4 * pu / np.linalg.norm(pu), 0.7 * pb / np.linalg.norm(pb)
        g, delta = -B @ (40.0 * pu + 40.0 * pb), 1.0
    else:
        pu, pb = 0.6 * pu / np.linalg.norm(pu), 3.0 * pb / np.linalg.norm(pb)
        g, delta = -B @ (30.0 * pu + 30.0 * pb), 1.0
    got, norm, (ref_p, ref_norm, hit) = _step(pu, pb, g, B, delta)
    assert hit == branch, f"case engineering broke: hit {hit}"
    np.testing.assert_allclose(got, ref_p, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(norm, ref_norm, rtol=1e-10)


def test_subspace_step_sweep():
    """Random draws over all branches agree with the numpy model (1e-8,
    as the reference's sweep)."""
    rng = np.random.default_rng(7)
    hits = set()
    for k in range(40):
        M = rng.standard_normal((DIM, DIM))
        B = M.T @ M + 0.1 * np.eye(DIM)
        pu = rng.standard_normal(DIM) * rng.uniform(0.1, 2.0)
        pb = rng.standard_normal(DIM) * rng.uniform(0.1, 2.0)
        amp = rng.uniform(0.02, 8.0)
        g = -B @ (amp * rng.uniform(0.5, 1.0) * pu
                  + amp * rng.uniform(0.5, 1.0) * pb)
        got, _norm, (ref_p, _rn, hit) = _step(pu, pb, g, B,
                                              rng.uniform(0.3, 3.0))
        hits.add(hit)
        np.testing.assert_allclose(got, ref_p, rtol=1e-8, atol=1e-10,
                                   err_msg=f"draw {k} branch {hit}")
    assert {"interior", "scaled_pu", "dogleg"} <= hits


# ------------------------------------------ kernel 5: observation stream

@pytest.mark.parametrize("flags", ["tr", "all", "all_valid"])
def test_linearize_stream_matches_pallas(prob_synth, flags):
    """linearize_stream (plain on the CPU) against linearize_pallas in
    float32, at the reference's own gates (tests/test_pallas.py): ex to
    1e-4 (residuals of O(px) against O(1e3) projections), A / B / W / V / U
    to 1e-5, ga / gb to 1e-3 (residual-weighted sums of both signs), l2 to
    1e-5; with a valid mask, U to 2e-6 of its largest entry."""
    p = prob_synth
    f32 = np.float32
    cams, pts = _state(p, 7)
    obs = p.obs.astype(f32)
    valid = None
    kw = (dict(want_point=False, want_w=False) if flags == "tr"
          else dict(want_jac=True))
    if flags == "all_valid":
        valid = np.arange(p.n_obs) < p.n_obs - 7
    ref = linearize_pallas(
        jnp.asarray(p.K, f32), jnp.asarray(p.q0, f32), jnp.asarray(cams),
        jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(p.cam_idx),
        jnp.asarray(p.pt_idx), None if valid is None else jnp.asarray(valid),
        p.n_cams, p.n_pts, **kw)
    t = lambda a: torch.from_numpy(np.asarray(a))
    tables = tls.build_stream_tables(p.cam_idx, p.pt_idx, p.n_cams, p.n_pts)
    got = tls.linearize_stream(
        t(p.K.astype(f32)), t(p.q0.astype(f32)), t(cams), t(pts), t(obs),
        t(p.cam_idx).long(), t(p.pt_idx).long(),
        None if valid is None else t(valid), p.n_cams, p.n_pts,
        tables=tables, **kw)
    names = ("ex", "l2", "U", "V", "W", "ga", "gb", "A", "B")
    tols = dict(ex=1e-4, U=1e-5, V=1e-5, W=1e-5, ga=1e-3, gb=1e-3, A=1e-5,
                B=1e-5)
    for name, g, r in zip(names, got, ref):
        assert (g is None) == (r is None), name
        if g is None:
            continue
        assert tuple(g.shape) == tuple(r.shape), name
        if name == "l2":
            np.testing.assert_allclose(float(g), float(r), rtol=1e-5)
        elif name == "U" and valid is not None:
            err = np.max(np.abs(g.numpy() - np.asarray(r)))
            assert err <= 2e-6 * np.max(np.abs(np.asarray(r))), err
        else:
            assert _rel(g.numpy(), r) < tols[name], name
    if flags == "tr":
        assert got[3] is None and got[4] is None and got[7] is None


def test_stream_tables_walk_every_observation(prob_mini_bal):
    """The camera-sorted walk covers each observation once, each block holds
    one camera's run of at most CHUNK, and the slots of a camera are
    0..n-1 (so the partial sums have a fixed order)."""
    p = prob_mini_bal
    st = tls.build_stream_tables(p.cam_idx, p.pt_idx, p.n_cams, p.n_pts)
    perm, chunks = st.perm.numpy(), st.chunks.numpy()
    np.testing.assert_array_equal(np.sort(perm), np.arange(p.n_obs))
    np.testing.assert_array_equal(st.pt_of.numpy(), p.pt_idx[perm])
    assert np.all(np.diff(p.cam_idx[perm]) >= 0)
    assert chunks[:, 2].sum() == p.n_obs
    assert (chunks[:, 2] >= 1).all() and (chunks[:, 2] <= tls.CHUNK).all()
    for cam, first, count, slot in chunks:
        assert (p.cam_idx[perm[first:first + count]] == cam).all()
        assert slot < st.max_chunks
    # a camera with more observations than one block takes several slots
    small = tls.build_stream_tables(np.repeat([0, 1], [5, 2 * tls.CHUNK + 1]),
                                    np.arange(2 * tls.CHUNK + 6), 2,
                                    2 * tls.CHUNK + 6)
    assert small.max_chunks == 3
    np.testing.assert_array_equal(small.chunks.numpy()[:, 3], [0, 0, 1, 2])


# ----------------------------------------------------- kernel 4: J-gram

@pytest.mark.parametrize("n", [1, 2, 3])
def test_jgram_dense_matches_pallas(prob_synth, n):
    """jgram_dense (plain on the CPU) against jgram_dense_pallas, float32,
    to 1e-4 of the largest entry (the reference's gate,
    tests/test_pallas.py), with garbage in the padded point lanes, which
    must contribute exactly nothing."""
    p = prob_synth
    jpa, tpa = _both(p)
    cams, pts = _state(p, n)
    C, P = p.n_cams, p.n_pts
    Pp = tld.padded_points(P)
    rng = np.random.default_rng(10 + n)
    dc = rng.standard_normal((n, C, 6)).astype(np.float32)
    dp = rng.standard_normal((n, 3, Pp)).astype(np.float32)
    ref = jgram_dense_pallas(jpa.K, jpa.q0, jnp.asarray(cams),
                             jnp.asarray(pts), jpa.valid_d, jnp.asarray(dc),
                             jnp.asarray(dp))
    t = torch.from_numpy
    args = (tpa.K, tpa.q0, t(cams), t(pts), tpa.valid_d, t(dc))
    G = trd.jgram_dense(*args, t(dp))
    assert G.shape == (n, n) and torch.equal(G, G.T)
    assert _rel(G.numpy(), ref) < 1e-4
    dp0 = dp.copy()
    dp0[:, :, P:] = 0.0
    assert torch.equal(trd.jgram_dense(*args, t(dp0)), G)
    assert torch.equal(trd.jgram_dense(*args, t(dp0[:, :, :P].copy())), G)


def test_jgram_dense_is_the_jmultiply_gram(prob_mini_bal):
    """In float64 the plain J-gram is the Gram matrix of explicit J x
    products over the observations, to 1e-10 (the same sum of products of
    per-row terms, in another order)."""
    p = prob_mini_bal
    _jpa, tpa = _both(p, jnp.float64)
    cams, pts = (torch.from_numpy(a) for a in _state(p, 4, np.float64))
    rng = np.random.default_rng(5)
    dc = torch.from_numpy(rng.standard_normal((3, p.n_cams, 6)))
    dpn = torch.from_numpy(rng.standard_normal((3, p.n_pts, 3)))
    G = trd.jgram_dense(tpa.K, tpa.q0, cams, pts, tpa.valid_d, dc,
                        dpn.transpose(1, 2).contiguous())
    A, B = tjac.jacobians(tpa.K, tpa.q0, cams, pts, tpa.cam_idx, tpa.pt_idx)
    jx = [tjac.jmultiply(A, B, dc[a], dpn[a], tpa.cam_idx, tpa.pt_idx)
          for a in range(3)]
    ref = torch.stack([torch.stack([(jx[a] * jx[b]).sum() for b in range(3)])
                       for a in range(3)])
    assert _rel(G.numpy(), ref.numpy()) < 1e-10


# ------------------------------------------------------------------- tr_run

@pytest.mark.parametrize("fixture,scale,rtol", [
    ("prob_mini_bal", 3.0, 1e-4), ("prob_synth", 30.0, 2e-3)])
def test_tr_run_matches_reference(fixture, scale, rtol, request):
    """Three TR iterations from one float32 state carried over with
    convert: the reference's tr_run (dense3, Pallas in interpret mode)
    against the port's. lambda = 10 > 0 at entry, so the Cholesky succeeds
    at once and the GMW bootstrap (rounding-noise driven on a gauge-singular
    S, see tests/test_torch_hybrid.py) stays out. The control columns of
    the history (itno, lambda, delta) must be equal; act, rho, p_norm,
    ex_l2 and the aux vector agree to `rtol`, the parameters to `rtol` of
    their scale. mini_bal: 1e-4, float32 sums in another order. The
    synthetic problem is started 30x further out so that all three steps
    make progress (at the optimum rho is a ratio of rounding errors); its
    third step takes L2 from 1.2e6 to 1.8e3, which magnifies the steps'
    float32 rounding a thousandfold in act, hence 2e-3."""
    from psba_tpu.solvers import SolverConfig as JSolverConfig
    from psba_tpu.solvers.tr import tr_run_jit
    from psba_tpu.solvers.types import OptState as JOptState
    from psba_tpu_torch.solvers import SolverConfig

    p = request.getfixturevalue(fixture)
    jpa, tpa = _both(p)
    cams, pts = _state(p, 3, scale=scale)
    aux = np.array([1.0, 10.0, 10.0, 2.0, 0.0, 0.0], np.float32)
    jst = JOptState.init(jpa, jnp.asarray(cams), jnp.asarray(pts))._replace(
        aux=jnp.asarray(aux), itno=jnp.int32(2),
        history=jnp.full((5, 6), jnp.nan, jnp.float32))
    jcfg = JSolverConfig.for_dtype(jnp.float32, backend="pallas",
                                   max_iters=5, record_history=True)
    ref = tr_run_jit(jpa, jst, jcfg)

    st = state_from_reference({k: np.asarray(v) for k, v in
                               jst._asdict().items()})
    assert st.itno == 2 and st.aux is not None
    np.testing.assert_array_equal(st.cams.numpy(), cams)
    out = ttr.tr_run(tpa, st, SolverConfig.for_dtype(
        torch.float32, max_iters=5, record_history=True))

    assert out.itno == int(ref.itno) == 5 and out.flag == int(ref.flag)
    h, hr = out.history, np.asarray(ref.history)
    assert np.isnan(h[:2]).all() and not np.isnan(h[2:]).any()
    np.testing.assert_array_equal(h[:, [0, 3, 4]], hr[:, [0, 3, 4]])
    np.testing.assert_allclose(h[2:], hr[2:], rtol=rtol)
    np.testing.assert_allclose(float(out.ex_l2), float(ref.ex_l2), rtol=rtol)
    np.testing.assert_allclose(out.aux.numpy(), np.asarray(ref.aux),
                               rtol=rtol)
    for got, want in ((out.cams, ref.cams), (out.pts, ref.pts)):
        want = np.asarray(want)
        assert np.max(np.abs(got.numpy() - want)) <= rtol * np.abs(want).max()
