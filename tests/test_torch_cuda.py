"""The port's CUDA kernels against their plain PyTorch versions.

These need an NVIDIA GPU with nvcc (sm_90a): each test is marked `gpu` and
skips, with its reason, where torch sees no CUDA device. Run them on the
card with

    python -m pytest tests/test_torch_cuda.py -q --noconftest

(--noconftest: tests/conftest.py sets up JAX, which these tests do not use
and a GPU machine may not have.)

Inputs are made with numpy from a seed and are small; tolerances are the
float32 ones chip_smoke.py states at the main path's shapes.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max().clamp_min(1e-30))


def _problem(cuda, seed=0):
    from psba_tpu_torch.io import synthetic_problem
    from psba_tpu_torch.solvers import ProblemArrays

    prob = synthetic_problem(n_cams=13, n_pts=700, seed=seed)
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(seed)
    cams = torch.as_tensor(prob.cams + np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1),
        dtype=torch.float32, device=cuda)
    pts = torch.as_tensor(prob.pts, dtype=torch.float32, device=cuda)
    return prob, pa, cams, pts


def test_linearize_dense_kernel_matches_plain(cuda):
    from psba_tpu_torch.ops import linearize_dense as ld

    prob, pa, cams, pts = _problem(cuda)
    args = (pa.K, pa.q0, cams, pts, pa.obs_du, pa.obs_dv, pa.valid_d)
    before = ld.linearize_dense.launches
    out = ld.linearize_dense(*args, want_u=True)
    torch.cuda.synchronize()
    assert ld.linearize_dense.launches == before + 1
    ref = ld.linearize_dense_plain(*args, want_u=True)
    for i, tol in ((0, 1e-5), (1, 1e-5), (2, 1e-5), (3, 1e-5), (4, 1e-3),
                   (6, 1e-5), (7, 1e-3)):
        assert _rel(out[i], ref[i]) < tol, i
    P = prob.n_pts
    assert bool((out[0][:, P:] == 0).all()) and bool((out[4][:, P:] == 0).all())
    eye = torch.eye(3, device=cuda)[:, :, None]
    assert bool((out[3][:, :, P:] == eye).all())
    six = ld.linearize_dense(*args)
    assert len(six) == 6 and _rel(six[0], out[0]) == 0.0


def test_gain_dense_kernel_matches_plain(cuda):
    from psba_tpu_torch.ops import residual_dense as rd

    _prob, pa, cams, pts = _problem(cuda, seed=1)
    g = torch.Generator(device="cpu").manual_seed(1)
    new_cams = cams + 1e-4 * torch.randn(cams.shape, generator=g).to(cuda)
    new_pts = pts + 1e-3 * torch.randn(pts.shape, generator=g).to(cuda)
    args = (pa.K, pa.q0, cams, pts, new_cams, new_pts, pa.obs_du, pa.obs_dv,
            pa.valid_d)
    gain, l2 = rd.gain_dense(*args)
    gain_p, l2_p = rd.gain_dense_plain(*args)
    assert _rel(gain, gain_p) < 1e-3
    assert _rel(l2, l2_p) < 1e-4


def _dense_inputs(cuda, C, n_pts, seed):
    """linearize_dense arguments for the first C cameras of a synthetic ring
    of max(C, 2) cameras (perturbed from a seed) over its P points, with P
    not a multiple of the 128-point tile."""
    from psba_tpu_torch.io import synthetic_problem
    from psba_tpu_torch.solvers import ProblemArrays

    prob = synthetic_problem(n_cams=max(C, 2), n_pts=n_pts, seed=seed)
    assert prob.n_pts % 128 != 0
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(seed)
    cams = prob.cams[:C] + np.concatenate(
        [1e-3 * rng.standard_normal((C, 3)),
         1e-2 * rng.standard_normal((C, 3))], axis=1)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    return (pa.K[:C].contiguous(), pa.q0[:C].contiguous(), f(cams),
            f(prob.pts), pa.obs_du[:C].contiguous(),
            pa.obs_dv[:C].contiguous(), pa.valid_d[:C].contiguous())


# C = 1, 9 (a ragged camera chunk of 1) and 138 cameras over a few hundred
# points, and 9 cameras over ~60k points (some 470 point tiles, so the
# in-launch sums run over many tiles)
_RAGGED = [(1, 333), (9, 333), (138, 333), (9, 60_000)]


@pytest.mark.parametrize("want_u", [True, False])
@pytest.mark.parametrize("C, n_pts", _RAGGED)
def test_linearize_dense_epilogue_matches_plain(cuda, C, n_pts, want_u):
    """The in-launch V / gb and U / ga sums: final outputs within the
    tolerances chip_smoke.py states (ZW 1e-5, Vp and U 1e-4, gbp and ga
    1e-3), ZW = 0, gb = 0 and V = I in the padded lanes, U symmetric, one
    launch per call, and two calls bit-identical."""
    from psba_tpu_torch.ops import linearize_dense as ld

    args = _dense_inputs(cuda, C, n_pts, seed=6)
    P = args[3].shape[0]
    before = ld.linearize_dense.launches
    out = ld.linearize_dense(*args, want_u=want_u)
    again = ld.linearize_dense(*args, want_u=want_u)
    torch.cuda.synchronize()
    assert ld.linearize_dense.launches == before + 2
    ref = ld.linearize_dense_plain(*args, want_u=want_u)
    assert len(out) == len(ref) == (8 if want_u else 6)
    tols = {0: 1e-5, 1: 1e-5, 2: 1e-5, 3: 1e-4, 4: 1e-3, 6: 1e-4, 7: 1e-3}
    for i, tol in tols.items():
        if i < len(out):
            assert out[i].shape == ref[i].shape, i
            assert _rel(out[i], ref[i]) < tol, i
            assert bool((again[i] == out[i]).all()), i
    Pp = out[5]
    assert Pp == ref[5] and Pp % 128 == 0 and Pp > P
    for i in (0, 1, 2, 4):
        assert bool((out[i][:, P:] == 0).all()), i
    eye = torch.eye(3, device=cuda)[:, :, None]
    assert bool((out[3][:, :, P:] == eye).all())
    if want_u:
        assert bool((out[6] == out[6].transpose(1, 2)).all())


@pytest.mark.parametrize("C, n_pts", _RAGGED)
def test_gain_dense_one_launch_matches_plain(cuda, C, n_pts):
    """The persistent grid with the in-launch sum: (gain, new_l2) within
    1e-3 / 1e-4 of the plain version, one launch per call, and two calls
    bit-identical."""
    from psba_tpu_torch.ops import residual_dense as rd

    K, q0, cams, pts, du, dv, vd = _dense_inputs(cuda, C, n_pts, seed=7)
    rng = np.random.default_rng(7)
    new_cams = cams + torch.as_tensor(1e-4 * rng.standard_normal(cams.shape),
                                      dtype=torch.float32, device=cuda)
    new_pts = pts + torch.as_tensor(1e-3 * rng.standard_normal(pts.shape),
                                    dtype=torch.float32, device=cuda)
    args = (K, q0, cams, pts, new_cams, new_pts, du, dv, vd)
    before = rd.gain_dense.launches
    one = rd.gain_dense(*args)
    two = rd.gain_dense(*args)
    torch.cuda.synchronize()
    assert rd.gain_dense.launches == before + 2
    gain_p, l2_p = rd.gain_dense_plain(*args)
    assert one[0].shape == () and one[1].shape == ()
    assert _rel(one[0], gain_p) < 1e-3 and _rel(one[1], l2_p) < 1e-4
    assert bool(one[0] == two[0]) and bool(one[1] == two[1])


def test_damping_probe_on_cuda_is_fixed_order(cuda):
    """Two damping probes on the card give the same bits (the sums per
    camera and per point run in a fixed order), within 1e-5 of the CPU's."""
    from psba_tpu_torch.solvers.types import _diag_minmax

    _prob, pa, cams, pts = _problem(cuda, seed=8)
    args = (pa.K, pa.q0, cams, pts, pa.cam_idx, pa.pt_idx, False)
    one = _diag_minmax(*args)
    two = _diag_minmax(*args)
    cpu = _diag_minmax(*(a.cpu() if torch.is_tensor(a) else a for a in args))
    for a, b, c in zip(one, two, cpu):
        assert bool(a == b)
        assert _rel(a.cpu(), c) < 1e-5


@pytest.mark.parametrize("n", [1, 6, 31, 32, 33, 126, 127, 128, 129, 130,
                               500, 828, 1023, 1024])
def test_spd_solve_kernel_matches_plain(cuda, n):
    from psba_tpu_torch.ops import cholesky as chol

    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    S = torch.as_tensor(A @ A.T + n * np.eye(n), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=cuda)
    x, ok = chol.spd_solve(S, b)
    x_p, ok_p = chol.spd_solve_plain(S, b)
    assert bool(ok) and bool(ok_p)
    assert _rel(x, x_p) < 5e-5


def test_spd_solve_kernel_flags_indefinite(cuda):
    from psba_tpu_torch.ops import cholesky as chol

    S = torch.eye(200, device=cuda)
    S[77, 77] = -1.0
    x, ok = chol.spd_solve(S, torch.ones(200, device=cuda))
    assert not bool(ok) and bool((x == 0).all())
    S[77, 77] = float("nan")
    x, ok = chol.spd_solve(S, torch.ones(200, device=cuda))
    assert not bool(ok) and bool((x == 0).all())


@pytest.mark.parametrize("where", ["first", "middle", "last"])
@pytest.mark.parametrize("bad", [-1.0, float("nan")])
def test_spd_solve_kernel_flags_bad_pivot_in_any_panel(cuda, where, bad):
    """A pivot that is <= 0 or NaN in the first, a middle or the last
    32-column panel clears ok and zeroes x (n = 828: 26 panels, the last
    one 28 wide)."""
    from psba_tpu_torch.ops import cholesky as chol

    n = 828
    i = dict(first=3, middle=13 * 32 + 7, last=n - 2)[where]
    rng = np.random.default_rng(i)
    A = rng.standard_normal((n, n))
    S = A @ A.T + n * np.eye(n)
    S[i, i] = bad
    S = torch.as_tensor(S, dtype=torch.float32, device=cuda)
    x, ok = chol.spd_solve(S, torch.ones(n, device=cuda))
    assert ok.shape == () and ok.dtype == torch.bool
    assert not bool(ok) and bool((x == 0).all())


@pytest.mark.parametrize("n", [126, 828])
def test_spd_solve_kernel_any_cluster_size(cuda, n):
    """Every cluster size the device schedules gives the same solution
    within the float32 tolerance."""
    from psba_tpu_torch.ops import cholesky as chol

    rng = np.random.default_rng(n)
    A = rng.standard_normal((n, n))
    S = torch.as_tensor(A @ A.T + n * np.eye(n), dtype=torch.float32,
                        device=cuda)
    b = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32,
                        device=cuda)
    x_p, _ = chol.spd_solve_plain(S, b)
    max_cluster = chol.max_cluster()
    cs = 1
    while cs <= max_cluster:
        x, ok = chol._launch(S, b, cs)
        assert bool(ok) and _rel(x, x_p) < 5e-5, cs
        cs *= 2


@pytest.mark.parametrize("width", [36, 6, 3])
def test_indexed_sum_on_cuda_is_fixed_order(cuda, width):
    """The bucket sum on the card: within float32 rounding of the CPU's,
    out-of-range buckets dropped, and the same bits on two calls (widths of
    S's 6x6 blocks, ea and eb; many terms per bucket)."""
    from psba_tpu_torch.ops.reduce import indexed_sum

    rng = np.random.default_rng(width)
    n_seg, n = 50, 200_000
    idx = rng.integers(-1, n_seg + 2, n)
    data = rng.standard_normal((n, width)).astype(np.float32)
    ref = indexed_sum(torch.as_tensor(data), torch.as_tensor(idx), n_seg)
    d, i = torch.as_tensor(data, device=cuda), torch.as_tensor(idx,
                                                               device=cuda)
    got = indexed_sum(d, i, n_seg)
    assert got.shape == (n_seg, width)
    assert _rel(got.cpu(), ref) < 1e-5
    assert bool((indexed_sum(d, i, n_seg) == got).all())


def test_wrappers_refuse_float64_on_cuda(cuda):
    from psba_tpu_torch.ops import cholesky as chol

    with pytest.raises(TypeError):
        chol.spd_solve(torch.eye(6, dtype=torch.float64, device=cuda),
                       torch.ones(6, dtype=torch.float64, device=cuda))


def test_solve_on_cuda_matches_cpu(cuda):
    import psba_tpu_torch
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.solvers import SolverConfig

    prob = bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))
    cfg = SolverConfig.for_dtype(torch.float32, lm_switch_count=10_000,
                                 max_iters=20, record_history=True)
    r_gpu = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32, device=cuda)
    r_cpu = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32,
                                 device="cpu")
    assert r_gpu.flag == r_cpu.flag and r_gpu.iterations == r_cpu.iterations
    np.testing.assert_allclose(r_gpu.final_l2, r_cpu.final_l2, rtol=1e-3)
    np.testing.assert_allclose(r_gpu.history[:5, 1], r_cpu.history[:5, 1],
                               rtol=1e-4)


@pytest.mark.parametrize("flags", ["tr", "all"])
def test_linearize_stream_kernel_matches_plain(cuda, flags):
    from psba_tpu_torch.ops import linearize_stream as ls

    prob, pa, cams, pts = _problem(cuda, seed=2)
    O = prob.n_obs
    kw = (dict(want_point=False, want_w=False) if flags == "tr"
          else dict(want_jac=True))
    valid = None
    if flags == "all":
        valid = (torch.arange(O, device=cuda) < O - 7).to(torch.float32)
    args = (pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx, pa.pt_idx, valid,
            prob.n_cams, prob.n_pts)
    before = ls.linearize_stream.launches
    out = ls.linearize_stream(*args, tables=pa.stream, **kw)
    torch.cuda.synchronize()
    assert ls.linearize_stream.launches == before + 1
    ref = ls.linearize_stream_plain(*args, **kw)
    names = ("ex", "l2", "U", "V", "W", "ga", "gb", "A", "B")
    # per-observation Jacobian values to 1e-5; ex = obs - proj with proj ~
    # 1e3 px rounding at ~6e-5 px, 1e-4 of max |ex|; sums over many terms
    # in another order to 1e-4; the residual-weighted gradients (both
    # signs) to 1e-3
    tols = dict(ex=1e-4, l2=1e-4, U=1e-4, V=1e-4, W=1e-5, ga=1e-3, gb=1e-3,
                A=1e-5, B=1e-5)
    for name, a, b in zip(names, out, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(a, b) < tols[name], name
    if flags == "tr":
        assert out[3] is None and out[4] is None and out[7] is None


def _long_point_stream(cuda):
    """The 13-camera problem with point 5's observations repeated (with
    noise) to 2 RUN + 41 of them, so the point pass cuts it into three
    pieces; re-sorted by point. Returns the linearize_stream arguments on
    `cuda` and the stream tables."""
    from psba_tpu_torch.io import synthetic_problem
    from psba_tpu_torch.ops import linearize_stream as ls

    prob = synthetic_problem(n_cams=13, n_pts=700, seed=5)
    rng = np.random.default_rng(5)
    mine = np.nonzero(prob.pt_idx == 5)[0]
    extra = rng.choice(mine, 2 * ls.RUN + 41 - len(mine))
    cam = np.concatenate([prob.cam_idx, prob.cam_idx[extra]])
    pt = np.concatenate([prob.pt_idx, prob.pt_idx[extra]])
    obs = np.concatenate([prob.obs, prob.obs[extra]
                          + rng.standard_normal((len(extra), 2))])
    order = np.argsort(pt, kind="stable")
    cam, pt, obs = cam[order], pt[order], obs[order]
    tables = ls.build_stream_tables(cam, pt, prob.n_cams, prob.n_pts,
                                    device=cuda)
    assert tables.n_pieces == 3
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    cams = prob.cams + np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1)
    args = (f(prob.K), f(prob.q0), f(cams), f(prob.pts), f(obs),
            torch.as_tensor(cam, device=cuda), torch.as_tensor(pt, device=cuda))
    return args, prob.n_cams, prob.n_pts, tables


@pytest.mark.parametrize("flags", ["pairs_lm", "pairs_tr"])
def test_linearize_stream_long_point_matches_plain(cuda, flags):
    """The pair path's flags on a problem with a point longer than one run
    of the point pass, against the plain version at the tolerances of
    test_linearize_stream_kernel_matches_plain, with a mask."""
    from psba_tpu_torch.ops import linearize_stream as ls

    args, C, P, tables = _long_point_stream(cuda)
    O = args[4].shape[0]
    valid = (torch.arange(O, device=cuda) < O - 7).to(torch.float32)
    kw = dict(want_jac=flags == "pairs_tr")
    out = ls.linearize_stream(*args, valid, C, P, tables=tables, **kw)
    ref = ls.linearize_stream_plain(*args, valid, C, P, **kw)
    names = ("ex", "l2", "U", "V", "W", "ga", "gb", "A", "B")
    tols = dict(ex=1e-4, l2=1e-4, U=1e-4, V=1e-4, W=1e-5, ga=1e-3, gb=1e-3,
                A=1e-5, B=1e-5)
    for name, a, b in zip(names, out, ref):
        assert (a is None) == (b is None), name
        if a is not None:
            assert _rel(a, b) < tols[name], name
    assert (out[7] is None) == (flags == "pairs_lm")


def test_linearize_stream_sums_are_deterministic(cuda):
    """Two calls give bit-identical V, gb, U and ga: no sum depends on the
    order in which blocks run."""
    from psba_tpu_torch.ops import linearize_stream as ls

    args, C, P, tables = _long_point_stream(cuda)
    one = ls.linearize_stream(*args, None, C, P, tables=tables, want_jac=True)
    two = ls.linearize_stream(*args, None, C, P, tables=tables, want_jac=True)
    for i in (2, 3, 5, 6):   # U, V, ga, gb
        assert bool((one[i] == two[i]).all()), i


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_jgram_dense_kernel_matches_plain(cuda, n):
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import residual_dense as rd

    prob, pa, cams, pts = _problem(cuda, seed=3)
    C, P = prob.n_cams, prob.n_pts
    Pp = ld.padded_points(P)
    rng = np.random.default_rng(n)
    dirs_c = torch.as_tensor(rng.standard_normal((n, C, 6)),
                             dtype=torch.float32, device=cuda)
    dp = rng.standard_normal((n, 3, Pp))
    dirs_p = torch.as_tensor(dp, dtype=torch.float32, device=cuda)
    args = (pa.K, pa.q0, cams, pts, pa.valid_d, dirs_c)
    G = rd.jgram_dense(*args, dirs_p)
    ref = rd.jgram_dense_plain(*args, dirs_p)
    assert G.shape == (n, n) and bool((G == G.T).all())
    assert _rel(G, ref) < 1e-4
    # padded lanes contribute nothing: same result with them zeroed
    dp[:, :, P:] = 0.0
    G0 = rd.jgram_dense(*args, torch.as_tensor(dp, dtype=torch.float32,
                                               device=cuda))
    assert bool((G0 == G).all())


@pytest.mark.parametrize("n", [1, 2, 3, 4])
@pytest.mark.parametrize("C", [1, 9, 138])
def test_jgram_dense_one_launch_matches_plain(cuda, C, n):
    """The persistent grid with the in-launch sum, over C cameras (a ragged
    camera chunk at 1 and 9) and P not a multiple of the 128-point tile:
    G within 1e-4 of max |G| of the plain version, symmetric, one launch per
    call, two calls bit-identical; garbage in the padded point lanes counts
    for nothing; the sequence form (row-major [P, 3] parts and transposed
    planar views) gives the stacked form's bits; a grid with no observed
    cell gives exactly 0."""
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import residual_dense as rd

    K, q0, cams, pts, _du, _dv, vd = _dense_inputs(cuda, C, 333, seed=8)
    P = pts.shape[0]
    rng = np.random.default_rng(40 + n)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    dc = f(rng.standard_normal((n, C, 6)))
    dp = f(rng.standard_normal((n, 3, ld.padded_points(P))))
    args = (K, q0, cams, pts, vd)
    before = rd.jgram_dense.launches
    G = rd.jgram_dense(*args, dc, dp)
    again = rd.jgram_dense(*args, dc, dp)
    torch.cuda.synchronize()
    assert rd.jgram_dense.launches == before + 2
    ref = rd.jgram_dense_plain(*args, dc, dp)
    assert G.shape == (n, n) and bool((G == G.T).all())
    assert _rel(G, ref) < 1e-4
    assert bool((again == G).all())
    dp0 = dp.clone()
    dp0[:, :, P:] = 0.0
    assert bool((rd.jgram_dense(*args, dc, dp0) == G).all())
    for parts in ([dp[a, :, :P].T for a in range(n)],
                  [dp[a, :, :P].T.contiguous() for a in range(n)]):
        seq = rd.jgram_dense(*args, list(dc.unbind()), parts)
        assert bool((seq == G).all())
    none = rd.jgram_dense(K, q0, cams, pts, torch.zeros_like(vd), dc, dp)
    assert bool((none == 0).all())


def _residual_inputs(cuda, C, O, seed):
    """residual_l2 arguments over C cameras, each a copy (perturbed from a
    seed) of one of the 13-camera synthetic ring's, and O observations
    drawn from the ring's observations in their point order, each moved to
    a random copy of its camera (so every projection is a real one)."""
    from psba_tpu_torch.io import synthetic_problem

    prob = synthetic_problem(n_cams=13, n_pts=700, seed=seed)
    rng = np.random.default_rng(seed)
    base = np.arange(C) % 13
    cams = prob.cams[base] + np.concatenate(
        [1e-3 * rng.standard_normal((C, 3)),
         1e-2 * rng.standard_normal((C, 3))], axis=1)
    pool = np.nonzero(prob.cam_idx < C)[0]
    pick = np.sort(rng.choice(pool, O))
    c = prob.cam_idx[pick]
    cam = c + 13 * rng.integers(0, (C - 1 - c) // 13 + 1)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    i = lambda a: torch.as_tensor(a, dtype=torch.int32, device=cuda)
    return (f(prob.K[base]), f(prob.q0[base]), f(cams), f(prob.pts),
            f(prob.obs[pick]), i(cam), i(prob.pt_idx[pick]))


# O = 1, under one block's share of 1,024, not a multiple of it; one
# camera; and more cameras than a block's shared-memory table holds
_RESIDUAL = [(13, 1), (13, 700), (13, 5_003), (1, 300), (5_000, 20_000)]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("C, O", _RESIDUAL)
def test_residual_l2_fused_gain_matches_plain(cuda, C, O, masked):
    """One launch per call, with and without ex_old: ex within 1e-4 of max
    |ex| and l2 within 1e-5 of the plain version (as chip_smoke.py), the
    gain within 1e-5 of sum |eo|^2 of error_l2_diff on the same CUDA
    tensors, ex and l2 the same bits with and without ex_old, and two
    calls bit-identical."""
    from psba_tpu_torch.core.residual import error_l2_diff
    from psba_tpu_torch.ops import linearize_stream as ls

    args = _residual_inputs(cuda, C, O, seed=9)
    if C == 5_000:
        assert C > ls._residual_kernel()[1], "C must exceed the table"
    valid = None
    if masked:
        valid = (torch.arange(O, device=cuda) < O - O // 3).to(torch.float32)
    g = torch.Generator(device="cpu").manual_seed(C + O)
    ex_old = (ls.residual_l2_plain(*args)[0]
              + torch.randn((O, 2), generator=g).to(cuda))
    before = ls.residual_l2.launches
    ex, l2 = ls.residual_l2(*args, valid)
    ex1, l2_1, gain1 = ls.residual_l2(*args, valid, ex_old=ex_old)
    ex2, l2_2, gain2 = ls.residual_l2(*args, valid, ex_old=ex_old)
    torch.cuda.synchronize()
    assert ls.residual_l2.launches == before + 3
    ex_p, l2_p = ls.residual_l2_plain(*args, valid)
    assert ex.shape == (O, 2) and l2.shape == () and gain1.shape == ()
    assert _rel(ex, ex_p) < 1e-4 and _rel(l2, l2_p) < 1e-5
    ref = error_l2_diff(ex_old, ex1, None if valid is None else valid > 0)
    eo2 = float((ex_old.double() ** 2).sum())
    assert abs(float(gain1) - float(ref)) <= 1e-5 * eo2
    for a, b in ((ex1, ex), (l2_1, l2), (ex2, ex1), (l2_2, l2_1),
                 (gain2, gain1)):
        assert bool((a == b).all())


def test_default_solve_on_cuda_matches_cpu(cuda):
    """The default config (LM -> TR) on the card against the CPU, with no
    device named for the card. 15 iterations: LM to 14, then one TR step.
    TR starts from a GMW-bootstrapped lambda that float32 rounding decides
    (S is singular along the gauge at lambda = 0), so the devices' TR
    trajectories part after that first step."""
    import psba_tpu_torch
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.solvers import SolverConfig

    prob = bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))
    cfg = SolverConfig.for_dtype(torch.float32, max_iters=15,
                                 record_history=True)
    r_gpu = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32)
    r_cpu = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32,
                                 device="cpu")
    assert any(ph == "tr" for ph, _, _ in r_gpu.phases)
    assert [p[0] for p in r_gpu.phases] == [p[0] for p in r_cpu.phases]
    assert r_gpu.flag == r_cpu.flag
    np.testing.assert_allclose(r_gpu.final_l2, r_cpu.final_l2, rtol=1e-3)


@pytest.mark.parametrize("masked", [False, True])
def test_residual_l2_kernel_matches_plain(cuda, masked):
    from psba_tpu_torch.ops import linearize_stream as ls

    prob, pa, cams, pts = _problem(cuda, seed=4)
    O = prob.n_obs
    valid = None
    if masked:
        valid = (torch.arange(O, device=cuda) < O - 7).to(torch.float32)
    args = (pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx32, pa.pt_idx32, valid)
    before = ls.residual_l2.launches
    ex, l2 = ls.residual_l2(*args)
    torch.cuda.synchronize()
    assert ls.residual_l2.launches == before + 1
    ex_p, l2_p = ls.residual_l2_plain(*args)
    # ex = obs - proj, each rounding the projection (~1e3 px) in float32,
    # the kernel with fused multiply-adds: 1e-4 of max |ex| as chip_smoke.py
    # and linearize_stream's ex; l2 a sum in another order, 1e-5
    assert _rel(ex, ex_p) < 1e-4 and _rel(l2, l2_p) < 1e-5
    with pytest.raises(ValueError, match="int32"):
        ls.residual_l2(*args[:5], pa.cam_idx, pa.pt_idx, valid)


def test_pairs_solve_on_cuda_matches_cpu(cuda):
    """mini_bal on the pair encoding, LM only, 20 iterations: the same flag
    and iteration count as on the CPU, final L2 within 1e-3, and the same
    final L2 as the dense path on the card within 1e-3."""
    import psba_tpu_torch
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.ops import linearize_stream as ls
    from psba_tpu_torch.solvers import SolverConfig

    prob = bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))
    cfg = SolverConfig.for_dtype(torch.float32, lm_switch_count=10_000,
                                 max_iters=20, record_history=True)
    before = ls.residual_l2.launches
    r_gpu = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32,
                                 device=cuda, schur="pairs")
    assert ls.residual_l2.launches > before
    r_cpu = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32,
                                 device="cpu", schur="pairs")
    r_dense = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32,
                                   device=cuda, schur="dense")
    assert r_gpu.flag == r_cpu.flag and r_gpu.iterations == r_cpu.iterations
    np.testing.assert_allclose(r_gpu.final_l2, r_cpu.final_l2, rtol=1e-3)
    np.testing.assert_allclose(r_gpu.final_l2, r_dense.final_l2, rtol=1e-3)


# ------------------------------------------------ the float64 (XLA) path

_KERNELS = ("linearize_dense", "gain_dense", "jgram_dense", "spd_solve",
            "linearize_stream", "residual_l2", "schur_pairs")


def _kernel_counts():
    from psba_tpu_torch.ops import cholesky as chol
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import linearize_stream as ls
    from psba_tpu_torch.ops import residual_dense as rd
    from psba_tpu_torch.ops import schur_pairs as sp

    fns = (ld.linearize_dense, rd.gain_dense, rd.jgram_dense, chol.spd_solve,
           ls.linearize_stream, ls.residual_l2, sp.schur_pairs)
    return {k: fn.launches for k, fn in zip(_KERNELS, fns)}


def test_xla_functions_on_cuda_match_cpu(cuda):
    """Each XLA-form function in float64 on the card (cuBLAS DGEMM / gemv,
    cuSOLVER, the fixed-order bucket sums) against the same call on the
    CPU, both fed the same inputs: to 1e-12 relative (the same products
    summed in another order). The solve is held to cond(S) * 1e-15: a
    backward-stable factorization's forward error grows with the condition
    number (about 7e7 here: S is singular along the gauge but for the
    damping)."""
    from psba_tpu_torch.core import hessian as th
    from psba_tpu_torch.core import linalg as tl
    from psba_tpu_torch.core import schur as ts
    from psba_tpu_torch.core.jacobian import jacobians
    from psba_tpu_torch.core.residual import residuals
    from psba_tpu_torch.io import synthetic_problem
    from psba_tpu_torch.solvers import ProblemArrays

    prob = synthetic_problem(n_cams=13, n_pts=700, seed=2)
    f64 = torch.float64
    C, P = prob.n_cams, prob.n_pts
    pa = ProblemArrays.from_problem(prob, dtype=f64, device="cpu")
    pa_c = ProblemArrays.from_problem(prob, dtype=f64, device=cuda)
    assert pa_c.obs_du is None and pa_c.blk_idx is not None
    cams = torch.as_tensor(prob.cams + 1e-3, dtype=f64)
    pts = torch.as_tensor(prob.pts, dtype=f64)

    def both(fn, *args):
        """fn on the CPU and on the card with the same inputs; returns the
        CPU outputs after holding the card's to them."""
        ref = fn(*args)
        got = fn(*(a.to(cuda) if torch.is_tensor(a) else a for a in args))
        single = not isinstance(ref, tuple)
        for r, g in zip((ref,) if single else ref, (got,) if single else got):
            assert g.device.type == "cuda" and g.dtype == r.dtype
            if r.dtype == torch.bool:
                assert bool(r) == bool(g.cpu())
            else:
                assert _rel(g.cpu(), r) < 1e-12, fn.__name__
        return ref

    idx = (pa.cam_idx, pa.pt_idx)
    A, B = both(jacobians, pa.K, pa.q0, cams, pts, *idx)
    ex = both(residuals, pa.K, pa.q0, cams, pts, pa.obs, *idx)
    U, V, W, ga, gb = both(th.assemble_blocks, A, B, ex, *idx, C, P, 2.0)
    U_d, V_d = th.damp_uv(U, V, 0.5)
    Vp, ok_v = both(ts.inv3x3_planar, V_d)
    ZW = both(ts.stack_blocks, W, pa.blk_idx)
    gbp = both(ts.planar_gb, gb)
    S, ZY = both(ts.schur_S_dense, U_d, ZW, Vp)
    ea = both(ts.reduced_rhs_dense, ga, gbp, ZY)
    calls = tl.spd_solve_xla.calls
    dpa, ok = tl.spd_solve(S, ea.reshape(-1))
    dpa_c, ok_c = tl.spd_solve(S.to(cuda), ea.reshape(-1).to(cuda))
    assert tl.spd_solve_xla.calls == calls + 2
    assert bool(ok) and bool(ok_c) and bool(ok_v)
    cond = float(torch.linalg.cond(S))
    assert _rel(dpa_c.cpu(), dpa) < 1e-15 * cond
    both(ts.back_substitute_dense, gbp, ZW, Vp, dpa.reshape(C, 6))


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_lm_run_xla_on_cuda_matches_cpu(cuda, schur):
    """Six float64 LM iterations with backend="xla" on the card and on the
    CPU from one state: history rows and parameters to 1e-9, the same flag;
    none of the seven kernels launches."""
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.solvers import OptState, ProblemArrays, SolverConfig
    from psba_tpu_torch.solvers.lm import lm_run

    prob = bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))
    cfg = SolverConfig.for_dtype(torch.float64, max_iters=6,
                                 lm_switch_count=10_000, record_history=True,
                                 damping="additive", backend="xla")
    runs = {}
    before = _kernel_counts()
    for dev in ("cpu", cuda):
        pa = ProblemArrays.from_problem(prob, dtype=torch.float64,
                                        device=dev, schur=schur)
        f = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        st = OptState.init(pa, f(prob.cams), f(prob.pts))
        runs[str(dev)] = lm_run(pa, st, cfg)
    assert _kernel_counts() == before
    a, b = runs[str(cuda)], runs["cpu"]
    assert a.itno == b.itno == 6 and a.flag == b.flag
    np.testing.assert_allclose(a.history, b.history, rtol=1e-9)
    assert _rel(a.cams.cpu(), b.cams) < 1e-9 and _rel(a.pts.cpu(), b.pts) < 1e-9


def test_f64_solve_on_cuda_launches_no_kernel(cuda):
    """The default float64 solve on the card (the XLA form) launches none
    of the seven kernels, meets the CPU's final L2 to 1e-9 with the same
    phases, and a second run gives the same bits."""
    import psba_tpu_torch
    from psba_tpu_torch.io import bal_to_problem

    prob = bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))
    before = _kernel_counts()
    r1 = psba_tpu_torch.solve(prob, device=cuda)
    r2 = psba_tpu_torch.solve(prob, device=cuda)
    assert _kernel_counts() == before
    r_cpu = psba_tpu_torch.solve(prob, device="cpu")
    assert r1.final_l2 == r2.final_l2 and r1.phases == r2.phases
    assert r1.phases == r_cpu.phases
    np.testing.assert_allclose(r1.final_l2, r_cpu.final_l2, rtol=1e-9)


def test_polish_on_cuda_follows_the_kernels(cuda):
    """A float32 solve with polish_iters=2 on the card: the float32 part
    launches the kernels, "lm64" comes last and the polish launches none."""
    import psba_tpu_torch
    from psba_tpu_torch.io import bal_to_problem
    from psba_tpu_torch.solvers import SolverConfig

    prob = bal_to_problem(str(REPO / "tests" / "data" / "mini_bal.txt"))
    cfg = SolverConfig.for_dtype(torch.float32, max_iters=10,
                                 lm_switch_count=10_000)
    before = _kernel_counts()
    main = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32, device=cuda)
    mid = _kernel_counts()
    pol = psba_tpu_torch.solve(prob, cfg, dtype=torch.float32, device=cuda,
                               polish_iters=2)
    after = _kernel_counts()
    assert mid["linearize_dense"] > before["linearize_dense"]
    assert {k: after[k] - mid[k] for k in _KERNELS} == {
        k: mid[k] - before[k] for k in _KERNELS}
    assert pol.phases[:-1] == main.phases and pol.phases[-1][0] == "lm64"
    assert pol.iterations == main.iterations + 2


def _clustered_ring(cuda, n_pts=3000):
    """A sparse problem clustered as the dense solve clusters it: 20 ring
    cameras, n_pts points at about four views each (some 60% of the
    (camera, tile) pairs occupied at 3,000), perturbed from a seed; float32
    tensors on the card with their tile mask, and a second state."""
    import os
    import tempfile

    from psba_tpu_torch.io import synthesize_points_for_cams, synthetic_problem
    from psba_tpu_torch.io.sba_text import write_cams
    from psba_tpu_torch.solvers import ProblemArrays

    ring = synthetic_problem(n_cams=20, n_pts=50, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cams.txt")
        write_cams(path, ring.K, ring.q0, ring.cams)
        prob = synthesize_points_for_cams(path, n_pts=n_pts, mean_obs=4.3,
                                          look_sign=1.0, seed=0)
    prob, _newpos = prob.with_tile_point_order()
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32, device=cuda)
    assert 0 < int(pa.tile_mask.sum()) < pa.tile_mask.numel()
    rng = np.random.default_rng(11)
    f = lambda a: torch.as_tensor(a, dtype=torch.float32, device=cuda)
    C = prob.n_cams
    cams = f(prob.cams + np.concatenate(
        [1e-3 * rng.standard_normal((C, 3)),
         1e-2 * rng.standard_normal((C, 3))], axis=1))
    pts = f(prob.pts)
    new = (cams + f(1e-4 * rng.standard_normal(cams.shape)),
           pts + f(1e-3 * rng.standard_normal(pts.shape)))
    return pa, cams, pts, new


_MASKED = ["linearize_u", "linearize", "gain", "jgram1", "jgram2", "jgram4"]


def _check_tile_mask(cuda, kernel, pa, cams, pts, new):
    """The dense kernel `kernel` (one of _MASKED) with the occupancy table:
    against its plain version with the same table (the tolerances above),
    the same bits as the kernel without the table, and with one observed
    tile's bit cleared against the plain version with that table (so the
    skip is taken, and honoured exactly)."""
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import residual_dense as rd

    C, P = pa.valid_d.shape
    base = (pa.K, pa.q0, cams, pts)
    if kernel.startswith("linearize"):
        want_u = kernel == "linearize_u"
        tols = {0: 1e-5, 1: 1e-5, 2: 1e-5, 3: 1e-4, 4: 1e-3, 6: 1e-4,
                7: 1e-3}

        def run(fn, mask):
            out = fn(*base, pa.obs_du, pa.obs_dv, pa.valid_d, want_u=want_u,
                     tile_mask=mask)
            return [out[i] for i in tols if i < len(out)]

        kern, plain = ld.linearize_dense, ld.linearize_dense_plain
        tol = [t for i, t in tols.items() if i < (8 if want_u else 6)]
    elif kernel == "gain":
        def run(fn, mask):
            return list(fn(*base, *new, pa.obs_du, pa.obs_dv, pa.valid_d,
                           tile_mask=mask))

        kern, plain, tol = rd.gain_dense, rd.gain_dense_plain, [1e-3, 1e-4]
    else:
        n = int(kernel[-1])
        rng = np.random.default_rng(n)
        dc = torch.as_tensor(rng.standard_normal((n, C, 6)),
                             dtype=torch.float32, device=cuda)
        dp = torch.as_tensor(rng.standard_normal((n, 3, P)),
                             dtype=torch.float32, device=cuda)

        def run(fn, mask):
            return [fn(*base, pa.valid_d, dc, dp, tile_mask=mask)]

        kern, plain, tol = rd.jgram_dense, rd.jgram_dense_plain, [1e-4]
    masked = run(kern, pa.tile_mask)
    free = run(kern, None)
    ref = run(plain, pa.tile_mask)
    torch.cuda.synchronize()
    for a, b, r, t in zip(masked, free, ref, tol):
        assert bool((a == b).all())
        assert _rel(a, r) < t
    cut = pa.tile_mask.clone()
    cut[3, int(torch.nonzero(cut[3])[0])] = 0
    got, want = run(kern, cut), run(plain, cut)
    for a, r, t in zip(got, want, tol):
        assert _rel(a, r) < t
    assert not all(bool((a == b).all()) for a, b in zip(got, masked))


@pytest.mark.parametrize("kernel", _MASKED)
def test_dense_kernels_take_the_tile_mask(cuda, kernel):
    """Each dense kernel with the occupancy table on a clustered sparse
    problem (_check_tile_mask)."""
    _check_tile_mask(cuda, kernel, *_clustered_ring(cuda))


@pytest.mark.parametrize("kernel", ["gain", "jgram1", "jgram2", "jgram4"])
def test_tile_mask_read_in_batches(cuda, kernel, monkeypatch):
    """gain_dense and jgram_dense read the table's bits in batches of 64
    units / tiles a block. With one block in the grid (jgram_dense: one a
    camera chunk) each block walks more than one batch on 10,000 clustered
    points (79 tiles; gain_dense 237 units), and _check_tile_mask holds."""
    from psba_tpu_torch.ops import residual_dense as rd

    real = rd._kernel
    monkeypatch.setattr(rd, "_kernel", lambda: (real()[0], 1))
    monkeypatch.setattr(rd, "_jgram_blocks", lambda n: 1)
    _check_tile_mask(cuda, kernel, *_clustered_ring(cuda, n_pts=10_000))


@pytest.mark.parametrize("schur", ["dense", "pairs"])
def test_one_nccl_rank_same_bits_as_lm_run(cuda, schur):
    """solve_sharded(n_devices=1) on the card: one NCCL rank in this
    process, so every collective passes its input through. Its float32 LM
    run (the kernels) gives the bits of OptState.init + lm_run on
    ProblemArrays.from_problem in the caller's point order, and launches
    the path's kernels."""
    from psba_tpu_torch.parallel.shard import solve_sharded
    from psba_tpu_torch.solvers import OptState, ProblemArrays, SolverConfig
    from psba_tpu_torch.solvers.lm import lm_run

    prob, _pa, _cams, _pts = _problem(cuda, seed=9)
    f32 = torch.float32
    cfg = SolverConfig.for_dtype(f32, max_iters=4, lm_switch_count=10_000,
                                 damping="additive")
    got = solve_sharded(prob, cfg, n_devices=1, dtype=f32, schur=schur,
                        device="cuda")
    pa = ProblemArrays.from_problem(prob, dtype=f32, device=cuda,
                                    schur=schur)
    t = lambda a: torch.as_tensor(a, dtype=f32, device=cuda)
    st = lm_run(pa, OptState.init(pa, t(prob.cams), t(prob.pts)), cfg)
    assert got.phases == [("lm", st.itno, st.flag)]
    assert np.array_equal(got.cams, st.cams.cpu().numpy())
    assert np.array_equal(got.pts, st.pts.cpu().numpy())
    assert got.final_l2 == float(st.ex_l2)
    assert got.collectives["S"]["calls"] > 0


def _dense_try(cuda, n_cams, n_pts, seed=0):
    """ZW3, U, Vinv of one damped dense3 try on a synthetic problem."""
    from psba_tpu_torch.core import schur as sc
    from psba_tpu_torch.io import synthetic_problem
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.solvers import ProblemArrays

    prob = synthetic_problem(n_cams=n_cams, n_pts=n_pts, seed=seed)
    pa = ProblemArrays.from_problem(prob, dtype=torch.float32, device=cuda)
    rng = np.random.default_rng(seed)
    cams = torch.as_tensor(prob.cams + np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1),
        dtype=torch.float32, device=cuda)
    pts = torch.as_tensor(prob.pts, dtype=torch.float32, device=cuda)
    ZW0, ZW1, ZW2, Vp, _gbp, _Pp, U, _ga = ld.linearize_dense(
        pa.K, pa.q0, cams, pts, pa.obs_du, pa.obs_dv, pa.valid_d,
        want_u=True)
    mu = 1e-3 * float(torch.diagonal(U, dim1=-2, dim2=-1).max())
    Vinv, _ok = sc.inv3x3_planar3(sc.damp_v_planar(Vp, mu))
    return (ZW0, ZW1, ZW2), U + mu * torch.eye(6, device=cuda), Vinv


def test_high_S_products_against_float64(cuda):
    """s_precision="high" on the card: schur_S_dense3 runs in full float32
    under "high" (a named deviation), even after
    torch.set_float32_matmul_precision("high"), which is single-pass TF32
    in PyTorch. At 300 cameras, the products (S - blockdiag U) against
    float64 from the same float32 inputs, normwise relative: at most twice
    the float32 product's plus 2^-21 (what "high" promises) and a tenth of
    single-pass TF32's (the check tells them apart); TF32 off after the
    call."""
    from psba_tpu_torch.core import schur as sc

    ZW3, Ud, Vinv = _dense_try(cuda, 300, 3000)
    C = Ud.shape[0]
    d = lambda t: tuple(x.double() for x in t)
    S64, ZY64 = sc.schur_S_dense3(Ud.double(), d(ZW3), Vinv.double())
    off64 = sum(ZY64[j] @ ZW3[j].double().T for j in range(3))
    blk = torch.block_diag(*Ud.double())
    offs = {}
    torch.set_float32_matmul_precision("high")
    try:
        S, ZY3 = sc.schur_S_dense3(Ud, ZW3, Vinv)
        assert torch.backends.cuda.matmul.allow_tf32 is False
    finally:
        torch.set_float32_matmul_precision("highest")
    offs["high"] = blk - S.double()
    offs["highest"] = blk - sc.schur_S_dense3(Ud, ZW3, Vinv)[0].double()
    # schur_S_dense3 pins float32; the single-pass TF32 products by hand
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        offs["tf32"] = sum(ZY3[j] @ ZW3[j].T for j in range(3)).double()
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    err = {k: float(torch.linalg.norm(v - off64) / torch.linalg.norm(off64))
           for k, v in offs.items()}
    print(err)
    assert S.shape == S64.shape == (6 * C, 6 * C)
    assert err["high"] <= 2 * err["highest"] + 2.0 ** -21, err
    assert err["high"] <= err["tf32"] / 10, err


def test_high_solve_on_cuda(cuda):
    """A float32 "high" default solve on the card: the dense kernels
    launch, the first LM phase and the switch to TR are "highest"'s, final
    L2 within 1e-3 of it, TF32 off after it."""
    from psba_tpu_torch import solve
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.solvers import SolverConfig

    prob, _pa, _cams, _pts = _problem(cuda, seed=2)
    runs = {}
    for prec in ("highest", "high"):
        before = ld.linearize_dense.launches
        runs[prec] = solve(prob, SolverConfig.for_dtype(
            torch.float32, s_precision=prec), dtype=torch.float32,
            device="cuda")
        assert ld.linearize_dense.launches > before
        assert torch.backends.cuda.matmul.allow_tf32 is False
    hi, lo = runs["high"], runs["highest"]
    assert hi.phases[0] == lo.phases[0]
    assert hi.final_l2 < hi.initial_l2
    np.testing.assert_allclose(hi.final_l2, lo.final_l2, rtol=1e-3)


def _render(uv, H=120, W=160):
    """tests/test_frontend.py's render: a 5x5 texture per point, seeded by
    its index, with a strong centre, on a dark gradient."""
    img = np.linspace(0, 0.1, W)[None, :] * np.ones((H, 1))
    for i, (u, v) in enumerate(uv):
        ui, vi = int(round(u)), int(round(v))
        if 3 <= ui < W - 3 and 3 <= vi < H - 3:
            tex = np.random.default_rng(1000 + i).uniform(0.2, 1.0, (5, 5))
            tex[2, 2] = 1.5
            img[vi - 2:vi + 3, ui - 2:ui + 3] += tex
    return img


def test_frontend_on_cuda_matches_cpu(cuda):
    """The two-view pipeline (RANSAC from the same CPU draws) on the card
    and on the CPU, on test_frontend's scene: the same observations,
    poses to 1e-4."""
    from psba_tpu_torch.frontend.pipeline import two_view_problem

    K = [200.0, 80.0, 60.0, 1.0, 0.0]
    rng = np.random.default_rng(3)
    X = rng.uniform([-1.2, -0.9, 4], [1.2, 0.9, 8], size=(40, 3))
    a = 0.08
    R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                  [-np.sin(a), 0, np.cos(a)]])
    uv = [(Xc[:, :2] / Xc[:, 2:3]) * K[0] + np.array(K[1:3])
          for Xc in (X, X @ R.T + [-0.6, 0.0, 0.0])]
    img1, img2 = _render(uv[0]), _render(uv[1])
    got = two_view_problem(img1, img2, K, n_features=128, device="cuda")
    ref = two_view_problem(img1, img2, K, n_features=128, device="cpu")
    np.testing.assert_array_equal(got.obs, ref.obs)
    np.testing.assert_allclose(got.q0, ref.q0, atol=1e-4)
    np.testing.assert_allclose(got.cams, ref.cams, atol=1e-4)
