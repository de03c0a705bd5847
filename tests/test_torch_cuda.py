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


@pytest.mark.parametrize("n", [6, 126, 130, 828, 1024])
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


@pytest.mark.parametrize("n", [1, 2, 3])
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
