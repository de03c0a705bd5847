"""Port against reference: the three kernel modules, on CPU tensors.

On the CPU each wrapper runs its plain PyTorch version; the reference's
Pallas kernels run in interpret mode (linearize_dense_pallas,
gain_dense_pallas, spd_solve_pallas). Inputs are float32, made with numpy
from a seed; tolerances are those the reference's own kernel tests use
(tests/test_pallas.py, tests/test_linalg.py), with the reason beside each.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.core.linalg import spd_solve_xla
from psba_tpu.ops.cholesky_pallas import spd_solve_pallas
from psba_tpu.ops.linearize_dense import linearize_dense_pallas
from psba_tpu.ops.residual_dense import gain_dense_pallas
from psba_tpu.solvers.types import ProblemArrays as JProblemArrays
from psba_tpu_torch.convert import from_reference, to_numpy
from psba_tpu_torch.core import linalg as tlinalg
from psba_tpu_torch.ops import cholesky as tchol
from psba_tpu_torch.ops import linearize_dense as tld
from psba_tpu_torch.ops import residual_dense as trd


@pytest.fixture(scope="module")
def prob_mini_bal():
    from psba_tpu.io import bal_to_problem

    return bal_to_problem(str(Path(__file__).parent / "data" / "mini_bal.txt"))


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.max(np.abs(a - b)) / (np.max(np.abs(b)) + 1e-30)


def _both(prob, seed):
    """The same float32 state in both packages: (jax pa, jax cams/pts,
    port pa, port cams/pts), cameras and points perturbed from a seed."""
    rng = np.random.default_rng(seed)
    cams = (prob.cams + np.concatenate(
        [0.01 * rng.standard_normal((prob.n_cams, 3)),
         0.02 * rng.standard_normal((prob.n_cams, 3))], axis=1)
    ).astype(np.float32)
    pts = (prob.pts + 0.01 * rng.standard_normal(prob.pts.shape)).astype(
        np.float32)
    jpa = JProblemArrays.from_problem(prob.with_blk(), dtype=jnp.float32,
                                      schur="dense")
    pa_np = {k: np.asarray(getattr(jpa, k)) for k in (
        "K", "q0", "obs", "cam_idx", "pt_idx", "obs_du", "obs_dv",
        "valid_d")}
    tpa, tcams, tpts = from_reference(pa_np, cams, pts, device="cpu")
    return jpa, jnp.asarray(cams), jnp.asarray(pts), tpa, tcams, tpts


@pytest.mark.parametrize("fixture", ["prob_synth", "prob_mini_bal"])
def test_linearize_dense_matches_pallas(fixture, request):
    prob = request.getfixturevalue(fixture)
    jpa, jc, jp, tpa, tc, tp = _both(prob, 1)
    P = prob.n_pts
    ref = linearize_dense_pallas(jpa.K, jpa.q0, jc, jp, jpa.obs_du,
                                 jpa.obs_dv, jpa.valid_d, want_u=True)
    out = tld.linearize_dense(tpa.K, tpa.q0, tc, tp, tpa.obs_du, tpa.obs_dv,
                              tpa.valid_d, want_u=True)
    ZWr, Vr, gbr, Ur, gar = ref[:3], ref[3], ref[4], ref[6], ref[7]
    ZWt, Pp = to_numpy(out[:3]), out[5]
    Vt, gbt, Ut, gat = (to_numpy(out[i]) for i in (3, 4, 6, 7))
    assert Pp == tld.padded_points(P) and Pp % tld.PTILE == 0
    for k in range(3):
        assert ZWt[k].shape == (6 * prob.n_cams, Pp)
        assert _rel(ZWt[k][:, :P], np.asarray(ZWr[k])[:, :P]) < 1e-5
    assert _rel(Vt[:, :, :P], np.asarray(Vr)[:, :, :P]) < 1e-5
    # B^T ex sums residual-weighted terms of both signs (cancellation),
    # as the reference's own gate
    assert _rel(gbt[:, :P], np.asarray(gbr)[:, :P]) < 1e-3
    assert _rel(Ut, Ur) < 1e-5
    assert _rel(gat, gar) < 1e-3
    np.testing.assert_array_equal(Ut, np.swapaxes(Ut, 1, 2))
    # padded lanes: ZW and gb exactly 0, V exactly the identity
    assert Pp > P
    for k in range(3):
        assert np.all(ZWt[k][:, P:] == 0.0)
    assert np.all(gbt[:, P:] == 0.0)
    np.testing.assert_array_equal(
        Vt[:, :, P:], np.broadcast_to(np.eye(3)[:, :, None], Vt[:, :, P:].shape))


def test_linearize_dense_without_u(prob_synth):
    _jpa, _jc, _jp, tpa, tc, tp = _both(prob_synth, 2)
    args = (tpa.K, tpa.q0, tc, tp, tpa.obs_du, tpa.obs_dv, tpa.valid_d)
    six = tld.linearize_dense(*args)
    eight = tld.linearize_dense(*args, want_u=True)
    assert len(six) == 6 and len(eight) == 8
    for a, b in zip(six[:5], eight[:5]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("fixture", ["prob_synth", "prob_mini_bal"])
def test_gain_dense_matches_pallas(fixture, request):
    prob = request.getfixturevalue(fixture)
    jpa, jc, jp, tpa, tc, tp = _both(prob, 3)
    rng = np.random.default_rng(4)
    dc = (1e-3 * rng.standard_normal(tc.shape)).astype(np.float32)
    dp = (1e-3 * rng.standard_normal(tp.shape)).astype(np.float32)
    g_r, l2_r = gain_dense_pallas(jpa.K, jpa.q0, jc, jp, jc + dc, jp + dp,
                                  jpa.obs_du, jpa.obs_dv, jpa.valid_d)
    g_t, l2_t = trd.gain_dense(tpa.K, tpa.q0, tc, tp, tc + torch.from_numpy(dc),
                               tp + torch.from_numpy(dp), tpa.obs_du,
                               tpa.obs_dv, tpa.valid_d)
    assert g_t.shape == () and l2_t.shape == ()
    # gain is a difference of nearly equal sums: the reference's gate
    np.testing.assert_allclose(float(g_t), float(g_r), rtol=1e-4)
    np.testing.assert_allclose(float(l2_t), float(l2_r), rtol=1e-5)


def _spd(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((n, n))
    S = (A @ A.T + n * np.eye(n)).astype(np.float32)
    return S, rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("n", [18, 126, 130])
def test_spd_solve_matches_pallas_and_xla(n):
    S, b = _spd(n, n)
    x_t, ok_t = tchol.spd_solve(torch.from_numpy(S), torch.from_numpy(b))
    x_p, ok_p = spd_solve_pallas(jnp.asarray(S), jnp.asarray(b))
    x_x, ok_x = spd_solve_xla(jnp.asarray(S), jnp.asarray(b))
    assert bool(ok_t) and bool(ok_p) and bool(ok_x)
    assert ok_t.dtype == torch.bool and ok_t.shape == ()
    # f32 factor-and-solve of a matrix with condition ~1e1: both within a
    # few ulps times n of each other
    scale = np.max(np.abs(np.asarray(x_x)))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_p), atol=1e-5 * scale)
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_x), atol=1e-5 * scale)


def test_spd_solve_flags_indefinite():
    S = np.eye(24, dtype=np.float32)
    S[5, 5] = -2.0
    b = np.ones(24, np.float32)
    x_t, ok_t = tchol.spd_solve(torch.from_numpy(S), torch.from_numpy(b))
    _x_p, ok_p = spd_solve_pallas(jnp.asarray(S), jnp.asarray(b))
    assert not bool(ok_t) and not bool(ok_p)
    assert torch.all(x_t == 0.0)


def test_spd_solve_size_dispatch_counts_oversized():
    """n > MAX_N takes core.linalg's explicit oversized branch, counted."""
    n = tlinalg.MAX_N + 6
    S, b = _spd(n, 0)
    before = tlinalg.spd_solve.oversized_launches
    x, ok = tlinalg.spd_solve(torch.from_numpy(S), torch.from_numpy(b))
    assert tlinalg.spd_solve.oversized_launches == before + 1
    assert bool(ok)
    ref = np.linalg.solve(S.astype(np.float64), b.astype(np.float64))
    np.testing.assert_allclose(x.numpy(), ref, atol=1e-4 * np.max(np.abs(ref)))
    # at the cap the dispatch stays on the kernel module (plain on CPU)
    S2, b2 = _spd(tlinalg.MAX_N, 1)
    tlinalg.spd_solve(torch.from_numpy(S2), torch.from_numpy(b2))
    assert tlinalg.spd_solve.oversized_launches == before + 1


def test_wrappers_refuse_meta_tensors():
    """Anything but CPU or CUDA tensors raises instead of falling back."""
    S = torch.eye(6, device="meta")
    with pytest.raises(ValueError):
        tchol.spd_solve(S, torch.ones(6, device="meta"))
