"""Port against reference: the dense3 Schur family of core/schur.py.

Inputs are made with numpy from a seed. float64 cases agree to ~1e-12
relative (reordered float64 arithmetic); float32 cases to the float32
tolerance stated at each."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.core import schur as js
from psba_tpu_torch.core import schur as ts


def _rel(a, b):
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    b = np.asarray(b)
    return np.max(np.abs(a.astype(np.float64) - b)) / (np.max(np.abs(b)) + 1e-300)


def _planar_spd(rng, P, scale=None, dtype=np.float64):
    """[3, 3, P] symmetric positive definite blocks, optionally with a
    per-block diagonal scale [P, 3]."""
    A = rng.standard_normal((P, 3, 3))
    V = A @ np.swapaxes(A, 1, 2) + 0.5 * np.eye(3)
    if scale is not None:
        s = np.sqrt(scale)
        V = V * s[:, :, None] * s[:, None, :]
    return np.transpose(V, (1, 2, 0)).astype(dtype)


def _both_inv(Vp):
    Vi_j, ok_j = js.inv3x3_planar3(jnp.asarray(Vp))
    Vi_t, ok_t = ts.inv3x3_planar3(torch.from_numpy(Vp))
    return np.asarray(Vi_j), bool(ok_j), Vi_t, bool(ok_t)


def test_inv3x3_planar3_well_scaled():
    Vp = _planar_spd(np.random.default_rng(0), 257)
    Vi_j, ok_j, Vi_t, ok_t = _both_inv(Vp)
    assert ok_j and ok_t
    assert _rel(Vi_t, Vi_j) < 1e-12
    eye = np.einsum("ijp,jkp->ikp", Vp, Vi_t.numpy())
    np.testing.assert_allclose(eye, np.broadcast_to(np.eye(3)[:, :, None],
                                                    eye.shape), atol=1e-10)


def test_inv3x3_planar3_badly_scaled_f32():
    """diag ~1e12 with mu-like 1e20 entries: the exact power-of-two block
    scale keeps the float32 determinant finite. Bit-level exponent trick
    in both packages, so they agree to float32 rounding (1e-5)."""
    rng = np.random.default_rng(1)
    scale = np.repeat(10.0 ** rng.uniform(8, 12, (129, 1)), 3, axis=1)
    Vp = _planar_spd(rng, 129, scale=scale, dtype=np.float32)
    Vp[:, :, :8] += (1e20 * np.eye(3, dtype=np.float32))[:, :, None]
    Vi_j, ok_j, Vi_t, ok_t = _both_inv(Vp)
    assert ok_j and ok_t
    assert np.all(np.isfinite(Vi_t.numpy()))
    for p in (0, 50, 128):
        assert _rel(Vi_t[:, :, p], Vi_j[:, :, p]) < 1e-5


def test_block_scale_power_of_two_f32():
    rng = np.random.default_rng(2)
    vals = [torch.from_numpy((10.0 ** rng.uniform(-30, 30, 64)).astype(
        np.float32)) for _ in range(6)]
    inv_m, inv_m3 = ts._block_scale(*vals)
    inv_j, inv_j3 = js._block_scale(*(jnp.asarray(v.numpy()) for v in vals))
    np.testing.assert_array_equal(inv_m.numpy(), np.asarray(inv_j))
    # the cube may leave the normal range: XLA's CPU backend flushes
    # subnormals to zero, torch keeps them; it only moves the fallback gate
    normal = np.abs(np.asarray(inv_j3)) >= np.finfo(np.float32).tiny
    np.testing.assert_array_equal(inv_m3.numpy()[normal],
                                  np.asarray(inv_j3)[normal])
    m = torch.stack([v.abs() for v in vals]).max(0).values
    scaled = (m * inv_m).numpy()
    assert np.all((scaled >= 1.0) & (scaled < 2.0))
    mant, _ = np.frexp(inv_m.numpy())
    assert np.all(mant == 0.5)


def test_inv3x3_planar3_pivoted_fallback():
    """Blocks whose closed-form determinant falls under the 1e-16
    (unscaled) gate go through the pivoted determinant and stay ok."""
    rng = np.random.default_rng(3)
    Vp = _planar_spd(rng, 64)
    small = 1e-3 * np.diag([1.0, 1.0, 1e-8])
    Vp[:, :, :4] = small[:, :, None]
    Vi_j, ok_j, Vi_t, ok_t = _both_inv(Vp)
    assert ok_j and ok_t
    assert _rel(Vi_t[:, :, :4], Vi_j[:, :, :4]) < 1e-12
    assert _rel(Vi_t, Vi_j) < 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_inv3x3_planar3_singular(dtype):
    rng = np.random.default_rng(4)
    Vp = _planar_spd(rng, 64, dtype=dtype)
    v = rng.standard_normal(3)
    Vp[:, :, 7] = np.outer(v, v).astype(dtype)      # rank one
    Vp[:, :, 9] = 0.0                                # all zero
    Vi_j, ok_j, Vi_t, ok_t = _both_inv(Vp)
    assert not ok_j and not ok_t
    # singular blocks come back as zeros, the others stay exact
    assert np.all(Vi_t[:, :, 9].numpy() == 0.0)
    keep = [p for p in range(64) if p not in (7, 9)]
    assert _rel(Vi_t[:, :, keep], Vi_j[:, :, keep]) < (
        1e-12 if dtype == np.float64 else 1e-5)


def test_damping_and_diagonals_match():
    rng = np.random.default_rng(5)
    C, P, Pp = 5, 40, 48
    Vp = _planar_spd(rng, Pp)
    A = rng.standard_normal((C, 6, 6))
    U = A @ np.swapaxes(A, 1, 2)
    mu = 0.37
    Vt, Ut = torch.from_numpy(Vp), torch.from_numpy(U)
    assert _rel(ts.damp_v_planar(Vt, mu), js.damp_v_planar(jnp.asarray(Vp), mu)) == 0
    assert _rel(ts.damp_v_planar_marquardt(Vt, mu),
                js.damp_v_planar_marquardt(jnp.asarray(Vp), mu)) < 1e-15
    assert _rel(ts.diag_v_planar(Vt, P), js.diag_v_planar(jnp.asarray(Vp), P)) == 0
    assert float(ts.max_diag_planar(Ut, Vt, P)) == float(
        js.max_diag_planar(jnp.asarray(U), jnp.asarray(Vp), P))


def _schur_inputs(seed, C=5, Pp=256):
    rng = np.random.default_rng(seed)
    ZW = [rng.standard_normal((6 * C, Pp)) for _ in range(3)]
    Vinv = _planar_spd(rng, Pp)
    A = rng.standard_normal((C, 6, 6))
    U = A @ np.swapaxes(A, 1, 2) + 100.0 * np.eye(6)
    ga = rng.standard_normal((C, 6))
    gbp = rng.standard_normal((3, Pp))
    dpa = rng.standard_normal((C, 6))
    return ZW, Vinv, U, ga, gbp, dpa


def test_schur_S_and_reduced_rhs_dense3_match():
    ZW, Vinv, U, ga, gbp, _ = _schur_inputs(6)
    S_j, ZY_j = js.schur_S_dense3(jnp.asarray(U), tuple(map(jnp.asarray, ZW)),
                                  jnp.asarray(Vinv))
    S_t, ZY_t = ts.schur_S_dense3(torch.from_numpy(U),
                                  tuple(map(torch.from_numpy, ZW)),
                                  torch.from_numpy(Vinv))
    assert S_t.shape == (30, 30)
    assert _rel(S_t, S_j) < 1e-12
    for a, b in zip(ZY_t, ZY_j):
        assert _rel(a, b) < 1e-12
    ea_j = js.reduced_rhs_dense3(jnp.asarray(ga), jnp.asarray(gbp), ZY_j)
    ea_t = ts.reduced_rhs_dense3(torch.from_numpy(ga), torch.from_numpy(gbp),
                                 ZY_t)
    assert ea_t.shape == (5, 6)
    assert _rel(ea_t, ea_j) < 1e-12


def test_back_substitute_dense3_matches():
    ZW, Vinv, _U, _ga, gbp, dpa = _schur_inputs(7)
    dpb_j = js.back_substitute_dense3(jnp.asarray(gbp),
                                      tuple(map(jnp.asarray, ZW)),
                                      jnp.asarray(Vinv), jnp.asarray(dpa))
    dpb_t = ts.back_substitute_dense3(torch.from_numpy(gbp),
                                      tuple(map(torch.from_numpy, ZW)),
                                      torch.from_numpy(Vinv),
                                      torch.from_numpy(dpa))
    assert dpb_t.shape == (3, 256)
    assert _rel(dpb_t, dpb_j) < 1e-12
