"""Port against reference: camera models, residuals and Jacobians.

Same float64 inputs, made with numpy from a seed, go through psba_tpu's
JAX function and psba_tpu_torch's counterpart; both run in float64, so
they agree to about 1e-12 relative (a few ulps of reordered arithmetic)."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from psba_tpu.core import jacobian as jjac
from psba_tpu.core import residual as jres
from psba_tpu.models import pinhole as jpin
from psba_tpu.models import quaternion as jq
from psba_tpu_torch.core import jacobian as tjac
from psba_tpu_torch.core import residual as tres
from psba_tpu_torch.models import pinhole as tpin
from psba_tpu_torch.models import quaternion as tq

RTOL = 1e-12


def _unit_quats(rng, n):
    q = rng.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return q * np.where(q[:, :1] >= 0, 1.0, -1.0)


def _close(port, ref, rtol=RTOL):
    port = port.numpy() if isinstance(port, torch.Tensor) else port
    ref = np.asarray(ref)
    scale = max(np.max(np.abs(ref)), 1e-300)
    assert np.max(np.abs(port - ref)) <= rtol * scale


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


@pytest.mark.parametrize("fn", ["quat_multiply", "quat_rotate",
                                "compose_local", "quat_to_matrix",
                                "local_scalar"])
def test_quaternion_functions_match(fn):
    rng = np.random.default_rng(11)
    n = 64
    q = _unit_quats(rng, n)
    r = _unit_quats(rng, n)
    v = 0.05 * rng.standard_normal((n, 3))
    p = rng.standard_normal((n, 3))
    args = {
        "quat_multiply": (q, r),
        "quat_rotate": (q, p),
        "compose_local": (v, q),
        "quat_to_matrix": (q,),
        "local_scalar": (v,),
    }[fn]
    ref = getattr(jq, fn)(*(jnp.asarray(a) for a in args))
    port = getattr(tq, fn)(*(_t(a) for a in args))
    _close(port, ref)


def test_local_scalar_clamp_matches():
    v = np.array([[0.9, 0.5, 0.1], [0.1, 0.2, 0.3]])
    ref = jq.local_scalar(jnp.asarray(v), clamp=True)
    port = tq.local_scalar(_t(v), clamp=True)
    np.testing.assert_array_equal(port.numpy(), np.asarray(ref))
    assert port[0] == 0.0


def test_project_quat_matches():
    rng = np.random.default_rng(12)
    n = 64
    K = np.column_stack([800 + rng.uniform(0, 50, n), rng.uniform(300, 340, n),
                         rng.uniform(220, 260, n), 1 + 0.01 * rng.random(n),
                         0.1 * rng.random(n)])
    q0 = _unit_quats(rng, n)
    v = 0.02 * rng.standard_normal((n, 3))
    t = rng.standard_normal((n, 3)) + np.array([0, 0, 8.0])
    X = rng.standard_normal((n, 3))
    ref = jpin.project_quat(*(jnp.asarray(a) for a in (K, q0, v, t, X)))
    port = tpin.project_quat(*(_t(a) for a in (K, q0, v, t, X)))
    _close(port, ref)
    pc = rng.standard_normal((n, 3)) + np.array([0, 0, 5.0])
    _close(tpin.project(_t(K), _t(pc)),
           jpin.project(jnp.asarray(K), jnp.asarray(pc)))


def _stream_inputs(prob, seed):
    """Problem arrays plus perturbed parameters (nonzero local rotations)."""
    rng = np.random.default_rng(seed)
    cams = prob.cams + np.concatenate(
        [0.01 * rng.standard_normal((prob.n_cams, 3)),
         0.05 * rng.standard_normal((prob.n_cams, 3))], axis=1)
    pts = prob.pts + 0.01 * rng.standard_normal(prob.pts.shape)
    return (prob.K, prob.q0, cams, pts, prob.obs, prob.cam_idx, prob.pt_idx)


def _split(arrs):
    K, q0, cams, pts, obs, ci, pi = arrs
    jx = [jnp.asarray(a) for a in (K, q0, cams, pts, obs)] + [
        jnp.asarray(ci), jnp.asarray(pi)]
    tx = [_t(a) for a in (K, q0, cams, pts, obs)] + [
        torch.as_tensor(ci, dtype=torch.int64),
        torch.as_tensor(pi, dtype=torch.int64)]
    return jx, tx


@pytest.mark.parametrize("fixture", ["prob_synth", "prob_mini_bal"])
def test_residual_family_matches(fixture, request):
    prob = request.getfixturevalue(fixture)
    jx, tx = _split(_stream_inputs(prob, 5))
    ex_j = jres.residuals(*jx)
    ex_t = tres.residuals(*tx)
    _close(ex_t, ex_j)
    _close(tres.error_l2(ex_t), jres.error_l2(ex_j))
    # a second parameter set for the factored difference
    jx2, tx2 = _split(_stream_inputs(prob, 6))
    ex_j2, ex_t2 = jres.residuals(*jx2), tres.residuals(*tx2)
    _close(tres.error_l2_diff(ex_t, ex_t2), jres.error_l2_diff(ex_j, ex_j2))
    _close(tres.rms_error(tres.error_l2(ex_t), prob.n_obs),
           jres.rms_error(jres.error_l2(ex_j), prob.n_obs))


@pytest.mark.parametrize("fixture", ["prob_synth", "prob_mini_bal"])
def test_jacobians_match(fixture, request):
    prob = request.getfixturevalue(fixture)
    jx, tx = _split(_stream_inputs(prob, 7))
    del jx[4], tx[4]   # no observations
    A_j, B_j = jjac.jacobians(*jx)
    A_t, B_t = tjac.jacobians(*tx)
    _close(A_t, A_j)
    _close(B_t, B_j)


@pytest.fixture(scope="module")
def prob_mini_bal():
    from psba_tpu.io import bal_to_problem

    return bal_to_problem(str(Path(__file__).parent / "data" / "mini_bal.txt"))
