"""Analytic reprojection Jacobians (PyTorch counterpart of
psba_tpu.core.jacobian).

Per observation, A_o = d(x̂)/d(cam) in R^{2x6} and B_o = d(x̂)/d(point) in
R^{2x3}, built from the structured chain rule

  p_c = R(q_l(v)) X0 + t,    X0 = R(q0) X,    q_l = (s, v), s = sqrt(1-||v||^2)
  dp_c/dv = -(2/s) w v^T - 2 s [X0]x - 2 [w]x - 2 [v]x [X0]x,   w = v x X0

with the rotation columns before the translation columns in A.
"""

from __future__ import annotations

import torch

from psba_tpu_torch.models.quaternion import (
    compose_local,
    local_scalar,
    quat_to_matrix,
)


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] cross-product matrices [v]x."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(m.shape[:-1] + (3, 3))


def _dproj_dpc(K: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """[..., 5], [..., 3] -> [..., 2, 3]."""
    fu, ar, sk = K[..., 0], K[..., 3], K[..., 4]
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / z
    zero = torch.zeros_like(fu)
    row_u = torch.stack([fu, sk, -(fu * x + sk * y) * inv_z], dim=-1)
    row_v = torch.stack([zero, fu * ar, -(fu * ar * y) * inv_z], dim=-1)
    return torch.stack([row_u, row_v], dim=-2) * inv_z[..., None, None]


def jacobians(K, q0, cams, pts, cam_idx, pt_idx, clamp: bool = False):
    """Return (A [O,2,6], B [O,2,3]), the Jacobians of the prediction x̂
    (the solver's sign convention: g = J^T ex with J = dx̂/dp)."""
    q0g = q0[cam_idx]
    v = cams[cam_idx, 0:3]
    t = cams[cam_idx, 3:6]
    X = pts[pt_idx]

    s = local_scalar(v, clamp=clamp)[..., None]                # [O,1]
    q = compose_local(v, q0g, clamp=clamp)                     # [O,4]
    R0 = quat_to_matrix(q0g)                                   # [O,3,3]
    X0 = torch.einsum("oij,oj->oi", R0, X)                     # [O,3]
    w = torch.linalg.cross(v, X0, dim=-1)                      # [O,3]
    pc = X0 + 2.0 * s * w + 2.0 * torch.linalg.cross(v, w, dim=-1) + t

    P = _dproj_dpc(K[cam_idx], pc)                             # [O,2,3]
    M = (
        -(2.0 / s)[..., None] * w[..., :, None] * v[..., None, :]
        - 2.0 * s[..., None] * _skew(X0)
        - 2.0 * _skew(w)
        - 2.0 * torch.einsum("oij,ojk->oik", _skew(v), _skew(X0))
    )                                                          # [O,3,3]
    A_rot = torch.einsum("oij,ojk->oik", P, M)                 # [O,2,3]
    A = torch.cat([A_rot, P], dim=-1)                          # [O,2,6]
    B = torch.einsum("oij,ojk->oik", P, quat_to_matrix(q))     # [O,2,3]
    return A, B


def jmultiply(A, B, x_cams, x_pts, cam_idx, pt_idx) -> torch.Tensor:
    """(J x)_o = A_o x_cam[j(o)] + B_o x_pt[i(o)]  -> [O, 2].

    The per-observation form of the reference's J x product: unobserved
    (point, camera) slots contribute nothing to the TR solver's dot
    products, so only the observations are formed."""
    xc = x_cams.reshape(-1, 6)[cam_idx]
    xp = x_pts.reshape(-1, 3)[pt_idx]
    return (torch.einsum("oij,oj->oi", A, xc)
            + torch.einsum("oij,oj->oi", B, xp))
