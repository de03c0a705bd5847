"""Pinhole camera projection (PyTorch counterpart of
psba_tpu.models.pinhole).

Intrinsics layout K = [fu, u0, v0, ar, s] per camera:

    u = (fu * Xc + s * Yc + u0 * Zc) / Zc
    v = (fu * ar * Yc + v0 * Zc) / Zc
"""

from __future__ import annotations

import torch

from psba_tpu_torch.models.quaternion import compose_local, quat_rotate


def project(K: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """Project camera-frame points pc [..., 3] with intrinsics K [..., 5]
    to pixel coordinates [..., 2]."""
    fu, u0, v0, ar, sk = (K[..., i] for i in range(5))
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    inv_z = 1.0 / z
    u = (fu * x + sk * y + u0 * z) * inv_z
    v = (fu * ar * y + v0 * z) * inv_z
    return torch.stack([u, v], dim=-1)


def project_quat(K, q0, v, t, X, clamp: bool = False) -> torch.Tensor:
    """Full prediction x̂ = proj(K, R(q_local(v) (x) q0) X + t).

    K [..., 5], q0 [..., 4], v [..., 3], t [..., 3], X [..., 3] -> [..., 2]."""
    q = compose_local(v, q0, clamp=clamp)
    pc = quat_rotate(q, X) + t
    return project(K, pc)
