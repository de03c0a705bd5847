"""Quaternion utilities (Hamilton convention, [w, x, y, z] layout).

PyTorch counterpart of psba_tpu.models.quaternion. Each camera carries a
fixed initial unit quaternion q0 and an optimized local rotation given by
its vector part v, with scalar part s = sqrt(1 - ||v||^2); the effective
rotation is q_local(v) (x) q0.

All functions take tensors with leading batch axes and keep the input's
dtype and device (float32 and float64 alike).
"""

from __future__ import annotations

import torch


def local_scalar(v: torch.Tensor, clamp: bool = False) -> torch.Tensor:
    """Scalar part s = sqrt(1 - ||v||^2) of a local rotation vector [..., 3].

    `clamp=True` guards the argument at zero (opt-in, as in the reference)."""
    sq = 1.0 - torch.sum(v * v, dim=-1)
    if clamp:
        sq = torch.clamp(sq, min=0.0)
    return torch.sqrt(sq)


def quat_multiply(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q (x) r for [..., 4] quaternions in [w, x, y, z]."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rw, rx, ry, rz = r[..., 0], r[..., 1], r[..., 2], r[..., 3]
    return torch.stack(
        [
            qw * rw - qx * rx - qy * ry - qz * rz,
            qw * rx + rw * qx + qy * rz - qz * ry,
            qw * ry + rw * qy + qz * rx - qx * rz,
            qw * rz + rw * qz + qx * ry - qy * rx,
        ],
        dim=-1,
    )


def compose_local(v: torch.Tensor, q0: torch.Tensor,
                  clamp: bool = False) -> torch.Tensor:
    """Effective rotation q = q_local(v) (x) q0; v [..., 3], q0 [..., 4]."""
    s = local_scalar(v, clamp=clamp)
    ql = torch.cat([s[..., None], v], dim=-1)
    return quat_multiply(ql, q0)


def quat_rotate(q: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rotate vectors p [..., 3] by unit quaternions q [..., 4] with the
    two-cross-product form p + 2 w (u x p) + 2 u x (u x p)."""
    w = q[..., 0:1]
    u = q[..., 1:4]
    u, p = torch.broadcast_tensors(u, p)
    t = 2.0 * torch.linalg.cross(u, p, dim=-1)
    return p + w * t + torch.linalg.cross(u, t, dim=-1)


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Rotation matrix [..., 3, 3] from unit quaternion [..., 4]."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r = torch.stack(
        [
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ],
        dim=-1,
    )
    return r.reshape(r.shape[:-1] + (3, 3))


def quat_normalize_vec(q: torch.Tensor):
    """Normalize full quaternions [..., 4], the scalar part forced
    non-negative (q and -q encode the same rotation). Returns (the vector
    part [..., 3], the normalized quaternions [..., 4]).

    The reference's quat2vec input filter (PSBA/misc.cpp:21-49): the
    vector part is the optimized local rotation's initial state before it
    is zeroed, and qn the sign convention of the stored q0."""
    mag = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    sg = torch.where(q[..., 0:1] >= 0.0, 1.0, -1.0).to(q.dtype)
    qn = q * (sg / mag)
    return qn[..., 1:4], qn
