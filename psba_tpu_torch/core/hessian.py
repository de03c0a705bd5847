"""Block Hessian assembly of the XLA form, and the damping of the U / V
blocks (PyTorch counterpart of psba_tpu.core.hessian).

`assemble_blocks` is the reference's XLA-form linearization: from the
Jacobians A [O, 2, 6], B [O, 2, 3] and the residual ex [O, 2] it forms

  U_j  = coeff * sum_{o: cam(o)=j} A_o^T A_o        [C, 6, 6]
  V_i  = coeff * sum_{o: pt(o)=i}  B_o^T B_o        [P, 3, 3]
  W_o  = coeff * A_o^T B_o                          [O, 6, 3]
  ga_j = coeff * sum_{o: cam(o)=j} A_o^T ex_o       [C, 6]
  gb_i = coeff * sum_{o: pt(o)=i}  B_o^T ex_o       [P, 3]

(coeff 1 in LM, 2 in TR). It carries the float64 path and
backend="xla"; the kernel path takes the same blocks from ops.linearize_dense
and ops.linearize_stream. The damping functions return damped copies; the
originals stay as they are.
"""

from __future__ import annotations

import torch

from psba_tpu_torch.ops.reduce import indexed_sum


def assemble_blocks(A: torch.Tensor, B: torch.Tensor, ex: torch.Tensor,
                    cam_idx, pt_idx, n_cams: int, n_pts: int, coeff=1.0,
                    valid=None):
    """Return (U [C,6,6], V [P,3,3], W [O,6,3], ga [C,6], gb [P,3]).

    One Gram G_o = [A|B|ex]^T [A|B|ex] [O, 10, 10] per observation holds
    every block; the camera pack U | ga [O, 42] and the point pack V | gb
    [O, 12] are each one fixed-order bucket sum (ops.reduce.indexed_sum).
    `valid` [O] bool zeroes the padded observations' A, B and ex first
    (the sharded path)."""
    if valid is not None:
        zero = torch.zeros((), dtype=A.dtype, device=A.device)
        A = torch.where(valid[:, None, None], A, zero)
        B = torch.where(valid[:, None, None], B, zero)
        ex = torch.where(valid[:, None], ex, zero)
    G = torch.cat([A, B, ex[:, :, None]], dim=-1)               # [O, 2, 10]
    Gram = (G[:, 0, :, None] * G[:, 0, None, :]
            + G[:, 1, :, None] * G[:, 1, None, :])              # [O, 10, 10]
    W = coeff * Gram[:, 0:6, 6:9]
    cam_pack = torch.cat([Gram[:, 0:6, 0:6].reshape(-1, 36),
                          Gram[:, 0:6, 9]], dim=-1)             # [O, 42]
    cam_red = coeff * indexed_sum(cam_pack, cam_idx, n_cams)
    pt_pack = torch.cat([Gram[:, 6:9, 6:9].reshape(-1, 9),
                         Gram[:, 6:9, 9]], dim=-1)              # [O, 12]
    pt_red = coeff * indexed_sum(pt_pack, pt_idx, n_pts)
    U = cam_red[:, :36].reshape(n_cams, 6, 6)
    V = pt_red[:, :9].reshape(n_pts, 3, 3)
    return U, V, W, cam_red[:, 36:], pt_red[:, 9:]


def damp_uv(U: torch.Tensor, V: torch.Tensor, mu):
    """Add mu to every U [C, 6, 6] / V [P, 3, 3] diagonal entry."""
    eye6 = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
    eye3 = torch.eye(V.shape[-1], dtype=V.dtype, device=V.device)
    return U + mu * eye6, V + mu * eye3


def max_diag(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """max over all U / V diagonal entries (the LM damping seed
    mu = tau * max(diag))."""
    du = torch.diagonal(U, dim1=-2, dim2=-1)
    dv = torch.diagonal(V, dim1=-2, dim2=-1)
    return torch.maximum(torch.max(du), torch.max(dv))


def damp_uv_marquardt(U: torch.Tensor, V: torch.Tensor, mu):
    """Multiplicative damping: each diagonal entry becomes d * (1 + mu);
    zero diagonals (parameters without observations) take additive mu."""
    eye6 = torch.eye(U.shape[-1], dtype=U.dtype, device=U.device)
    eye3 = torch.eye(V.shape[-1], dtype=V.dtype, device=V.device)
    du = torch.diagonal(U, dim1=-2, dim2=-1)
    dv = torch.diagonal(V, dim1=-2, dim2=-1)
    du = torch.where(du > 0.0, du, torch.ones_like(du))
    dv = torch.where(dv > 0.0, dv, torch.ones_like(dv))
    return (U + (mu * du)[..., None] * eye6,
            V + (mu * dv)[..., None] * eye3)
