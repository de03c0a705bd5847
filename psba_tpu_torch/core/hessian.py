"""Damping of the U / V blocks (PyTorch counterpart of the damping
functions of psba_tpu.core.hessian).

The blocks themselves come from the observation stream
(ops.linearize_stream); the reference's `assemble_blocks` belongs to the
XLA-form path and is not ported yet (ROADMAP Queue 1 item 11). Damped
copies are returned; the originals stay as they are.
"""

from __future__ import annotations

import torch


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
