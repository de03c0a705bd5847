"""Gill–Murray–Wright modified Cholesky, diagonal perturbation only
(PyTorch counterpart of psba_tpu.core.gmw).

When the Cholesky factor of S fails at lambda = 0, the TR solver runs a GMW
factorization A + E = L D L^T with a diagonal E >= 0 and bootstraps the
regularizer as lambda = |sum(E)| / n. Only E is used; the factor is
discarded, as in the reference.

  eta  = max |diag(A)|,  xi = max |offdiag(A)|
  delta = 1e-15 * max(xi + eta, 1)
  beta^2 = max(eta, xi / sqrt(n^2 - 1), 1e-15)

Plain torch on the solver's device: a Python loop over columns (full-matrix
rank-1 updates), or over 16-column panels with one matrix product per
panel above BLOCKED_GMW_MIN_N. Off the hot path: it runs only when the
Cholesky fails at lambda = 0.
"""

from __future__ import annotations

import math

import torch


def gmw_delta_beta(A: torch.Tensor):
    """(delta, beta^2) as 0-d tensors of A's dtype."""
    n = A.shape[0]
    diag = torch.diagonal(A)
    eta = torch.max(torch.abs(diag))
    xi = torch.max(torch.abs(A - torch.diag(diag)))
    delta = 1e-15 * torch.clamp(xi + eta, min=1.0)
    beta2 = torch.clamp(
        torch.maximum(eta, xi / math.sqrt(float(n * n - 1))), min=1e-15
    )
    return delta, beta2


def gmw_perturbation(A: torch.Tensor) -> torch.Tensor:
    """The GMW diagonal perturbation E [n] with A + E = L D L^T."""
    n = A.shape[0]
    delta, beta2 = gmw_delta_beta(A)
    idx = torch.arange(n, device=A.device)
    c = A.clone()
    E = torch.zeros(n, dtype=A.dtype, device=A.device)
    for j in range(n):
        col = torch.where(idx > j, c[:, j], torch.zeros_like(c[:, j]))
        theta = torch.max(torch.abs(col))
        cjj = c[j, j]
        dj = torch.maximum(
            torch.maximum(torch.abs(cjj), theta * theta / beta2), delta
        )
        E[j] = dj - cjj
        # col is zero at and above j: the update touches rows/cols > j only
        c = c - torch.outer(col, col) / dj
    return E


def gmw_perturbation_blocked(A: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Blocked right-looking GMW: the same E as gmw_perturbation.

    Columns inside an [n, block] panel are factored with rank-1 updates
    restricted to the panel; the trailing matrix takes the whole panel's
    update as one [n, block] @ [block, n] product."""
    n = A.shape[0]
    nb = (n + block - 1) // block
    np_ = nb * block
    # identity tail: the extra columns factor trivially (d_j = 1, E_j = 0)
    Ap = torch.eye(np_, dtype=A.dtype, device=A.device)
    Ap[:n, :n] = A
    delta, beta2 = gmw_delta_beta(A)
    idx = torch.arange(np_, device=A.device)
    bidx = torch.arange(block, device=A.device)
    c = Ap
    E = torch.zeros(np_, dtype=A.dtype, device=A.device)
    for kb in range(nb):
        k = kb * block
        panel = c[:, k:k + block].clone()
        Pm = torch.zeros((np_, block), dtype=A.dtype, device=A.device)
        dinv = torch.zeros(block, dtype=A.dtype, device=A.device)
        for j in range(block):
            gj = k + j
            col = torch.where(idx > gj, panel[:, j],
                              torch.zeros_like(panel[:, j]))
            theta = torch.max(torch.abs(col))
            cjj = panel[gj, j]
            dj = torch.maximum(
                torch.maximum(torch.abs(cjj), theta * theta / beta2), delta
            )
            E[gj] = dj - cjj
            upd = torch.outer(col, col[k:k + block] / dj)
            panel = panel - torch.where((bidx > j)[None, :], upd,
                                        torch.zeros_like(upd))
            Pm[:, j] = col
            dinv[j] = 1.0 / dj
        trail = (idx[None, :] >= k + block).to(A.dtype)
        c = c - ((Pm * dinv[None, :]) @ Pm.T) * trail
    return E[:n]


BLOCKED_GMW_MIN_N = 128  # below it the column recurrence is kept


def gmw_bootstrap_lambda(A: torch.Tensor) -> torch.Tensor:
    """lambda = |sum(E)| / n, a 0-d tensor."""
    n = A.shape[0]
    E = (gmw_perturbation_blocked(A) if n > BLOCKED_GMW_MIN_N
         else gmw_perturbation(A))
    return torch.abs(torch.sum(E)) / n
