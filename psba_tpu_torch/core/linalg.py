"""Dense SPD linear algebra for the reduced camera system (PyTorch
counterpart of psba_tpu.core.linalg).

Two implementations, dispatched on dtype and size:
  - float32 with n <= MAX_N: ops.cholesky.spd_solve (the hand-written
    kernel on CUDA tensors, its plain version on CPU tensors);
  - everything else: `spd_solve_xla`, the reference's XLA form
    (torch.linalg.cholesky_ex + cholesky_solve; cuSOLVER on the card).
    That is the whole float64 path, and the float32 systems above MAX_N,
    which are also counted in `spd_solve.oversized_launches`.
`spd_solve_xla.calls` counts every call of the XLA form, so a run shows
which branch it took.

Documented deviation: on ok=False the port returns x = 0, where the
reference's XLA form leaves what the failed factor gives.
"""

from __future__ import annotations

import torch

from psba_tpu_torch.ops import cholesky

MAX_N = cholesky.MAX_N


def spd_solve_xla(S: torch.Tensor, b: torch.Tensor):
    """Factor-and-solve S x = b with torch.linalg (cholesky_ex +
    cholesky_solve: the same operations as the kernel's plain version).
    Returns (x, ok); ok is False when a pivot is <= 0 or not finite, and x
    is then 0 (as is any entry of x that is not finite)."""
    spd_solve_xla.calls += 1
    return cholesky.spd_solve_plain(S, b)


spd_solve_xla.calls = 0


def spd_solve(S: torch.Tensor, b: torch.Tensor):
    """Solve S x = b for SPD S. Returns (x, ok); on ok=False, x is 0."""
    if S.dtype == torch.float32 and S.shape[0] <= MAX_N:
        return cholesky.spd_solve(S, b)
    if S.dtype == torch.float32:
        spd_solve.oversized_launches += 1
    return spd_solve_xla(S, b)


spd_solve.oversized_launches = 0
