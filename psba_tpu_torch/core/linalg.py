"""Dense SPD linear algebra for the reduced camera system (PyTorch
counterpart of psba_tpu.core.linalg).

The dispatch is by size only: n <= MAX_N goes to ops.cholesky.spd_solve
(the hand-written kernel on CUDA tensors, its plain version on CPU
tensors); a larger system goes to torch.linalg.cholesky_ex +
cholesky_solve, the reference's own oversized branch, and is counted in
`spd_solve.oversized_launches` so a run shows which branch it took.
"""

from __future__ import annotations

import torch

from psba_tpu_torch.ops import cholesky

MAX_N = cholesky.MAX_N


def spd_solve(S: torch.Tensor, b: torch.Tensor):
    """Solve S x = b for SPD S. Returns (x, ok); on ok=False, x is 0."""
    if S.shape[0] <= MAX_N:
        return cholesky.spd_solve(S, b)
    spd_solve.oversized_launches += 1
    return cholesky.spd_solve_plain(S, b)


spd_solve.oversized_launches = 0
