"""Indexed (bucket) sums (PyTorch counterpart of psba_tpu.ops.reduce).

The reference lowers `indexed_sum` to a one-hot matmul on the TPU and to a
scatter segment-sum elsewhere; on the card and on the CPU the port takes
`index_add_`. On CUDA that uses float atomics, so the order of the terms,
and the float32 rounding of the sums, changes from run to run.
"""

from __future__ import annotations

import torch


def indexed_sum(data: torch.Tensor, idx: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """sum_{n: idx[n] = s} data[n] -> [n_segments, ...].

    Out-of-range indices (padding markers such as the pair list's bucket
    C*C) add nothing, as jax.ops.segment_sum drops them: they go to one
    extra row that is cut off."""
    idx = idx.long()
    inside = (idx >= 0) & (idx < n_segments)
    idx = torch.where(inside, idx, torch.full_like(idx, n_segments))
    out = torch.zeros((n_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    out.index_add_(0, idx, data)
    return out[:n_segments]
