"""Indexed (bucket) sums (PyTorch counterpart of psba_tpu.ops.reduce).

The reference lowers `indexed_sum` to a one-hot matmul on the TPU and to a
scatter segment-sum elsewhere. The port takes `index_add_` on the CPU (one
pass in index order) and `index_put_(accumulate=True)` on the card, which
sorts the indices (stably) and adds each bucket's terms in a fixed order:
`index_add_` on CUDA uses float atomics, so the float32 rounding of its sums
would change from run to run, and with it every solve that reads S.
"""

from __future__ import annotations

import torch


def indexed_sum(data: torch.Tensor, idx: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """sum_{n: idx[n] = s} data[n] -> [n_segments, ...], the same bits on
    every call.

    Out-of-range indices (padding markers such as the pair list's bucket
    C*C) add nothing, as jax.ops.segment_sum drops them: they go to one
    extra row that is cut off."""
    idx = idx.long()
    inside = (idx >= 0) & (idx < n_segments)
    idx = torch.where(inside, idx, torch.full_like(idx, n_segments))
    out = torch.zeros((n_segments + 1,) + tuple(data.shape[1:]),
                      dtype=data.dtype, device=data.device)
    if data.device.type == "cpu":
        out.index_add_(0, idx, data)
    else:
        out.index_put_((idx,), data, accumulate=True)
    return out[:n_segments]
