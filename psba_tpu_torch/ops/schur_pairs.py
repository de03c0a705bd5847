"""The pair products of the Schur complement, summed by camera pair.

For the covisibility-pair list (problem.build_covis_pairs, sorted by bucket
cam(o1) * C + cam(o2)) and the per-observation blocks Y, W [O, 6, 3]:

  S_off[6k + i, 6l + j] = - sum_{(o1, o2) in bucket kC+l} (Y_o1 W_o2^T)[i, j]

returned as S_off [6C, 6C], in the layout of S; core.schur.schur_S adds U
on its diagonal blocks. `pair_start` [C*C + 1] (pair_offsets,
ProblemArrays.pair_start) gives each bucket's first pair and, last, the end
of the real pairs: padding (bucket C*C) lies past it and adds nothing.

`schur_pairs` launches csrc/schur_pairs.cu on CUDA tensors (float32): a
group of lanes per bucket (eight, or the whole warp on a tile of four
buckets with one above 128 pairs) sums its pairs' products in registers in
an order fixed by the offsets, so no per-pair tensor is made and two calls
give the same bits. CPU tensors run `schur_pairs_plain` over the list's
own buckets: a batched product over the pairs and a bucket sum, which is
also the path of the XLA form.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from psba_tpu_torch.ops import _build
from psba_tpu_torch.ops.reduce import indexed_sum


def pair_offsets(bucket: torch.Tensor, n_cams: int) -> torch.Tensor:
    """pair_start [C*C + 1] int64 on the device of `bucket`, the pair list's
    buckets: the first pair of each bucket and, last, the first padding
    entry (bucket C*C) or N, by torch.searchsorted there. Raises unless the
    list is non-decreasing (one bool read back)."""
    if bool((bucket[1:] < bucket[:-1]).any()):
        raise ValueError("pair list not sorted by bucket: the pair kernel "
                         "reads each bucket as one run")
    cc = n_cams * n_cams
    return torch.searchsorted(
        bucket, torch.arange(cc + 1, dtype=bucket.dtype,
                             device=bucket.device))


def schur_pairs_plain(Y, W, pair_o1, pair_o2, pair_bucket, n_cams: int):
    """Plain PyTorch version (any dtype, any device, any order of the
    list; buckets outside [0, C*C) add nothing): one batched product over
    the pairs, [N, 6, 6], and one bucket sum, ops.reduce.indexed_sum."""
    C = n_cams
    contrib = torch.matmul(Y[pair_o1], W[pair_o2].transpose(1, 2))
    off = indexed_sum(contrib.reshape(-1, 36), pair_bucket, C * C)
    return (-off).reshape(C, C, 6, 6).permute(0, 2, 1, 3).reshape(6 * C,
                                                                   6 * C)


@functools.cache
def _kernel():
    fn = _build.library("schur_pairs").psba_schur_pairs
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] + (
        [ctypes.c_void_p] * 2)
    fn.restype = ctypes.c_int
    return fn


def schur_pairs(Y, W, pair_o1, pair_o2, pair_bucket, pair_start,
                n_cams: int):
    """S_off [6C, 6C] of the module docstring.

    CPU tensors run the plain version over pair_bucket. CUDA tensors (Y, W
    float32, contiguous, 8-byte aligned; pair_o1, pair_o2 [N] and
    pair_start [C*C + 1] contiguous int64, observation numbers below O)
    launch csrc/schur_pairs.cu, which reads pair_start in place of
    pair_bucket, and count one launch."""
    if Y.device.type == "cpu":
        return schur_pairs_plain(Y, W, pair_o1, pair_o2, pair_bucket, n_cams)
    dev = _build.cuda_inputs("schur_pairs", Y=Y, W=W)
    C, O, N = n_cams, Y.shape[0], pair_o1.shape[0]
    if (C < 1 or Y.shape != (O, 6, 3) or W.shape != (O, 6, 3)
            or pair_o2.shape != (N,) or pair_start.shape != (C * C + 1,)):
        raise ValueError("schur_pairs: inconsistent shapes")
    if Y.data_ptr() % 8 or W.data_ptr() % 8:
        raise ValueError("schur_pairs: Y and W must be 8-byte aligned")
    for name, t in (("pair_o1", pair_o1), ("pair_o2", pair_o2),
                    ("pair_start", pair_start)):
        if (t.device != dev or t.dtype != torch.int64
                or not t.is_contiguous()):
            raise ValueError(f"schur_pairs: {name} must be a contiguous "
                             f"int64 tensor on {dev}")
    S = torch.empty((6 * C, 6 * C), dtype=torch.float32, device=dev)
    err = _kernel()(Y.data_ptr(), W.data_ptr(), pair_o1.data_ptr(),
                    pair_o2.data_ptr(), pair_start.data_ptr(), C,
                    S.data_ptr(), _build.stream(dev))
    _build.check(err, "schur_pairs")
    schur_pairs.launches += 1
    return S


schur_pairs.launches = 0
