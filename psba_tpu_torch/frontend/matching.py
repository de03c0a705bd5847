"""Descriptor matching (PyTorch counterpart of
psba_tpu.frontend.matching): mutual nearest neighbour with Lowe's ratio
test.

One dense [K1, K2] similarity matrix per image pair (descriptors are
L2-normalized, so distance ranking reduces to a dot product), in full
float32 (TF32 off), then row and column argmax agreement. Fixed-size
output: a match per feature of image 1 with a validity mask.
"""

from __future__ import annotations

import torch

from psba_tpu_torch.frontend.features import fp32


def match_descriptors(d1, d2, score1=None, score2=None, ratio: float = 0.9):
    """Match rows of d1 [K, D] to d2 [K, D] (unit-norm descriptors, on one
    device).

    Returns (idx2 [K] int32, valid [K] bool): for each feature in image 1,
    its mutual nearest neighbour in image 2 passing the ratio test.
    Features with a non-positive detector score are excluded when scores
    are given. argmax takes the first maximum, as the reference's does."""
    with fp32():
        sim = d1 @ d2.T                              # [K, K] cosine
    best2 = torch.argmax(sim, dim=1)
    row = torch.max(sim, dim=1).values
    # second best for the ratio test (distance^2 = 2 - 2 sim)
    ar = torch.arange(sim.shape[0], device=sim.device)
    masked = sim.clone()
    masked[ar, best2] = -torch.inf
    second = torch.max(masked, dim=1).values
    d_best = 2.0 - 2.0 * row
    d_second = 2.0 - 2.0 * second
    ratio_ok = d_best <= (ratio * ratio) * d_second
    # mutual check
    best1 = torch.argmax(sim, dim=0)
    mutual = best1[best2] == ar
    valid = ratio_ok & mutual
    if score1 is not None:
        valid &= score1 > 0
    if score2 is not None:
        valid &= score2[best2] > 0
    return best2.to(torch.int32), valid
