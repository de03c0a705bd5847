"""The device of a call into the port.

Every entry point that builds tensors (solve, the sharded solve, the
front-end, ProblemArrays.from_problem, convert) runs on the CUDA device
unless its caller names another. Without a card that is an error naming
device="cpu", never a quiet fall-back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device, who: str,
                   what: str = "the plain PyTorch versions of the kernels"
                   ) -> torch.device:
    """`device` as a torch.device, CUDA when it is None. A CUDA device
    where torch sees none raises RuntimeError: `who` runs there by default,
    and device="cpu" runs `what` on the CPU instead."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who} runs on the CUDA device by default and torch sees no "
            f"CUDA device; pass device=\"cpu\" to run {what} on the CPU")
    return dev
