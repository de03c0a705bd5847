"""Debug / numerical-tripwire utilities (PyTorch counterpart of
psba_tpu.utils.debug).

  - enable_nan_checks() / env_nan_checks(): JAX's per-op NaN tripwire
    (jax_debug_nans) has no torch counterpart. Here, when enabled, `solve`
    calls `check_finite` at every phase and chunk boundary (and after
    OptState.init): one host read of isfinite over cams, pts and ex_l2,
    raising FloatingPointError that names the first non-finite tensor and
    the phase. Disabled, the check returns before touching a tensor.
    PSBA_DEBUG_NANS=1 enables it through env_nan_checks (the CLI calls it).
  - first_nonfinite(tree): the first non-finite entry of a tensor, an
    array, or a dict / list / tuple of them (host side).
  - dump_blocks(...): print the first blocks of a batched block array.
"""

from __future__ import annotations

import os

import numpy as np
import torch

_enabled = False


def enable_nan_checks(enable: bool = True) -> None:
    global _enabled
    _enabled = bool(enable)


def env_nan_checks() -> bool:
    """Enable the checks when PSBA_DEBUG_NANS=1; returns whether it did."""
    if os.environ.get("PSBA_DEBUG_NANS") == "1":
        enable_nan_checks(True)
        return True
    return False


def check_finite(phase: str, **tensors) -> None:
    """When enabled: raise FloatingPointError naming the first of
    `tensors` (in the order given) that holds a non-finite value, and
    `phase`. One host read for all of them."""
    if not _enabled:
        return
    names = list(tensors)
    finite = torch.stack([
        torch.isfinite(t).all() for t in tensors.values()
    ]).cpu().numpy()
    for name, ok in zip(names, finite):
        if not ok:
            raise FloatingPointError(
                f"non-finite value in {name} at the {phase!r} boundary "
                "(PSBA_DEBUG_NANS)")


def _leaves(tree):
    """Leaves in the order jax.tree.flatten gives them (dict keys sorted)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _leaves(x)
    elif tree is not None:
        yield tree


def first_nonfinite(tree, names=None):
    """Return (name, index, value) of the first non-finite entry, or
    None."""
    leaves = list(_leaves(tree))
    paths = names or [str(i) for i in range(len(leaves))]
    for name, leaf in zip(paths, leaves):
        if isinstance(leaf, torch.Tensor):
            leaf = leaf.detach().cpu().numpy()
        arr = np.asarray(leaf)
        if not np.issubdtype(arr.dtype, np.floating):
            continue
        bad = ~np.isfinite(arr)
        if bad.any():
            idx = tuple(int(i) for i in np.argwhere(bad)[0])
            return name, idx, float(arr[idx])
    return None


def dump_blocks(arr, n=4, title="blocks"):
    """Print the first n blocks of a batched block array."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    arr = np.asarray(arr)
    print(f"== {title} {arr.shape} dtype={arr.dtype}")
    for i in range(min(n, arr.shape[0])):
        print(f"[{i}]\n{np.array2string(arr[i], precision=6)}")
    nf = first_nonfinite(arr, names=[title])
    if nf:
        print(f"!! first non-finite at {nf[1]}: {nf[2]}")
