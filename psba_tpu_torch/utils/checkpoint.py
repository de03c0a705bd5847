"""Checkpoint / resume of solver state.

The reference keeps parameters only in device buffers and never persists
anything (SURVEY.md §5 "Checkpoint/resume: None"); this is new
functionality. Checkpoints are written at phase boundaries (each LM/TR
run return) — the natural consistency points, since a phase is one jitted
computation.

Format: a single .npz with cams/pts/itno/flag/phase plus metadata, written
atomically (tmp + rename) so an interrupted write never corrupts the
latest checkpoint. With iteration-boundary (chunked) checkpointing the
solver's phase-scalar aux vector (OptState.aux) is stored too, so resume
is exact mid-phase (same mu/nu or delta/lambda trajectory).
"""

from __future__ import annotations

import json
import os
import tempfile

import numpy as np

FORMAT_VERSION = 1


def save(path: str, cams, pts, itno: int, flag: int, phase: str,
         extra: dict | None = None, aux=None) -> str:
    """Write a checkpoint; returns the file path."""
    os.makedirs(path, exist_ok=True)
    meta = dict(version=FORMAT_VERSION, itno=int(itno), flag=int(flag),
                phase=phase, **(extra or {}))
    fname = os.path.join(path, f"ckpt_{int(itno):05d}.npz")
    fd, tmp = tempfile.mkstemp(dir=path, suffix=".tmp")
    os.close(fd)
    arrays = dict(cams=np.asarray(cams), pts=np.asarray(pts))
    if aux is not None:
        arrays["aux"] = np.asarray(aux)
    try:
        with open(tmp, "wb") as f:
            np.savez(f, meta=json.dumps(meta), **arrays)
        os.replace(tmp, fname)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    latest = os.path.join(path, "latest")
    with open(latest + ".tmp", "w") as f:
        f.write(os.path.basename(fname))
    os.replace(latest + ".tmp", latest)
    return fname


def load_latest(path: str):
    """Return (cams, pts, meta) from the newest checkpoint, or None.
    `meta["aux"]` holds the phase-scalar vector when one was saved."""
    latest = os.path.join(path, "latest")
    if not os.path.exists(latest):
        return None
    with open(latest) as f:
        fname = f.read().strip()
    full = os.path.join(path, fname)
    if not os.path.exists(full):
        return None
    with np.load(full, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        if "aux" in z.files:
            meta["aux"] = z["aux"].copy()
        return z["cams"].copy(), z["pts"].copy(), meta
