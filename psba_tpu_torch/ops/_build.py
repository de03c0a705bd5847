"""Build and load the port's CUDA kernels.

Each `psba_tpu_torch/csrc/<name>.cu` is compiled with nvcc into its own
shared library with a plain C interface and loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -o build/psba_tpu_torch/<name>-<hash>.so <name>.cu

The file name carries a hash of the sources, the headers and the flags, so a
changed source rebuilds and an unchanged one loads from disk. All sources
build at once, one nvcc process each, on the first call to `library`. There
is no fallback: a missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "psba_tpu_torch"
SOURCES = ("linearize_dense", "cholesky", "gain_dense", "linearize_stream",
           "jgram_dense", "residual_l2", "schur_pairs")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError(
        "nvcc not found (PATH or /usr/local/cuda/bin): the port's CUDA "
        "kernels are built from psba_tpu_torch/csrc at first use"
    )


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(verbose: bool = True) -> float:
    """Compile every stale kernel library, all in parallel. Returns the
    wall seconds spent (0.0 when everything was up to date)."""
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return 0.0
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if verbose:
        ver = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
        print(f"[psba_tpu_torch] nvcc: {ver.splitlines()[-1]}", flush=True)
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        out = _target(name)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}.cu (exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
        if verbose:
            for line in log.splitlines():
                if "Used" in line or "spill" in line:
                    print(f"[psba_tpu_torch] {name}: {line.strip()}",
                          flush=True)
    secs = time.perf_counter() - t0
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    if verbose:
        print(f"[psba_tpu_torch] built {', '.join(todo)} in {secs:.1f} s",
              flush=True)
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, building the kernels if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build()
        lib = ctypes.CDLL(str(_target(name)))
        _loaded[name] = lib
    return lib


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on the CUDA `device`, read
    without building a torch.cuda.Stream object."""
    index = torch.cuda.current_device() if device.index is None else (
        device.index)
    return torch._C._cuda_getCurrentRawStream(index)


_workspaces: dict[tuple[str, torch.device], torch.Tensor] = {}


def workspace(what: str, device: torch.device, n: int) -> torch.Tensor:
    """A zeroed int32 tensor of at least n entries on `device`, kept for the
    kernel `what` from call to call: the integer ticket by which its last
    block finds itself, which the kernel leaves at zero, and its scratch.
    Calls of one kernel share it, so they must run on one stream."""
    ws = _workspaces.get((what, device))
    if ws is None or ws.numel() < n:
        ws = torch.zeros(n, dtype=torch.int32, device=device)
        _workspaces[what, device] = ws
    return ws


def check(err: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def cuda_inputs(what: str, **tensors) -> torch.device:
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA
    device; returns that device."""
    dev = None
    for name, t in tensors.items():
        if dev is None:
            dev = t.device
            if dev.type != "cuda":
                raise ValueError(f"{what}: takes CPU or CUDA tensors, got "
                                 f"{dev}")
        elif t.device != dev:
            devs = sorted({str(x.device) for x in tensors.values()})
            raise ValueError(f"{what}: tensors on several devices {devs}")
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev


def carve(device: torch.device, *shapes) -> list[torch.Tensor]:
    """Contiguous float32 tensors of the given shapes on `device`, cut from
    one allocation: one torch.empty and a view each (on the card an
    allocation costs several times a view in host time)."""
    sizes = [math.prod(s) for s in shapes]
    buf = torch.empty((sum(sizes),), dtype=torch.float32, device=device)
    out, off = [], 0
    for shape, n in zip(shapes, sizes):
        strides, step = [], 1
        for d in reversed(shape):
            strides.append(step)
            step *= d
        out.append(buf.as_strided(shape, strides[::-1], off))
        off += n
    return out
