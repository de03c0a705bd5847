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
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "psba_tpu_torch"
SOURCES = ("linearize_dense", "cholesky", "gain_dense", "linearize_stream",
           "jgram_dense", "residual_l2")
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


def check(err: int, what: str) -> None:
    """Raise when a C launcher returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")


def cuda_inputs(what: str, **tensors) -> torch.device:
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA
    device; returns that device."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{what}: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type != "cuda":
        raise ValueError(f"{what}: takes CPU or CUDA tensors, got {dev}")
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{what}: {name} must be float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    return dev
