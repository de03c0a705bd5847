"""ctypes bindings to the native C++ problem reader (native/loader.cpp),
the port's counterpart of psba_tpu.io.native.

Reading a large points file is the one host-bound step of problem set-up;
the C++ parser reads the SBA points text and raw BAL files in one pass.
This module builds native/loader.cpp as it stands, at first use, with

    g++ -O3 -shared -fPIC -std=c++17 -o build/psba_tpu_torch/libpsba_io-<hash>.so

(the hash covers the source and the flags, as ops/_build.py keys the CUDA
kernels; nothing is written into native/). `available()` says whether the
library is loaded or could be built; where it cannot (no g++, a failed
build), io.bal.read_bal and io.sba_text.read_pts use their numpy parsers,
and `reader()` names which one runs. This is host I/O, not a device
kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "psba_tpu_torch"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_lib = None
_failed = None   # why the library could not be built, once tried


def library_path() -> Path:
    """Where the library for the current source and flags lives."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libpsba_io-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile native/loader.cpp unless its library is up to date; returns
    the library's path. Raises RuntimeError without g++ or on a failed
    build."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed (exit {res.returncode}):\n"
                           f"{res.stderr}")
    os.replace(tmp, out)
    return out


def _load():
    global _lib, _failed
    if _lib is not None or _failed is not None:
        return _lib
    try:
        lib = ctypes.CDLL(str(build()))
    except (RuntimeError, OSError) as e:
        _failed = str(e)
        return None
    L, I, D = ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_double)
    pL, pI = ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_int)
    lib.psba_count_pts.restype = ctypes.c_int
    lib.psba_count_pts.argtypes = [ctypes.c_char_p, pL, pL, pI]
    lib.psba_read_pts.restype = ctypes.c_int
    # path, P, O, cov kind, n_cams, pts [P*3], obs [O*2], cam_idx [O],
    # pt_idx [O], cov [O*4] or NULL
    lib.psba_read_pts.argtypes = [ctypes.c_char_p, L, L, I, L, D, D, pI, pI,
                                  D]
    lib.psba_read_bal_header.restype = ctypes.c_int
    lib.psba_read_bal_header.argtypes = [ctypes.c_char_p, pL, pL, pL]
    lib.psba_read_bal.restype = ctypes.c_int
    # path, C, P, O, cam_params [C*9], pts [P*3], obs [O*2], cam_idx [O],
    # pt_idx [O]
    lib.psba_read_bal.argtypes = [ctypes.c_char_p, L, L, L, D, D, D, pI, pI]
    _lib = lib
    return lib


def available() -> bool:
    """True when the native reader is loaded or could be built now."""
    return _load() is not None


def reader() -> str:
    """Which reader io.bal.read_bal / io.sba_text.read_pts use, for a
    run's summary: the native library's path, or numpy and why."""
    if available():
        return f"native ({library_path()})"
    return f"numpy (native reader unavailable: {_failed.splitlines()[0]})"


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def _iptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def read_bal(path: str, dtype=np.float64):
    """Raw BAL file -> (cam_params [C,9], pts [P,3], obs [O,2], cam_idx,
    pt_idx), the contract of io.bal.read_bal."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reader unavailable: {_failed}")
    nc, np_, no = ctypes.c_long(), ctypes.c_long(), ctypes.c_long()
    rc = lib.psba_read_bal_header(path.encode(), ctypes.byref(nc),
                                  ctypes.byref(np_), ctypes.byref(no))
    if rc != 0:
        raise IOError(f"native BAL header parse failed ({rc}) for {path}")
    C, P, O = nc.value, np_.value, no.value
    cam_params = np.empty((C, 9), np.float64)
    pts = np.empty((P, 3), np.float64)
    obs = np.empty((O, 2), np.float64)
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    rc = lib.psba_read_bal(path.encode(), C, P, O, _dptr(cam_params),
                           _dptr(pts), _dptr(obs), _iptr(cam_idx),
                           _iptr(pt_idx))
    if rc != 0:
        raise IOError(f"native BAL read failed ({rc}) for {path}")
    if dtype != np.float64:
        cam_params = cam_params.astype(dtype)
        pts, obs = pts.astype(dtype), obs.astype(dtype)
    return cam_params, pts, obs, cam_idx, pt_idx


def read_pts(path: str, n_cams: int, dtype=np.float64):
    """SBA points file -> (pts [P,3], obs [O,2], cam_idx [O], pt_idx [O],
    cov [O,2,2] or None), the contract of io.sba_text.read_pts."""
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reader unavailable: {_failed}")
    n_pts, n_obs, cov_kind = ctypes.c_long(), ctypes.c_long(), ctypes.c_int()
    rc = lib.psba_count_pts(path.encode(), ctypes.byref(n_pts),
                            ctypes.byref(n_obs), ctypes.byref(cov_kind))
    if rc != 0:
        raise IOError(f"native count failed ({rc}) for {path}")
    P, O = n_pts.value, n_obs.value
    pts = np.empty((P, 3), np.float64)
    obs = np.empty((O, 2), np.float64)
    cam_idx = np.empty(O, np.int32)
    pt_idx = np.empty(O, np.int32)
    cov = np.empty((O, 2, 2), np.float64) if cov_kind.value else None
    rc = lib.psba_read_pts(path.encode(), P, O, cov_kind.value, n_cams,
                           _dptr(pts), _dptr(obs), _iptr(cam_idx),
                           _iptr(pt_idx),
                           _dptr(cov) if cov is not None else None)
    if rc != 0:
        raise IOError(f"native read failed ({rc}) for {path}")
    if dtype != np.float64:
        pts, obs = pts.astype(dtype), obs.astype(dtype)
        cov = None if cov is None else cov.astype(dtype)
    return pts, obs, cam_idx, pt_idx, cov
