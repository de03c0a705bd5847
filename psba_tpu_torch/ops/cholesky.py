"""Single-launch Cholesky factor and solve of the reduced camera system.

Port of psba_tpu.ops.cholesky_pallas.spd_solve_pallas. Solves S x = b for
symmetric positive definite S [n, n] and returns (x, ok): ok is False when
a pivot is <= 0 or not finite, and x is then zeroed.

`spd_solve` launches csrc/cholesky.cu on CUDA tensors (float32, n <= MAX_N)
and runs `spd_solve_plain` (torch.linalg.cholesky_ex + cholesky_solve) on
CPU tensors. Callers with n > MAX_N go through core.linalg.spd_solve, which
sends them to the plain version explicitly.
"""

from __future__ import annotations

import ctypes

import torch

from psba_tpu_torch.ops import _build

# the panel (n x 36 floats), the transposed diagonal block and two
# n-vectors in shared memory: 157 KB at n = 1024, inside the 227 KB a block
# may use. 1024 covers C <= 170 cameras.
MAX_N = 1024


def spd_solve_plain(S: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch factor-and-solve with the kernel's (x, ok) contract."""
    L, info = torch.linalg.cholesky_ex(S)
    d = torch.diagonal(L)
    ok = (info == 0) & torch.all(torch.isfinite(d) & (d > 0.0))
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(ok & torch.isfinite(x), x, torch.zeros_like(x)), ok


def _kernel():
    lib = _build.library("cholesky")
    if lib.psba_spd_solve_max_n() != MAX_N:
        raise RuntimeError("cholesky.cu MAX_N differs from "
                           "psba_tpu_torch.ops.cholesky.MAX_N")
    fn = lib.psba_spd_solve
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int] + (
        [ctypes.c_void_p] * 4
    )
    fn.restype = ctypes.c_int
    return fn


def spd_solve(S: torch.Tensor, b: torch.Tensor):
    """Solve S x = b (SPD). Returns (x [n], ok 0-d bool tensor).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    n <= MAX_N) launch csrc/cholesky.cu and count one launch."""
    if S.device.type == "cpu":
        return spd_solve_plain(S, b)
    dev = _build.cuda_inputs("spd_solve", S=S, b=b)
    n = S.shape[0]
    if S.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"spd_solve: S {tuple(S.shape)}, b {tuple(b.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"spd_solve: kernel takes 1 <= n <= {MAX_N}, got {n}")
    fn = _kernel()
    work = torch.empty((n, n), dtype=torch.float32, device=dev)
    x = torch.empty((n,), dtype=torch.float32, device=dev)
    ok = torch.empty((1,), dtype=torch.int32, device=dev)
    err = fn(S.data_ptr(), b.data_ptr(), n, work.data_ptr(), x.data_ptr(),
             ok.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spd_solve")
    spd_solve.launches += 1
    okb = ok[0] > 0
    return torch.where(okb & torch.isfinite(x), x, torch.zeros_like(x)), okb


spd_solve.launches = 0
