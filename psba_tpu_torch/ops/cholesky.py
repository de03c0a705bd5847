"""Single-launch Cholesky factor and solve of the reduced camera system.

Port of psba_tpu.ops.cholesky_pallas.spd_solve_pallas. Solves S x = b for
symmetric positive definite S [n, n] and returns (x, ok): ok is False when
a pivot is <= 0 or not finite, and x is then zeroed (as is any entry of x
that is not finite).

`spd_solve` launches csrc/cholesky.cu on CUDA tensors (float32, n <= MAX_N):
one thread-block cluster whose CTAs share each 32-column panel step, with
the zeroing of x and the ok flag done in the kernel, so a call is one
launch. CPU tensors run `spd_solve_plain` (torch.linalg.cholesky_ex +
cholesky_solve). core.linalg.spd_solve sends float32 systems with n <=
MAX_N here and every other system (float64, n > MAX_N) to its XLA form.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from psba_tpu_torch.ops import _build

# the staged panel rows (N x 36 floats), the diagonal block, the right-hand
# side and a 32 x 33 column-sum table in shared memory: 160 KB at n = 1024,
# inside the 227 KB a block may use. 1024 covers C <= 170 cameras.
MAX_N = 1024
PANEL = 32


def spd_solve_plain(S: torch.Tensor, b: torch.Tensor):
    """Plain PyTorch factor-and-solve with the kernel's (x, ok) contract."""
    L, info = torch.linalg.cholesky_ex(S)
    d = torch.diagonal(L)
    ok = (info == 0) & torch.all(torch.isfinite(d) & (d > 0.0))
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(ok & torch.isfinite(x), x, torch.zeros_like(x)), ok


@functools.cache
def _kernel():
    lib = _build.library("cholesky")
    if lib.psba_spd_solve_max_n() != MAX_N:
        raise RuntimeError("cholesky.cu MAX_N differs from "
                           "psba_tpu_torch.ops.cholesky.MAX_N")
    max_cluster = lib.psba_spd_solve_max_cluster()
    if max_cluster < 1:
        raise RuntimeError("spd_solve: the device schedules no cluster of "
                           "the cholesky.cu kernel")
    fn = lib.psba_spd_solve
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int
    return fn, max_cluster


def max_cluster() -> int:
    """The largest cluster of the kernel the device schedules (at most 16)."""
    return _kernel()[1]


def cluster_size(n: int, max_cluster: int) -> int:
    """CTAs of the launch for an n x n system: one per 32-column panel, at
    most the device's largest cluster."""
    return max(1, min(max_cluster, -(-n // PANEL)))


def spd_solve(S: torch.Tensor, b: torch.Tensor):
    """Solve S x = b (SPD). Returns (x [n], ok 0-d bool tensor).

    CPU tensors run the plain version; CUDA tensors (float32, contiguous,
    n <= MAX_N) launch csrc/cholesky.cu with cluster_size(n, the device's
    largest cluster) CTAs and count one launch."""
    if S.device.type == "cpu":
        return spd_solve_plain(S, b)
    return _launch(S, b)


def _launch(S, b, cs: int | None = None):
    """One launch of the kernel (counted) on a cluster of `cs` CTAs, by
    default cluster_size(n, the device's largest cluster)."""
    dev = _build.cuda_inputs("spd_solve", S=S, b=b)
    n = S.shape[0]
    if S.shape != (n, n) or b.shape != (n,):
        raise ValueError(f"spd_solve: S {tuple(S.shape)}, b {tuple(b.shape)}")
    if not 1 <= n <= MAX_N:
        raise ValueError(f"spd_solve: kernel takes 1 <= n <= {MAX_N}, got {n}")
    fn, max_cs = _kernel()
    if cs is None:
        cs = cluster_size(n, max_cs)
    if not 1 <= cs <= max_cs:
        raise ValueError(f"spd_solve: cluster {cs} not in 1..{max_cs}")
    N = -(-n // PANEL) * PANEL
    work = torch.empty((N * N + 33 * N,), dtype=torch.float32, device=dev)
    status = torch.empty((1,), dtype=torch.int32, device=dev)
    x = torch.empty((n,), dtype=torch.float32, device=dev)
    ok = torch.empty((), dtype=torch.bool, device=dev)
    err = fn(S.data_ptr(), b.data_ptr(), n, cs, work.data_ptr(),
             status.data_ptr(), x.data_ptr(), ok.data_ptr(),
             torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "spd_solve")
    spd_solve.launches += 1
    return x, ok


spd_solve.launches = 0
