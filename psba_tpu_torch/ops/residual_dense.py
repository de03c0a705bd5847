"""Dense-grid trial-step gain and Jacobian Gram matrix.

Ports of psba_tpu.ops.residual_dense.gain_dense_pallas and
jgram_dense_pallas. The LM / TR acceptance test needs two scalars per trial
step:

  gain   = sum over observed cells of (eo - en)(eo + en)
  new_l2 = sum over observed cells of en^2

with eo / en the residuals at the old and the new parameters. The factored
form is exact in real numbers and keeps the difference of two nearly equal
sums meaningful in float32 near convergence. No [O, 2] residual is stored.

The TR phase needs the curvature of its model along a few directions x_a
(camera parts [C, 6], point parts [P, 3]; stacked, dirs_c [n, C, 6] and
planar dirs_p [n, 3, Pd], or as sequences):

  G[a, b] = <J x_a, J x_b>

summed cell by cell over the products of the per-residual-row terms J x,
the conditioning of the reference's explicit J p; the algebraically equal
block form x^T [[U, W], [W^T, V]] x cancels in float32 when |J x| is small.

`gain_dense` / `jgram_dense` launch csrc/gain_dense.cu / csrc/jgram_dense.cu
on CUDA tensors (float32) and run `gain_dense_plain` / `jgram_dense_plain`
on CPU tensors. Both take the occupancy table `tile_mask` of
ops.linearize_dense (build_tile_mask) and skip the (camera, tile) pairs
whose bit is 0; the plain versions apply it to the validity table.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from psba_tpu_torch.ops import _build
from psba_tpu_torch.ops.linearize_dense import (
    CAM_CHUNK,
    PTILE,
    _cell_model,
    camera_rows,
    cell_residual,
    mask_pointer,
    masked_valid,
)

# largest number of directions jgram_dense takes (TR uses 1 and 2)
JGRAM_MAX_N = 4


def gain_dense_plain(K, q0, cams, pts, new_cams, new_pts, obs_du, obs_dv,
                     valid_d, clamp=False, tile_mask=None):
    """Plain PyTorch version: returns (gain, new_l2) as 0-d tensors."""
    valid_d = masked_valid(valid_d, tile_mask)
    xo = pts.T
    xn = new_pts.T
    eou, eov = cell_residual(camera_rows(K, q0, cams), xo[0:1], xo[1:2],
                             xo[2:3], obs_du, obs_dv, valid_d, clamp)
    enu, env = cell_residual(camera_rows(K, q0, new_cams), xn[0:1],
                             xn[1:2], xn[2:3], obs_du, obs_dv, valid_d,
                             clamp)
    gain = ((eou - enu) * (eou + enu) + (eov - env) * (eov + env)).sum()
    return gain, (enu * enu + env * env).sum()


@functools.cache
def _kernel():
    """(the launcher, blocks the current device holds resident at once: the
    kernel's largest grid)."""
    lib = _build.library("gain_dense")
    if (lib.psba_gain_dense_ptile() != PTILE
            or lib.psba_gain_dense_cam_chunk() != CAM_CHUNK):
        raise RuntimeError("gain_dense.cu tile constants differ from "
                           "psba_tpu_torch.ops.linearize_dense")
    blocks = lib.psba_gain_dense_resident_blocks()
    if blocks < 1:
        raise RuntimeError("gain_dense: no block of the kernel fits the "
                           "device")
    fn = lib.psba_gain_dense
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 + (
        [ctypes.c_void_p] * 3
    )
    fn.restype = ctypes.c_int
    return fn, blocks


def gain_dense(K, q0, cams, pts, new_cams, new_pts, obs_du, obs_dv, valid_d,
               clamp=False, kq=None, tile_mask=None):
    """Trial-step (gain, new_l2) on the dense grid, as 0-d tensors.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch csrc/gain_dense.cu, which sums to the two scalars itself, and
    count one launch. `kq` is the [C, 9] camera rows K | q0
    (ProblemArrays.kq), built here when not given; `tile_mask` as for
    linearize_dense."""
    if valid_d.device.type == "cpu":
        return gain_dense_plain(K, q0, cams, pts, new_cams, new_pts, obs_du,
                                obs_dv, valid_d, clamp=clamp,
                                tile_mask=tile_mask)
    if kq is None:
        kq = torch.cat([K, q0], dim=1)
    dev = _build.cuda_inputs(
        "gain_dense", kq=kq, cams=cams, pts=pts, new_cams=new_cams,
        new_pts=new_pts, obs_du=obs_du, obs_dv=obs_dv, valid_d=valid_d,
    )
    C, P = valid_d.shape
    if (kq.shape != (C, 9) or cams.shape != (C, 6)
            or new_cams.shape != (C, 6) or pts.shape != (P, 3)
            or new_pts.shape != (P, 3) or obs_du.shape != (C, P)
            or obs_dv.shape != (C, P)):
        raise ValueError("gain_dense: inconsistent shapes")
    mask = mask_pointer("gain_dense", tile_mask, dev, C, P)
    fn, blocks = _kernel()
    ws = _build.workspace("gain_dense", dev, 1 + 2 * blocks)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), new_cams.data_ptr(),
        new_pts.data_ptr(), obs_du.data_ptr(), obs_dv.data_ptr(),
        valid_d.data_ptr(), mask, C, P, int(bool(clamp)), blocks,
        ws.data_ptr(), out.data_ptr(), _build.stream(dev),
    )
    _build.check(err, "gain_dense")
    gain_dense.launches += 1
    return out.unbind()


gain_dense.launches = 0


def _sym(tri, n):
    """Upper-triangle entries (row-major) -> symmetric [n, n], a stack of
    views (no index tensor copied to the device)."""
    idx, pos = {}, 0
    for a in range(n):
        for b in range(a, n):
            idx[a, b] = idx[b, a] = pos
            pos += 1
    return torch.stack([tri[idx[a, b]] for a in range(n)
                        for b in range(n)]).reshape(n, n)


def _directions(dirs_c, dirs_p):
    """[(dc [C, 6], dp [3, >= P] rows)] per direction, from the stacked form
    (dirs_c [n, C, 6], dirs_p [n, 3, Pd], Pd >= P) or the sequence form (n
    tensors [C, 6], n tensors [P, 3]); the point parts are views."""
    if isinstance(dirs_c, torch.Tensor):
        return [(dirs_c[a], dirs_p[a]) for a in range(dirs_c.shape[0])]
    if len(dirs_c) != len(dirs_p):
        raise ValueError(f"jgram_dense: {len(dirs_c)} camera parts, "
                         f"{len(dirs_p)} point parts")
    return [(dc, dp.T) for dc, dp in zip(dirs_c, dirs_p)]


def jgram_dense_plain(K, q0, cams, pts, valid_d, dirs_c, dirs_p,
                      clamp=False, tile_mask=None):
    """Plain PyTorch version: G [n, n] with G[a, b] = <J x_a, J x_b> over the
    observed cells of the [C, P] grid; the directions in either form of
    jgram_dense (padded lanes of a stacked dirs_p are ignored)."""
    valid_d = masked_valid(valid_d, tile_mask)
    C, P = valid_d.shape
    x = pts.T
    zero = torch.zeros_like(valid_d)
    A, B, _exu, _exv = _cell_model(camera_rows(K, q0, cams), x[0:1], x[1:2],
                                   x[2:3], zero, zero, valid_d, clamp)
    jx = []
    for dc, dp in _directions(dirs_c, dirs_p):
        dp = dp[:, :P]
        jx.append([
            sum(A[r][i] * dc[:, i:i + 1] for i in range(6))
            + sum(B[r][k] * dp[k:k + 1] for k in range(3))
            for r in range(2)
        ])
    n = len(jx)
    tri = torch.stack([
        (jx[a][0] * jx[b][0] + jx[a][1] * jx[b][1]).sum()
        for a in range(n) for b in range(a, n)
    ])
    return _sym(tri, n)


@functools.cache
def _jgram_kernel():
    lib = _build.library("jgram_dense")
    if (lib.psba_jgram_dense_cam_chunk() != CAM_CHUNK
            or lib.psba_jgram_dense_max_n() != JGRAM_MAX_N):
        raise RuntimeError("jgram_dense.cu constants differ from "
                           "psba_tpu_torch.ops.residual_dense")
    fn = lib.psba_jgram_dense
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 13 + [
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _jgram_blocks(n: int) -> int:
    """Blocks of the n-direction kernel the current device holds resident
    at once."""
    blocks = _build.library("jgram_dense").psba_jgram_dense_resident_blocks(n)
    if blocks < 1:
        raise RuntimeError("jgram_dense: no block of the kernel fits the "
                           "device")
    return blocks


def jgram_dense(K, q0, cams, pts, valid_d, dirs_c, dirs_p, clamp=False,
                kq=None, tile_mask=None):
    """G [n, n] = <J x_a, J x_b> on the dense grid (coefficient-free: the
    TR scalars of B = 2 J^T J are 2 G). The directions come stacked,
    dirs_c [n, C, 6] and dirs_p [n, 3, Pd] with Pd >= P (the planar width
    of linearize_dense, or P), or as sequences of n camera parts [C, 6]
    and n point parts [P, 3] (any strides), which the kernel reads in
    place.

    CPU tensors run the plain version. CUDA tensors (float32, the camera
    parts contiguous, n <= JGRAM_MAX_N) launch csrc/jgram_dense.cu, which
    writes the symmetric G itself, and count one launch; `kq` and
    `tile_mask` as for gain_dense."""
    if valid_d.device.type == "cpu":
        return jgram_dense_plain(K, q0, cams, pts, valid_d, dirs_c, dirs_p,
                                 clamp=clamp, tile_mask=tile_mask)
    if kq is None:
        kq = torch.cat([K, q0], dim=1)
    dev = _build.cuda_inputs("jgram_dense", kq=kq, cams=cams, pts=pts,
                             valid_d=valid_d)
    C, P = valid_d.shape
    if kq.shape != (C, 9) or cams.shape != (C, 6) or pts.shape != (P, 3):
        raise ValueError("jgram_dense: inconsistent shapes")
    mask = mask_pointer("jgram_dense", tile_mask, dev, C, P)
    # per direction: the camera part's address, the point part's address
    # and the strides of its entry (k, p), taken without a torch op
    if isinstance(dirs_c, torch.Tensor):
        n = dirs_c.shape[0]
        if (dirs_c.shape != (n, C, 6) or dirs_p.dim() != 3
                or dirs_p.shape[:2] != (n, 3) or dirs_p.shape[2] < P):
            raise ValueError("jgram_dense: inconsistent shapes")
        if not dirs_c.is_contiguous():
            raise ValueError("jgram_dense: dirs_c must be contiguous")
        tensors = (dirs_c, dirs_p)
        cs, ps = 4 * dirs_c.stride(0), 4 * dirs_p.stride(0)
        dcs = [dirs_c.data_ptr() + a * cs for a in range(n)]
        dps = [dirs_p.data_ptr() + a * ps for a in range(n)]
        sks, sps = [dirs_p.stride(1)] * n, [dirs_p.stride(2)] * n
    else:
        n = len(dirs_c)
        if len(dirs_p) != n or any(dc.shape != (C, 6) for dc in dirs_c) or (
                any(dp.shape != (P, 3) for dp in dirs_p)):
            raise ValueError("jgram_dense: the sequence form takes n camera "
                             "parts [C, 6] and n point parts [P, 3]")
        if not all(dc.is_contiguous() for dc in dirs_c):
            raise ValueError("jgram_dense: camera parts must be contiguous")
        tensors = (*dirs_c, *dirs_p)
        dcs = [dc.data_ptr() for dc in dirs_c]
        dps = [dp.data_ptr() for dp in dirs_p]
        sks, sps = [dp.stride(1) for dp in dirs_p], [dp.stride(0)
                                                     for dp in dirs_p]
    if not 1 <= n <= JGRAM_MAX_N:
        raise ValueError(f"jgram_dense: n = {n} directions, the kernel takes "
                         f"1 to {JGRAM_MAX_N}")
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"jgram_dense: directions must be float32 on {dev}")
    pad = [None] * (JGRAM_MAX_N - n)
    zero = [0] * (JGRAM_MAX_N - n)
    fn = _jgram_kernel()
    blocks = _jgram_blocks(n)
    ws = _build.workspace("jgram_dense", dev, 1 + max(
        blocks, -(-C // CAM_CHUNK)) * (n * (n + 1) // 2))
    G = torch.empty((n, n), dtype=torch.float32, device=dev)
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), valid_d.data_ptr(),
        mask, *dcs, *pad, *dps, *pad, *sks, *zero, *sps, *zero,
        n, C, P, int(bool(clamp)), blocks, ws.data_ptr(), ws.numel(),
        G.data_ptr(), _build.stream(dev),
    )
    _build.check(err, "jgram_dense")
    jgram_dense.launches += 1
    return G


jgram_dense.launches = 0
