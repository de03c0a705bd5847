"""Dense-grid linearization: ZW / V / gb born planar, U / ga reduced.

Port of psba_tpu.ops.linearize_dense.linearize_dense_pallas. The grid is
every (camera, point) cell, masked by the dense validity table; each cell
runs the forward model and its analytic Jacobian A (2x6) / B (2x3) and
contributes

  ZWk [6C, Pp]   ZWk[6c+i, p] = W[i, k],  W = A^T B      (planar factor)
  Vp  [3, 3, Pp] B^T B summed over cameras                (point blocks)
  gbp [3, Pp]    B^T ex summed over cameras               (point gradient)
  U   [C, 6, 6]  A^T A summed over points   (want_u)      (camera blocks)
  ga  [C, 6]     A^T ex summed over points  (want_u)      (camera gradient)

Pp is P padded to the kernel's point tile PTILE; padded columns have ZW and
gb exactly 0 and V the identity, so they pass through the Schur solve as
inert, always-invertible blocks.

The three dense kernels (this one, gain_dense and jgram_dense) take an
optional occupancy table, `tile_mask` [C, Pp / PTILE] int32
(`build_tile_mask`): bit (c, t) is 1 iff camera c observes a point in
columns [t * PTILE, (t + 1) * PTILE). A (camera, tile) pair whose bit is 0
is skipped; the skip is exact, since every cell of such a pair is unseen and
contributes exactly 0. It removes work once the points are clustered so
that each camera's observations fill few tiles
(problem.BAProblem.with_tile_point_order). The plain versions apply the
mask by multiplying the validity table with it (`masked_valid`), so a mask
that clears an observed tile changes both alike.

`linearize_dense` is the entry point. On CUDA tensors it launches the
hand-written kernel csrc/linearize_dense.cu (float32); on CPU tensors it
runs `linearize_dense_plain`, the same function in plain PyTorch, which is
also what the kernel is held against on the card.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from psba_tpu_torch.ops import _build

# point tile = threads per block of the kernel; camera chunk = cameras per
# block (both checked against the built library at its first use)
PTILE = 128
CAM_CHUNK = 8

# [C, 27] packs (21 upper-triangle U entries, row-major, then 6 ga) ->
# the 36 entries of the symmetric 6x6 block
_IU, _JU = np.triu_indices(6)
_SYM6 = np.empty((6, 6), np.int64)
_SYM6[_IU, _JU] = np.arange(21)
_SYM6[_JU, _IU] = np.arange(21)
_SYM3 = [0, 1, 2, 1, 3, 4, 2, 4, 5]   # 6 upper V entries -> 3x3


def padded_points(P: int) -> int:
    """P rounded up to the kernel's point tile."""
    return ((P + PTILE - 1) // PTILE) * PTILE


def tile_slot_order(P: int) -> np.ndarray:
    """Planar positions in the dense kernels' tile-visit order: a block
    covers PTILE consecutive points, so the order is 0..P-1 (points
    assigned to slots in this order fill the tiles one after another)."""
    return np.arange(P)


def build_tile_mask(valid_d: torch.Tensor) -> torch.Tensor:
    """[C, Pp / PTILE] int32 occupancy table of the validity table valid_d
    [C, P], on its device: 1 where camera c observes a point of tile t."""
    C, P = valid_d.shape
    Pp = padded_points(P)
    occ = F.pad(valid_d, (0, Pp - P)).reshape(C, Pp // PTILE, PTILE)
    return (occ.amax(dim=2) > 0).to(torch.int32)


def masked_valid(valid_d, tile_mask):
    """valid_d [C, P] times the occupancy table expanded to cells: valid_d
    itself (the same bits) under the table build_tile_mask gives, and
    valid_d with the cells of every cleared (camera, tile) pair zeroed."""
    if tile_mask is None:
        return valid_d
    P = valid_d.shape[1]
    cells = tile_mask.to(valid_d.dtype).repeat_interleave(PTILE, dim=1)
    return valid_d * cells[:, :P]


def mask_pointer(what, tile_mask, dev, C, P):
    """The address of a CUDA tile_mask for a launcher (None for no mask);
    raises unless it is a contiguous int32 [C, Pp / PTILE] tensor on dev."""
    if tile_mask is None:
        return None
    n_tiles = padded_points(P) // PTILE
    if (tile_mask.device != dev or tile_mask.dtype != torch.int32
            or tile_mask.shape != (C, n_tiles)
            or not tile_mask.is_contiguous()):
        raise ValueError(f"{what}: tile_mask must be a contiguous int32 "
                         f"[{C}, {n_tiles}] tensor on {dev}")
    return tile_mask.data_ptr()


def dense_obs_tables(blk_idx, obs, n_obs, dtype=np.float32):
    """Host-side dense (cam x point) observation tables: obs_du / obs_dv
    [C, P] measurements and valid_d [C, P] mask (1.0 where the cell has an
    observation). `blk_idx` marks unseen cells with `n_obs`
    (psba_tpu.problem.build_blk_idx)."""
    blk = np.asarray(blk_idx)
    obs = np.asarray(obs, dtype)
    seen = blk < n_obs
    safe = np.where(seen, blk, 0)
    obs_du = np.where(seen, obs[safe, 0], 0.0).astype(dtype)
    obs_dv = np.where(seen, obs[safe, 1], 0.0).astype(dtype)
    return obs_du, obs_dv, seen.astype(dtype)


def camera_rows(K, q0, cams) -> torch.Tensor:
    """[C, 15] camera records (K | q0 | v | t), the kernels' layout."""
    return torch.cat([K, q0, cams], dim=1)


def _cell_forward(cam, x1, x2, x3, vmask, clamp):
    """Forward model of every cell; cam [C, 15], x* [1, Pp] or [P]
    broadcast against the camera columns [C, 1]."""
    a, b, cc, d = (cam[:, i:i + 1] for i in range(5, 9))
    v1, v2, v3 = (cam[:, i:i + 1] for i in range(9, 12))
    t1, t2, t3 = (cam[:, i:i + 1] for i in range(12, 15))
    s2 = 1.0 - v1 * v1 - v2 * v2 - v3 * v3
    if clamp:
        s2 = torch.clamp(s2, min=0.0)
    s = torch.sqrt(s2)
    t01 = 2.0 * (cc * x3 - d * x2)
    t02 = 2.0 * (d * x1 - b * x3)
    t03 = 2.0 * (b * x2 - cc * x1)
    X0 = (
        x1 + a * t01 + (cc * t03 - d * t02),
        x2 + a * t02 + (d * t01 - b * t03),
        x3 + a * t03 + (b * t02 - cc * t01),
    )
    w = (
        v2 * X0[2] - v3 * X0[1],
        v3 * X0[0] - v1 * X0[2],
        v1 * X0[1] - v2 * X0[0],
    )
    p1 = X0[0] + 2.0 * (s * w[0] + v2 * w[2] - v3 * w[1]) + t1
    p2 = X0[1] + 2.0 * (s * w[1] + v3 * w[0] - v1 * w[2]) + t2
    p3 = X0[2] + 2.0 * (s * w[2] + v1 * w[1] - v2 * w[0]) + t3
    # unseen cells can sit at p3 ~ 0: the guard precedes the division
    p3 = torch.where(vmask > 0.0, p3, torch.ones_like(p3))
    return s, X0, w, p1, p2, p3, 1.0 / p3


def cell_residual(cam, x1, x2, x3, obsu, obsv, vmask, clamp):
    """Masked residual (exu, exv) of every cell."""
    fu, u0, v0, ar, sk = (cam[:, i:i + 1] for i in range(5))
    _s, _X0, _w, p1, p2, p3, iz = _cell_forward(cam, x1, x2, x3, vmask, clamp)
    pu = (fu * p1 + sk * p2 + u0 * p3) * iz
    pv = (fu * ar * p2 + v0 * p3) * iz
    return (obsu - pu) * vmask, (obsv - pv) * vmask


def _cell_model(cam, x1, x2, x3, obsu, obsv, vmask, clamp):
    """Residual and masked Jacobian rows of every cell: (A, B, exu, exv)
    with A[r][0..5], B[r][0..2] tensors, r = u, v."""
    fu, u0, v0, ar, sk = (cam[:, i:i + 1] for i in range(5))
    a, b, cc, d = (cam[:, i:i + 1] for i in range(5, 9))
    v1, v2, v3 = (cam[:, i:i + 1] for i in range(9, 12))
    s, X0, w, p1, p2, p3, iz = _cell_forward(cam, x1, x2, x3, vmask, clamp)
    pu = (fu * p1 + sk * p2 + u0 * p3) * iz
    pv = (fu * ar * p2 + v0 * p3) * iz
    exu = (obsu - pu) * vmask
    exv = (obsv - pv) * vmask

    du = (fu * iz, sk * iz, -(fu * p1 + sk * p2) * iz * iz)
    dv = (torch.zeros_like(iz), fu * ar * iz, -(fu * ar * p2) * iz * iz)

    inv_s = 1.0 / s
    g = tuple(-2.0 * (inv_s * w[i] + X0[i]) for i in range(3))
    cdot = 2.0 * (v1 * X0[0] + v2 * X0[1] + v3 * X0[2])
    s2_ = 2.0 * s
    M = (
        (g[0] * v1 + cdot, g[0] * v2 + s2_ * X0[2] + 2 * w[2],
         g[0] * v3 - s2_ * X0[1] - 2 * w[1]),
        (g[1] * v1 - s2_ * X0[2] - 2 * w[2], g[1] * v2 + cdot,
         g[1] * v3 + s2_ * X0[0] + 2 * w[0]),
        (g[2] * v1 + s2_ * X0[1] + 2 * w[1], g[2] * v2 - s2_ * X0[0] - 2 * w[0],
         g[2] * v3 + cdot),
    )
    qw = s * a - (v1 * b + v2 * cc + v3 * d)
    qx = s * b + a * v1 + (v2 * d - v3 * cc)
    qy = s * cc + a * v2 + (v3 * b - v1 * d)
    qz = s * d + a * v3 + (v1 * cc - v2 * b)
    R = (
        (1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
         2 * (qx * qz + qy * qw)),
        (2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
         2 * (qy * qz - qx * qw)),
        (2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
         1 - 2 * (qx * qx + qy * qy)),
    )

    def rowdot(pr, cols):
        return tuple(
            pr[0] * cols[0][k] + pr[1] * cols[1][k] + pr[2] * cols[2][k]
            for k in range(3)
        )

    A, B = [], []
    for pr in (du, dv):
        A.append(tuple(x * vmask for x in rowdot(pr, M) + pr))
        B.append(tuple(x * vmask for x in rowdot(pr, R)))
    return A, B, exu, exv


def linearize_dense_plain(K, q0, cams, pts, obs_du, obs_dv, valid_d,
                          clamp=False, want_u=False, tile_mask=None):
    """Plain PyTorch version of the dense-grid linearization (any dtype,
    any device). Returns (ZW0, ZW1, ZW2, Vp, gbp, Pp) and, with want_u,
    (..., U, ga) as well."""
    valid_d = masked_valid(valid_d, tile_mask)
    C, P = valid_d.shape
    Pp = padded_points(P)
    pad = Pp - P
    X = F.pad(pts.T, (0, pad))
    ou, ov, vd = (F.pad(t, (0, pad)) for t in (obs_du, obs_dv, valid_d))
    A, B, exu, exv = _cell_model(
        camera_rows(K, q0, cams), X[0:1], X[1:2], X[2:3], ou, ov, vd, clamp
    )
    ZW = tuple(
        torch.stack(
            [A[0][i] * B[0][k] + A[1][i] * B[1][k] for i in range(6)], dim=1
        ).reshape(6 * C, Pp)
        for k in range(3)
    )
    vs = [
        (B[0][i] * B[0][j] + B[1][i] * B[1][j]).sum(0)
        for i in range(3) for j in range(i, 3)
    ]
    Vp = torch.stack([vs[r] for r in _SYM3]).reshape(3, 3, Pp)
    gbp = torch.stack([(B[0][i] * exu + B[1][i] * exv).sum(0)
                       for i in range(3)])
    Vp[:, :, P:] = torch.eye(3, dtype=Vp.dtype, device=Vp.device)[:, :, None]
    if not want_u:
        return (*ZW, Vp, gbp, Pp)
    us = [
        (A[0][i] * A[0][j] + A[1][i] * A[1][j]).sum(1)
        for i in range(6) for j in range(i, 6)
    ]
    U = torch.stack(us, dim=1)[:, torch.as_tensor(_SYM6.reshape(-1))]
    ga = torch.stack([(A[0][i] * exu + A[1][i] * exv).sum(1)
                      for i in range(6)], dim=1)
    return (*ZW, Vp, gbp, Pp, U.reshape(C, 6, 6), ga)


@functools.cache
def _kernel():
    lib = _build.library("linearize_dense")
    if (lib.psba_linearize_dense_ptile() != PTILE
            or lib.psba_linearize_dense_cam_chunk() != CAM_CHUNK):
        raise RuntimeError("linearize_dense.cu tile constants differ from "
                           "psba_tpu_torch.ops.linearize_dense")
    fn = lib.psba_linearize_dense
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + (
        [ctypes.c_void_p] * 9
    )
    fn.restype = ctypes.c_int
    return fn


def linearize_dense(K, q0, cams, pts, obs_du, obs_dv, valid_d, clamp=False,
                    want_u=False, kq=None, tile_mask=None):
    """Dense-grid linearization; see the module docstring for the outputs.

    CPU tensors run the plain version. CUDA tensors (float32, contiguous)
    launch csrc/linearize_dense.cu (the grid kernel, then the kernel that
    finishes the V / gb and U / ga sums) and count one call: the wrapper
    only allocates the outputs (one buffer, cut into views).
    `kq` is the [C, 9] camera rows K | q0 (ProblemArrays.kq), built here
    when not given. With `tile_mask` (build_tile_mask) the grid kernel
    skips the (camera, tile) pairs whose bit is 0 and writes their ZW
    cells as zeros."""
    if valid_d.device.type == "cpu":
        return linearize_dense_plain(K, q0, cams, pts, obs_du, obs_dv,
                                     valid_d, clamp=clamp, want_u=want_u,
                                     tile_mask=tile_mask)
    if kq is None:
        kq = torch.cat([K, q0], dim=1)
    dev = _build.cuda_inputs(
        "linearize_dense", kq=kq, cams=cams, pts=pts, obs_du=obs_du,
        obs_dv=obs_dv, valid_d=valid_d,
    )
    C, P = valid_d.shape
    if (kq.shape != (C, 9) or cams.shape != (C, 6) or pts.shape != (P, 3)
            or obs_du.shape != (C, P) or obs_dv.shape != (C, P)):
        raise ValueError("linearize_dense: inconsistent shapes")
    mask = mask_pointer("linearize_dense", tile_mask, dev, C, P)
    fn = _kernel()
    Pp = padded_points(P)
    n_tiles, n_cg = Pp // PTILE, -(-C // CAM_CHUNK)
    # the outputs and the kernels' scratch (the per-chunk V / gb and the
    # per-tile U / ga partials) in one allocation
    scratch = n_cg * 9 * Pp + (n_tiles * C * 27 if want_u else 0)
    out = _build.carve(dev, *[(6 * C, Pp)] * 3, (3, 3, Pp), (3, Pp),
                       *([(C, 6, 6), (C, 6)] if want_u else []), (scratch,))
    U, ga = out[5:7] if want_u else (None, None)
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), obs_du.data_ptr(),
        obs_dv.data_ptr(), valid_d.data_ptr(), mask, C, P, Pp,
        int(bool(clamp)), *(t.data_ptr() for t in out[:5]),
        None if U is None else U.data_ptr(),
        None if ga is None else ga.data_ptr(), out[-1].data_ptr(),
        _build.stream(dev),
    )
    _build.check(err, "linearize_dense")
    linearize_dense.launches += 1
    if not want_u:
        return (*out[:5], Pp)
    return (*out[:5], Pp, U, ga)


linearize_dense.launches = 0
