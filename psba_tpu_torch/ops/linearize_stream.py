"""Observation-stream linearization and trial-step residual.

Ports of psba_tpu.ops.linearize_pallas.linearize_pallas and
residual_l2_pallas. One pass of `linearize_stream` over the observations
gives, per observation o:

  ex [O, 2]      residual obs - proj, unmasked
  A  [O, 2, 6]   camera Jacobian of the prediction  (want_jac)
  B  [O, 2, 3]   point Jacobian                      (want_jac)
  W  [O, 6, 3]   A^T B                               (want_w)
  V  [P, 3, 3], gb [P, 3]   B^T B, B^T ex summed by point  (want_point)

and always the camera blocks U [C, 6, 6] = A^T A, ga [C, 6] = A^T ex summed
over each camera's observations, and l2 = sum |ex|^2. `valid` [O] (optional)
masks A, B, W, the packs and l2; ex stays unmasked. All outputs are
coefficient-free (callers scale by the LM / TR convention).

`linearize_stream` launches csrc/linearize_stream.cu on CUDA tensors
(float32) and runs `linearize_stream_plain` on CPU tensors. The kernel
walks the observations twice: in camera order for the camera sums, and in
their own point-sorted order for the per-observation outputs and the point
sums, each without atomics. `StreamTables` holds both walks, built once per
problem (ProblemArrays.stream).

`residual_l2` is the trial step of the pair-encoding LM / TR loops: ex [O, 2]
(unmasked) and l2 = sum valid * |ex|^2 at new parameters, launching
csrc/residual_l2.cu on CUDA tensors (float32, int32 indices) and running
`residual_l2_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from psba_tpu_torch.ops import _build
from psba_tpu_torch.ops.linearize_dense import (
    _SYM6,
    _cell_model,
    camera_rows,
    cell_residual,
)

# observations per block of the camera pass (one camera per block), the
# per-block pack (21 upper-triangle U entries, 6 ga entries, l2), and the
# observations per block of the point pass
CHUNK = 1024
PACK = 28
RUN = 256


@dataclasses.dataclass(frozen=True)
class StreamTables:
    """The kernel's two walks of the observation stream: camera-sorted
    chunks for the camera sums, point-sorted runs for the per-observation
    outputs and the point sums."""

    perm: torch.Tensor     # [O] int32, observation indices sorted by camera
    pt_of: torch.Tensor    # [O] int32, pt_idx[perm]
    chunks: torch.Tensor   # [n_chunks, 4] int32: camera, start, count, slot
    max_chunks: int        # most blocks any camera has
    cam32: torch.Tensor    # [O] int32 copy of cam_idx
    pt32: torch.Tensor     # [O] int32 copy of pt_idx
    runs: torch.Tensor     # [n_runs, 5] int32, see build_point_runs
    split_pt: torch.Tensor     # [n_split] int64, points cut into pieces
    split_piece: torch.Tensor  # [n_split, max_pieces] int64 piece rows,
                               # n_pieces where a point has fewer
    n_pieces: int
    n_pts: int


def build_point_runs(pt_idx, n_pts: int):
    """Runs of the point pass over point-sorted observations, each at most
    RUN observations and at most RUN points, cut at point boundaries.

    Returns (runs [n_runs, 5] int64: first observation, count, first point,
    number of points, piece; pieces [n_split] list of piece-index lists;
    split points [n_split]). A run with piece -1 holds the whole of its
    points (some may have no observation; together the runs tile 0..n_pts-1
    apart from the split points). A point with more than RUN observations
    is cut into runs of its own, piece 0, 1, ... in observation order, with
    no points of their own."""
    pt = np.asarray(pt_idx, np.int64)
    if pt.size and np.any(np.diff(pt) < 0):
        raise ValueError("build_point_runs: observations not sorted by point")
    counts = np.bincount(pt, minlength=n_pts).tolist()
    runs, pieces, split = [], [], []
    obs0 = pt0 = cnt = o = 0
    n_pieces = 0
    for p, c in enumerate(counts):
        if c > RUN:
            if p > pt0:
                runs.append((obs0, cnt, pt0, p - pt0, -1))
            mine = []
            for s in range(0, c, RUN):
                runs.append((o + s, min(RUN, c - s), p, 0, n_pieces))
                mine.append(n_pieces)
                n_pieces += 1
            pieces.append(mine)
            split.append(p)
            obs0, cnt, pt0 = o + c, 0, p + 1
        elif cnt + c > RUN or p - pt0 == RUN:
            runs.append((obs0, cnt, pt0, p - pt0, -1))
            obs0, cnt, pt0 = o, c, p
        else:
            cnt += c
        o += c
    if n_pts > pt0:
        runs.append((obs0, cnt, pt0, n_pts - pt0, -1))
    return np.asarray(runs, np.int64).reshape(-1, 5), pieces, split


def build_stream_tables(cam_idx, pt_idx, n_cams: int, n_pts: int,
                        device="cpu") -> StreamTables:
    """Host-side tables of both walks, built once per problem: each camera's
    observations (in their stream order) cut into runs of at most CHUNK, and
    the point runs of build_point_runs."""
    cam = np.asarray(cam_idx, np.int64)
    pt = np.asarray(pt_idx, np.int64)
    perm = np.argsort(cam, kind="stable")
    counts = np.bincount(cam, minlength=n_cams)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    n_per = -(-counts // CHUNK)
    rows = []
    for c in np.nonzero(counts)[0]:
        k = np.arange(n_per[c])
        first = starts[c] + k * CHUNK
        cnt = np.minimum(CHUNK, counts[c] - k * CHUNK)
        rows.append(np.stack([np.full_like(k, c), first, cnt, k], axis=1))
    chunks = (np.concatenate(rows) if rows
              else np.zeros((0, 4), np.int64)).astype(np.int32)
    if np.all(np.diff(pt) >= 0):
        runs, pieces, split = build_point_runs(pt, n_pts)
    else:   # no point pass: the CUDA wrapper refuses its flags
        runs, pieces, split = np.zeros((0, 5), np.int64), [], []
    width = max((len(q) for q in pieces), default=0)
    n_pieces = sum(len(q) for q in pieces)
    split_piece = np.full((len(pieces), width), n_pieces, np.int64)
    for r, q in enumerate(pieces):
        split_piece[r, :len(q)] = q
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int32, device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return StreamTables(
        perm=i32(perm), pt_of=i32(pt[perm]),
        chunks=i32(chunks), max_chunks=max(int(n_per.max(initial=0)), 1),
        cam32=i32(cam), pt32=i32(pt), runs=i32(runs),
        split_pt=i64(split), split_piece=i64(split_piece),
        n_pieces=n_pieces, n_pts=n_pts,
    )


def _unpack(packs, n_cams):
    """[C, 28] camera packs -> (U [C, 6, 6], ga [C, 6], l2); a stack of
    views, so no index tensor is copied to the device."""
    U = torch.stack([packs[:, r] for r in _SYM6.reshape(-1).tolist()], dim=1)
    return U.reshape(n_cams, 6, 6), packs[:, 21:27], packs[:, 27].sum()


def linearize_stream_plain(K, q0, cams, pts, obs, cam_idx, pt_idx, valid,
                           n_cams, n_pts, clamp=False, want_jac=False,
                           want_point=True, want_w=True):
    """Plain PyTorch version (any dtype, any device). Returns (ex, l2, U, V,
    W, ga, gb, A, B) with None in the slots its flags leave out."""
    rows = camera_rows(K, q0, cams)[cam_idx]                  # [O, 15]
    X = pts[pt_idx]
    one = torch.ones_like(obs[:, :1])
    col = lambda t: t.reshape(-1)
    A, B, exu, exv = _cell_model(rows, X[:, 0:1], X[:, 1:2], X[:, 2:3],
                                 obs[:, 0:1], obs[:, 1:2], one, clamp)
    A = [[col(a) for a in r] for r in A]
    B = [[col(b) for b in r] for r in B]
    exu, exv = col(exu), col(exv)
    ex = torch.stack([exu, exv], dim=1)
    if valid is not None:
        m = valid.to(obs.dtype)
        A = [[a * m for a in r] for r in A]
        B = [[b * m for b in r] for r in B]
        mexu, mexv = exu * m, exv * m
    else:
        mexu, mexv = exu, exv
    cols = [A[0][i] * A[0][j] + A[1][i] * A[1][j]
            for i in range(6) for j in range(i, 6)]
    cols += [A[0][i] * mexu + A[1][i] * mexv for i in range(6)]
    cols.append(mexu * exu + mexv * exv)
    packs = torch.zeros((n_cams, PACK), dtype=obs.dtype, device=obs.device)
    packs.index_add_(0, cam_idx, torch.stack(cols, dim=1))
    U, ga, l2 = _unpack(packs, n_cams)
    W = V = gb = Aj = Bj = None
    if want_w:
        W = torch.stack([A[0][i] * B[0][j] + A[1][i] * B[1][j]
                         for i in range(6) for j in range(3)],
                        dim=1).reshape(-1, 6, 3)
    if want_point:
        pk = [B[0][i] * B[0][j] + B[1][i] * B[1][j]
              for i in range(3) for j in range(3)]
        pk += [B[0][i] * mexu + B[1][i] * mexv for i in range(3)]
        red = torch.zeros((n_pts, 12), dtype=obs.dtype, device=obs.device)
        red.index_add_(0, pt_idx, torch.stack(pk, dim=1))
        V, gb = red[:, :9].reshape(n_pts, 3, 3), red[:, 9:]
    if want_jac:
        Aj = torch.stack([a for r in A for a in r], dim=1).reshape(-1, 2, 6)
        Bj = torch.stack([b for r in B for b in r], dim=1).reshape(-1, 2, 3)
    return ex, l2, U, V, W, ga, gb, Aj, Bj


def _kernel():
    lib = _build.library("linearize_stream")
    if (lib.psba_linearize_stream_chunk() != CHUNK
            or lib.psba_linearize_stream_pack() != PACK
            or lib.psba_linearize_stream_run() != RUN):
        raise RuntimeError("linearize_stream.cu constants differ from "
                           "psba_tpu_torch.ops.linearize_stream")
    fn = lib.psba_linearize_stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 2 + (
        [ctypes.c_void_p] * 3) + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
    fn.restype = ctypes.c_int
    return fn


def linearize_stream(K, q0, cams, pts, obs, cam_idx, pt_idx, valid, n_cams,
                     n_pts, clamp=False, want_jac=False, want_point=True,
                     want_w=True, tables: StreamTables | None = None):
    """Observation-stream linearization; see the module docstring.

    CPU tensors run the plain version. CUDA tensors (float32, contiguous)
    launch csrc/linearize_stream.cu, walking `tables` (required there), and
    count one launch: the camera pass, then the point pass when want_jac,
    want_w or want_point asks for it (counted in `point_launches` too).
    Points cut into pieces by the point runs get their V / gb as the sum
    of the pieces, in order."""
    if obs.device.type == "cpu":
        return linearize_stream_plain(
            K, q0, cams, pts, obs, cam_idx, pt_idx, valid, n_cams, n_pts,
            clamp=clamp, want_jac=want_jac, want_point=want_point,
            want_w=want_w)
    floats = dict(K=K, q0=q0, cams=cams, pts=pts, obs=obs)
    if valid is not None:
        floats["valid"] = valid
    dev = _build.cuda_inputs("linearize_stream", **floats)
    if tables is None:
        raise ValueError("linearize_stream: CUDA tensors need the stream "
                         "tables (ProblemArrays.stream)")
    O = obs.shape[0]
    C, P = n_cams, n_pts
    if (K.shape != (C, 5) or q0.shape != (C, 4) or cams.shape != (C, 6)
            or pts.shape != (P, 3) or obs.shape != (O, 2)
            or tables.perm.shape != (O,) or tables.cam32.shape != (O,)
            or tables.n_pts != P
            or (valid is not None and valid.shape != (O,))):
        raise ValueError("linearize_stream: inconsistent shapes")
    if obs.data_ptr() % 8:
        raise ValueError("linearize_stream: obs must be 8-byte aligned")
    for name in ("perm", "pt_of", "chunks", "cam32", "pt32", "runs"):
        t = getattr(tables, name)
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"linearize_stream: tables.{name} must be a "
                             f"contiguous int32 tensor on {dev}")
    points = want_jac or want_w or want_point
    if points and tables.runs.shape[0] == 0:
        raise ValueError("linearize_stream: the point pass needs "
                         "observations sorted by point")
    fn = _kernel()
    f32 = dict(dtype=torch.float32, device=dev)
    kq = torch.cat([K, q0], dim=1).contiguous()
    ex = torch.empty((O, 2), **f32)
    A = torch.empty((O, 2, 6), **f32) if want_jac else None
    B = torch.empty((O, 2, 3), **f32) if want_jac else None
    W = torch.empty((O, 6, 3), **f32) if want_w else None
    red = torch.empty((P, 12), **f32) if want_point else None
    pieces = None
    if want_point and tables.n_pieces:
        pieces = torch.zeros((tables.n_pieces + 1, 12), **f32)
    part = torch.zeros((C, tables.max_chunks, PACK), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), obs.data_ptr(),
        ptr(valid), tables.perm.data_ptr(), tables.pt_of.data_ptr(),
        tables.chunks.data_ptr(), tables.chunks.shape[0], tables.max_chunks,
        tables.cam32.data_ptr(), tables.pt32.data_ptr(),
        tables.runs.data_ptr(), tables.runs.shape[0], int(bool(clamp)),
        ex.data_ptr(), ptr(A), ptr(B), ptr(W), ptr(red), ptr(pieces),
        part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "linearize_stream")
    linearize_stream.launches += 1
    linearize_stream.point_launches += int(points)
    U, ga, l2 = _unpack(part.sum(1), C)
    V = gb = None
    if want_point:
        if pieces is not None:
            red[tables.split_pt] = pieces[tables.split_piece].sum(1)
        V, gb = red[:, :9].reshape(P, 3, 3), red[:, 9:]
    return ex, l2, U, V, W, ga, gb, A, B


linearize_stream.launches = 0
# calls that also ran the point pass (want_jac, want_w or want_point)
linearize_stream.point_launches = 0


def residual_l2_plain(K, q0, cams, pts, obs, cam_idx, pt_idx, valid=None,
                      clamp=False):
    """Plain PyTorch version (any dtype, any device): (ex [O, 2] unmasked,
    l2 = sum valid * |ex|^2 as a 0-d tensor)."""
    rows = camera_rows(K, q0, cams)[cam_idx.long()]            # [O, 15]
    X = pts[pt_idx.long()]
    one = torch.ones_like(obs[:, :1])
    exu, exv = cell_residual(rows, X[:, 0:1], X[:, 1:2], X[:, 2:3],
                             obs[:, 0:1], obs[:, 1:2], one, clamp)
    e2 = (exu * exu + exv * exv)[:, 0]
    if valid is not None:
        e2 = e2 * valid.to(obs.dtype)
    return torch.cat([exu, exv], dim=1), e2.sum()


def _residual_kernel():
    lib = _build.library("residual_l2")
    fn = lib.psba_residual_l2
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 2 + (
        [ctypes.c_void_p] * 3
    )
    fn.restype = ctypes.c_int
    return fn, lib.psba_residual_l2_per_block()


def residual_l2(K, q0, cams, pts, obs, cam_idx, pt_idx, valid=None,
                clamp=False):
    """Trial-step residual ex [O, 2] (unmasked) and l2 = sum valid *
    |ex|^2 (0-d); `valid` [O] optional.

    CPU tensors run the plain version. CUDA tensors (float32, contiguous;
    cam_idx / pt_idx contiguous int32, ProblemArrays.cam_idx32 / pt_idx32)
    launch csrc/residual_l2.cu and count one launch; the per-block partial
    sums of l2 are added outside."""
    if obs.device.type == "cpu":
        return residual_l2_plain(K, q0, cams, pts, obs, cam_idx, pt_idx,
                                 valid=valid, clamp=clamp)
    floats = dict(K=K, q0=q0, cams=cams, pts=pts, obs=obs)
    if valid is not None:
        floats["valid"] = valid
    dev = _build.cuda_inputs("residual_l2", **floats)
    O, C, P = obs.shape[0], K.shape[0], pts.shape[0]
    if (O < 1 or q0.shape != (C, 4) or K.shape != (C, 5)
            or cams.shape != (C, 6) or pts.shape != (P, 3)
            or obs.shape != (O, 2)
            or (valid is not None and valid.shape != (O,))):
        raise ValueError("residual_l2: inconsistent shapes")
    if obs.data_ptr() % 8:
        raise ValueError("residual_l2: obs must be 8-byte aligned")
    for name, t in (("cam_idx", cam_idx), ("pt_idx", pt_idx)):
        if (t.device != dev or t.dtype != torch.int32
                or not t.is_contiguous() or t.shape != (O,)):
            raise ValueError(f"residual_l2: {name} must be a contiguous "
                             f"int32 [O] tensor on {dev}")
    fn, per_block = _residual_kernel()
    f32 = dict(dtype=torch.float32, device=dev)
    kq = torch.cat([K, q0], dim=1).contiguous()
    ex = torch.empty((O, 2), **f32)
    part = torch.empty((-(-O // per_block),), **f32)
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), obs.data_ptr(),
        cam_idx.data_ptr(), pt_idx.data_ptr(),
        None if valid is None else valid.data_ptr(), O, int(bool(clamp)),
        ex.data_ptr(), part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "residual_l2")
    residual_l2.launches += 1
    return ex, part.sum()


residual_l2.launches = 0
