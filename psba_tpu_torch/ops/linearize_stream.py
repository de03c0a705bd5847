"""Observation-stream linearization: residual, Jacobians, Hessian packs.

Port of psba_tpu.ops.linearize_pallas.linearize_pallas. One pass over the
observations gives, per observation o:

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
(float32) and runs `linearize_stream_plain` on CPU tensors. The kernel walks
the observations in camera order; `StreamTables` holds that order and the
per-block runs, built once per problem (ProblemArrays.stream).
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from psba_tpu_torch.ops import _build
from psba_tpu_torch.ops.linearize_dense import _SYM6, _cell_model, camera_rows

# observations per block of the kernel (one camera per block), and the
# per-block pack: 21 upper-triangle U entries, 6 ga entries, l2
CHUNK = 1024
PACK = 28


@dataclasses.dataclass(frozen=True)
class StreamTables:
    """Camera-sorted walk of the observation stream for the kernel."""

    perm: torch.Tensor     # [O] int32, observation indices sorted by camera
    pt_of: torch.Tensor    # [O] int32, pt_idx[perm]
    chunks: torch.Tensor   # [n_chunks, 4] int32: camera, start, count, slot
    max_chunks: int        # most blocks any camera has


def build_stream_tables(cam_idx, pt_idx, n_cams: int,
                        device="cpu") -> StreamTables:
    """Host-side tables of the camera-sorted walk: each camera's
    observations (in their stream order) cut into runs of at most CHUNK."""
    cam = np.asarray(cam_idx, np.int64)
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
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                    dtype=torch.int32, device=device)
    return StreamTables(
        perm=i32(perm), pt_of=i32(np.asarray(pt_idx)[perm]),
        chunks=i32(chunks), max_chunks=max(int(n_per.max(initial=0)), 1),
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
            or lib.psba_linearize_stream_pack() != PACK):
        raise RuntimeError("linearize_stream.cu constants differ from "
                           "psba_tpu_torch.ops.linearize_stream")
    fn = lib.psba_linearize_stream
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + (
        [ctypes.c_void_p] * 7
    )
    fn.restype = ctypes.c_int
    return fn


def linearize_stream(K, q0, cams, pts, obs, cam_idx, pt_idx, valid, n_cams,
                     n_pts, clamp=False, want_jac=False, want_point=True,
                     want_w=True, tables: StreamTables | None = None):
    """Observation-stream linearization; see the module docstring.

    CPU tensors run the plain version. CUDA tensors (float32, contiguous)
    launch csrc/linearize_stream.cu, walking `tables` (required there),
    and count one launch; the point sums of want_point are an index_add_
    outside the kernel."""
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
            or tables.perm.shape != (O,) or tables.pt_of.shape != (O,)
            or (valid is not None and valid.shape != (O,))):
        raise ValueError("linearize_stream: inconsistent shapes")
    for name, t in (("perm", tables.perm), ("pt_of", tables.pt_of),
                    ("chunks", tables.chunks)):
        if t.device != dev or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"linearize_stream: tables.{name} must be a "
                             f"contiguous int32 tensor on {dev}")
    fn = _kernel()
    f32 = dict(dtype=torch.float32, device=dev)
    kq = torch.cat([K, q0], dim=1).contiguous()
    ex = torch.empty((O, 2), **f32)
    A = torch.empty((O, 2, 6), **f32) if want_jac else None
    B = torch.empty((O, 2, 3), **f32) if want_jac else None
    W = torch.empty((O, 6, 3), **f32) if want_w else None
    pk = torch.empty((O, 12), **f32) if want_point else None
    part = torch.zeros((C, tables.max_chunks, PACK), **f32)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), obs.data_ptr(),
        ptr(valid), tables.perm.data_ptr(), tables.pt_of.data_ptr(),
        tables.chunks.data_ptr(), tables.chunks.shape[0], tables.max_chunks,
        int(bool(clamp)), ex.data_ptr(), ptr(A), ptr(B), ptr(W), ptr(pk),
        part.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "linearize_stream")
    linearize_stream.launches += 1
    U, ga, l2 = _unpack(part.sum(1), C)
    V = gb = None
    if want_point:
        red = torch.zeros((P, 12), **f32)
        red.index_add_(0, pt_idx, pk)
        V, gb = red[:, :9].reshape(P, 3, 3), red[:, 9:]
    return ex, l2, U, V, W, ga, gb, A, B


linearize_stream.launches = 0
