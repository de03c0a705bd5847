"""Bundle-adjustment problem container and sparsity preprocessing.

The reference keeps the problem in ~30 flat OpenCL buffers plus host-built
index arrays (PSBA/cl_psba.cpp:40-85, PSBA/misc.cpp:178-218). Here the
problem is an immutable container of dense, statically-shaped arrays ready
for jit:

  K        [C, 5]  fixed pinhole intrinsics per camera
  q0       [C, 4]  fixed initial unit quaternion per camera (w,x,y,z)
  cams     [C, 6]  optimized extrinsics: local rotation vector (3) + t (3)
  pts      [P, 3]  optimized 3-D points
  obs      [O, 2]  measured image projections
  cam_idx  [O]     camera of each observation  (reference jidx)
  pt_idx   [O]     point of each observation   (reference iidx)

Schur-complement sparsity is preprocessed into a *covisibility pair list*
instead of the reference's dense comm3DIdx lookup (which costs
O(nCams^2 * n3Dpts) ints, PSBA/main.cpp:186): for every point and every
ordered pair of observations (o1, o2) of that point, one entry

  pair_o1[n], pair_o2[n]  observation indices
  pair_bucket[n] = cam_idx[o1] * C + cam_idx[o2]

drives a batched 6x3 @ 3x6 product + segment-sum that assembles exactly the
nonzero Y_ik W_il^T terms of S (reference kern_compute_S,
CL_files/compute_S.cl:40-56). The pair list is static per problem, built
once on the host, and maps to MXU-batched matmuls + one segment reduction
on TPU.

Observations are kept sorted by point index (the text format's natural
order), so per-point reductions are segment-sums over contiguous ranges.

This is the JAX package's host-side container, copied so the port carries
its own. `with_tile_point_order` clusters covisible points into the dense
kernels' point tiles (128 consecutive points in the port, not the JAX
package's strided TPU tiles), which `solve` does on the dense encoding.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from psba_tpu_torch.constants import CNP, PNP


@dataclasses.dataclass(frozen=True)
class BAProblem:
    """Immutable bundle-adjustment problem (host-side numpy arrays)."""

    K: np.ndarray        # [C, 5] float
    q0: np.ndarray       # [C, 4] float
    cams: np.ndarray     # [C, 6] float — initial extrinsics (v=0, t)
    pts: np.ndarray      # [P, 3] float
    obs: np.ndarray      # [O, 2] float
    cam_idx: np.ndarray  # [O] int32
    pt_idx: np.ndarray   # [O] int32
    obs_cov: np.ndarray | None = None  # [O, 2, 2] parsed but unused (parity:
    # the reference reads covariances and never consumes them, main.cpp:112)

    # Covisibility pair list for Schur S assembly (built by with_pairs()).
    pair_o1: np.ndarray | None = None      # [N] int32
    pair_o2: np.ndarray | None = None      # [N] int32
    pair_bucket: np.ndarray | None = None  # [N] int32 in [0, C*C)

    # Dense (cam, point) -> observation lookup (built by with_blk()); the
    # reference's blk_idx table (misc.cpp:190-199) transposed to camera-major
    # and with n_obs (instead of -1) marking unseen cells so it gathers a
    # zero row directly (see core/schur.py::stack_blocks).
    blk_idx: np.ndarray | None = None      # [C, P] int32; n_obs = unseen

    @property
    def n_cams(self) -> int:
        return int(self.K.shape[0])

    @property
    def n_pts(self) -> int:
        return int(self.pts.shape[0])

    @property
    def n_obs(self) -> int:
        return int(self.obs.shape[0])

    @property
    def n_params(self) -> int:
        return self.n_cams * CNP + self.n_pts * PNP

    def validate(self) -> None:
        C, P, O = self.n_cams, self.n_pts, self.n_obs
        assert self.K.shape == (C, 5)
        assert self.q0.shape == (C, 4)
        assert self.cams.shape == (C, CNP)
        assert self.pts.shape == (P, PNP)
        assert self.obs.shape == (O, 2)
        assert self.cam_idx.shape == (O,) and self.pt_idx.shape == (O,)
        assert self.cam_idx.min() >= 0 and self.cam_idx.max() < C
        assert self.pt_idx.min() >= 0 and self.pt_idx.max() < P
        # observations must be sorted by point for segment reductions
        assert np.all(np.diff(self.pt_idx) >= 0), "obs must be sorted by point"

    def with_pairs(self) -> "BAProblem":
        """Return a copy carrying the covisibility pair list (idempotent)."""
        if self.pair_o1 is not None:
            return self
        o1, o2, bucket = build_covis_pairs(
            self.pt_idx, self.cam_idx, self.n_cams
        )
        return dataclasses.replace(
            self, pair_o1=o1, pair_o2=o2, pair_bucket=bucket
        )

    def with_blk(self) -> "BAProblem":
        """Return a copy carrying the dense blk_idx table (idempotent)."""
        if self.blk_idx is not None:
            return self
        return dataclasses.replace(
            self,
            blk_idx=build_blk_idx(
                self.pt_idx, self.cam_idx, self.n_cams, self.n_pts
            ),
        )

    def with_tile_point_order(self) -> tuple["BAProblem", np.ndarray]:
        """Reorder points so covisible points cluster into the dense
        kernels' point tiles.

        Points are sorted by (min, max) observing camera and assigned to
        the planar positions in the kernels' tile-visit order
        (ops.linearize_dense.tile_slot_order), so each camera's
        observations fill few (camera, tile) pairs and the kernels' exact
        occupancy skip (build_tile_mask) removes the empty ones.
        Observations are re-sorted (stably) to keep them sorted by point.

        Returns (problem, newpos) with newpos[i] = the new index of
        original point i; map an optimized pts array back with
        pts_original_order = pts_new_order[newpos]."""
        from psba_tpu_torch.ops.linearize_dense import tile_slot_order

        P, C = self.n_pts, self.n_cams
        mincam = np.full(P, C, np.int64)
        np.minimum.at(mincam, self.pt_idx, self.cam_idx)
        maxcam = np.zeros(P, np.int64)
        np.maximum.at(maxcam, self.pt_idx, self.cam_idx)
        order = np.lexsort((maxcam, mincam))     # point ids, sorted
        newpos = np.empty(P, np.int64)
        newpos[order] = tile_slot_order(P)
        pts_new = np.empty_like(self.pts)
        pts_new[newpos] = self.pts
        pt_idx_new = newpos[self.pt_idx].astype(self.pt_idx.dtype)
        o = np.argsort(pt_idx_new, kind="stable")
        return dataclasses.replace(
            self,
            pts=pts_new,
            obs=self.obs[o],
            cam_idx=self.cam_idx[o],
            pt_idx=pt_idx_new[o],
            obs_cov=None if self.obs_cov is None else self.obs_cov[o],
            # cached encodings are keyed on the old order
            pair_o1=None, pair_o2=None, pair_bucket=None, blk_idx=None,
        ), newpos

    def summary(self) -> str:
        n_pairs = 0 if self.pair_o1 is None else len(self.pair_o1)
        return (
            f"BAProblem(cams={self.n_cams}, pts={self.n_pts}, "
            f"obs={self.n_obs}, covis_pairs={n_pairs}, "
            f"params={self.n_params}, dtype={self.pts.dtype})"
        )


def build_covis_pairs(pt_idx: np.ndarray, cam_idx: np.ndarray, n_cams: int):
    """Build the ordered covisibility pair list.

    For each point, emits every ordered pair of its observations. This is
    the exact nonzero pattern of the off-diagonal sum in S_kl =
    delta_kl U_k - sum_{i in covis(k,l)} Y_ik W_il^T (compute_S.cl:40-56),
    replacing the reference's comm3DIdx dense per-camera-pair lists.

    Vectorized host-side construction: observations are sorted by point, so
    each point's observations form a contiguous run [start_i, start_i + m_i).
    """
    pt_idx = np.asarray(pt_idx, dtype=np.int64)
    cam_idx = np.asarray(cam_idx, dtype=np.int64)
    assert np.all(np.diff(pt_idx) >= 0), "obs must be sorted by point"

    # run-length encode per-point observation counts
    _, start, counts = np.unique(pt_idx, return_index=True, return_counts=True)
    n_pairs = int(np.sum(counts * counts))

    # For each point with m obs, emit the m*m grid of (o1, o2).
    # Vectorized: repeat each run's local grid.
    o1 = np.empty(n_pairs, dtype=np.int64)
    o2 = np.empty(n_pairs, dtype=np.int64)
    pos = 0
    # group points by multiplicity so each group is one vectorized emit
    for m in np.unique(counts):
        sel = counts == m
        starts_m = start[sel]  # [G]
        g = len(starts_m)
        grid_a, grid_b = np.meshgrid(np.arange(m), np.arange(m), indexing="ij")
        # [G, m, m] absolute observation indices
        a = starts_m[:, None, None] + grid_a[None]
        b = starts_m[:, None, None] + grid_b[None]
        n = g * m * m
        o1[pos : pos + n] = a.reshape(-1)
        o2[pos : pos + n] = b.reshape(-1)
        pos += n
    assert pos == n_pairs

    bucket = cam_idx[o1] * n_cams + cam_idx[o2]
    # sort by bucket for a contiguous segment-sum
    order = np.argsort(bucket, kind="stable")
    return (
        o1[order].astype(np.int32),
        o2[order].astype(np.int32),
        bucket[order].astype(np.int32),
    )


def build_blk_idx(pt_idx: np.ndarray, cam_idx: np.ndarray, n_cams: int,
                  n_pts: int) -> np.ndarray:
    """Dense camera-major (cam, point) -> observation-index table.

    The reference builds the same table point-major as blk_idx[i*nCams+j]
    with -1 for unseen cells (misc.cpp:190-199) and loops over it inside
    kern_compute_U/V/S. Here it drives a single row gather that stacks the
    per-observation W blocks into the planar dense [6C, 3P] layout consumed by
    the matmul Schur assembly; unseen cells hold n_obs, the index of an
    appended all-zero row (negative markers would wrap, not fill)."""
    n_obs = len(pt_idx)
    blk = np.full((n_cams, n_pts), n_obs, dtype=np.int32)
    blk[np.asarray(cam_idx), np.asarray(pt_idx)] = np.arange(
        n_obs, dtype=np.int32
    )
    return blk


def visibility_mask(problem: BAProblem) -> np.ndarray:
    """Dense [P, C] uint8 visibility mask (reference vmask layout,
    readparams.cpp:415)."""
    m = np.zeros((problem.n_pts, problem.n_cams), dtype=np.uint8)
    m[problem.pt_idx, problem.cam_idx] = 1
    return m
