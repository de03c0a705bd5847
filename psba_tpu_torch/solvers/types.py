"""Solver configuration and problem / state containers (PyTorch
counterpart of psba_tpu.solvers.types)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from psba_tpu_torch import constants as C
from psba_tpu_torch.ops.linearize_stream import (
    StreamTables,
    build_stream_tables,
)
from psba_tpu_torch.ops.reduce import indexed_sum
from psba_tpu_torch.ops.schur_pairs import pair_offsets
from psba_tpu_torch.parallel.ctx import NO_MESH, MeshCtx
from psba_tpu_torch.utils.device import resolve_device

# Dense-Schur cap in (camera x point) cells: schur="auto" takes the dense
# encoding up to it and the covisibility-pair encoding above. The dense S
# products cost 6C x 6C x 3P multiply-adds whatever the sparsity, the pair
# products one 6x3 by 3x6 product per covisibility pair. At Dubrovnik-356's
# counts (356 cameras x 226,730 points = 80.7M cells, 5 observations per
# point; chip_smoke.py --cap, float32, one H100 80GB HBM3 at 700 W) the
# dense encoding took 186.8 ms per LM iteration and 21.1 GB of device
# memory, the pair encoding 29.7 ms and 2.1 GB, its products then a cuBLAS
# batched product and an index_put_ bucket sum (85.3 ms a try at
# Final-961's counts on that card, against 1.43 ms for the kernel that
# replaced them, ops.schur_pairs). So the cap sits below that shape, at
# the reference's own 32M cells.
DENSE_MAX_ENTRIES = 32 * 1024 * 1024

_NP_OF_TORCH = {torch.float32: np.float32, torch.float64: np.float64}
_TORCH_OF_NP = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float64): torch.float64}


def np_dtype(dtype) -> np.dtype:
    """numpy dtype of a torch or numpy floating dtype."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NP_OF_TORCH[dtype])
    return np.dtype(dtype)


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype of a torch or numpy floating dtype."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_OF_NP[np.dtype(dtype)]


class SolverConfig(NamedTuple):
    """Same fields and defaults as psba_tpu.solvers.types.SolverConfig.

    `backend` (resolved by use_kernels):
      - "pallas": the kernel path, the hand-written kernels on CUDA tensors
        and their plain versions on CPU tensors: dense3 on the dense
        encoding, the observation-stream kernels on the pairs;
      - "xla": the XLA form (core.hessian.assemble_blocks, the dense or the
        pair Schur family, spd_solve_xla) in any dtype; on CUDA float32 it
        is a request for a path of torch ops only, and stays one;
      - "auto": the kernel path for float32, the XLA form for float64, on
        any device. Named deviation: the reference's "auto" takes the XLA
        form for float32 off the TPU; the port keeps the kernels' plain
        versions on a CPU float32 run.
    `s_reduce` picks the collective of the S assembly on a mesh
    (parallel.ctx.MeshCtx: "psum" all_reduce, "scatter" reduce_scatter +
    all_gather). `s_precision` "highest" or "high" (the reference's
    Precision.HIGH on the dense3 products, about 2^-21 relative): the port
    runs both in full float32 on every path, a named deviation
    (core.schur)."""

    tau: float = C.PSBA_INIT_MU
    stop_thresh: float = C.PSBA_STOP_THRESH
    eps2: float = C.PSBA_EPSILON2
    max_iters: int = C.MAX_TOTAL_ITERS
    max_delta: float = C.TR_MAX_DELTA
    init_delta: float = C.TR_INIT_DELTA
    clamp_quat: bool = False
    max_inner: int = 64
    lm_switch_count: int = 5
    backend: str = "auto"
    s_reduce: str = "psum"
    record_history: bool = False
    s_precision: str = "highest"
    damping: str = "auto"

    @classmethod
    def for_dtype(cls, dtype, **overrides) -> "SolverConfig":
        """Defaults adapted to the working precision: float32 gets stop
        thresholds it can reach (the reference's 1e-12 sit below float32
        roundoff)."""
        if np_dtype(dtype) == np.float32:
            base = cls(stop_thresh=1e-6, eps2=3e-7)
        else:
            base = cls()
        return base._replace(**overrides) if overrides else base


def kernels_for(backend: str, dtype) -> bool:
    """True when `backend` in `dtype` resolves to the kernel path."""
    if backend == "pallas":
        return True
    if backend == "xla":
        return False
    if backend == "auto":
        return torch_dtype(dtype) == torch.float32
    raise ValueError(f"backend={backend!r}: 'auto', 'pallas' or 'xla'")


def use_kernels(cfg: SolverConfig, dtype) -> bool:
    """Backend resolution (the port's counterpart of the reference's
    use_pallas; see SolverConfig.backend)."""
    return kernels_for(cfg.backend, dtype)


def dense_encoding(schur: str, n_cams: int, n_pts: int) -> bool:
    """True when `schur` ("dense", "pairs", or "auto": dense up to
    DENSE_MAX_ENTRIES camera x point cells) takes the dense encoding."""
    if schur not in ("auto", "dense", "pairs"):
        raise ValueError(f"schur={schur!r}")
    return schur == "dense" or (
        schur == "auto" and n_cams * n_pts <= DENSE_MAX_ENTRIES)


def _diag_minmax(K, q0, cams, pts, cam_idx, pt_idx, clamp, valid=None):
    """max / min-positive of diag(J^T J) from one Jacobian probe; `valid`
    [O] (bool or None) weighs out padded observations."""
    from psba_tpu_torch.core.jacobian import jacobians

    A, B = jacobians(K, q0, cams, pts, cam_idx, pt_idx, clamp=clamp)
    a2, b2 = (A * A).sum(1), (B * B).sum(1)
    if valid is not None:
        w = valid[:, None].to(a2.dtype)
        a2, b2 = a2 * w, b2 * w
    # fixed-order sums: the same bits, and so the same damping, on every run
    dU = indexed_sum(a2, cam_idx, K.shape[0])
    dV = indexed_sum(b2, pt_idx, pts.shape[0])
    d = torch.cat([dU.reshape(-1), dV.reshape(-1)])
    mn = torch.min(torch.where(d > 0, d, torch.full_like(d, float("inf"))))
    return torch.max(d), mn


def resolve_damping(cfg: SolverConfig, pa: "ProblemArrays", cams,
                    pts) -> SolverConfig:
    """Resolve damping="auto" from the Hessian diagonal's dynamic range:
    additive while tau * max(diag)/min(diag>0) < 1/eps(dtype), Marquardt
    beyond (which also pushes lm_switch_count past max_iters, since the TR
    phase damps additively). See psba_tpu.solvers.types.resolve_damping."""
    if cfg.damping != "auto":
        return cfg
    dtype = np_dtype(cams.dtype)
    mx, mn = _diag_minmax(pa.K, pa.q0, cams, pts, pa.cam_idx, pa.pt_idx,
                          cfg.clamp_quat, valid=pa.valid)
    ratio = float(mx) / max(float(mn), np.finfo(dtype).tiny)
    if cfg.tau * ratio < 1.0 / np.finfo(dtype).eps:
        return cfg._replace(damping="additive")
    return cfg._replace(
        damping="marquardt",
        lm_switch_count=max(cfg.lm_switch_count, cfg.max_iters + 1),
    )


@dataclasses.dataclass(frozen=True)
class ProblemArrays:
    """Problem tensors on one device. Exactly one Schur encoding is
    present: the dense (camera x point) table blk_idx, or the covisibility
    pair list (problem.build_covis_pairs). What only the kernel path reads
    (the stream tables, the int32 index copies, the dense grid tables) is
    built only for it (from_problem's `backend`)."""

    K: torch.Tensor         # [C, 5]
    q0: torch.Tensor        # [C, 4]
    obs: torch.Tensor       # [O, 2]
    cam_idx: torch.Tensor   # [O] int64
    pt_idx: torch.Tensor    # [O] int64
    # kernel path: int32 copies of the two index streams, read by the
    # residual_l2 kernel (the same tensors as stream.cam32 / stream.pt32)
    cam_idx32: torch.Tensor | None = None
    pt_idx32: torch.Tensor | None = None
    # kernel path: the camera-sorted and point-sorted walks of the
    # observation stream (ops.linearize_stream), built once here
    stream: StreamTables | None = None
    # dense encoding: the (camera, point) -> observation table, n_obs where
    # unseen (core.schur.stack_blocks); the grid tables on the kernel path
    blk_idx: torch.Tensor | None = None  # [C, P] int64
    obs_du: torch.Tensor | None = None   # [C, P] measurements (u), 0 unseen
    obs_dv: torch.Tensor | None = None   # [C, P] measurements (v), 0 unseen
    valid_d: torch.Tensor | None = None  # [C, P] 1.0 where observed
    # (camera, point tile) occupancy of valid_d for the dense kernels' exact
    # skip (ops.linearize_dense.build_tile_mask); None visits every pair
    tile_mask: torch.Tensor | None = None  # [C, Pp / PTILE] int32
    # pair encoding: observation pairs of one point, sorted by their bucket
    # cam(o1) * C + cam(o2); bucket C*C marks padding
    pair_o1: torch.Tensor | None = None      # [N] int64
    pair_o2: torch.Tensor | None = None      # [N] int64
    pair_bucket: torch.Tensor | None = None  # [N] int64
    # kernel path, pair encoding: the first pair of each bucket and, last,
    # the end of the real pairs (ops.schur_pairs.pair_offsets), built once
    # here
    pair_start: torch.Tensor | None = None   # [C*C + 1] int64
    # [O] bool, False on the padding of a shard (parallel.shard); None when
    # every observation is real
    valid: torch.Tensor | None = None
    # [C, 9] camera rows K | q0, built once here for the dense kernels
    kq: torch.Tensor = dataclasses.field(init=False, repr=False)
    # [O] `valid` in the working dtype, the stream kernels' mask
    valid_f: torch.Tensor | None = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        object.__setattr__(self, "kq", torch.cat([self.K, self.q0], dim=1))
        object.__setattr__(self, "valid_f", None if self.valid is None
                           else self.valid.to(self.K.dtype))

    @staticmethod
    def from_problem(prob, dtype=None, device=None, schur="auto",
                     backend="auto", valid=None) -> "ProblemArrays":
        """Build the tensors of a psba_tpu_torch.problem.BAProblem on
        `device` (default: the CUDA device, an error without one;
        device="cpu" for the plain versions) in `dtype` (default: the
        problem's own). `schur` picks the
        encoding: "dense", "pairs", or "auto" (dense up to
        DENSE_MAX_ENTRIES camera x point cells, pairs above). `backend`
        (SolverConfig.backend, resolved in `dtype`) says which path will
        read them: the kernel path also gets the stream tables of the
        camera-ordered walk and, dense, the grid tables with their
        occupancy table, pairs, the bucket offsets pair_start (raising
        unless the pair list is sorted by bucket); the XLA form gets none,
        so a float64 dense solve does not hold the grid. `valid` [O] (numpy
        bool) marks the real observations of a padded problem
        (parallel.shard); padded observations must repeat a real one, stay
        out of blk_idx and the pair list (bucket C*C, at its end), and keep
        the stream sorted by point."""
        device = resolve_device(device, "ProblemArrays.from_problem")
        schur = ("dense" if dense_encoding(schur, prob.n_cams, prob.n_pts)
                 else "pairs")
        dt = torch_dtype(prob.pts.dtype if dtype is None else dtype)
        kernels = kernels_for(backend, dt)
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                      device=device)
        if schur == "dense":
            prob = prob.with_blk()
            enc = dict(blk_idx=i(prob.blk_idx))
            if kernels:
                from psba_tpu_torch.ops.linearize_dense import (
                    build_tile_mask,
                    dense_obs_tables,
                )

                du, dv, vd = dense_obs_tables(prob.blk_idx, prob.obs,
                                              prob.n_obs, dtype=np_dtype(dt))
                valid_d = f(vd)
                enc.update(obs_du=f(du), obs_dv=f(dv), valid_d=valid_d,
                           tile_mask=build_tile_mask(valid_d))
        else:
            prob = prob.with_pairs()
            enc = dict(pair_o1=i(prob.pair_o1), pair_o2=i(prob.pair_o2),
                       pair_bucket=i(prob.pair_bucket))
            if kernels:
                enc["pair_start"] = pair_offsets(enc["pair_bucket"],
                                                 prob.n_cams)
        if kernels:
            stream = build_stream_tables(prob.cam_idx, prob.pt_idx,
                                         prob.n_cams, prob.n_pts,
                                         device=device)
            enc.update(cam_idx32=stream.cam32, pt_idx32=stream.pt32,
                       stream=stream)
        if valid is not None:
            enc["valid"] = torch.as_tensor(np.asarray(valid, bool),
                                           device=device)
        return ProblemArrays(
            K=f(prob.K), q0=f(prob.q0), obs=f(prob.obs),
            cam_idx=i(prob.cam_idx), pt_idx=i(prob.pt_idx), **enc,
        )

    def need(self, kernels: bool) -> None:
        """Raise unless these tensors carry what the chosen path reads."""
        if kernels and (self.stream is None
                        or (not self.pairs and self.obs_du is None)
                        or (self.pairs and self.pair_start is None)):
            raise ValueError(
                "ProblemArrays built for the XLA form: the kernel path "
                "needs the stream tables, the grid tables (dense) or the "
                "bucket offsets pair_start (pairs) (from_problem with "
                "backend='pallas', or 'auto' in float32)")
        if not kernels and not self.pairs and self.blk_idx is None:
            raise ValueError("the dense XLA form needs blk_idx")

    @property
    def pairs(self) -> bool:
        """True under the pair encoding."""
        return self.pair_o1 is not None

    @property
    def n_cams(self) -> int:
        return self.K.shape[0]

    @property
    def n_obs(self) -> int:
        return self.obs.shape[0]


@dataclasses.dataclass
class OptState:
    """Parameters and solver scalars shared by the LM and TR phases and
    `solve`.

    `ex` is the residual: the pair path refreshes it on every accepted
    step (its trial gains are error_l2_diff(ex, new_ex)); the dense path
    computes trial gains on the grid and leaves it at its phase-entry value
    (as the reference).
    `history` rows are (itno, ex_l2, rho, mu, nan, nan) for LM iterations
    and (itno, act, rho, lambda, delta, p_norm) for TR iterations, NaN
    where unused. `aux` is the phase-scalar carry for chunked
    checkpointing, LM (mu, nu, p_l2, good_cnt, first, 0) or TR (delta,
    lambda, origin_lambda, nu, notgood, good_iters): present means resume
    mid-phase."""

    cams: torch.Tensor           # [C, 6]
    pts: torch.Tensor            # [P, 3]
    ex: torch.Tensor             # [O, 2]
    ex_l2: torch.Tensor          # 0-d, working dtype
    itno: int = 0
    flag: int = C.ITER_CONTINUE
    history: np.ndarray | None = None
    aux: torch.Tensor | None = None

    @staticmethod
    def init(pa: ProblemArrays, cams, pts, clamp=False,
             ctx: MeshCtx = NO_MESH) -> "OptState":
        """The residual and its L2 (summed over the mesh of `ctx`) at
        (cams, pts)."""
        from psba_tpu_torch.core.residual import error_l2, residuals

        ex = residuals(pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx,
                       pa.pt_idx, clamp=clamp)
        return OptState(cams=cams, pts=pts, ex=ex,
                        ex_l2=ctx.psum(error_l2(ex, pa.valid), tag="init"))
