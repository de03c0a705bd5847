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

# Dense-Schur cap in (camera x point) cells: schur="auto" takes the dense
# encoding up to it and the covisibility-pair encoding above. The dense S
# products cost 6C x 6C x 3P multiply-adds whatever the sparsity, the pair
# products one 6x3 by 3x6 product per covisibility pair. At Dubrovnik-356's
# counts (356 cameras x 226,730 points = 80.7M cells, 5 observations per
# point; chip_smoke.py --cap, float32, one H100 80GB HBM3 at 700 W) the
# dense encoding took 186.8 ms per LM iteration and 21.1 GB of device
# memory, the pair encoding 29.7 ms and 2.1 GB. So the cap sits below that
# shape, at the reference's own 32M cells.
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

    In this port `backend`, `s_reduce` and `s_precision` keep their names
    so configurations carry over: `backend` must be "auto" or "pallas"
    (both mean the hand-written kernels on CUDA), `s_reduce` only matters
    on a mesh, and `s_precision` must be "highest"."""

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


def _diag_minmax(K, q0, cams, pts, cam_idx, pt_idx, clamp):
    """max / min-positive of diag(J^T J) from one Jacobian probe."""
    from psba_tpu_torch.core.jacobian import jacobians

    A, B = jacobians(K, q0, cams, pts, cam_idx, pt_idx, clamp=clamp)
    dU = torch.zeros((K.shape[0], 6), dtype=A.dtype, device=A.device)
    dU.index_add_(0, cam_idx, (A * A).sum(1))
    dV = torch.zeros((pts.shape[0], 3), dtype=A.dtype, device=A.device)
    dV.index_add_(0, pt_idx, (B * B).sum(1))
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
                          cfg.clamp_quat)
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
    present: the dense (camera x point) tables, or the covisibility pair
    list (problem.build_covis_pairs)."""

    K: torch.Tensor         # [C, 5]
    q0: torch.Tensor        # [C, 4]
    obs: torch.Tensor       # [O, 2]
    cam_idx: torch.Tensor   # [O] int64
    pt_idx: torch.Tensor    # [O] int64
    # int32 copies of the two index streams, read by the residual_l2 kernel
    # (the same tensors as stream.cam32 / stream.pt32)
    cam_idx32: torch.Tensor
    pt_idx32: torch.Tensor
    # the camera-sorted and point-sorted walks of the observation stream
    # (ops.linearize_stream), built once here
    stream: StreamTables
    # dense encoding
    obs_du: torch.Tensor | None = None   # [C, P] measurements (u), 0 unseen
    obs_dv: torch.Tensor | None = None   # [C, P] measurements (v), 0 unseen
    valid_d: torch.Tensor | None = None  # [C, P] 1.0 where observed
    # pair encoding: observation pairs of one point, sorted by their bucket
    # cam(o1) * C + cam(o2); bucket C*C marks padding
    pair_o1: torch.Tensor | None = None      # [N] int64
    pair_o2: torch.Tensor | None = None      # [N] int64
    pair_bucket: torch.Tensor | None = None  # [N] int64

    @staticmethod
    def from_problem(prob, dtype=None, device="cpu",
                     schur="auto") -> "ProblemArrays":
        """Build the tensors of a psba_tpu_torch.problem.BAProblem on
        `device` in `dtype` (default: the problem's own), with the stream
        tables of the camera-ordered walk. `schur` picks the encoding:
        "dense", "pairs", or "auto" (dense up to DENSE_MAX_ENTRIES camera x
        point cells, pairs above)."""
        if schur not in ("auto", "dense", "pairs"):
            raise ValueError(f"schur={schur!r}")
        if schur == "auto":
            schur = ("dense" if prob.n_cams * prob.n_pts <= DENSE_MAX_ENTRIES
                     else "pairs")
        dt = torch_dtype(prob.pts.dtype if dtype is None else dtype)
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        i = lambda a, kind=torch.int64: torch.as_tensor(
            np.asarray(a), dtype=kind, device=device)
        if schur == "dense":
            from psba_tpu_torch.ops.linearize_dense import dense_obs_tables

            prob = prob.with_blk()
            du, dv, vd = dense_obs_tables(prob.blk_idx, prob.obs,
                                          prob.n_obs, dtype=np_dtype(dt))
            enc = dict(obs_du=f(du), obs_dv=f(dv), valid_d=f(vd))
        else:
            prob = prob.with_pairs()
            enc = dict(pair_o1=i(prob.pair_o1), pair_o2=i(prob.pair_o2),
                       pair_bucket=i(prob.pair_bucket))
        stream = build_stream_tables(prob.cam_idx, prob.pt_idx, prob.n_cams,
                                     prob.n_pts, device=device)
        return ProblemArrays(
            K=f(prob.K), q0=f(prob.q0), obs=f(prob.obs),
            cam_idx=i(prob.cam_idx), pt_idx=i(prob.pt_idx),
            cam_idx32=stream.cam32, pt_idx32=stream.pt32, stream=stream,
            **enc,
        )

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
    def init(pa: ProblemArrays, cams, pts, clamp=False) -> "OptState":
        from psba_tpu_torch.core.residual import error_l2, residuals

        ex = residuals(pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx,
                       pa.pt_idx, clamp=clamp)
        return OptState(cams=cams, pts=pts, ex=ex, ex_l2=error_l2(ex))
