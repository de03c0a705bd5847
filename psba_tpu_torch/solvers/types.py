"""Solver configuration and problem / state containers (PyTorch
counterpart of psba_tpu.solvers.types, dense encoding only)."""

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

# Dense-Schur cap in (camera x point) cells. The dense path holds the three
# ZW planes and the three ZY planes (144 bytes per cell in float32) plus
# transients of the same order; 128M cells keeps that under about 40 GB of
# the H100's 80 GB. Derived from the layout, not measured. Above it the
# reference switches to the covisibility-pair encoding, which this port
# does not have yet (ROADMAP Queue 1 item 10).
DENSE_MAX_ENTRIES = 128 * 1024 * 1024

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
    """Problem tensors on one device, dense (camera x point) encoding."""

    K: torch.Tensor         # [C, 5]
    q0: torch.Tensor        # [C, 4]
    obs: torch.Tensor       # [O, 2]
    cam_idx: torch.Tensor   # [O] int64
    pt_idx: torch.Tensor    # [O] int64
    obs_du: torch.Tensor    # [C, P] measurements (u), 0 where unseen
    obs_dv: torch.Tensor    # [C, P] measurements (v), 0 where unseen
    valid_d: torch.Tensor   # [C, P] 1.0 where the cell has an observation
    # camera-sorted walk of the observation stream (the TR phase's U / ga
    # kernel, ops.linearize_stream), built once here
    stream: StreamTables

    @staticmethod
    def from_problem(prob, dtype=None, device="cpu",
                     schur="auto") -> "ProblemArrays":
        """Build the tensors of a psba_tpu_torch.problem.BAProblem on
        `device` in `dtype` (default: the problem's own), with the stream
        tables of the camera-ordered walk. Only the dense encoding exists
        in this port; "pairs", or a problem above DENSE_MAX_ENTRIES cells,
        raises NotImplementedError."""
        if schur not in ("auto", "dense", "pairs"):
            raise ValueError(f"schur={schur!r}")
        if schur == "pairs" or (
            schur == "auto"
            and prob.n_cams * prob.n_pts > DENSE_MAX_ENTRIES
        ):
            raise NotImplementedError(
                "covisibility-pair Schur encoding: not ported yet "
                "(ROADMAP Queue 1 item 10)"
            )
        from psba_tpu_torch.ops.linearize_dense import dense_obs_tables

        dt = torch_dtype(prob.pts.dtype if dtype is None else dtype)
        prob = prob.with_blk()
        du, dv, vd = dense_obs_tables(prob.blk_idx, prob.obs, prob.n_obs,
                                      dtype=np_dtype(dt))
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
        i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                      device=device)
        return ProblemArrays(
            K=f(prob.K), q0=f(prob.q0), obs=f(prob.obs),
            cam_idx=i(prob.cam_idx), pt_idx=i(prob.pt_idx),
            obs_du=f(du), obs_dv=f(dv), valid_d=f(vd),
            stream=build_stream_tables(prob.cam_idx, prob.pt_idx,
                                       prob.n_cams, device=device),
        )

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

    `ex` is the residual at phase entry: the dense path computes trial
    gains on the grid and never refreshes it mid-phase (as the reference).
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
