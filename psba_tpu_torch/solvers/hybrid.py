"""Hybrid LM <-> TR controller (PyTorch counterpart of
psba_tpu.solvers.hybrid).

`solve` runs damping resolution and OptState.init, then alternates the
dense3 LM phase (solvers.lm) and the dense3 TR phase (solvers.tr) until
either returns a flag other than the switch requests. Each switch starts
the new phase with fresh phase scalars, as the reference calls levmar() /
trust_region() afresh. Checkpoint / resume covers both phases. The float64
polish and the pair encoding raise NotImplementedError naming their ROADMAP
item.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from psba_tpu_torch import constants as CC
from psba_tpu_torch.problem import BAProblem
from psba_tpu_torch.solvers.lm import lm_fresh_aux, lm_run
from psba_tpu_torch.solvers.tr import tr_fresh_aux, tr_run
from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    resolve_damping,
    torch_dtype,
)
from psba_tpu_torch.utils import checkpoint as ckpt
from psba_tpu_torch.utils.timing import PhaseTimers


@dataclasses.dataclass
class SolveResult:
    cams: np.ndarray
    pts: np.ndarray
    initial_l2: float
    final_l2: float
    initial_error: float   # sqrt(L2)/n2Dprojs, the reference's metric
    final_error: float
    iterations: int
    flag: int
    flag_name: str
    wall_s: float
    phases: list  # [(phase, itno_after, flag_after)]
    history: np.ndarray | None = None  # [max_iters, 6] when record_history:
    # LM rows (itno, ex_l2, rho, mu, nan, nan), TR rows (itno, act, rho,
    # lambda, delta, p_norm)
    phase_report: str = ""
    resolved_damping: str = ""  # "additive" | "marquardt" after "auto"
    phase_seconds: dict = dataclasses.field(default_factory=dict)  # wall
    # seconds per phase name, summed over the phase's runs

    def format_history(self) -> str:
        """Reference-style per-iteration progress lines (LM and TR rows)."""
        if self.history is None:
            return "(no history recorded)"
        lines = []
        for itno, err, rho, mul, dk, pn in self.history:
            if np.isnan(itno):
                continue
            if np.isnan(dk):
                lines.append(f"itno={int(itno)}\tErr={err:.9E}\trho={rho:f}"
                             f"\tmu={mul:f}")
            else:
                lines.append(f"itno={int(itno)}\tErr={err:.9E}\tDelta={dk:f}"
                             f"\tRho={rho:f}\tnorm_p={pn:f}\tLambda={mul:E}")
        return "\n".join(lines)

    def __str__(self):
        return (
            f"SolveResult(err {self.initial_error:.6e} -> "
            f"{self.final_error:.6e}, iters={self.iterations}, "
            f"flag={self.flag_name}, {self.wall_s:.3f}s)"
        )


def _device(device) -> torch.device:
    """The solve's device: CUDA unless the caller names another. Without a
    card, no device is an error, not a quiet fall-back to the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "psba_tpu_torch.solve runs on the CUDA device by default and "
            "torch sees none; pass device=\"cpu\" to run the plain PyTorch "
            "versions of the kernels on the CPU"
        )
    return torch.device("cuda")


def solve(
    problem: BAProblem,
    config: SolverConfig | None = None,
    dtype=None,
    device=None,
    start: str = "lm",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 8,
    polish_iters: int = 0,
    schur: str = "auto",
) -> SolveResult:
    """Hybrid LM / TR optimization of a BAProblem on `device` (default: the
    CUDA device; pass device="cpu" for the plain PyTorch versions).

    `dtype` (torch or numpy) casts the problem; default keeps its own.
    On a CUDA device the hand-written kernels need float32. `start` is the
    first phase, "lm" or "tr". `checkpoint_dir` enables checkpointing with
    resume from the newest checkpoint; `checkpoint_every` > 0 also cuts each
    phase into chunks of that many iterations and saves the phase scalars at
    each boundary, so a resume is exact mid-phase. Points keep the caller's
    order (point_order "natural")."""
    dt = torch_dtype(problem.pts.dtype if dtype is None else dtype)
    device = _device(device)
    if start not in ("lm", "tr"):
        raise ValueError(f"start={start!r}: 'lm' or 'tr'")
    if polish_iters > 0:
        raise NotImplementedError(
            "polish_iters > 0: the float64 polish needs the XLA-form dense "
            "path, not ported yet (ROADMAP Queue 1 item 11)"
        )
    if device.type == "cuda" and dt != torch.float32:
        raise NotImplementedError(
            f"{dt} on CUDA: the kernels are float32; the float64 dense path "
            "is not ported yet (ROADMAP Queue 1 item 11)"
        )
    cfg = config or SolverConfig.for_dtype(dt)
    point_order = "natural"
    pa = ProblemArrays.from_problem(problem, dtype=dt, device=device,
                                    schur=schur)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    cams, pts = as_t(problem.cams), as_t(problem.pts)
    cfg = resolve_damping(cfg, pa, cams, pts)

    chunk = int(checkpoint_every) if checkpoint_dir else 0
    phase = start
    resume_itno = 0
    resume_aux = None
    if checkpoint_dir:
        restored = ckpt.load_latest(checkpoint_dir)
        if restored is not None:
            r_cams, r_pts, meta = restored
            saved_order = meta.get("point_order", "natural")
            if saved_order != point_order:
                raise ValueError(
                    f"checkpoint in {checkpoint_dir!r} stores points in "
                    f"order {saved_order!r} but this run uses "
                    f"{point_order!r}; resuming would scramble the point "
                    "array — delete the checkpoint or rerun with the "
                    "original settings"
                )
            phase = meta.get("phase", start)
            if phase not in ("lm", "tr"):
                raise NotImplementedError(
                    f"resume into phase {phase!r}: the float64 polish is "
                    "not ported yet (ROADMAP Queue 1 item 11)"
                )
            cams, pts = as_t(r_cams), as_t(r_pts)
            resume_itno = int(meta.get("itno", 0))
            resume_aux = meta.get("aux")

    state = OptState.init(pa, cams, pts, clamp=cfg.clamp_quat)
    state.itno = resume_itno
    if resume_aux is not None:
        state.aux = torch.as_tensor(resume_aux, dtype=dt, device=device)
    initial_l2 = float(state.ex_l2)

    timers = PhaseTimers()
    t0 = time.perf_counter()
    phases = []
    while True:
        if chunk and state.aux is None:
            state.aux = (lm_fresh_aux(dt, device) if phase == "lm"
                         else tr_fresh_aux(cfg, dt, device))
        runner = lm_run if phase == "lm" else tr_run
        with timers.phase(phase):
            cap = min(state.itno + chunk, cfg.max_iters) if chunk else None
            state = runner(pa, state, cfg, iter_cap=cap)
        flag = state.flag
        # chunk boundary: budget left and no phase-ending flag
        mid_phase = (
            chunk > 0
            and flag == CC.ITER_CONTINUE
            and state.itno < cfg.max_iters
        )
        if not mid_phase:
            phases.append((phase, state.itno, flag))
        next_phase = None
        if mid_phase:
            next_phase = phase
        elif phase == "lm" and flag == CC.ITER_TURN_TO_TR:
            next_phase = "tr"
        elif phase == "tr" and flag == CC.ITER_TURN_TO_LM:
            next_phase = "lm"
        if checkpoint_dir:
            ckpt.save(
                checkpoint_dir, state.cams.cpu().numpy(),
                state.pts.cpu().numpy(), state.itno, flag,
                next_phase or phase,
                extra={"ex_l2": float(state.ex_l2),
                       "point_order": point_order},
                aux=state.aux.cpu().numpy() if mid_phase else None,
            )
        if next_phase is None:
            break
        if not mid_phase:
            # a new phase starts with fresh scalars
            state.aux = None
        phase = next_phase
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    final_l2 = float(state.ex_l2)
    n_obs = problem.n_obs
    return SolveResult(
        cams=state.cams.cpu().numpy(),
        pts=state.pts.cpu().numpy(),
        resolved_damping=cfg.damping,
        initial_l2=initial_l2,
        final_l2=final_l2,
        initial_error=float(np.sqrt(initial_l2) / n_obs),
        final_error=float(np.sqrt(final_l2) / n_obs),
        iterations=state.itno,
        flag=flag,
        flag_name=CC.FLAG_NAMES.get(flag, str(flag)),
        wall_s=wall,
        phases=phases,
        history=state.history,
        phase_report=timers.report(),
        phase_seconds=dict(timers.totals),
    )
