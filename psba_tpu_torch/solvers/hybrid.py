"""Hybrid LM <-> TR controller (PyTorch counterpart of
psba_tpu.solvers.hybrid), LM phase only.

`solve` runs damping resolution, OptState.init and the dense3 LM phase,
with checkpoint / resume. The TR phase is the port's next slice: a run that
reaches it (LM's ITER_TURN_TO_TR, or start="tr") raises
NotImplementedError rather than stopping early, and so do the float64
polish and the pair encoding.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from psba_tpu import constants as CC
from psba_tpu.problem import BAProblem
from psba_tpu.utils.timing import PhaseTimers
from psba_tpu_torch.solvers.lm import lm_fresh_aux, lm_run
from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    resolve_damping,
    torch_dtype,
)

_TR_SLICE = "TR phase: slice 2, ROADMAP Queue 1 item 9"


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
    history: np.ndarray | None = None  # [max_iters, 6] when record_history
    phase_report: str = ""
    resolved_damping: str = ""  # "additive" | "marquardt" after "auto"

    def format_history(self) -> str:
        """Reference-style per-iteration progress lines (LM rows only)."""
        if self.history is None:
            return "(no history recorded)"
        return "\n".join(
            f"itno={int(itno)}\tErr={err:.9E}\trho={rho:f}\tmu={mul:f}"
            for itno, err, rho, mul, _dk, _pn in self.history
            if not np.isnan(itno)
        )

    def __str__(self):
        return (
            f"SolveResult(err {self.initial_error:.6e} -> "
            f"{self.final_error:.6e}, iters={self.iterations}, "
            f"flag={self.flag_name}, {self.wall_s:.3f}s)"
        )


def solve(
    problem: BAProblem,
    config: SolverConfig | None = None,
    dtype=None,
    device="cpu",
    start: str = "lm",
    checkpoint_dir: str | None = None,
    checkpoint_every: int = 8,
    polish_iters: int = 0,
    schur: str = "auto",
) -> SolveResult:
    """LM optimization of a BAProblem on `device`.

    `dtype` (torch or numpy) casts the problem; default keeps its own.
    On a CUDA device the hand-written kernels need float32.
    `checkpoint_dir` enables checkpointing with resume from the newest
    checkpoint; `checkpoint_every` > 0 also cuts the phase into chunks of
    that many iterations and saves the phase scalars at each boundary, so
    a resume is exact mid-phase. Points keep the caller's order
    (point_order "natural")."""
    dt = torch_dtype(problem.pts.dtype if dtype is None else dtype)
    device = torch.device(device)
    if start != "lm":
        raise NotImplementedError(f"start={start!r}: {_TR_SLICE}")
    if polish_iters > 0:
        raise NotImplementedError(
            "polish_iters > 0: the float64 polish needs the XLA-form dense "
            "path, not ported yet (ROADMAP Queue 1 item 10)"
        )
    if device.type == "cuda" and dt != torch.float32:
        raise NotImplementedError(
            f"{dt} on CUDA: the kernels are float32; the float64 dense path "
            "is not ported yet (ROADMAP Queue 1 item 10)"
        )
    cfg = config or SolverConfig.for_dtype(dt)
    point_order = "natural"
    pa = ProblemArrays.from_problem(problem, dtype=dt, device=device,
                                    schur=schur)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    cams, pts = as_t(problem.cams), as_t(problem.pts)
    cfg = resolve_damping(cfg, pa, cams, pts)

    chunk = int(checkpoint_every) if checkpoint_dir else 0
    resume_itno = 0
    resume_aux = None
    if checkpoint_dir:
        from psba_tpu.utils import checkpoint as ckpt

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
            if meta.get("phase", start) != "lm":
                raise NotImplementedError(
                    f"resume into phase {meta.get('phase')!r}: {_TR_SLICE}"
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
            state.aux = lm_fresh_aux(dt, device)
        with timers.phase("lm"):
            cap = min(state.itno + chunk, cfg.max_iters) if chunk else None
            state = lm_run(pa, state, cfg, iter_cap=cap)
        flag = state.flag
        if flag == CC.ITER_TURN_TO_TR:
            raise NotImplementedError(
                f"LM handed over to TR at iteration {state.itno}: "
                f"{_TR_SLICE}"
            )
        mid_phase = (
            chunk > 0
            and flag == CC.ITER_CONTINUE
            and state.itno < cfg.max_iters
        )
        if not mid_phase:
            phases.append(("lm", state.itno, flag))
        if checkpoint_dir:
            from psba_tpu.utils import checkpoint as ckpt

            ckpt.save(
                checkpoint_dir, state.cams.cpu().numpy(),
                state.pts.cpu().numpy(), state.itno, flag, "lm",
                extra={"ex_l2": float(state.ex_l2),
                       "point_order": point_order},
                aux=state.aux.cpu().numpy() if mid_phase else None,
            )
        if not mid_phase:
            break
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
    )
