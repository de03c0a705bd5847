"""Hybrid LM <-> TR controller (PyTorch counterpart of
psba_tpu.solvers.hybrid).

`solve` picks the Schur encoding (dense, or the covisibility pairs above
DENSE_MAX_ENTRIES cells or on request) and the path (SolverConfig.backend:
by default the kernel path in float32, the XLA form in float64); on the
dense encoding it clusters the points into the dense kernels' tiles
(BAProblem.with_tile_point_order) in either dtype, and maps them back to
the caller's order at the end. It runs damping resolution and
OptState.init, then alternates the LM phase (solvers.lm) and the TR
phase (solvers.tr) until either returns a flag other than the switch
requests. Each switch starts the new phase with fresh
phase scalars, as the reference calls levmar() / trust_region() afresh.

`polish_iters` > 0 appends the float64 polish after a run in another
dtype: phase "lm64", LM in the XLA form on the same device (on CUDA after a
float32 run that launched the kernels), with lm_switch_count 10,000, damping
resolved again in float64 and the budget polish_target = the main run's
iterations + polish_iters. Checkpoint / resume covers all three phases; an
"lm64" checkpoint carries polish_target, and a resume into it skips the
main run. With utils.debug's NaN checks on, every phase and chunk boundary
reads isfinite over the parameters and ex_l2.
"""

from __future__ import annotations

import dataclasses
import time
import zlib

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
    dense_encoding,
    resolve_damping,
    torch_dtype,
)
from psba_tpu_torch.utils import checkpoint as ckpt
from psba_tpu_torch.utils.debug import check_finite
from psba_tpu_torch.utils.device import resolve_device
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
    collectives: dict = dataclasses.field(default_factory=dict)  # a
    # sharded solve's collectives by tag: calls, bytes, seconds (timed only
    # on request; parallel.ctx.MeshCtx.summary)

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
    With the default backend a float32 solve takes the kernel path (the
    hand-written kernels on CUDA) and a float64 solve the XLA form (torch
    ops: cuBLAS DGEMM and cuSOLVER on the card). `start` is the first
    phase, "lm" or "tr". `checkpoint_dir` enables checkpointing with
    resume from the newest checkpoint; `checkpoint_every` > 0 also cuts each
    phase into chunks of that many iterations and saves the phase scalars at
    each boundary, so a resume is exact mid-phase. `polish_iters` > 0
    appends that many float64 LM iterations after a run in another dtype
    (phase "lm64", see the module docstring). `schur` picks the
    encoding of the reduced camera system: "dense", "pairs" (the
    covisibility pair list), or "auto" (dense up to
    solvers.types.DENSE_MAX_ENTRIES camera x point cells, pairs above).
    The dense encoding works on the points clustered into the dense
    kernels' tiles, and checkpoints hold them in that order (point_order
    "tile-<crc32 of the map>"); the pair encoding keeps the caller's
    order ("natural"). A resume refuses a checkpoint of another order.
    SolveResult.pts comes back in the caller's order."""
    dt = torch_dtype(problem.pts.dtype if dtype is None else dtype)
    device = resolve_device(device, "psba_tpu_torch.solve")
    if start not in ("lm", "tr"):
        raise ValueError(f"start={start!r}: 'lm' or 'tr'")
    cfg = config or SolverConfig.for_dtype(dt)
    point_map = None
    if dense_encoding(schur, problem.n_cams, problem.n_pts):
        # newpos[i] = the solver's index of the caller's point i
        problem, point_map = problem.with_tile_point_order()
    point_order = ("natural" if point_map is None else
                   f"tile-{zlib.crc32(np.ascontiguousarray(point_map)):08x}")
    pa = ProblemArrays.from_problem(problem, dtype=dt, device=device,
                                    schur=schur, backend=cfg.backend)
    as_t = lambda a, d=dt: torch.as_tensor(np.asarray(a), dtype=d,
                                           device=device)
    cams, pts = as_t(problem.cams), as_t(problem.pts)
    cfg = resolve_damping(cfg, pa, cams, pts)

    chunk = int(checkpoint_every) if checkpoint_dir else 0
    phase = start
    resume_itno = 0
    resume_aux = None
    polish_target = None
    resume64 = None
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
            cams, pts = as_t(r_cams), as_t(r_pts)
            resume_itno = int(meta.get("itno", 0))
            resume_aux = meta.get("aux")
            if meta.get("polish_target") is not None:
                polish_target = int(meta["polish_target"])
            if phase == "lm64":
                # the polish resumes from the checkpoint's float64 values
                resume64 = (r_cams, r_pts)

    state = OptState.init(pa, cams, pts, clamp=cfg.clamp_quat)
    state.itno = resume_itno
    if resume_aux is not None and phase != "lm64":
        state.aux = torch.as_tensor(resume_aux, dtype=dt, device=device)
    initial_l2 = float(state.ex_l2)
    check_finite("init", cams=state.cams, pts=state.pts, ex_l2=state.ex_l2)

    timers = PhaseTimers()
    t0 = time.perf_counter()
    phases = []
    flag = state.flag
    while phase != "lm64":
        if chunk and state.aux is None:
            state.aux = (lm_fresh_aux(dt, device) if phase == "lm"
                         else tr_fresh_aux(cfg, dt, device))
        runner = lm_run if phase == "lm" else tr_run
        with timers.phase(phase):
            cap = min(state.itno + chunk, cfg.max_iters) if chunk else None
            state = runner(pa, state, cfg, iter_cap=cap)
        flag = state.flag
        check_finite(phase, cams=state.cams, pts=state.pts,
                     ex_l2=state.ex_l2)
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

    if polish_iters > 0 and dt != torch.float64:
        f64 = torch.float64
        if polish_target is None:
            polish_target = state.itno + polish_iters
        cfg64 = SolverConfig.for_dtype(f64)._replace(
            max_iters=polish_target, lm_switch_count=10_000)
        # the main run's tensors (the grid tables among them) go first
        pa = None
        pa64 = ProblemArrays.from_problem(problem, dtype=f64, device=device,
                                          schur=schur, backend=cfg64.backend)
        if resume64 is not None:
            c64, p64 = (as_t(a, f64) for a in resume64)
        else:
            c64, p64 = state.cams.to(f64), state.pts.to(f64)
        state64 = OptState.init(pa64, c64, p64, clamp=cfg.clamp_quat)
        state64.itno = state.itno
        # the damping thresholds depend on the dtype
        cfg64 = resolve_damping(cfg64, pa64, state64.cams, state64.pts)
        if chunk:
            state64.aux = (
                torch.as_tensor(resume_aux, dtype=f64, device=device)
                if resume64 is not None and resume_aux is not None
                else lm_fresh_aux(f64, device))
        while True:
            with timers.phase("lm64"):
                cap = (min(state64.itno + chunk, polish_target) if chunk
                       else None)
                state64 = lm_run(pa64, state64, cfg64, iter_cap=cap)
            flag = state64.flag
            check_finite("lm64", cams=state64.cams, pts=state64.pts,
                         ex_l2=state64.ex_l2)
            mid_phase = (
                chunk > 0
                and flag == CC.ITER_CONTINUE
                and state64.itno < polish_target
            )
            if checkpoint_dir:
                ckpt.save(
                    checkpoint_dir, state64.cams.cpu().numpy(),
                    state64.pts.cpu().numpy(), state64.itno, flag, "lm64",
                    extra={"ex_l2": float(state64.ex_l2),
                           "polish_target": polish_target,
                           "point_order": point_order},
                    aux=state64.aux.cpu().numpy() if mid_phase else None,
                )
            if not mid_phase:
                break
        state = state64
        phases.append(("lm64", state.itno, flag))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    final_l2 = float(state.ex_l2)
    n_obs = problem.n_obs
    pts_out = state.pts.cpu().numpy()
    if point_map is not None:
        pts_out = pts_out[point_map]
    return SolveResult(
        cams=state.cams.cpu().numpy(),
        pts=pts_out,
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
