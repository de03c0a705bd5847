"""Driver "lm_repeats": fixed-work Levenberg-Marquardt on one problem.

Set-up takes the program through its direct entry, `from_problem ->
OptState.init -> resolve_damping`, the dense encoding in the tile point
order that `solve` applies; a step is one repeat of `lm_run(iter_cap)` from
the set-up's state, so every repeat does the same work. The check runs the
plain reference (reference/lm.py) over the same iterations from the same
start and judges each kept answer by

  proj_err   |x^(p) - x^(p_ref)| / |x^(p_ref) - x^(p0)| over every
             observation's predicted image point x^: how far the answer
             lies from the reference's, in what the parameters predict
             (blind to the gauge, which only the damping pins)
  iters_gap  |iterations - the reference's|, plus 1 on another flag

The traffic file gives `iter_cap`, the solver settings over PSBA's defaults
in the configuration's dtype (`solver`) and the traced window's length
(`trace_seconds`).
"""

from __future__ import annotations

import math

import numpy as np

SPAN = "lm_run"                  # the traced span around a step
# the stop threshold by the configuration's dtype
STOP_THRESH = {"float32": 1e-6, "float64": 1e-12}


def end_to_end(window: dict) -> dict:
    """The cell's end-to-end values from the window's totals: the whole
    window over every LM iteration completed in it."""
    return dict(lm_iter_ms=1e3 * window["seconds"]
                / max(window["iterations"], 1))


class Program:
    """psba_tpu_torch set up on one problem; `step` is one repeat."""

    def __init__(self, arrays: dict, config: dict, traffic: dict, device):
        import torch

        from psba_tpu_torch.problem import BAProblem
        from psba_tpu_torch.solvers.types import (
            OptState,
            ProblemArrays,
            SolverConfig,
            dense_encoding,
            resolve_damping,
        )

        self.dtype = getattr(torch, config["dtype"])
        prob = BAProblem(**arrays)
        schur = config["schur"]
        self.newpos = None
        if dense_encoding(schur, prob.n_cams, prob.n_pts):
            prob, self.newpos = prob.with_tile_point_order()
        self.pa = ProblemArrays.from_problem(prob, dtype=self.dtype,
                                             device=device, schur=schur)
        as_t = lambda a: torch.as_tensor(a, dtype=self.dtype, device=device)
        cams, pts = as_t(prob.cams), as_t(prob.pts)
        cfg = SolverConfig.for_dtype(self.dtype)._replace(
            s_precision=config["s_precision"], **traffic["solver"])
        self.cfg = resolve_damping(cfg, self.pa, cams, pts)
        self.state0 = OptState.init(self.pa, cams, pts,
                                    clamp=self.cfg.clamp_quat)
        self.iter_cap = int(traffic["iter_cap"])

    def step(self):
        """One repeat: lm_run(iter_cap) from the set-up's state."""
        from psba_tpu_torch.solvers import lm

        return lm.lm_run(self.pa, self.state0, self.cfg,
                         iter_cap=self.iter_cap)

    def iterations(self, st) -> int:
        return st.itno - self.state0.itno

    @staticmethod
    def keep(st) -> tuple:
        """What the check reads of a repeat's state, copied to the host at
        once, so that nothing kept stays on the card."""
        return st.cams.detach().cpu(), st.pts.detach().cpu(), st.itno, \
            st.flag

    def answer(self, kept: tuple) -> dict:
        """A kept repeat, points in the caller's order."""
        cams, pts, itno, flag = kept
        pts = pts.double().numpy()
        if self.newpos is not None:
            pts = pts[self.newpos]
        return dict(cams=cams.double().numpy(), pts=pts, itno=int(itno),
                    flag=int(flag))


def reference_settings(traffic: dict, dtype: str) -> dict:
    """The solver settings the traffic states over PSBA's defaults in the
    configuration's `dtype` (tau 1e-3, 64 tries, switch after 5 good
    steps; the stop threshold PSBA's 1e-12 in float64, 1e-6 in float32,
    where 1e-12 sits below round-off), as the reference takes them."""
    solver = dict(tau=1e-3, stop_thresh=STOP_THRESH[dtype], max_inner=64,
                  lm_switch_count=5)
    solver.update({k: v for k, v in traffic["solver"].items()
                   if k in solver})
    solver["iters"] = int(traffic["iter_cap"])
    return solver


class Check:
    """The plain reference's run of the cell's iterations from the same
    start, in `dtype` with `matmul` products (float64 and exact; the
    control is float32 with TF32 products), and the numbers an answer is
    judged by, in float64."""

    FLAGS = {"continue": 3, "turn_to_tr": 2, "err": 4, "dp_no_change": 5,
             "small_enough": 6}

    def __init__(self, arrays: dict, config: dict, traffic: dict, device,
                 matmul: str = "exact", dtype: str = "float64"):
        import torch

        from portbench.reference import lm as ref

        f64 = torch.float64
        dt = getattr(torch, dtype)
        rp = ref.Problem(arrays, device, dt)
        cams0 = torch.as_tensor(arrays["cams"], dtype=dt, device=device)
        pts0 = torch.as_tensor(arrays["pts"], dtype=dt, device=device)
        settings = reference_settings(traffic, config["dtype"])
        settings["damping"] = ref.resolve_damping(
            rp, cams0, pts0, settings["tau"], np.dtype(config["dtype"]))
        out = ref.lm(rp, cams0, pts0, settings, matmul=matmul)
        del rp
        self.device = device
        self.r64 = ref.Problem(arrays, device, f64)
        self.cams0, self.pts0 = cams0.to(f64), pts0.to(f64)
        self.cams, self.pts = out["cams"].to(f64), out["pts"].to(f64)
        self.x_ref = self.predicted(self.cams, self.pts)
        self.dx = float(torch.linalg.norm(
            self.x_ref - self.predicted(self.cams0, self.pts0)))
        self.iters, self.flag = out["iters"], self.FLAGS[out["flag"]]
        self.summary = dict(iters=out["iters"], tries=out["tries"],
                            flag=out["flag"], damping=settings["damping"],
                            l2=out["l2"])

    def predicted(self, cams, pts):
        return self.r64.obs - self.r64.residual(cams, pts)

    def as_answer(self) -> dict:
        """This run's result as an answer (the control's)."""
        return dict(cams=self.cams.cpu().numpy(), pts=self.pts.cpu().numpy(),
                    itno=self.iters, flag=self.flag)

    def numbers(self, a: dict) -> dict:
        import torch

        f64 = torch.float64
        c = torch.as_tensor(a["cams"], dtype=f64, device=self.device)
        p = torch.as_tensor(a["pts"], dtype=f64, device=self.device)
        out = dict(
            proj_err=float(torch.linalg.norm(self.predicted(c, p)
                                             - self.x_ref)) / self.dx,
            iters_gap=float(abs(a["itno"] - self.iters)
                            + (a["flag"] != self.flag)))
        return {k: v if math.isfinite(v) else math.inf
                for k, v in out.items()}
