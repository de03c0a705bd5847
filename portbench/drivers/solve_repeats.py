"""Driver "solve_repeats": PSBA's default hybrid solve, whole, on one
problem.

Set-up builds the problem and, on the pair encoding, its covisibility pair
list (`BAProblem.with_pairs`, which `solve` then reuses); a step is one call
of `psba_tpu_torch.solve`, the entry users call, so every step runs what a
user's call runs: `from_problem`, `resolve_damping`, `OptState.init`, the
LM / TR phase loop with its GMW bootstrap, and the copies back to the host.
Every step solves the same problem from the same start, so every step does
the same work. The check runs the plain reference of the hybrid solve
(reference/hybrid.py) over the same budget from the same start and judges
each kept answer by

  l2_gap     |L2(p) - L2(p_ref)| / L2(p_ref), the squared reprojection
             error that the solve minimizes, in float64
  iters_gap  |iterations - the reference's|, plus 1 each on another flag,
             another phase list, or TR's lambda bootstrapped at other
             iterations

and reports, unjudged, lm_repeats' proj_err. After a TR phase proj_err
reads the rounding of float32 more than the solve: with a large lambda,
P_B lies nearly along P_U and TR's two-dimensional step is ill-conditioned,
so the answer moves along directions in which the error barely changes.

TR's first lambda at each bootstrap is the rounding noise of a singular S
(reference/hybrid.py), which no reference can work out again or bound;
the reference takes it from the lambda that the judged answer's history
reports at that iteration, and works out everything else itself. So the
traffic asks the solve for its history (`record_history`, host scalars
the loops hold anyway), and the check judges TR from that lambda on, not
the lambda's value: the program's GMW is tested by itself
(tests/test_pb_solve.py).

The traffic file gives the solver settings over PSBA's defaults in the
configuration's dtype (`solver`) and the traced window's length
(`trace_seconds`).
"""

from __future__ import annotations

import math

import numpy as np

SPAN = "solve"                   # the traced span around a step
# by the configuration's dtype: LM's stop threshold and TR's eps2
STOP_THRESH = {"float32": 1e-6, "float64": 1e-12}
EPS2 = {"float32": 3e-7, "float64": 1e-12}


def end_to_end(window: dict) -> dict:
    """The cell's end-to-end values from the window's totals: the whole
    window over the solves completed in it."""
    return dict(solve_s=window["seconds"] / max(window["repeats"], 1))


def bootstraps(phases, history) -> dict | None:
    """{iteration: lambda} at each TR iteration that began at lambda = 0
    (the first of a TR phase, or one after a reset), from a solve's phase
    list and history (None without a history)."""
    if history is None:
        return None
    out, start = {}, 0
    for name, after, _ in phases:
        if name == "tr":
            for k in range(start, after):
                if k == start or history[k - 1, 3] == 0.0:
                    out[k] = float(history[k, 3])
        start = after
    return out


class Program:
    """psba_tpu_torch set up on one problem; `step` is one solve."""

    def __init__(self, arrays: dict, config: dict, traffic: dict, device):
        import torch

        from psba_tpu_torch.problem import BAProblem
        from psba_tpu_torch.solvers.types import SolverConfig, dense_encoding

        self.dtype = getattr(torch, config["dtype"])
        self.schur, self.device = config["schur"], device
        prob = BAProblem(**arrays)
        if not dense_encoding(self.schur, prob.n_cams, prob.n_pts):
            prob = prob.with_pairs()
        self.prob = prob
        self.cfg = SolverConfig.for_dtype(self.dtype)._replace(
            s_precision=config["s_precision"], **traffic["solver"])

    def step(self):
        """One solve, the user's entry (psba_tpu_torch.solve)."""
        from psba_tpu_torch.solvers import hybrid

        return hybrid.solve(self.prob, self.cfg, dtype=self.dtype,
                            device=self.device, schur=self.schur)

    @staticmethod
    def iterations(st) -> int:
        return st.iterations

    @staticmethod
    def keep(st) -> tuple:
        """What the check reads of a solve (already on the host)."""
        return (st.cams.copy(), st.pts.copy(), st.iterations, st.flag,
                [tuple(int(v) if i else v for i, v in enumerate(p))
                 for p in st.phases],
                None if st.history is None else st.history.copy())

    @staticmethod
    def answer(kept: tuple) -> dict:
        cams, pts, itno, flag, phases, history = kept
        return dict(cams=cams.astype(np.float64), pts=pts.astype(np.float64),
                    itno=int(itno), flag=int(flag), phases=phases,
                    boots=bootstraps(phases, history))


def reference_settings(traffic: dict, dtype: str) -> dict:
    """The solver settings the traffic states over PSBA's defaults in the
    configuration's `dtype` (tau 1e-3, 64 tries, switch after 5 good
    steps, 50 iterations, TR radius 1 to at most 10^4; the stop threshold
    and eps2 PSBA's 1e-12 in float64, 1e-6 and 3e-7 in float32), as the
    reference takes them."""
    s = dict(tau=1e-3, stop_thresh=STOP_THRESH[dtype], max_inner=64,
             lm_switch_count=5, max_iters=50, eps2=EPS2[dtype],
             init_delta=1.0, max_delta=1e4, damping="auto")
    s.update({k: v for k, v in traffic["solver"].items() if k in s})
    return s


class Check:
    """The plain reference's hybrid solve from the same start, in `dtype`
    with `matmul` products (float64 and exact; the control is float32 with
    TF32 products and bootstraps lambda itself), and the numbers an answer
    is judged by, in float64. The reference runs once for each set of
    bootstrapped lambdas that the answers report."""

    def __init__(self, arrays: dict, config: dict, traffic: dict, device,
                 matmul: str = "exact", dtype: str = "float64"):
        import torch

        from portbench.reference import lm as ref

        f64 = torch.float64
        dt = getattr(torch, dtype)
        self.device, self.matmul = device, matmul
        self.prob = ref.Problem(arrays, device, dt)
        self.cams0 = torch.as_tensor(arrays["cams"], dtype=f64, device=device)
        self.pts0 = torch.as_tensor(arrays["pts"], dtype=f64, device=device)
        s = reference_settings(traffic, config["dtype"])
        if s["damping"] == "auto":
            s["damping"] = ref.resolve_damping(
                self.prob, self.cams0.to(dt), self.pts0.to(dt), s["tau"],
                np.dtype(config["dtype"]))
        if s["damping"] == "marquardt":
            # TR damps additively: Marquardt keeps the solve in LM
            s["lm_switch_count"] = max(s["lm_switch_count"],
                                       s["max_iters"] + 1)
        self.settings = s
        self.r64 = (self.prob if dt == f64
                    else ref.Problem(arrays, device, f64))
        self.runs = {}
        self.summary = dict(damping=s["damping"], runs=0)

    def predicted(self, cams, pts):
        return self.r64.obs - self.r64.residual(cams, pts)

    def cost(self, cams, pts) -> float:
        return float((self.r64.residual(cams, pts) ** 2).sum())

    def run(self, boots: dict | None) -> dict:
        """The reference's solve, bootstrapping lambda from `boots` where
        it holds the iteration; its result becomes the one judged
        against (cams, pts, x_ref, dx, l2, summary)."""
        import torch

        from portbench.reference import hybrid

        key = None if boots is None else tuple(sorted(boots.items()))
        if key not in self.runs:
            self.runs[key] = hybrid.hybrid(self.prob, self.cams0, self.pts0,
                                           self.settings, self.matmul, boots)
            if self.prob.device.type == "cuda":
                torch.cuda.empty_cache()
        out = self.runs[key]
        f64 = torch.float64
        self.cams, self.pts = out["cams"].to(f64), out["pts"].to(f64)
        self.x_ref = self.predicted(self.cams, self.pts)
        self.dx = float(torch.linalg.norm(
            self.x_ref - self.predicted(self.cams0, self.pts0)))
        self.l2 = self.cost(self.cams, self.pts)
        self.summary = dict(
            iters=out["iters"], flag=out["flag"], phases=out["phases"],
            boots=out["boots"], tries=out["lm_tries"] + out["tr_tries"],
            damping=self.settings["damping"], runs=len(self.runs))
        return out

    def as_answer(self) -> dict:
        """This run's result as an answer (the control's), lambda
        bootstrapped by its own GMW."""
        out = self.run(None)
        return dict(cams=out["cams"].double().cpu().numpy(),
                    pts=out["pts"].double().cpu().numpy(),
                    itno=out["iters"], flag=out["flag"],
                    phases=out["phases"],
                    boots={k: lam for k, lam, _ in out["boots"]})

    def numbers(self, a: dict) -> dict:
        import torch

        out = self.run(a["boots"])
        f64 = torch.float64
        c = torch.as_tensor(a["cams"], dtype=f64, device=self.device)
        p = torch.as_tensor(a["pts"], dtype=f64, device=self.device)
        booted = sorted({k for k, _, _ in out["boots"]})
        given = None if a["boots"] is None else sorted(a["boots"])
        res = dict(
            l2_gap=abs(self.cost(c, p) - self.l2) / self.l2,
            proj_err=float(torch.linalg.norm(self.predicted(c, p)
                                             - self.x_ref)) / self.dx,
            iters_gap=float(abs(a["itno"] - out["iters"])
                            + (a["flag"] != out["flag"])
                            + (list(a["phases"]) != list(out["phases"]))
                            + (given != booted)))
        return {k: v if math.isfinite(v) else math.inf
                for k, v in res.items()}
