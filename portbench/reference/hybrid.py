"""Plain reference of PSBA's default hybrid solve: LM, the switch to dogleg
TR, TR with its lambda escalation and GMW bootstrap, and the hand-back.

Plain PyTorch, written from PSBA's published solver (levmar.cpp,
trust_region.cpp, cl_cholmod.cpp, main.cpp); it imports nothing of the
program. The camera model, the Jacobians, the per-point Schur products and
the LM phase are reference/lm.py's, reused as they stand.

  phase loop     LM from iteration 0; LM hands over to TR after
                 lm_switch_count consecutive accepted steps with |rho - 1|
                 < 1/5 (levmar.cpp:215-221), TR back to LM on its hand-back
                 flag; every phase starts with fresh phase scalars, and
                 LM and TR share one budget of max_iters iterations
                 (main.cpp:193-208). Any other flag, or the budget, ends
                 the solve.
  TR iteration   B = 2 J^T J and g = -2 J^T e in blocks; the Cauchy step
                 P_U = -(g^T g / g^T B g) g, formed on g / max|g|; the
                 Gauss-Newton step P_B = -dp, (B + lambda I) dp = g by the
                 Schur reduction (compute_PB, trust_region.cpp:292-405)
  lambda         a Cholesky failure at lambda = 0 bootstraps lambda =
                 |sum E| / n from the GMW modified Cholesky of S (below;
                 trust_region.cpp:358-364); a later failure doubles it;
                 once a lambda has succeeded, a failure scales it by nu
                 and doubles nu, and nu > 4 hands back to LM; 64 tries
  step           the minimizer of the model over span{P_U, P_B} inside
                 the radius, else P_U scaled to it, P_B, or the dogleg
                 point on the radius (compute_p_2, trust_region.cpp:520-595)
  radius         rho = gain / (L2 - L(p)), L(p) = L2 + g^T p + p^T B p / 2;
                 the radius /4 on rho < 1/4 or a loss, x2 (to 10^4) on rho
                 >= 3/4; accept on rho >= 1/4 with a gain; a NaN rho, or 5
                 rho < 1/4 in a row, hands back to LM; 10 rho > 3/4 in a
                 row reset lambda to 0; stop when |gain| / L2 <= eps2; at
                 most 200 radius tries an iteration (trust_region.cpp:
                 180-272)
  GMW            A + E = L D L^T with E diagonal: delta = 1e-15 max(xi +
                 eta, 1), beta^2 = max(eta, xi / sqrt(n^2 - 1), 1e-15)
                 (get_delta_beta, cl_cholmod.cpp:109-167), d_j = max(|c_jj|,
                 theta_j^2 / beta^2, delta), E_j = d_j - c_jj, which is
                 diag(L D L^T) - diag(A) (compute_cholmod_E, :176-202); in
                 panels of `GMW_BLOCK` columns, with the same arithmetic

Departures from PSBA, each where the reference follows the program:
  - float32 stop thresholds: a float32 configuration stops on 1e-6
    (LM) and 3e-7 (TR's eps2), PSBA's 1e-12 sitting below float32
    round-off (the program's float32 defaults); float64 keeps PSBA's
  - the trial gain is the factored sum (e_old - e_new)(e_old + e_new),
    and every p^T B p an explicit 2 |J p|^2; the tracked L2 falls by each
    step's gain with rho above 1/4 (as the program's TR); an LM phase
    starts from the L2 of its own residual
  - the Cauchy step is formed on g / max|g|
  - a singular V block is not tested (every point has two views or more)
  - at lambda = 0 the Cholesky is taken as failed: S is singular along
    the gauge, so it fails in exact arithmetic, and whether a computed
    factor fails is rounding (in float64, a run's atomic sums decide it)
  - PSBA caps the iterations at 50; the budget here is the traffic's

What the reference cannot work out again: at lambda = 0, S is singular
along the 7-dimensional similarity gauge (no camera is fixed), so the
Cholesky fails on rounding and GMW's E sits on the pivots that rounding
left: lambda is the rounding noise of S, and a perturbation of S by one
unit in its last place moves it by orders of magnitude. `boots`, where
given, holds the lambda that the judged run reports for each iteration;
a bootstrap at such an iteration takes it instead of its own, and is
recorded as taken. Everything else is the reference's own.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import lm as ref

# PSBA's flags (psba.h:12-18)
FLAG = {"turn_to_lm": 1, "turn_to_tr": 2, "continue": 3, "err": 4,
        "dp_no_change": 5, "small_enough": 6}
MAX_SOLVE_TRIES = 64
MAX_MODEL_TRIES = 200
GMW_BLOCK = 64


def gmw_delta_beta(A: torch.Tensor) -> tuple:
    """(delta, beta^2) of get_delta_beta, as floats."""
    n = A.shape[0]
    diag = torch.diagonal(A)
    eta = float(diag.abs().max())
    xi = float((A - torch.diag(diag)).abs().max())
    delta = 1e-15 * max(xi + eta, 1.0)
    beta2 = max(eta, xi / math.sqrt(float(n * n - 1)), 1e-15)
    return delta, beta2


def gmw_perturbation(A: torch.Tensor, mm: ref.Products | None = None,
                     block: int = GMW_BLOCK) -> torch.Tensor:
    """The GMW diagonal perturbation E [n] with A + E = L D L^T, right
    looking: each column's pivot from the column as the earlier columns
    left it, the columns of a panel updated inside it, the trailing matrix
    once a panel by one product (`mm`'s)."""
    mm = mm or ref.Products("exact")
    n = A.shape[0]
    delta, beta2 = gmw_delta_beta(A)
    c = A.clone()
    E = torch.zeros(n, dtype=A.dtype, device=A.device)
    for k0 in range(0, n, block):
        k1 = min(k0 + block, n)
        b = k1 - k0
        panel = c[k0:, k0:k1].clone()                  # [n - k0, b]
        cols = torch.zeros_like(panel)
        dinv = torch.zeros(b, dtype=A.dtype, device=A.device)
        for j in range(b):
            col = panel[j + 1:, j]
            theta = (col.abs().max() if col.numel()
                     else torch.zeros((), dtype=A.dtype, device=A.device))
            cjj = panel[j, j]
            dj = torch.clamp(torch.maximum(cjj.abs(), theta * theta / beta2),
                             min=delta)
            E[k0 + j] = dj - cjj
            if j + 1 < b:
                panel[j + 1:, j + 1:] -= torch.outer(col, col[:b - j - 1]
                                                     / dj)
            cols[j + 1:, j] = col
            dinv[j] = 1.0 / dj
        if k1 < n:
            Pm = cols[b:]                                 # rows k1..n-1
            c[k1:, k1:] -= mm.einsum("ik,jk->ij", Pm * dinv, Pm).to(A.dtype)
    return E


def gmw_bootstrap(S: torch.Tensor, mm: ref.Products | None = None) -> float:
    """lambda = |sum E| / n."""
    return abs(float(gmw_perturbation(S, mm).sum())) / S.shape[0]


class Blocks:
    """One TR linearization in the reference's working dtype: the blocks of
    B = 2 J^T J, g = -2 J^T e, and the Jacobians for J x."""

    def __init__(self, prob: ref.Problem, cams, pts, ex, mm: ref.Products):
        dt, dev = prob.dtype, prob.device
        A, B = prob.jacobians(cams, pts)
        self.A, self.B, self.prob, self.mm = A, B, prob, mm
        C, P = prob.C, prob.P
        self.U = torch.zeros(C, 6, 6, dtype=dt, device=dev)
        self.V = torch.zeros(P, 3, 3, dtype=dt, device=dev)
        ga = torch.zeros(C, 6, dtype=dt, device=dev)
        gb = torch.zeros(P, 3, dtype=dt, device=dev)
        self.U.index_add_(0, prob.cam_idx,
                          2.0 * mm.einsum("oki,okj->oij", A, A).to(dt))
        self.V.index_add_(0, prob.pt_idx,
                          2.0 * mm.einsum("oki,okj->oij", B, B).to(dt))
        ga.index_add_(0, prob.cam_idx, mm.einsum("oki,ok->oi", A, ex).to(dt))
        gb.index_add_(0, prob.pt_idx, mm.einsum("oki,ok->oi", B, ex).to(dt))
        self.W = 2.0 * mm.einsum("oki,okj->oij", A, B).to(dt)   # [O, 6, 3]
        self.g_c, self.g_p = -2.0 * ga, -2.0 * gb

    def jx(self, x_c, x_p):
        """(J x) per observation [O, 2]."""
        p = self.prob
        return (self.mm.einsum("oij,oj->oi", self.A, x_c[p.cam_idx])
                + self.mm.einsum("oij,oj->oi", self.B, x_p[p.pt_idx])
                ).to(p.dtype)

    def curv(self, x_c, x_p, y_c, y_p) -> float:
        """x^T B y = 2 (J x) . (J y)."""
        return 2.0 * float((self.jx(x_c, x_p) * self.jx(y_c, y_p)).sum())

    def reduced(self, lam: float):
        """(S, ea, Vinv) of (B + lam I) dp = g reduced to the cameras."""
        p, mm, dt, dev = self.prob, self.mm, self.prob.dtype, self.prob.device
        C = p.C
        Ud = self.U + lam * torch.eye(6, dtype=dt, device=dev)
        Vinv = torch.linalg.inv(self.V + lam * torch.eye(3, dtype=dt,
                                                         device=dev))
        Y = mm.einsum("oij,ojk->oik", self.W, Vinv[p.pt_idx]).to(dt)
        pad = torch.zeros(1, 6, 3, dtype=dt, device=dev)
        Y_pad, W_pad = torch.cat([Y, pad]), torch.cat([self.W, pad])
        S4 = torch.zeros(C + 1, C + 1, 6, 6, dtype=dt, device=dev)
        cp = p.cam_pad
        for pts_b, m in p.blocks:
            T = p.table[pts_b, :m]
            prod = mm.einsum("bmij,bnkj->bmnik", Y_pad[T], W_pad[T]).to(dt)
            ca = cp[T]
            S4.index_put_((ca[:, :, None].expand(-1, m, m),
                           ca[:, None, :].expand(-1, m, m)), prod,
                          accumulate=True)
        S = ref._block_diag(Ud) - S4[:C, :C].permute(0, 2, 1, 3).reshape(
            6 * C, 6 * C)
        ea = self.g_c.clone()
        ea.index_add_(0, p.cam_idx, -mm.einsum(
            "oij,oj->oi", Y, self.g_p[p.pt_idx]).to(dt))
        return S, ea, Vinv

    def back(self, Vinv, dpa):
        """dpb = Vinv (g_p - W^T dpa)."""
        p, mm = self.prob, self.mm
        eb = self.g_p.clone()
        eb.index_add_(0, p.pt_idx, -mm.einsum(
            "oji,oj->oi", self.W, dpa[p.cam_idx]).to(p.dtype))
        return mm.einsum("pij,pj->pi", Vinv, eb).to(p.dtype)


def _dot(a_c, a_p, b_c, b_p) -> float:
    return float((a_c * b_c).sum() + (a_p * b_p).sum())


def _subspace(pu, pb, g, B: Blocks):
    """compute_p_2's terms that do not depend on the radius."""
    pu_c, pu_p = pu
    pb_c, pb_p = pb
    uu = B.curv(pu_c, pu_p, pu_c, pu_p)
    ub = B.curv(pu_c, pu_p, pb_c, pb_p)
    bb = B.curv(pb_c, pb_p, pb_c, pb_p)
    d = (pb_c - pu_c, pb_p - pu_p)
    e = (2.0 * pu_c - pb_c, 2.0 * pu_p - pb_p)
    pUg, pBg = _dot(*pu, *g), _dot(*pb, *g)
    with np.errstate(all="ignore"):
        den = np.float64(-ub * ub + bb * uu)
        eta1 = (pBg * ub - bb * pUg) / den
        eta2 = (pUg * ub - pBg * uu) / den
    p = (float(eta1) * pu_c + float(eta2) * pb_c,
         float(eta1) * pu_p + float(eta2) * pb_p)
    return dict(p=p, p_norm=math.sqrt(_dot(*p, *p)),
                pu_norm=math.sqrt(_dot(*pu, *pu)),
                pb_norm=math.sqrt(_dot(*pb, *pb)), d=d,
                a=_dot(*d, *d), b=2.0 * _dot(*d, *e), ee=_dot(*e, *e))


def _pick(s, pu, pb, delta: float):
    """compute_p_2 at radius `delta`: (p_c, p_p)."""
    if s["p_norm"] <= delta:
        return s["p"]
    if s["pu_norm"] > delta:
        k = delta / s["pu_norm"]
        return k * pu[0], k * pu[1]
    if s["pb_norm"] <= delta:
        return pb
    a, b = s["a"], s["b"]
    disc = b * b - 4.0 * a * (s["ee"] - delta * delta)
    disc = 0.0 if abs(disc) < 1e-12 else disc
    with np.errstate(all="ignore"):
        tau = float((-b + np.sqrt(np.float64(disc))) / (2.0 * a))
    return pu[0] + (tau - 1.0) * s["d"][0], pu[1] + (tau - 1.0) * s["d"][1]


def tr(prob: ref.Problem, cams, pts, l2: float, itno: int, settings: dict,
       mm: ref.Products, boots: dict | None, log: list) -> dict:
    """One TR phase from iteration `itno` with fresh phase scalars, until
    a flag other than continue or the budget. Appends each bootstrap of
    lambda to `log` as (iteration, lambda, "own" or "given")."""
    cap = int(settings["max_iters"])
    eps2 = float(settings["eps2"])
    dk, lam, origin, nu = float(settings["init_delta"]), 0.0, 0.0, 2.0
    notgood = good = 0
    flag = "continue"
    ex = prob.residual(cams, pts)
    tries = []
    while itno < cap and flag == "continue":
        Bk = Blocks(prob, cams, pts, ex, mm)
        g = (Bk.g_c, Bk.g_p)
        gm = max(float(Bk.g_c.abs().max()), float(Bk.g_p.abs().max()))
        gm = gm if gm > 0.0 else 1.0
        gh = (Bk.g_c / gm, Bk.g_p / gm)
        scal = -_dot(*gh, *gh) / Bk.curv(*gh, *gh)
        pu = (scal * Bk.g_c, scal * Bk.g_p)

        n_try, solved, failed_out = 0, False, False
        while not solved and not failed_out and n_try < MAX_SOLVE_TRIES:
            S, ea, Vinv = Bk.reduced(lam)
            L, info = torch.linalg.cholesky_ex(S)
            # at lambda = 0, S is singular along the gauge: the factor
            # fails in exact arithmetic, whatever rounding gives
            ok = int(info) == 0 and lam != 0.0
            if ok:
                dpa = torch.cholesky_solve(ea.reshape(-1, 1), L).reshape(
                    prob.C, 6)
                dpb = Bk.back(Vinv, dpa)
                ok = bool(torch.isfinite(dpa).all()) and bool(
                    torch.isfinite(dpb).all())
            if ok:
                pb = (-dpa, -dpb)
                origin, nu = lam, 2.0
            else:
                if lam == 0.0:
                    if boots is not None and itno in boots:
                        lam_fail, how = float(boots[itno]), "given"
                    else:
                        lam_fail, how = gmw_bootstrap(S, mm), "own"
                    log.append((itno, lam_fail, how))
                else:
                    lam_fail = 2.0 * lam
                esc = origin != 0.0
                failed_out = esc and nu > 4.0
                if esc:
                    lam, nu = lam_fail * nu, nu * 2.0
                else:
                    lam = lam_fail
            del S, L
            solved = ok
            n_try += 1
        if failed_out or not solved:
            flag = "turn_to_lm"
            itno += 1
            tries.append(n_try)
            break
        sub = _subspace(pu, pb, g, Bk)

        m_flag, m_tries = "continue", 0
        while m_flag == "continue" and m_tries < MAX_MODEL_TRIES:
            p_c, p_p = _pick(sub, pu, pb, dk)
            new_cams, new_pts = cams + p_c, pts + p_p
            new_ex = prob.residual(new_cams, new_pts)
            gain = float(((ex - new_ex) * (ex + new_ex)).sum())
            gtp = _dot(p_c, p_p, *g)
            ptBp = Bk.curv(p_c, p_p, p_c, p_p)
            with np.errstate(all="ignore"):
                rel = abs(np.float64(gain) / l2)
                rho = float(np.float64(gain) / (l2 - (l2 + gtp + 0.5 * ptBp)))
            tiny, stop_small = rel < eps2, rel <= eps2
            improved = gain > 0
            reduce_region = rho < 0.25 or gain < 0
            accept_hi = rho >= 0.75 and improved
            accept_lo = 0.25 <= rho < 0.75 and improved
            accept = (accept_hi or accept_lo) and not tiny
            nan_rho = (math.isnan(rho) and not reduce_region
                       and not accept_hi and not accept_lo)
            if not tiny:
                if reduce_region:
                    dk = dk / 4.0
                elif accept_hi:
                    dk = min(2.0 * dk, float(settings["max_delta"]))
            notgood = notgood + 1 if rho < 0.25 else 0
            good = good + 1 if (rho > 0.75 and improved) else 0
            if good >= 10:
                lam, origin, good = 0.0, 0.0, 0
            if tiny:
                m_flag = "dp_no_change"
            elif nan_rho:
                m_flag = "turn_to_lm"
            elif stop_small:
                m_flag = "small_enough"
            elif notgood >= 5:
                m_flag = "turn_to_lm"
            elif accept:
                m_flag = "pass"
            if rho > 0.25 and improved and not tiny and not nan_rho:
                l2 -= gain
            if accept:
                cams, pts, ex = new_cams, new_pts, new_ex
            m_tries += 1
        if m_tries >= MAX_MODEL_TRIES:
            m_flag = "turn_to_lm"
        tries.append(n_try)
        itno += 1
        flag = "continue" if m_flag == "pass" else m_flag
        del Bk
    return dict(cams=cams, pts=pts, l2=l2, itno=itno, flag=flag,
                tries=tries)


def hybrid(prob: ref.Problem, cams, pts, settings: dict,
           matmul: str = "exact", boots: dict | None = None) -> dict:
    """PSBA's default solve from (cams, pts) in prob.dtype.

    settings: lm.lm's (tau, stop_thresh, damping, max_inner,
    lm_switch_count) and max_iters, eps2, init_delta, max_delta. Returns
    dict(cams, pts, iters, flag, phases [(phase, iteration after, flag)],
    boots [(iteration, lambda, "own" / "given")], lm_tries, tr_tries,
    l2), the flags as PSBA's numbers."""
    mm = ref.Products(matmul)
    cams = cams.to(prob.dtype).clone()
    pts = pts.to(prob.dtype).clone()
    cap = int(settings["max_iters"])
    itno, phase, l2 = 0, "lm", None
    phases, log, lm_tries, tr_tries = [], [], [], []
    while True:
        if itno >= cap:
            # a phase handed the spent budget runs no iteration
            out = dict(flag="continue")
        elif phase == "lm":
            out = ref.lm(prob, cams, pts, dict(settings, iters=cap - itno),
                         matmul=matmul)
            cams, pts, l2 = out["cams"], out["pts"], out["l2"][-1]
            itno += out["iters"]
            lm_tries += out["tries"]
        else:
            out = tr(prob, cams, pts, l2, itno, settings, mm, boots, log)
            cams, pts, l2, itno = out["cams"], out["pts"], out["l2"], \
                out["itno"]
            tr_tries += out["tries"]
        phases.append((phase, itno, FLAG[out["flag"]]))
        if (phase, out["flag"]) == ("lm", "turn_to_tr"):
            phase = "tr"
        elif (phase, out["flag"]) == ("tr", "turn_to_lm"):
            phase = "lm"
        else:
            break
    return dict(cams=cams, pts=pts, iters=itno, flag=FLAG[out["flag"]],
                phases=phases, boots=log, lm_tries=lm_tries,
                tr_tries=tr_tries, l2=l2)
