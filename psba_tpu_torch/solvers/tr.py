"""Dogleg trust-region solver (PyTorch counterpart of the dense3 and the
covisibility-pair branches of psba_tpu.solvers.tr.tr_run).

The camera blocks U and the gradient ga always come from the observation
stream (ops.linearize_stream), whose camera-ordered reduction is what lets
float32 TR reach the optimum (TR takes g itself as its Cauchy direction and
in the model prediction).

  - dense3: ZW, V and gb come from the dense grid (ops.linearize_dense),
    the reduced system from the dense3 Schur family, every |J x|^2 from
    ops.residual_dense.jgram_dense and each trial gain from
    ops.residual_dense.gain_dense; ex stays the phase-entry value.
  - pairs: one stream pass gives V, W, gb and the Jacobians A, B as well;
    the reduced system comes from the pair family (inv3x3, y_blocks,
    schur_S, reduced_rhs, back_substitute), every |J x|^2 from
    core.jacobian.jmultiply, each trial residual from ops.residual_l2 with
    the gain error_l2_diff(ex, new_ex); ex is refreshed on accept.

Then, in both:

  - B = 2 J^T J, g = -2 J^T ex; every block carries the factor 2
  - Cauchy step P_U = -(g^T g / g^T B g) g, computed on g divided by its
    largest entry (g^T g and |J g|^2 overflow float32 on badly scaled
    cameras; the factors cancel in the ratio)
  - Gauss-Newton step P_B from the Schur-reduced system damped by lambda,
    with the escalation of the reference: a Cholesky failure at lambda = 0
    bootstraps lambda from the GMW modified Cholesky (core.gmw); later
    failures double lambda, escalate by nu once a lambda had succeeded, and
    nu > 4 hands back to LM (at most 64 tries)
  - the step minimizes the model over span{P_U, P_B} or falls back to the
    scaled P_U / P_B / dogleg (`_subspace_step`)
  - rho = gain / (ex_l2 - L(p)) with L(p) = ex_l2 + g^T p + p^T B p / 2;
    every p^T B p is an explicit |J p|^2 (jgram_dense or jmultiply above;
    the expansion over the 2x2 Gram of {P_U, P_B} cancels in float32)
  - radius /4 on rho < 1/4 or a loss, x2 (capped) on rho >= 3/4; a NaN rho
    or 5 consecutive rho < 1/4 hand back to LM; 10 consecutive rho > 3/4
    reset lambda to 0; at most 200 tries per iteration
  - a tracked step lowers ex_l2 by its gain

The loops are eager Python, as in solvers.lm: vectors stay on the device,
the scalars that decide control flow are read to the host once per try and
handled as numpy scalars of the working dtype.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from psba_tpu_torch import constants as CC
from psba_tpu_torch.core.gmw import gmw_bootstrap_lambda
from psba_tpu_torch.core.hessian import damp_uv
from psba_tpu_torch.core.jacobian import jmultiply
from psba_tpu_torch.core.linalg import spd_solve
from psba_tpu_torch.core.residual import error_l2_diff
from psba_tpu_torch.core.schur import (
    back_substitute,
    back_substitute_dense3,
    damp_v_planar,
    inv3x3,
    inv3x3_planar3,
    reduced_rhs,
    reduced_rhs_dense3,
    schur_S,
    schur_S_dense3,
    y_blocks,
)
from psba_tpu_torch.ops.linearize_dense import linearize_dense
from psba_tpu_torch.ops.linearize_stream import linearize_stream, residual_l2
from psba_tpu_torch.ops.residual_dense import gain_dense, jgram_dense
from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    np_dtype,
)

_MAX_SOLVE_TRIES = 64
_MAX_MODEL_TRIES = 200


def tr_fresh_aux(cfg: SolverConfig, dtype, device="cpu") -> torch.Tensor:
    """Phase-start aux vector (delta, lambda, origin_lambda, nu, notgood,
    good_iters), the scalars tr_run seeds when state.aux is None."""
    return torch.tensor([cfg.init_delta, 0.0, 0.0, 2.0, 0.0, 0.0],
                        dtype=dtype, device=device)


def _dot(a_cams, a_pts, b_cams, b_pts) -> torch.Tensor:
    return torch.sum(a_cams * b_cams) + torch.sum(a_pts * b_pts)


def _subspace_step(dot, pu_c, pu_p, pb_c, pb_p, g_c, g_p,
                   pUtBpU, pUtBpB, pBtBpB, delta):
    """compute_p_2: minimize the quadratic model over span{P_U, P_B}; when
    the minimizer leaves the radius, take the scaled P_U, P_B or the classic
    dogleg point. Returns (p_cams, p_pts, p_norm), p_norm a 0-d tensor.
    Every branch is formed on the device and selected by torch.where, so
    NaNs route as in the reference."""
    delta = torch.as_tensor(delta, dtype=pu_c.dtype, device=pu_c.device)
    pUg = dot(pu_c, pu_p, g_c, g_p)
    pBg = dot(pb_c, pb_p, g_c, g_p)
    den = -pUtBpB * pUtBpB + pBtBpB * pUtBpU
    eta1 = (pBg * pUtBpB - pBtBpB * pUg) / den
    eta2 = (pUg * pUtBpB - pBg * pUtBpU) / den
    p_c = eta1 * pu_c + eta2 * pb_c
    p_p = eta1 * pu_p + eta2 * pb_p
    p_norm = torch.sqrt(dot(p_c, p_p, p_c, p_p))

    pu_norm = torch.sqrt(dot(pu_c, pu_p, pu_c, pu_p))
    pb_norm = torch.sqrt(dot(pb_c, pb_p, pb_c, pb_p))

    # dogleg tau root
    d_c, d_p = pb_c - pu_c, pb_p - pu_p
    e_c, e_p = 2.0 * pu_c - pb_c, 2.0 * pu_p - pb_p
    a = dot(d_c, d_p, d_c, d_p)
    b = 2.0 * dot(d_c, d_p, e_c, e_p)
    c = dot(e_c, e_p, e_c, e_p) - delta * delta
    b2_4ac = b * b - 4.0 * a * c
    b2_4ac = torch.where(torch.abs(b2_4ac) < 1e-12,
                         torch.zeros_like(b2_4ac), b2_4ac)
    tau = (-b + torch.sqrt(b2_4ac)) / (2.0 * a)
    dog_c = pu_c + (tau - 1.0) * d_c
    dog_p = pu_p + (tau - 1.0) * d_p

    inside = p_norm <= delta
    use_pu = (~inside) & (pu_norm > delta)
    use_pb = (~inside) & (~use_pu) & (pb_norm <= delta)

    scale_pu = delta / pu_norm
    out_c = torch.where(inside, p_c, torch.where(
        use_pu, scale_pu * pu_c, torch.where(use_pb, pb_c, dog_c)))
    out_p = torch.where(inside, p_p, torch.where(
        use_pu, scale_pu * pu_p, torch.where(use_pb, pb_p, dog_p)))
    out_norm = torch.where(inside, p_norm,
                           torch.where(use_pb, pb_norm, delta))
    return out_c, out_p, out_norm


def tr_run(pa: ProblemArrays, state: OptState, cfg: SolverConfig,
           iter_cap: int | None = None) -> OptState:
    """Run dogleg TR until a flag other than PASS / CONTINUE or the shared
    iteration budget (or `iter_cap`, a global-iteration bound below
    cfg.max_iters for chunked checkpointing)."""
    if cfg.backend == "xla":
        raise NotImplementedError(
            "backend='xla' (the XLA-form dense path): not ported yet "
            "(ROADMAP Queue 1 item 11)"
        )
    if cfg.s_precision != "highest":
        raise NotImplementedError(
            f"s_precision={cfg.s_precision!r}: its Hopper mapping is not "
            "decided yet (ROADMAP Queue 1, s_precision item)"
        )
    dtype = state.cams.dtype
    dev = state.cams.device
    ft = np_dtype(dtype).type
    eps2 = ft(cfg.eps2)
    max_delta = ft(cfg.max_delta)
    cap = cfg.max_iters if iter_cap is None else min(int(iter_cap),
                                                      cfg.max_iters)
    C, P = pa.n_cams, state.pts.shape[0]
    eye6 = torch.eye(6, dtype=dtype, device=dev)
    clamp = cfg.clamp_quat
    grid = (pa.obs_du, pa.obs_dv, pa.valid_d)

    if state.aux is None:
        dk, lam, origin, nu = ft(cfg.init_delta), ft(0.0), ft(0.0), ft(2.0)
        notgood, good_iters = 0, 0
    else:
        a = state.aux.detach().cpu().numpy().astype(ft)
        dk, lam, origin, nu = a[0], a[1], a[2], a[3]
        notgood, good_iters = int(a[4]), int(a[5])
    history = state.history
    if cfg.record_history and history is None:
        history = np.full((cfg.max_iters, 6), np.nan, ft)
    elif not cfg.record_history:
        history = None

    cams, pts, ex = state.cams, state.pts, state.ex
    ex_l2 = ft(state.ex_l2.item())
    itno, flag = state.itno, CC.ITER_CONTINUE
    pairs = pa.pairs

    def jgram(c, p, dirs_c, dirs_p):
        return 2.0 * jgram_dense(pa.K, pa.q0, c, p, pa.valid_d, dirs_c,
                                 dirs_p, clamp=clamp)

    def jx(A, B, x_c, x_p):
        return jmultiply(A, B, x_c, x_p, pa.cam_idx, pa.pt_idx)

    while itno < cap and flag in (CC.ITER_PASS, CC.ITER_CONTINUE):
        # every block carries the TR coefficient 2
        if pairs:
            _ex, _l2, U1, V1, W1, ga1, gb1, A, B = linearize_stream(
                pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx, pa.pt_idx, None,
                C, P, clamp=clamp, want_jac=True, tables=pa.stream,
            )
            U, V, W = 2.0 * U1, 2.0 * V1, 2.0 * W1
            g_c, g_p = -(2.0 * ga1), -(2.0 * gb1)
        else:
            # U / ga from the observation stream, ZW / V / gb from the grid
            _ex, _l2, U1, _, _, ga1, _, _, _ = linearize_stream(
                pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx, pa.pt_idx, None,
                C, P, clamp=clamp, want_point=False, want_w=False,
                tables=pa.stream,
            )
            ZW0, ZW1, ZW2, Vp1, gbp1, Pp = linearize_dense(
                pa.K, pa.q0, cams, pts, *grid, clamp=clamp)
            U = 2.0 * U1
            Vp = 2.0 * Vp1
            ZW3 = (2.0 * ZW0, 2.0 * ZW1, 2.0 * ZW2)
            g_c = -(2.0 * ga1)
            g_pp3 = -2.0 * gbp1                       # planar [3, Pp]
            # [P, 3] row-major, so every point vector built from it is too
            g_p = g_pp3[:, :P].T.contiguous()

        # Cauchy step on g / max|g|
        gm = torch.maximum(torch.max(torch.abs(g_c)),
                           torch.max(torch.abs(g_p)))
        gm = torch.where(gm > 0.0, gm, torch.ones_like(gm))
        gh_c, gh_p = g_c / gm, g_p / gm
        if pairs:
            Jg = jx(A, B, gh_c, gh_p)
            gtBg_n = 2.0 * torch.sum(Jg * Jg)
        else:
            gtBg_n = jgram(cams, pts, gh_c[None], (g_pp3 / gm)[None])[0, 0]
        gtg_n = _dot(gh_c, gh_p, gh_c, gh_p)
        scal = -(gtg_n / gtBg_n)
        pu_c, pu_p = scal * g_c, scal * g_p

        # Gauss-Newton step with lambda escalation
        tries, solved, failed_out = 0, False, False
        pb_c, pb_p = torch.zeros_like(cams), torch.zeros_like(pts)
        while not solved and not failed_out and tries < _MAX_SOLVE_TRIES:
            lam_t = float(lam)
            if pairs:
                U_d, V_d = damp_uv(U, V, lam_t)
                Vinv, vok = inv3x3(V_d)
                Y = y_blocks(W, Vinv, pa.pt_idx)
                S = schur_S(U_d, Y, W, pa.pair_o1, pa.pair_o2,
                            pa.pair_bucket, C)
                ea = reduced_rhs(g_c, g_p, Y, pa.cam_idx, pa.pt_idx, C)
            else:
                Vinv, vok = inv3x3_planar3(damp_v_planar(Vp, lam_t))
                S, ZY3 = schur_S_dense3(U + lam_t * eye6, ZW3, Vinv)
                ea = reduced_rhs_dense3(g_c, g_pp3, ZY3)
            dpa_flat, ok_t = spd_solve(S, ea.reshape(-1))
            # the one host read of the try; a singular V block escalates
            # like a Cholesky failure
            ok = bool(ok_t & vok)
            if ok:
                dpa = dpa_flat.reshape(C, 6)
                if pairs:
                    _eb, dpb = back_substitute(g_p, W, Vinv, dpa, pa.cam_idx,
                                               pa.pt_idx, P)
                else:
                    dpb = back_substitute_dense3(g_pp3, ZW3, Vinv,
                                                 dpa)[:, :P].T
                pb_c, pb_p = -dpa, -dpb
                origin = lam
                nu = ft(2.0)
            else:
                if lam == 0.0:
                    lam_fail = ft(gmw_bootstrap_lambda(S).item())
                else:
                    lam_fail = ft(2.0) * lam
                esc = origin != 0.0
                failed_out = esc and nu > 4.0
                if esc:
                    lam, nu = lam_fail * nu, nu * ft(2.0)
                else:
                    lam = lam_fail
            solved = ok
            tries += 1
        aborted = failed_out or not solved

        nan = ft(np.nan)
        rho = act = p_norm = nan
        m_flag, m_tries = CC.ITER_CONTINUE, 0
        if aborted:
            m_flag = CC.ITER_TURN_TO_LM
        else:
            # curvature scalars, each an explicit |J x|^2
            if pairs:
                Jpu, Jpb = jx(A, B, pu_c, pu_p), jx(A, B, pb_c, pb_p)
                pUtBpU = 2.0 * torch.sum(Jpu * Jpu)
                pUtBpB = 2.0 * torch.sum(Jpu * Jpb)
                pBtBpB = 2.0 * torch.sum(Jpb * Jpb)
            else:
                pb_pp3 = F.pad(pb_p.T, (0, Pp - P))
                Gm = jgram(cams, pts, torch.stack([pu_c, pb_c]),
                           torch.stack([scal * g_pp3, pb_pp3]))
                pUtBpU, pUtBpB, pBtBpB = Gm[0, 0], Gm[0, 1], Gm[1, 1]

        # model / radius loop
        while m_flag == CC.ITER_CONTINUE and m_tries < _MAX_MODEL_TRIES:
            p_c, p_p, p_norm_t = _subspace_step(
                _dot, pu_c, pu_p, pb_c, pb_p, g_c, g_p, pUtBpU, pUtBpB,
                pBtBpB, dk,
            )
            new_cams, new_pts = cams + p_c, pts + p_p
            if pairs:
                new_ex, act_t = residual_l2(
                    pa.K, pa.q0, new_cams, new_pts, pa.obs, pa.cam_idx32,
                    pa.pt_idx32, None, clamp=clamp,
                )
                gain_t = error_l2_diff(ex, new_ex)
                Jp = jx(A, B, p_c, p_p)
                ptBp_t = 2.0 * torch.sum(Jp * Jp)
            else:
                gain_t, act_t = gain_dense(pa.K, pa.q0, cams, pts, new_cams,
                                           new_pts, *grid, clamp=clamp)
                ptBp_t = jgram(cams, pts, p_c[None],
                               F.pad(p_p.T, (0, Pp - P))[None])[0, 0]
            # the one host read of the try
            gain, act, gtp, ptBp, p_norm = torch.stack([
                gain_t, act_t, _dot(g_c, g_p, p_c, p_p), ptBp_t, p_norm_t,
            ]).cpu().numpy().astype(ft)
            with np.errstate(divide="ignore", invalid="ignore"):
                tiny = abs(gain / ex_l2) < eps2
                pred = ex_l2 + gtp + ft(0.5) * ptBp
                rho = gain / (ex_l2 - pred)
                stop_small = abs(gain / ex_l2) <= eps2
            improved = gain > 0
            # the reference's strict reduce test (gain < 0): a NaN rho with
            # gain == 0 claims no branch and hands back to LM below
            reduce_region = rho < 0.25 or gain < 0
            accept_hi = rho >= 0.75 and improved
            accept_lo = 0.25 <= rho < 0.75 and improved
            accept = (accept_hi or accept_lo) and not tiny
            nan_rho = (np.isnan(rho) and not reduce_region
                       and not accept_hi and not accept_lo)
            if not tiny:
                if reduce_region:
                    dk = dk / ft(4.0)
                elif accept_hi:
                    dk = min(ft(2.0) * dk, max_delta)
            notgood = notgood + 1 if rho < 0.25 else 0
            good_iters = good_iters + 1 if (rho > 0.75 and improved) else 0
            if good_iters >= 10:
                lam, origin, good_iters = ft(0.0), ft(0.0), 0
            if tiny:
                m_flag = CC.ITER_DP_NO_CHANGE
            elif nan_rho:
                m_flag = CC.ITER_TURN_TO_LM
            elif stop_small:
                m_flag = CC.ITER_ERR_SMALL_ENOUGH
            elif notgood >= 5:
                m_flag = CC.ITER_TURN_TO_LM
            elif accept:
                m_flag = CC.ITER_PASS
            if rho > 0.25 and improved and not tiny and not nan_rho:
                ex_l2 = ex_l2 - gain
            if accept:
                cams, pts = new_cams, new_pts
                if pairs:
                    ex = new_ex
            m_tries += 1
        if m_tries >= _MAX_MODEL_TRIES:
            m_flag = CC.ITER_TURN_TO_LM

        if history is not None:
            history[itno] = (itno, act, rho, lam, dk, p_norm)
        itno += 1
        flag = m_flag

    if flag == CC.ITER_PASS:
        flag = CC.ITER_CONTINUE
    aux = None
    if state.aux is not None:
        aux = torch.tensor([dk, lam, origin, nu, notgood, good_iters],
                           dtype=dtype, device=dev)
    # the loop may end on the iteration budget with flag still CONTINUE
    return OptState(
        cams=cams, pts=pts, ex=ex,
        ex_l2=torch.tensor(ex_l2, dtype=dtype, device=dev),
        itno=itno, flag=flag, history=history, aux=aux,
    )
