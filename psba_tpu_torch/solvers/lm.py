"""Levenberg–Marquardt solver (PyTorch counterpart of the dense3 and the
covisibility-pair branches of psba_tpu.solvers.lm.lm_run).

One outer iteration linearizes once and then runs the damping-retry loop:
damp U and V, invert V, assemble and solve the reduced camera system
(spd_solve), back-substitute the points and evaluate the trial gain.

  - dense3 (ProblemArrays with the dense tables): everything on the dense
    grid (ops.linearize_dense with U / ga; inv3x3_planar3, schur_S_dense3,
    reduced_rhs_dense3, back_substitute_dense3; ops.gain_dense). The
    residual ex is never formed and stays at its phase-entry value.
  - pairs (ProblemArrays with the pair list): the observation stream
    (ops.linearize_stream with the point sums and W; inv3x3, y_blocks,
    schur_S, reduced_rhs, back_substitute); the trial residual comes from
    ops.residual_l2, the gain is error_l2_diff(ex, new_ex), and ex is
    refreshed on accept.

The loops are eager Python. Tensors stay on the device; once per try the
few scalars that decide acceptance are read to the host in one transfer,
and the control arithmetic (mu, nu, rho, the stop tests) runs on numpy
scalars of the working dtype, so it rounds as the reference's on-device
scalars do. Same constants and update rules as the reference:
  - first damping mu = tau * max(diag U, diag V) (additive) or tau
    (Marquardt, which damps mu * diag)
  - gain ratio rho = gain / dp^T (mu D dp + g)
  - Nielsen update mu *= max(1/3, 1 - (2 rho - 1)^3), nu = 2 on accept;
    mu *= nu, nu *= 2 on reject, nu >= 2^31 -> ERR
  - stop on ||dp||^2 < ||p||^2 stop_thresh^2 (DP_NO_CHANGE) or
    ||dp||^2 >= (||p||^2 + stop_thresh) / eps^2 (ERR); at most max_inner
    tries per iteration (ERR); ex_l2 <= stop_thresh -> ERR_SMALL_ENOUGH
  - lm_switch_count consecutive accepted steps with |rho - 1| < 0.2 ->
    TURN_TO_TR
"""

from __future__ import annotations

import numpy as np
import torch

from psba_tpu_torch import constants as CC
from psba_tpu_torch.core.hessian import damp_uv, damp_uv_marquardt, max_diag
from psba_tpu_torch.core.linalg import spd_solve
from psba_tpu_torch.core.residual import error_l2_diff
from psba_tpu_torch.core.schur import (
    back_substitute,
    back_substitute_dense3,
    damp_v_planar,
    damp_v_planar_marquardt,
    diag_v_planar,
    inv3x3,
    inv3x3_planar3,
    max_diag_planar,
    reduced_rhs,
    reduced_rhs_dense3,
    schur_S,
    schur_S_dense3,
    y_blocks,
)
from psba_tpu_torch.ops.linearize_dense import linearize_dense
from psba_tpu_torch.ops.linearize_stream import linearize_stream, residual_l2
from psba_tpu_torch.ops.residual_dense import gain_dense
from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    np_dtype,
)

_NU_OVERFLOW = 2.0 ** 31  # the reference's int nu wraps here


def lm_fresh_aux(dtype, device="cpu") -> torch.Tensor:
    """Phase-start aux vector (mu, nu, p_l2, good_cnt, first=1, 0)."""
    return torch.tensor([0.0, 2.0, 1e3, 0.0, 1.0, 0.0], dtype=dtype,
                        device=device)


def lm_run(pa: ProblemArrays, state: OptState, cfg: SolverConfig,
           iter_cap: int | None = None) -> OptState:
    """Run LM until a flag other than CONTINUE or the shared iteration
    budget (or `iter_cap`, a global-iteration bound below cfg.max_iters
    for chunked checkpointing). `cfg.damping` must be resolved."""
    if cfg.damping == "auto":
        raise ValueError(
            'cfg.damping="auto" must be resolved before lm_run: call '
            "psba_tpu_torch.solvers.types.resolve_damping(cfg, pa, cams, "
            "pts) (solve does this itself)"
        )
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
    marq = cfg.damping == "marquardt"
    dtype = state.cams.dtype
    dev = state.cams.device
    ft = np_dtype(dtype).type
    stop2 = ft(cfg.stop_thresh) ** 2
    stop_thresh = ft(cfg.stop_thresh)
    eps_sq = ft(CC.PSBA_EPSILON_SQ)
    cap = cfg.max_iters if iter_cap is None else min(int(iter_cap),
                                                      cfg.max_iters)
    C, P = pa.n_cams, state.pts.shape[0]
    eye6 = torch.eye(6, dtype=dtype, device=dev)

    if state.aux is None:
        mu, nu, p_l2, good, first = ft(0.0), ft(2.0), ft(1e3), 0, True
    else:
        a = state.aux.detach().cpu().numpy().astype(ft)
        mu, nu, p_l2 = a[0], a[1], a[2]
        good, first = int(a[3]), bool(a[4] > 0.5)
    history = state.history
    if cfg.record_history and history is None:
        history = np.full((cfg.max_iters, 6), np.nan, ft)
    elif not cfg.record_history:
        history = None

    cams, pts, ex = state.cams, state.pts, state.ex
    ex_l2 = ft(state.ex_l2.item())
    itno, flag = state.itno, CC.ITER_CONTINUE
    pairs = pa.pairs
    clamp = cfg.clamp_quat
    tables = (pa.obs_du, pa.obs_dv, pa.valid_d)

    while itno < cap and flag == CC.ITER_CONTINUE:
        if pairs:
            _ex, _l2, U, V, W, ga, gb, _, _ = linearize_stream(
                pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx, pa.pt_idx, None,
                C, P, clamp=clamp, tables=pa.stream,
            )
        else:
            ZW0, ZW1, ZW2, Vp, gbp, _Pp, U, ga = linearize_dense(
                pa.K, pa.q0, cams, pts, *tables, clamp=clamp, want_u=True,
            )
            ZW3 = (ZW0, ZW1, ZW2)
            gb = gbp[:, :P].T
        if first:
            if marq:
                mu = ft(cfg.tau)
            else:
                md = max_diag(U, V) if pairs else max_diag_planar(U, Vp, P)
                mu = ft(cfg.tau) * ft(md.item())
            nu, p_l2 = ft(2.0), ft(1e3)
        if marq:
            dU = torch.diagonal(U, dim1=-2, dim2=-1)
            dV = (torch.diagonal(V, dim1=-2, dim2=-1) if pairs
                  else diag_v_planar(Vp, P))
            Dc = torch.where(dU > 0.0, dU, torch.ones_like(dU))
            Dp = torch.where(dV > 0.0, dV, torch.ones_like(dV))

        tries, accepted, rho = 0, False, ft(np.nan)
        while (flag == CC.ITER_CONTINUE and not accepted
               and tries < cfg.max_inner):
            mu_t = float(mu)
            if pairs:
                U_d, V_d = (damp_uv_marquardt if marq else damp_uv)(U, V,
                                                                    mu_t)
                Vinv, vok = inv3x3(V_d)
                Y = y_blocks(W, Vinv, pa.pt_idx)
                S = schur_S(U_d, Y, W, pa.pair_o1, pa.pair_o2,
                            pa.pair_bucket, C)
                ea = reduced_rhs(ga, gb, Y, pa.cam_idx, pa.pt_idx, C)
            else:
                if marq:
                    U_d = U + (mu_t * Dc)[..., None] * eye6
                    Vp_d = damp_v_planar_marquardt(Vp, mu_t)
                else:
                    U_d = U + mu_t * eye6
                    Vp_d = damp_v_planar(Vp, mu_t)
                Vinv, vok = inv3x3_planar3(Vp_d)
                S, ZY3 = schur_S_dense3(U_d, ZW3, Vinv)
                ea = reduced_rhs_dense3(ga, gbp, ZY3)
            dpa_flat, ok = spd_solve(S, ea.reshape(-1))
            dpa = dpa_flat.reshape(C, 6)
            if pairs:
                _eb, dpb = back_substitute(gb, W, Vinv, dpa, pa.cam_idx,
                                           pa.pt_idx, P)
            else:
                dpb = back_substitute_dense3(gbp, ZW3, Vinv, dpa)[:, :P].T
            new_cams = cams + dpa
            new_pts = pts + dpb
            if pairs:
                new_ex, _new_l2 = residual_l2(
                    pa.K, pa.q0, new_cams, new_pts, pa.obs, pa.cam_idx32,
                    pa.pt_idx32, None, clamp=clamp,
                )
                gain_t = error_l2_diff(ex, new_ex)
            else:
                gain_t, _new_l2 = gain_dense(
                    pa.K, pa.q0, cams, pts, new_cams, new_pts, *tables,
                    clamp=clamp,
                )
            if marq:
                den_c = torch.sum(dpa * (mu_t * Dc * dpa + ga))
                den_p = torch.sum(dpb * (mu_t * Dp * dpb + gb))
            else:
                den_c = torch.sum(dpa * (mu_t * dpa + ga))
                den_p = torch.sum(dpb * (mu_t * dpb + gb))
            # the one host read of the try
            vals = torch.stack([
                torch.sum(dpa * dpa), torch.sum(dpb * dpb), den_c, den_p,
                gain_t, torch.sum(new_cams * new_cams),
                torch.sum(new_pts * new_pts), (ok & vok).to(dtype),
            ]).cpu().numpy().astype(ft)
            dpa2, dpb2, den_c, den_p, gain, nc2, np2, okf = vals
            ok_all = bool(okf > 0.5)
            dp_l2 = dpa2 + dpb2
            denom = den_c + den_p

            stop_small = ok_all and dp_l2 < p_l2 * stop2
            stop_singular = ok_all and dp_l2 >= (p_l2 + stop_thresh) / eps_sq
            with np.errstate(divide="ignore", invalid="ignore"):
                rho = gain / denom if ok_all else ft(-1.0)
            accept = bool(rho > 0) and ok_all and not (
                stop_small or stop_singular
            )
            if stop_small:
                flag = CC.ITER_DP_NO_CHANGE
            elif stop_singular:
                flag = CC.ITER_ERR
            elif accept:
                tmp = ft(2.0) * rho - ft(1.0)
                shrink = max(ft(1.0) - tmp * tmp * tmp, ft(1.0 / 3.0))
                good = good + 1 if abs(rho - ft(1.0)) < ft(0.2) else 0
                if good >= cfg.lm_switch_count:
                    flag = CC.ITER_TURN_TO_TR
                cams, pts = new_cams, new_pts
                if pairs:
                    ex = new_ex
                ex_l2 = ex_l2 - gain
                p_l2 = nc2 + np2
                mu, nu = mu * shrink, ft(2.0)
            else:
                # a failed solve resets the good-step count; rho <= 0 does
                # not (as in the reference)
                mu, nu = mu * nu, ft(2.0) * nu
                if nu >= _NU_OVERFLOW:
                    flag = CC.ITER_ERR
                if not ok_all:
                    good = 0
            accepted = accept
            tries += 1

        if tries >= cfg.max_inner and not accepted:
            flag = CC.ITER_ERR
        if ex_l2 <= stop_thresh:
            flag = CC.ITER_ERR_SMALL_ENOUGH
        if history is not None:
            history[itno] = (itno, ex_l2, rho, mu, np.nan, np.nan)
        itno += 1
        first = False

    aux = None
    if state.aux is not None:
        aux = torch.tensor([mu, nu, p_l2, good, float(first), 0.0],
                           dtype=dtype, device=dev)
    # the loop may end on the iteration budget with flag still CONTINUE
    return OptState(
        cams=cams, pts=pts, ex=ex,
        ex_l2=torch.tensor(ex_l2, dtype=dtype, device=dev),
        itno=itno, flag=flag, history=history, aux=aux,
    )
