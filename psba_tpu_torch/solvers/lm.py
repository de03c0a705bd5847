"""Levenberg–Marquardt solver (PyTorch counterpart of
psba_tpu.solvers.lm.lm_run: its dense3, dense XLA-form and pair branches).

One outer iteration linearizes once and then runs the damping-retry loop:
damp U and V, invert V, assemble and solve the reduced camera system
(spd_solve), back-substitute the points and evaluate the trial gain.

The kernel path (solvers.types.use_kernels: float32 by default):
  - dense3 (the dense encoding): everything on the dense grid
    (ops.linearize_dense with U / ga; inv3x3_planar3, schur_S_dense3,
    reduced_rhs_dense3, back_substitute_dense3; ops.gain_dense). The
    residual ex is never formed and stays at its phase-entry value.
    cfg.s_precision "high" runs as "highest", in full float32 (a named
    deviation, core.schur); the pair and XLA-form branches ignore it, as
    the reference's do.
  - pairs: the observation stream (ops.linearize_stream with the point
    sums and W; inv3x3, y_blocks, schur_S with its pair products in
    ops.schur_pairs, reduced_rhs, back_substitute);
    the trial residual and the gain, the factored error_l2_diff(ex,
    new_ex), come from one ops.residual_l2 call, and ex is refreshed on
    accept.
The XLA form (float64 by default, or backend="xla"), torch ops only:
  core.jacobian.jacobians + core.hessian.assemble_blocks linearize; on the
  dense encoding stack_blocks / planar_gb once per iteration, then the
  dense family (inv3x3_planar, schur_S_dense, reduced_rhs_dense,
  back_substitute_dense) in every try; on the pairs the pair family. The
  trial residual is core.residual.residuals, the gain error_l2_diff(ex,
  new_ex), and ex is refreshed on accept.

The loops are eager Python. Tensors stay on the device; once per try the
few scalars that decide acceptance are read to the host in one transfer,
and the control arithmetic (mu, nu, rho, the stop tests) runs on numpy
scalars of the working dtype, so it rounds as the reference's on-device
scalars do. That is not the only host read. Each of these waits for the
card, and all go through utils.timing.host_read:
  - on entry, ex_l2 (and the phase's aux vector, when the state has one);
  - in the first iteration, the max diagonal of the additive damping;
  - in every try, the fallback test of core.schur.inv3x3_planar3 (whether
    any V block needs the pivoted determinant), on every branch, and the
    try's scalars;
  - on exit, the copy of ex_l2 (and of aux) back to the device.
With one try an iteration and additive damping, lm_run(iter_cap=3) makes
9: 3 an iteration.

While a torch.profiler records (utils.timing.tracing), each iteration's
stages run inside profiler spans (psba.lm.linearize, .damping,
.schur, .solve, .step, .control; psba.read around each host read) and
utils.timing.LM counts the iterations, the reads, the host's wait in
them and lm_run's own host time. Otherwise no span is built.

On a mesh (`ctx`, a parallel.ctx.MeshCtx over a process group) `pa` and
the points hold one shard (padded observations masked by pa.valid) and the
cameras are replicated. The reductions sit where the reference's are: U and
ga (one all_reduce), S (cfg.s_reduce) and ea, the max diagonal of the first
damping, and once per try the shard-local scalars of the host read (|dpb|^2,
the point part of the denominator, the gain, |new pts|^2 and the count of
shards with a singular V block) in one all_reduce before the read. Every
rank then reads the same scalars and takes the same branch. With NO_MESH
each reduction is the identity. Same constants and update rules as the
reference:
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
from psba_tpu_torch.core.hessian import (
    assemble_blocks,
    damp_uv,
    damp_uv_marquardt,
    max_diag,
)
from psba_tpu_torch.core.jacobian import jacobians
from psba_tpu_torch.core.linalg import spd_solve
from psba_tpu_torch.core.residual import error_l2_diff, residuals
from psba_tpu_torch.core.schur import (
    back_substitute,
    back_substitute_dense,
    back_substitute_dense3,
    damp_v_planar,
    damp_v_planar_marquardt,
    diag_v_planar,
    inv3x3,
    inv3x3_planar,
    inv3x3_planar3,
    max_diag_planar,
    planar_gb,
    reduced_rhs,
    reduced_rhs_dense,
    reduced_rhs_dense3,
    schur_S,
    schur_S_dense,
    schur_S_dense3,
    stack_blocks,
    y_blocks,
)
from psba_tpu_torch.ops.linearize_dense import linearize_dense
from psba_tpu_torch.ops.linearize_stream import linearize_stream, residual_l2
from psba_tpu_torch.ops.residual_dense import gain_dense
from psba_tpu_torch.parallel.ctx import NO_MESH, MeshCtx
from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    np_dtype,
    use_kernels,
)
from psba_tpu_torch.utils import timing
from psba_tpu_torch.utils.timing import host_read

_NU_OVERFLOW = 2.0 ** 31  # the reference's int nu wraps here


def lm_fresh_aux(dtype, device) -> torch.Tensor:
    """Phase-start aux vector (mu, nu, p_l2, good_cnt, first=1, 0)."""
    return torch.tensor([0.0, 2.0, 1e3, 0.0, 1.0, 0.0], dtype=dtype,
                        device=device)


def lm_run(pa: ProblemArrays, state: OptState, cfg: SolverConfig,
           iter_cap: int | None = None, ctx: MeshCtx = NO_MESH) -> OptState:
    """Run LM until a flag other than CONTINUE or the shared iteration
    budget (or `iter_cap`, a global-iteration bound below cfg.max_iters
    for chunked checkpointing). `cfg.damping` must be resolved. `ctx`: the
    mesh of a sharded solve (module docstring)."""
    if cfg.damping == "auto":
        raise ValueError(
            'cfg.damping="auto" must be resolved before lm_run: call '
            "psba_tpu_torch.solvers.types.resolve_damping(cfg, pa, cams, "
            "pts) (solve does this itself)"
        )
    if not timing.tracing():
        return _lm_loop(pa, state, cfg, iter_cap, ctx, timing.no_span)
    with timing.lm_traced() as counters:
        out = _lm_loop(pa, state, cfg, iter_cap, ctx, timing.span)
        counters.iters += out.itno - state.itno
    return out


def _lm_loop(pa, state, cfg, iter_cap, ctx, span) -> OptState:
    """lm_run's loop; `span(name)` opens each stage's span (utils.timing.
    span while tracing, else utils.timing.no_span)."""
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
        a = host_read(state.aux.detach().cpu).numpy().astype(ft)
        mu, nu, p_l2 = a[0], a[1], a[2]
        good, first = int(a[3]), bool(a[4] > 0.5)
    history = state.history
    if cfg.record_history and history is None:
        history = np.full((cfg.max_iters, 6), np.nan, ft)
    elif not cfg.record_history:
        history = None

    cams, pts, ex = state.cams, state.pts, state.ex
    ex_l2 = ft(host_read(state.ex_l2.item))
    itno, flag = state.itno, CC.ITER_CONTINUE
    pairs = pa.pairs
    kernels = use_kernels(cfg, dtype)
    pa.need(kernels)
    # the kernel path on the dense encoding; every other path carries V
    # blocks [P, 3, 3] and refreshes ex on accept
    dense3 = kernels and not pairs
    # the pair kernel's bucket offsets (ops.schur_pairs), which need()
    # requires on the kernel path; the XLA form keeps its batched product
    pstart = pa.pair_start if kernels else None
    clamp = cfg.clamp_quat
    tables = (pa.obs_du, pa.obs_dv, pa.valid_d)
    valid = pa.valid
    # the collective of the S assembly (cfg.s_reduce)
    s_psum = ((lambda x: ctx.psum_rs(x, tag="S"))
              if cfg.s_reduce == "scatter" else
              (lambda x: ctx.psum(x, tag="S")))
    ea_psum = lambda x: ctx.psum(x, tag="ea")

    while itno < cap and flag == CC.ITER_CONTINUE:
        with span("psba.lm.linearize"):
            if not kernels:
                A, B = jacobians(pa.K, pa.q0, cams, pts, pa.cam_idx,
                                 pa.pt_idx, clamp=clamp)
                U, V, W, ga, gb = assemble_blocks(A, B, ex, pa.cam_idx,
                                                  pa.pt_idx, C, P,
                                                  valid=valid)
                if not pairs:
                    # once per iteration: every try reuses the planar ZW
                    ZW = stack_blocks(W, pa.blk_idx)
                    gbp = planar_gb(gb)
            elif pairs:
                _ex, _l2, U, V, W, ga, gb, _, _ = linearize_stream(
                    pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx, pa.pt_idx,
                    pa.valid_f, C, P, clamp=clamp, tables=pa.stream,
                )
            else:
                ZW0, ZW1, ZW2, Vp, gbp, _Pp, U, ga = linearize_dense(
                    pa.K, pa.q0, cams, pts, *tables, clamp=clamp,
                    want_u=True, kq=pa.kq, tile_mask=pa.tile_mask,
                )
                ZW3 = (ZW0, ZW1, ZW2)
                gb = gbp[:, :P].T
            U, ga = ctx.psum(U, ga, tag="U_ga")
        if first or marq:
            with span("psba.lm.damping"):
                if first:
                    if marq:
                        mu = ft(cfg.tau)
                    else:
                        md = (max_diag_planar(U, Vp, P) if dense3
                              else max_diag(U, V))
                        md = ctx.pmax(md, tag="max_diag")
                        mu = ft(cfg.tau) * ft(host_read(md.item))
                    nu, p_l2 = ft(2.0), ft(1e3)
                if marq:
                    dU = torch.diagonal(U, dim1=-2, dim2=-1)
                    dV = (diag_v_planar(Vp, P) if dense3
                          else torch.diagonal(V, dim1=-2, dim2=-1))
                    Dc = torch.where(dU > 0.0, dU, torch.ones_like(dU))
                    Dp = torch.where(dV > 0.0, dV, torch.ones_like(dV))

        tries, accepted, rho = 0, False, ft(np.nan)
        while (flag == CC.ITER_CONTINUE and not accepted
               and tries < cfg.max_inner):
            with span("psba.lm.schur"):
                mu_t = float(mu)
                if not dense3:
                    U_d, V_d = (damp_uv_marquardt if marq else damp_uv)(
                        U, V, mu_t)
                if pairs:
                    Vinv, vok = inv3x3(V_d)
                    Y = y_blocks(W, Vinv, pa.pt_idx)
                    S = schur_S(U_d, Y, W, pa.pair_o1, pa.pair_o2,
                                pa.pair_bucket, C, psum=s_psum,
                                pair_start=pstart)
                    ea = reduced_rhs(ga, gb, Y, pa.cam_idx, pa.pt_idx, C,
                                     psum=ea_psum)
                elif not kernels:
                    Vinv, vok = inv3x3_planar(V_d)
                    S, ZY = schur_S_dense(U_d, ZW, Vinv, psum=s_psum)
                    ea = reduced_rhs_dense(ga, gbp, ZY, psum=ea_psum)
                else:
                    if marq:
                        U_d = U + (mu_t * Dc)[..., None] * eye6
                        Vp_d = damp_v_planar_marquardt(Vp, mu_t)
                    else:
                        U_d = U + mu_t * eye6
                        Vp_d = damp_v_planar(Vp, mu_t)
                    Vinv, vok = inv3x3_planar3(Vp_d)
                    S, ZY3 = schur_S_dense3(U_d, ZW3, Vinv, psum=s_psum)
                    ea = reduced_rhs_dense3(ga, gbp, ZY3, psum=ea_psum)
            with span("psba.lm.solve"):
                dpa_flat, ok = spd_solve(S, ea.reshape(-1))
            with span("psba.lm.step"):
                dpa = dpa_flat.reshape(C, 6)
                if pairs:
                    _eb, dpb = back_substitute(gb, W, Vinv, dpa, pa.cam_idx,
                                               pa.pt_idx, P)
                elif not kernels:
                    _ebp, dpb = back_substitute_dense(gbp, ZW, Vinv, dpa)
                else:
                    dpb = back_substitute_dense3(gbp, ZW3, Vinv,
                                                 dpa)[:, :P].T
                new_cams = cams + dpa
                new_pts = pts + dpb
                if not kernels:
                    new_ex = residuals(pa.K, pa.q0, new_cams, new_pts,
                                       pa.obs, pa.cam_idx, pa.pt_idx,
                                       clamp=clamp)
                    gain_t = error_l2_diff(ex, new_ex, valid)
                elif pairs:
                    new_ex, _new_l2, gain_t = residual_l2(
                        pa.K, pa.q0, new_cams, new_pts, pa.obs,
                        pa.cam_idx32, pa.pt_idx32, pa.valid_f, clamp=clamp,
                        kq=pa.kq, ex_old=ex,
                    )
                else:
                    gain_t, _new_l2 = gain_dense(
                        pa.K, pa.q0, cams, pts, new_cams, new_pts, *tables,
                        clamp=clamp, kq=pa.kq, tile_mask=pa.tile_mask,
                    )
                if marq:
                    den_c = torch.sum(dpa * (mu_t * Dc * dpa + ga))
                    den_p = torch.sum(dpb * (mu_t * Dp * dpb + gb))
                else:
                    den_c = torch.sum(dpa * (mu_t * dpa + ga))
                    den_p = torch.sum(dpb * (mu_t * dpb + gb))
                # the shard-local scalars, summed over the mesh in one
                # collective (the last counts the shards with a singular V
                # block), then the one host read of the try
                local = ctx.psum(torch.stack([
                    torch.sum(dpb * dpb), den_p, gain_t,
                    torch.sum(new_pts * new_pts), (~vok).to(dtype),
                ]), tag="lm_try")
                packed = torch.cat([torch.stack([
                    torch.sum(dpa * dpa), den_c,
                    torch.sum(new_cams * new_cams), ok.to(dtype),
                ]), local])
                vals = host_read(packed.cpu).numpy().astype(ft)
            with span("psba.lm.control"):
                dpa2, den_c, nc2, okf, dpb2, den_p, gain, np2, n_bad = vals
                ok_all = bool(okf > 0.5) and bool(n_bad < 0.5)
                dp_l2 = dpa2 + dpb2
                denom = den_c + den_p

                stop_small = ok_all and dp_l2 < p_l2 * stop2
                stop_singular = ok_all and dp_l2 >= (p_l2
                                                     + stop_thresh) / eps_sq
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
                    if not dense3:
                        ex = new_ex
                    ex_l2 = ex_l2 - gain
                    p_l2 = nc2 + np2
                    mu, nu = mu * shrink, ft(2.0)
                else:
                    # a failed solve resets the good-step count; rho <= 0
                    # does not (as in the reference)
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
        aux = host_read(lambda: torch.tensor(
            [mu, nu, p_l2, good, float(first), 0.0], dtype=dtype, device=dev))
    # the loop may end on the iteration budget with flag still CONTINUE
    return OptState(
        cams=cams, pts=pts, ex=ex,
        ex_l2=host_read(lambda: torch.tensor(ex_l2, dtype=dtype,
                                             device=dev)),
        itno=itno, flag=flag, history=history, aux=aux,
    )
