"""Plain reference of a Levenberg-Marquardt run of PSBA's bundle adjustment.

Plain PyTorch, written from the published description of PSBA's camera
model and LM loop; it imports nothing of the program. Given the generated
inputs, a starting point and the solver settings, it works out again what
the program derives for itself (the damping mode, the per-point structure
of the reduced camera system) and runs the same iterations:

  camera model   x = proj(K, R(q_l(v) (x) q0) X + t), q_l(v) = (sqrt(1 -
                 |v|^2), v), K = [fu, u0, v0, ar, s]; the residual is
                 e = obs - x and the Jacobian J = dx/dp (forward-mode
                 derivatives of the model, one per parameter)
  damping        "additive" while tau max(diag) / min(diag > 0) of J^T J
                 at the start is below 1/eps of the working precision,
                 "marquardt" beyond; mu = tau max(diag U, diag V) (additive)
                 or tau (marquardt) at the first iteration
  one try        U + mu D, V + mu D; S = U_d - sum_points W V_d^-1 W^T (the
                 products over every pair of observations of a point);
                 ea = ga - sum W V_d^-1 gb; S dpa = ea (Cholesky); dpb =
                 V_d^-1 (gb - W^T dpa); the gain sum (e_old - e_new)(e_old
                 + e_new) and rho = gain / dp^T (mu D dp + g)
  acceptance     rho > 0 and neither stop test (|dp|^2 < |p|^2 stop^2,
                 |dp|^2 >= (|p|^2 + stop) / eps^2); Nielsen's update of mu

`matmul="tf32"` rounds both operands of every product to TF32 (10 bits of
mantissa, round to nearest even) and multiplies in float32: the precision a
matrix product gets on the card with TF32 on. It serves as the control.
"""

from __future__ import annotations

import numpy as np
import torch

EPS_SQ = 1e-24          # PSBA's epsilon^2 of the singular-step test
NU_OVERFLOW = 2.0 ** 31


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10-bit mantissa (nearest even)."""
    i = x.contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    r = ((i + 0x0FFF + lsb) >> 13) << 13
    return r.view(torch.float32)


class Products:
    """The reference's matrix products, exact in the working dtype or with
    TF32 operands (the control)."""

    def __init__(self, matmul: str):
        if matmul not in ("exact", "tf32"):
            raise ValueError(f"matmul={matmul!r}")
        self.tf32 = matmul == "tf32"

    def einsum(self, eq: str, *ops):
        if self.tf32:
            ops = [round_tf32(o.to(torch.float32)) for o in ops]
        return torch.einsum(eq, *ops)


def quat_mul(q, r):
    qw, qx, qy, qz = q.unbind(-1)
    rw, rx, ry, rz = r.unbind(-1)
    return torch.stack([qw * rw - qx * rx - qy * ry - qz * rz,
                        qw * rx + qx * rw + qy * rz - qz * ry,
                        qw * ry - qx * rz + qy * rw + qz * rx,
                        qw * rz + qx * ry - qy * rx + qz * rw], dim=-1)


def rotate(q, p):
    """p rotated by the unit quaternion q, as R(q) p."""
    w, x, y, z = q.unbind(-1)
    px, py, pz = p.unbind(-1)
    return torch.stack([
        (1 - 2 * (y * y + z * z)) * px + 2 * (x * y - z * w) * py
        + 2 * (x * z + y * w) * pz,
        2 * (x * y + z * w) * px + (1 - 2 * (x * x + z * z)) * py
        + 2 * (y * z - x * w) * pz,
        2 * (x * z - y * w) * px + 2 * (y * z + x * w) * py
        + (1 - 2 * (x * x + y * y)) * pz], dim=-1)


def predict(K, q0, cam, X):
    """Per observation: K [O,5], q0 [O,4], cam [O,6] = (v, t), X [O,3]."""
    v, t = cam[:, :3], cam[:, 3:]
    s = torch.sqrt(1.0 - (v * v).sum(-1, keepdim=True))
    q = quat_mul(torch.cat([s, v], dim=-1), q0)
    pc = rotate(q, X) + t
    fu, u0, v0, ar, sk = K.unbind(-1)
    x, y, z = pc.unbind(-1)
    return torch.stack([(fu * x + sk * y + u0 * z) / z,
                        (fu * ar * y + v0 * z) / z], dim=-1)


class Problem:
    """The inputs on a device in the working dtype, with the per-point
    table of observations [P, m] (m the most views of a point; padding
    points at the observation n_obs, whose camera is the padding camera C)
    and blocks of points, by their number of views, that hold about
    `pairs_per_block` pairs of observations each."""

    def __init__(self, arrays: dict, device, dtype=torch.float64,
                 pairs_per_block: int = 1 << 21):
        f = lambda k: torch.as_tensor(arrays[k], dtype=dtype, device=device)
        i = lambda k: torch.as_tensor(arrays[k].astype(np.int64),
                                      device=device)
        self.dtype, self.device = dtype, torch.device(device)
        self.K, self.q0, self.obs = f("K"), f("q0"), f("obs")
        self.cam_idx, self.pt_idx = i("cam_idx"), i("pt_idx")
        self.C, self.P = self.K.shape[0], arrays["pts"].shape[0]
        self.O = self.obs.shape[0]
        counts = torch.bincount(self.pt_idx, minlength=self.P)
        self.m = int(counts.max())
        order = torch.argsort(self.pt_idx, stable=True)
        start = torch.cumsum(counts, 0) - counts
        rank = torch.arange(self.O, device=self.device) - start[
            self.pt_idx[order]]
        table = torch.full((self.P, self.m), self.O, dtype=torch.int64,
                           device=self.device)
        table[self.pt_idx[order], rank] = order
        self.table = table
        self.cam_pad = torch.cat([self.cam_idx, torch.tensor(
            [self.C], device=self.device)])
        # blocks of points in the order of their views: (points, m of the
        # block), each block's points times its m^2 at most pairs_per_block
        by_views = torch.argsort(counts, stable=True)
        views = counts[by_views].cpu().numpy()
        self.blocks, b0 = [], 0
        while b0 < self.P:
            nb = max(1, pairs_per_block // int(views[b0]) ** 2)
            m = int(views[min(b0 + nb, self.P) - 1])
            nb = max(1, pairs_per_block // m ** 2)
            m = int(views[min(b0 + nb, self.P) - 1])
            self.blocks.append((by_views[b0:b0 + nb], m))
            b0 += nb

    def residual(self, cams, pts):
        ci, pi = self.cam_idx, self.pt_idx
        return self.obs - predict(self.K[ci], self.q0[ci], cams[ci], pts[pi])

    def jacobians(self, cams, pts):
        """A [O,2,6] = dx/dcam and B [O,2,3] = dx/dpoint, one forward-mode
        derivative of the model per parameter."""
        ci, pi = self.cam_idx, self.pt_idx
        Kc, qc, cc, X = self.K[ci], self.q0[ci], cams[ci], pts[pi]
        cols = []
        for k in range(9):
            dc = torch.zeros_like(cc)
            dX = torch.zeros_like(X)
            (dc if k < 6 else dX)[:, k % 6 if k < 6 else k - 6] = 1.0
            _, d = torch.func.jvp(lambda c, x: predict(Kc, qc, c, x),
                                  (cc, X), (dc, dX))
            cols.append(d)
        J = torch.stack(cols, dim=-1)
        return J[..., :6], J[..., 6:]


def resolve_damping(prob: Problem, cams, pts, tau: float,
                    working_dtype) -> str:
    """The damping mode PSBA's "auto" takes at this start."""
    A, B = prob.jacobians(cams, pts)
    dU = torch.zeros(prob.C, 6, dtype=prob.dtype, device=prob.device)
    dV = torch.zeros(prob.P, 3, dtype=prob.dtype, device=prob.device)
    dU.index_add_(0, prob.cam_idx, (A * A).sum(1))
    dV.index_add_(0, prob.pt_idx, (B * B).sum(1))
    d = torch.cat([dU.reshape(-1), dV.reshape(-1)])
    ratio = float(d.max()) / max(float(d[d > 0].min()),
                                 float(np.finfo(working_dtype).tiny))
    eps = float(np.finfo(working_dtype).eps)
    return "additive" if tau * ratio < 1.0 / eps else "marquardt"


def lm(prob: Problem, cams, pts, settings: dict,
       matmul: str = "exact") -> dict:
    """`settings["iters"]` LM iterations from (cams, pts) in prob.dtype.

    settings: iters, tau, stop_thresh, damping ("additive" / "marquardt"),
    max_inner, lm_switch_count. Returns dict(cams, pts, l2 [per iteration],
    tries [per iteration], iters, flag), flag "continue", "dp_no_change",
    "err", "small_enough" or "turn_to_tr"."""
    dt, dev = prob.dtype, prob.device
    mm = Products(matmul)
    C, P = prob.C, prob.P
    marq = settings["damping"] == "marquardt"
    stop = float(settings["stop_thresh"])
    tau = float(settings["tau"])
    cams = cams.to(dt).clone()
    pts = pts.to(dt).clone()
    ex = prob.residual(cams, pts)
    l2 = float((ex * ex).sum())
    mu, nu, p_l2, good, flag = 0.0, 2.0, 1e3, 0, "continue"
    l2s, tries_log = [], []
    eye6 = torch.eye(6, dtype=dt, device=dev)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    cp = prob.cam_pad
    for it in range(int(settings["iters"])):
        A, B = prob.jacobians(cams, pts)
        U = torch.zeros(C, 6, 6, dtype=dt, device=dev)
        V = torch.zeros(P, 3, 3, dtype=dt, device=dev)
        ga = torch.zeros(C, 6, dtype=dt, device=dev)
        gb = torch.zeros(P, 3, dtype=dt, device=dev)
        U.index_add_(0, prob.cam_idx, mm.einsum("oki,okj->oij", A, A).to(dt))
        V.index_add_(0, prob.pt_idx, mm.einsum("oki,okj->oij", B, B).to(dt))
        ga.index_add_(0, prob.cam_idx, mm.einsum("oki,ok->oi", A, ex).to(dt))
        gb.index_add_(0, prob.pt_idx, mm.einsum("oki,ok->oi", B, ex).to(dt))
        W = mm.einsum("oki,okj->oij", A, B).to(dt)              # [O, 6, 3]
        W_pad = torch.cat([W, torch.zeros(1, 6, 3, dtype=dt, device=dev)])
        dU = torch.diagonal(U, dim1=-2, dim2=-1)
        dV = torch.diagonal(V, dim1=-2, dim2=-1)
        if it == 0:
            mu = tau if marq else tau * float(torch.maximum(dU.max(),
                                                            dV.max()))
            nu, p_l2 = 2.0, 1e3
        Dc = torch.where(dU > 0, dU, torch.ones_like(dU)) if marq else 1.0
        Dp = torch.where(dV > 0, dV, torch.ones_like(dV)) if marq else 1.0
        tries, accepted = 0, False
        while flag == "continue" and not accepted and \
                tries < settings["max_inner"]:
            Ud = U + (mu * Dc)[..., None] * eye6 if marq else U + mu * eye6
            Vd = V + (mu * Dp)[..., None] * eye3 if marq else V + mu * eye3
            Vinv = torch.linalg.inv(Vd)
            Y = mm.einsum("oij,ojk->oik", W, Vinv[prob.pt_idx]).to(dt)
            Y_pad = torch.cat([Y, torch.zeros(1, 6, 3, dtype=dt,
                                              device=dev)])
            S4 = torch.zeros(C + 1, C + 1, 6, 6, dtype=dt, device=dev)
            for pts_b, m in prob.blocks:
                T = prob.table[pts_b, :m]                      # [b, m]
                prod = mm.einsum("bmij,bnkj->bmnik", Y_pad[T],
                                 W_pad[T]).to(dt)            # [b,m,m,6,6]
                ca = cp[T]
                S4.index_put_((ca[:, :, None].expand(-1, m, m),
                               ca[:, None, :].expand(-1, m, m)), prod,
                              accumulate=True)
            S = _block_diag(Ud) - S4[:C, :C].permute(0, 2, 1, 3).reshape(
                6 * C, 6 * C)
            ea = ga.clone()
            ea.index_add_(0, prob.cam_idx, -mm.einsum(
                "oij,oj->oi", Y, gb[prob.pt_idx]).to(dt))
            L, info = torch.linalg.cholesky_ex(S)
            ok = int(info) == 0
            dpa = torch.cholesky_solve(ea.reshape(-1, 1), L).reshape(C, 6)
            eb = gb.clone()
            eb.index_add_(0, prob.pt_idx, -mm.einsum(
                "oji,oj->oi", W, dpa[prob.cam_idx]).to(dt))
            dpb = mm.einsum("pij,pj->pi", Vinv, eb).to(dt)
            new_cams, new_pts = cams + dpa, pts + dpb
            new_ex = prob.residual(new_cams, new_pts)
            gain = float(((ex - new_ex) * (ex + new_ex)).sum())
            denom = float((dpa * (mu * Dc * dpa + ga)).sum()
                          + (dpb * (mu * Dp * dpb + gb)).sum())
            dp_l2 = float((dpa * dpa).sum() + (dpb * dpb).sum())
            ok = ok and bool(torch.isfinite(dpa).all()) and bool(
                torch.isfinite(dpb).all())
            stop_small = ok and dp_l2 < p_l2 * stop * stop
            stop_sing = ok and dp_l2 >= (p_l2 + stop) / EPS_SQ
            rho = gain / denom if ok else -1.0
            accept = rho > 0 and ok and not (stop_small or stop_sing)
            if stop_small:
                flag = "dp_no_change"
            elif stop_sing:
                flag = "err"
            elif accept:
                good = good + 1 if abs(rho - 1.0) < 0.2 else 0
                if good >= settings["lm_switch_count"]:
                    flag = "turn_to_tr"
                cams, pts, ex = new_cams, new_pts, new_ex
                l2 -= gain
                p_l2 = float((cams * cams).sum() + (pts * pts).sum())
                tmp = 2.0 * rho - 1.0
                mu, nu = mu * max(1.0 - tmp ** 3, 1.0 / 3.0), 2.0
            else:
                mu, nu = mu * nu, 2.0 * nu
                if nu >= NU_OVERFLOW:
                    flag = "err"
                if not ok:
                    good = 0
            accepted = accept
            tries += 1
        if tries >= settings["max_inner"] and not accepted:
            flag = "err"
        if l2 <= stop:
            flag = "small_enough"
        l2s.append(l2)
        tries_log.append(tries)
        if flag != "continue":
            break
    return dict(cams=cams, pts=pts, l2=l2s, tries=tries_log,
                iters=len(l2s), flag=flag)


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """[C, 6, 6] -> the [6C, 6C] block-diagonal matrix."""
    C = blocks.shape[0]
    out = torch.zeros(C, 6, C, 6, dtype=blocks.dtype, device=blocks.device)
    idx = torch.arange(C, device=blocks.device)
    out[idx, :, idx, :] = blocks
    return out.reshape(6 * C, 6 * C)
