"""Schur-complement reduction of the camera system (PyTorch counterpart
of psba_tpu.core.schur): the dense3 family, the dense family of the XLA
form and the covisibility-pair family.

dense3. Everything per point is planar: V blocks are [3, 3, Pp] and the
stacked off-diagonal factor comes as three [6C, Pp] planes ZWk[6c+i, p] =
W_(c,p)[i, k] (ops.linearize_dense). With that layout

  ZY_j   = sum_m ZW_m * Vinv[m, j]                 (broadcast FMAs)
  S      = blockdiag(U) - sum_j ZY_j @ ZW_j^T      [6C, 6C]
  ea     = ga - sum_j ZY_j @ gb_j                  [C, 6]
  eb_j   = gb_j - ZW_j^T dpa;  dpb_k = sum_j Vinv[j, k] eb_j

dense, XLA form (the float64 path and backend="xla"). The per-observation
W_o [O, 6, 3] of core.hessian.assemble_blocks are stacked once per
linearization into the planar ZW [6C, 3P] (stack_blocks: ZW[6c+i, kP+p] =
W_(c,p)[i, k], zero where unseen), V blocks are inverted to [3, 3, P]
(inv3x3_planar), and

  ZY[:, jP+p] = sum_k ZW[:, kP+p] Vinv[k, j, p]     (nine broadcast FMAs)
  S  = blockdiag(U) - ZY @ ZW^T;  ea = ga - ZY @ gbp
  ebp = gbp - ZW^T dpa;  dpb_(p, j) = sum_k Vinv[k, j, p] eb_(k, p)

pairs. Per-observation blocks W_o [O, 6, 3] (ops.linearize_stream) and the
static covisibility pair list of problem.build_covis_pairs:

  Y_o    = W_o Vinv_{i(o)}                                     [O, 6, 3]
  S_kl   = delta_kl U_k - sum_{pairs (o1, o2) in bucket kC+l} Y_o1 W_o2^T
  ea_j   = ga_j - sum_{o: cam(o)=j} Y_o gb_{i(o)}              [C, 6]
  eb_i   = gb_i - sum_{o: pt(o)=i} W_o^T dpa_{j(o)};  dpb_i = Vinv_i eb_i

The pair products are one batched (6x3)(3x6) product over the pairs and
one bucket sum (ops.reduce.indexed_sum, in a fixed order on the card).

The products are plain matrix products (cuBLAS on the card), pinned to
true float32: TF32 would keep about three decimal digits of S, which caps
how far the float32 path converges (the reference pins Precision.HIGHEST
for the same reason). The dense XLA family does not pin: TF32 touches
float32 products only, and in float64 its products are DGEMM and gemv.

s_precision="high" (SolverConfig) is the reference's Precision.HIGH (3-pass
bf16, about 2^-21 relative error on its products). Named deviation: the
port runs every product under "high" in full float32, as under "highest",
on the card as on the CPU (where the reference's HIGH is float32 too).
float32 is at least as accurate as "high" promises, and on the H100 a
3xTF32 S product built from cuBLAS TF32 GEMMs and torch ops was slower
than the float32 one, with no gain in accuracy (PERF.md section 6, PR 11;
ROADMAP Queue 2 for the fused kernel that could beat it).
"""

from __future__ import annotations

import torch

from psba_tpu_torch.ops.reduce import indexed_sum
from psba_tpu_torch.utils.timing import host_read


def _pin_fp32_matmul() -> None:
    """Keep float32 products in full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _block_scale(a, b, c, d, e, f):
    """Per-block power-of-two scale 2^-floor(log2(max|entry|)) and its cube.

    The power of two makes the scaling exact: the inverse of the scaled
    block equals the unscaled one whenever the latter does not overflow,
    and badly scaled blocks (diag ~1e12, mu ~1e20) no longer overflow the
    float32 determinant. In float32 the exponent is read from the bits."""
    m = torch.maximum(
        torch.maximum(torch.maximum(a.abs(), b.abs()), c.abs()),
        torch.maximum(torch.maximum(d.abs(), e.abs()), f.abs()),
    )
    m_safe = torch.where(m > 0.0, m, torch.ones_like(m))
    if m_safe.dtype == torch.float32:
        # m_safe > 0, so the sign bit is clear and >> is a logical shift;
        # a subnormal m maps to exponent 0 -> inv_m = 2^127
        eb = m_safe.view(torch.int32) >> 23
        inv_bits = torch.clamp(254 - eb, 1, 254) << 23
        inv_m = inv_bits.to(torch.int32).view(torch.float32)
    else:
        inv_m = torch.exp2(-torch.floor(torch.log2(m_safe)))
    return inv_m, inv_m * inv_m * inv_m


def _pivoted_det3_rows(m):
    """Partial-pivot Gaussian determinant of a 3x3 of planar [P] vectors
    (m[i][j] is row i, column j): pivots chosen by magnitude, row-swap
    signs tracked."""
    r0, r1, r2 = list(m[0]), list(m[1]), list(m[2])
    sign = torch.ones_like(r0[0])
    c0 = (r0[0].abs(), r1[0].abs(), r2[0].abs())
    p1 = c0[1] > torch.maximum(c0[0], c0[2])
    p2 = (~p1) & (c0[2] > c0[0])

    def swap(ra, rb, pred):
        return (
            [torch.where(pred, y, x) for x, y in zip(ra, rb)],
            [torch.where(pred, x, y) for x, y in zip(ra, rb)],
        )

    r0, r1 = swap(r0, r1, p1)
    r0, r2 = swap(r0, r2, p2)
    sign = torch.where(p1 | p2, -sign, sign)

    a00 = r0[0]
    nz0 = a00 != 0.0
    safe00 = torch.where(nz0, a00, torch.ones_like(a00))
    zero = torch.zeros_like(a00)
    l1 = torch.where(nz0, r1[0] / safe00, zero)
    l2 = torch.where(nz0, r2[0] / safe00, zero)
    b11 = r1[1] - l1 * r0[1]
    b12 = r1[2] - l1 * r0[2]
    b21 = r2[1] - l2 * r0[1]
    b22 = r2[2] - l2 * r0[2]

    swap2 = b21.abs() > b11.abs()
    t11 = torch.where(swap2, b21, b11)
    t12 = torch.where(swap2, b22, b12)
    t21 = torch.where(swap2, b11, b21)
    t22 = torch.where(swap2, b12, b22)
    sign = torch.where(swap2, -sign, sign)

    nz1 = t11 != 0.0
    safe11 = torch.where(nz1, t11, torch.ones_like(t11))
    c22 = t22 - torch.where(nz1, t21 / safe11, zero) * t12
    return sign * a00 * t11 * c22


def inv3x3_planar3(Vp: torch.Tensor):
    """Batched symmetric 3x3 inverse on planar [3, 3, P] blocks by
    cofactors, with the pivoted determinant as fallback where the closed
    form's |det| < 1e-16 (unscaled). The fallback is only evaluated when
    some block needs it; that test is a host read (utils.timing.host_read),
    so every call waits for the card. Returns (Vinv [3, 3, P], ok) with ok
    a 0-d bool tensor: False when any block is singular (|scaled det| <=
    8 eps or non-finite)."""
    a, b, c = Vp[0, 0], Vp[0, 1], Vp[0, 2]
    d, e, f = Vp[1, 1], Vp[1, 2], Vp[2, 2]
    inv_m, inv_m3 = _block_scale(a, b, c, d, e, f)
    a, b, c = a * inv_m, b * inv_m, c * inv_m
    d, e, f = d * inv_m, e * inv_m, f * inv_m
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    det = a * co00 + b * co01 + c * co02
    need_fallback = det.abs() < 1e-16 * inv_m3
    if host_read(need_fallback.any().item):
        det_piv = _pivoted_det3_rows(((a, b, c), (b, d, e), (c, e, f)))
        det = torch.where(need_fallback, det_piv, det)
    eps = torch.finfo(det.dtype).eps
    blk_ok = torch.isfinite(det) & (det.abs() > 8.0 * eps)
    ok = torch.all(blk_ok)
    one = torch.ones_like(det)
    inv_det = torch.where(
        blk_ok, 1.0 / torch.where(blk_ok, det, one), torch.zeros_like(det)
    )
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    Vinv = torch.stack([
        torch.stack([co00, co01, co02], dim=0),
        torch.stack([co01, co11, co12], dim=0),
        torch.stack([co02, co12, co22], dim=0),
    ], dim=0) * (inv_det * inv_m)[None, None]
    return Vinv, ok


def _eye3(Vp: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=Vp.dtype, device=Vp.device)[:, :, None]


def damp_v_planar(Vp: torch.Tensor, mu) -> torch.Tensor:
    """Additive diagonal damping of planar [3, 3, P] point blocks."""
    return Vp + mu * _eye3(Vp)


def damp_v_planar_marquardt(Vp: torch.Tensor, mu) -> torch.Tensor:
    """Multiplicative damping: diagonals become d*(1+mu); zero diagonals
    fall back to additive mu."""
    d = torch.where(Vp > 0.0, Vp, torch.ones_like(Vp))
    return Vp + mu * (d * _eye3(Vp))


def diag_v_planar(Vp: torch.Tensor, n_pts: int) -> torch.Tensor:
    """Diagonal of planar V blocks as [P, 3]."""
    return torch.stack([Vp[0, 0], Vp[1, 1], Vp[2, 2]], dim=1)[:n_pts]


def max_diag_planar(U: torch.Tensor, Vp: torch.Tensor,
                    n_pts: int) -> torch.Tensor:
    """max over the U and planar-V diagonals; padded columns excluded."""
    du = torch.max(torch.diagonal(U, dim1=-2, dim2=-1))
    dv = torch.max(torch.stack(
        [Vp[0, 0, :n_pts], Vp[1, 1, :n_pts], Vp[2, 2, :n_pts]]
    ))
    return torch.maximum(du, dv)


def schur_S_dense3(U: torch.Tensor, ZW3, Vinv: torch.Tensor, psum=None):
    """S = blockdiag(U) - sum_j ZY_j @ ZW_j^T with ZY_j = sum_m ZW_m *
    Vinv[m, j]. U [C, 6, 6] must already be damped (and mesh-global);
    `psum` (a parallel.ctx.MeshCtx reduction) sums the shard-local
    off-diagonal part. Full float32 under s_precision "high" too, where
    the reference runs Precision.HIGH (core/schur.py:345): the named
    deviation of the module docstring. Returns (S [6C, 6C], ZY3), ZY3 reused by
    reduced_rhs_dense3."""
    _pin_fp32_matmul()
    C = U.shape[0]
    ZY3 = tuple(
        ZW3[0] * Vinv[0, j][None]
        + ZW3[1] * Vinv[1, j][None]
        + ZW3[2] * Vinv[2, j][None]
        for j in range(3)
    )
    off = torch.matmul(ZY3[0], ZW3[0].T)
    off += torch.matmul(ZY3[1], ZW3[1].T)
    off += torch.matmul(ZY3[2], ZW3[2].T)
    if psum is not None:
        off = psum(off)
    S = (-off).reshape(C, 6, C, 6)
    # the diagonal view over the two camera axes is [6, 6, C]
    S.diagonal(dim1=0, dim2=2).add_(U.permute(1, 2, 0))
    return S.reshape(6 * C, 6 * C), ZY3


def reduced_rhs_dense3(ga: torch.Tensor, gbp: torch.Tensor, ZY3, psum=None):
    """ea = ga - sum_j ZY_j @ gbp[j]; gbp is [3, Pp]. Returns [C, 6]. `ga`
    must be mesh-global; `psum` sums the shard-local term. Full float32
    under s_precision "high" too, where the reference runs Precision.HIGH
    (core/schur.py:359): the named deviation of the module docstring."""
    _pin_fp32_matmul()
    term = sum(torch.matmul(ZY3[j], gbp[j]) for j in range(3))
    if psum is not None:
        term = psum(term)
    return ga - term.reshape(-1, 6)


def back_substitute_dense3(gbp: torch.Tensor, ZW3, Vinv: torch.Tensor,
                           dpa: torch.Tensor) -> torch.Tensor:
    """eb_j = gbp[j] - ZW_j^T dpa; dpb_k = sum_j Vinv[j, k] eb_j.
    Returns dpb [3, Pp]. Full float32 under s_precision "high" too, where
    the reference runs Precision.HIGH (core/schur.py:372): the named
    deviation of the module docstring."""
    _pin_fp32_matmul()
    v = dpa.reshape(-1)
    eb = [gbp[j] - torch.matmul(v, ZW3[j]) for j in range(3)]
    return torch.stack(
        [
            Vinv[0, k] * eb[0] + Vinv[1, k] * eb[1] + Vinv[2, k] * eb[2]
            for k in range(3)
        ],
        dim=0,
    )


def inv3x3_planar(V: torch.Tensor):
    """inv3x3_planar3 on [P, 3, 3] blocks, stacked as [3, 3, P]: the same
    cofactor inverse, power-of-two block scale and pivoted fallback, read
    from the upper triangle (V symmetric). Returns (Vinv [3, 3, P], ok)."""
    return inv3x3_planar3(V.permute(1, 2, 0))


def stack_blocks(W: torch.Tensor, blk_idx: torch.Tensor) -> torch.Tensor:
    """W [O, 6, 3] -> planar ZW [6C, 3P] with ZW[6c+i, kP+p] = W_o[i, k]
    for the observation o of point p in camera c, 0 where unseen: one row
    gather by blk_idx [C, P] (n_obs marks an unseen cell and picks the
    appended zero row)."""
    O = W.shape[0]
    C, P = blk_idx.shape
    W_pad = torch.cat([W.reshape(O, 18), W.new_zeros((1, 18))], dim=0)
    G = W_pad.index_select(0, blk_idx.reshape(-1))         # [C*P, 18]
    # [C, P, 6, 3] -> [C, 6, 3, P]: rows 6c+i, columns kP+p
    return G.reshape(C, P, 6, 3).permute(0, 2, 3, 1).reshape(6 * C, 3 * P)


def schur_S_dense(U: torch.Tensor, ZW: torch.Tensor, Vp: torch.Tensor,
                  psum=None):
    """S = blockdiag(U) - ZY @ ZW^T with ZY[:, jP+p] = sum_k ZW[:, kP+p]
    Vp[k, j, p]. U [C, 6, 6] must already be damped (and mesh-global); Vp
    is the planar inverse [3, 3, P] (inv3x3_planar); `psum` sums the
    shard-local ZY @ ZW^T. Returns (S [6C, 6C], ZY [6C, 3P]), ZY reused by
    reduced_rhs_dense."""
    R = ZW.shape[0]
    C, P = R // 6, ZW.shape[1] // 3
    Zk = ZW.reshape(R, 3, P)
    ZY = torch.cat([
        Zk[:, 0] * Vp[0, j][None] + Zk[:, 1] * Vp[1, j][None]
        + Zk[:, 2] * Vp[2, j][None]
        for j in range(3)
    ], dim=1)
    # no _pin_fp32_matmul here: TF32 concerns float32 products only, and
    # in float64 this product is DGEMM
    off = torch.matmul(ZY, ZW.T)
    if psum is not None:
        off = psum(off)
    S = (-off).reshape(C, 6, C, 6)
    S.diagonal(dim1=0, dim2=2).add_(U.permute(1, 2, 0))
    return S.reshape(6 * C, 6 * C), ZY


def reduced_rhs_dense(ga: torch.Tensor, gbp: torch.Tensor,
                      ZY: torch.Tensor, psum=None) -> torch.Tensor:
    """ea = ga - ZY @ gbp; gbp is the planar [3P] point vector
    (planar_gb). Returns [C, 6]. `ga` must be mesh-global; `psum` sums the
    shard-local term."""
    term = torch.matmul(ZY, gbp)
    if psum is not None:
        term = psum(term)
    return ga - term.reshape(-1, 6)


def planar_gb(gb: torch.Tensor) -> torch.Tensor:
    """[P, 3] point vector -> planar [3P] (index kP+p), the column layout
    of stack_blocks."""
    return gb.T.reshape(-1)


def back_substitute_dense(gbp: torch.Tensor, ZW: torch.Tensor,
                          Vp: torch.Tensor, dpa: torch.Tensor):
    """ebp = gbp - ZW^T dpa;  dpb_(p, j) = sum_k Vp[k, j, p] eb_(k, p).
    Returns (ebp [3P] planar, dpb [P, 3])."""
    P = ZW.shape[1] // 3
    ebp = gbp - torch.matmul(dpa.reshape(-1), ZW)
    Ek = ebp.reshape(3, P)
    dpb = torch.stack([
        Vp[0, j] * Ek[0] + Vp[1, j] * Ek[1] + Vp[2, j] * Ek[2]
        for j in range(3)
    ], dim=1)
    return ebp, dpb


def inv3x3(V: torch.Tensor):
    """inv3x3_planar3 on [P, 3, 3] blocks: the same cofactor inverse,
    power-of-two block scale and pivoted fallback, read from the upper
    triangle (V symmetric). Returns (Vinv [P, 3, 3], ok)."""
    Vinv, ok = inv3x3_planar3(V.permute(1, 2, 0))
    return Vinv.permute(2, 0, 1).contiguous(), ok


def y_blocks(W: torch.Tensor, Vinv: torch.Tensor,
             pt_idx: torch.Tensor) -> torch.Tensor:
    """Y_o = W_o Vinv_{i(o)}  [O, 6, 3]."""
    _pin_fp32_matmul()
    return torch.matmul(W, Vinv[pt_idx])


def schur_S(U: torch.Tensor, Y: torch.Tensor, W: torch.Tensor, pair_o1,
            pair_o2, pair_bucket, n_cams: int, psum=None) -> torch.Tensor:
    """S [6C, 6C] from the pair list; U [C, 6, 6] must already be damped
    (and mesh-global); `psum` sums the shard-local bucket sums. Pair
    entries with bucket C*C (padding) add nothing."""
    _pin_fp32_matmul()
    C = n_cams
    contrib = torch.matmul(Y[pair_o1], W[pair_o2].transpose(1, 2))  # [N,6,6]
    off = indexed_sum(contrib.reshape(-1, 36), pair_bucket, C * C)
    if psum is not None:
        off = psum(off)
    S = -off.reshape(C, C, 6, 6)
    ar = torch.arange(C, device=U.device)
    S[ar, ar] += U
    return S.permute(0, 2, 1, 3).reshape(6 * C, 6 * C)


def reduced_rhs(ga: torch.Tensor, gb: torch.Tensor, Y: torch.Tensor,
                cam_idx, pt_idx, n_cams: int, psum=None) -> torch.Tensor:
    """ea_j = ga_j - sum_{o: cam(o)=j} Y_o gb_{i(o)}  [C, 6]. `ga` must be
    mesh-global; `psum` sums the shard-local term."""
    _pin_fp32_matmul()
    contrib = torch.matmul(Y, gb[pt_idx][..., None])[..., 0]      # [O, 6]
    term = indexed_sum(contrib, cam_idx, n_cams)
    if psum is not None:
        term = psum(term)
    return ga - term


def back_substitute(gb: torch.Tensor, W: torch.Tensor, Vinv: torch.Tensor,
                    dpa: torch.Tensor, cam_idx, pt_idx, n_pts: int):
    """eb_i = gb_i - sum_{o: pt(o)=i} W_o^T dpa_{j(o)};  dpb_i = Vinv_i eb_i.
    Returns (eb [P, 3], dpb [P, 3])."""
    _pin_fp32_matmul()
    wt_dpa = torch.matmul(W.transpose(1, 2), dpa[cam_idx][..., None])[..., 0]
    eb = gb - indexed_sum(wt_dpa, pt_idx, n_pts)
    return eb, torch.matmul(Vinv, eb[..., None])[..., 0]
