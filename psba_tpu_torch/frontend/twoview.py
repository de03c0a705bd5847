"""Two-view geometry (PyTorch counterpart of psba_tpu.frontend.twoview):
essential matrix, pose, triangulation.

The normalized 8-point algorithm over all valid correspondences (least
squares by SVD), E projected onto the essential manifold, fixed-iteration
RANSAC around it, the four-fold (R, t) decomposition decided by a
cheirality vote, and batched DLT triangulation. Fixed shapes; invalid
correspondences carry zero weight. Every function runs on the device of
its tensor inputs.

SVD signs are the library's: E comes out up to sign, as the reference's
does; R after the cheirality vote, and the direction of t, do not depend
on them.
"""

from __future__ import annotations

import math

import torch


def _hartley(scale, mean):
    """[[s, 0, -s mx], [0, s, -s my], [0, 0, 1]] (batched over leading
    dimensions of scale [...] and mean [..., 2])."""
    z, one = torch.zeros_like(scale), torch.ones_like(scale)
    return torch.stack([
        torch.stack([scale, z, -scale * mean[..., 0]], dim=-1),
        torch.stack([z, scale, -scale * mean[..., 1]], dim=-1),
        torch.stack([z, z, one], dim=-1),
    ], dim=-2)


def _normalize_pts(x, w):
    """Hartley normalization with weights w [N]."""
    wsum = torch.sum(w) + 1e-9
    mean = torch.sum(x * w[:, None], dim=0) / wsum
    d = torch.sqrt(torch.sum((x - mean) ** 2, dim=1)) * w
    scale = math.sqrt(2.0) / (torch.sum(d) / wsum + 1e-9)
    return (x - mean) * scale, _hartley(scale, mean)


def _epipolar_rows(x1n, x2n):
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        torch.ones_like(u1)], dim=-1)


def _to_manifold(F, T1, T2):
    """E = T2^T F T1 projected to equal singular values and a zero third,
    unit norm (batched over leading dimensions)."""
    F = T2.transpose(-1, -2) @ F @ T1
    U, s, Vt = torch.linalg.svd(F)
    sbar = 0.5 * (s[..., 0] + s[..., 1])
    diag = torch.stack([sbar, sbar, torch.zeros_like(sbar)], dim=-1)
    E = (U * diag[..., None, :]) @ Vt
    norm = torch.linalg.matrix_norm(E)[..., None, None]
    return E / (norm + 1e-12)


def essential_8pt(x1, x2, valid):
    """Essential matrix from calibrated correspondences.

    x1, x2: [N, 2] normalized image coordinates (K already removed);
    valid: [N] bool weights. Returns E [3, 3] with the essential-manifold
    projection (equal singular values, third zero)."""
    w = valid.to(x1.dtype)
    x1n, T1 = _normalize_pts(x1, w)
    x2n, T2 = _normalize_pts(x2, w)
    A = _epipolar_rows(x1n, x2n) * w[:, None]
    _, _, vt = torch.linalg.svd(A, full_matrices=False)
    return _to_manifold(vt[-1].reshape(3, 3), T1, T2)


def sampson_sq(E, x1, x2):
    """Squared Sampson distance of correspondences under E (first-order
    geometric error in normalized image coordinates). [N], or [B, N] for
    E [B, 3, 3]."""
    ones = torch.ones_like(x1[:, :1])
    p1 = torch.cat([x1, ones], dim=1)                  # [N, 3]
    p2 = torch.cat([x2, ones], dim=1)
    Ex1 = p1 @ E.transpose(-1, -2)                     # [..., N, 3]
    Etx2 = p2 @ E
    num = torch.sum(p2 * Ex1, dim=-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2
           + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2)
    return num / (den + 1e-18)


def _essential_minimal(xs1, xs2):
    """8-point solve on minimal samples ([..., 8, 2] each, batched over
    leading dimensions), with per-sample Hartley normalization. Returns
    unit-norm E candidates [..., 3, 3]."""

    def norm8(x):
        mean = torch.mean(x, dim=-2)
        d = torch.sqrt(torch.sum((x - mean[..., None, :]) ** 2, dim=-1))
        scale = math.sqrt(2.0) / (torch.mean(d, dim=-1) + 1e-9)
        return (x - mean[..., None, :]) * scale[..., None, None], mean, scale

    x1n, m1, s1 = norm8(xs1)
    x2n, m2, s2 = norm8(xs2)
    A = _epipolar_rows(x1n, x2n)                       # [..., 8, 9]
    # full_matrices: A is 8 x 9, and its null vector is the last row of vt
    _, _, vt = torch.linalg.svd(A, full_matrices=True)
    F = vt[..., -1, :].reshape(*vt.shape[:-2], 3, 3)
    return _to_manifold(F, _hartley(s1, m1), _hartley(s2, m2))


def essential_ransac(x1, x2, valid, iters: int = 64, thresh: float = 2e-3,
                     seed: int = 0, sample_idx=None):
    """Fixed-iteration RANSAC around the 8-point solver: `iters` minimal
    8-point hypotheses, each scored by its Sampson inlier count at
    `thresh` (squared normalized-coordinate distance ~ (px / f)^2), the
    first best kept, and E re-estimated by weighted least squares over its
    consensus set (the hypothesis itself where that set has fewer than 8).

    The minimal sets are drawn from the valid correspondences, with
    replacement, by a CPU torch.Generator seeded with `seed` (the same
    draws on every device). `sample_idx` [iters, 8] replaces the draws: a
    test seam, so that a test can pass the reference's jax.random draws to
    both packages, not a feature.

    Returns (E, inliers [N] bool)."""
    w = valid.to(x1.dtype)
    if sample_idx is None:
        p = (w / (torch.sum(w) + 1e-9)).cpu()
        g = torch.Generator().manual_seed(int(seed))
        sample_idx = torch.multinomial(p.expand(iters, -1), 8,
                                       replacement=True, generator=g)
    idx = torch.as_tensor(sample_idx, dtype=torch.int64, device=x1.device)
    Es = _essential_minimal(x1[idx], x2[idx])             # [iters, 3, 3]
    inl = (sampson_sq(Es, x1, x2) < thresh * thresh) & valid
    best = torch.argmax(torch.sum(inl.to(x1.dtype), dim=1))
    E0 = Es[best]
    inliers = (sampson_sq(E0, x1, x2) < thresh * thresh) & valid
    E = torch.where(torch.sum(inliers) >= 8,
                    essential_8pt(x1, x2, inliers), E0)
    return E, inliers


def triangulate(R, t, x1, x2):
    """DLT triangulation of [N] correspondences for the cameras
    P1 = [I | 0], P2 = [R | t]: one batched SVD over [N, 4, 4].

    The reference's [I | 0] is jnp.eye's default float, float64 under
    jax_enable_x64 (which its CLI and tests set), so its rows from P1, the
    SVD and the points are float64 there; so they are here. The rows from
    P2 are formed in the inputs' dtype, as the reference forms them."""
    f64 = torch.float64
    P1 = torch.cat([torch.eye(3, dtype=f64, device=x1.device),
                    torch.zeros((3, 1), dtype=f64, device=x1.device)], dim=1)
    P2 = torch.cat([R, t[:, None]], dim=1)
    A = torch.stack([
        x1[:, 0:1] * P1[2] - P1[0],
        x1[:, 1:2] * P1[2] - P1[1],
        (x2[:, 0:1] * P2[2] - P2[0]).to(f64),
        (x2[:, 1:2] * P2[2] - P2[1]).to(f64),
    ], dim=1)                                              # [N, 4, 4]
    _, _, vt = torch.linalg.svd(A)
    Xh = vt[:, -1]
    return Xh[:, :3] / Xh[:, 3:4]


def decompose_essential(E, x1, x2, valid):
    """(R, t) from E by cheirality voting over the four candidates
    (positive depth in both views, weighted by `valid`); the first of
    equal votes wins, as in the reference."""
    U, _, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    Wm = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=E.dtype,
                      device=E.device)
    Ra = U @ Wm @ Vt
    Rb = U @ Wm.T @ Vt
    tu = U[:, 2]
    cands = [(Ra, tu), (Ra, -tu), (Rb, tu), (Rb, -tu)]
    w = valid.to(E.dtype)

    def votes(R, t):
        X = triangulate(R, t, x1, x2)
        z1 = X[:, 2]
        z2 = (X @ R.T.to(X.dtype) + t.to(X.dtype))[:, 2]
        return torch.sum(((z1 > 0) & (z2 > 0)).to(E.dtype) * w)

    best = torch.argmax(torch.stack([votes(R, t) for R, t in cands]))
    Rs = torch.stack([c[0] for c in cands])
    ts = torch.stack([c[1] for c in cands])
    return Rs[best], ts[best]
