"""Synthetic problem generation.

Two uses:
  1. `synthetic_problem` — fully synthetic, well-conditioned problems of any
     size for unit tests and kernel benchmarks.
  2. `synthesize_points_for_cams` — regenerate a plausible points/observation
     set for the bundled BAL camera files whose points files the reference
     does not ship (Trafalgar-50, Dubrovnik-16/88, Rome-93, Venice-52,
     Ladybug-138 — SURVEY.md §2.4), so those configurations can be exercised
     at their published scale. The generated geometry is consistent (points
     project into the real cameras) but is NOT the original BAL data; results
     on these sets measure performance/scaling, not reference-RMSE parity.
"""

from __future__ import annotations

import numpy as np

from psba_tpu_torch.problem import BAProblem


def _quat_rotate_np(q, p):
    w = q[..., 0:1]
    u = q[..., 1:4]
    t = 2.0 * np.cross(u, p)
    return p + w * t + np.cross(u, t)


def _project_np(K, pc):
    fu, u0, v0, ar, sk = (K[..., i] for i in range(5))
    z = pc[..., 2]
    u = (fu * pc[..., 0] + sk * pc[..., 1] + u0 * z) / z
    v = (fu * ar * pc[..., 1] + v0 * z) / z
    return np.stack([u, v], axis=-1)


def synthetic_problem(
    n_cams: int = 6,
    n_pts: int = 200,
    noise_px: float = 0.5,
    point_jitter: float = 0.01,
    seed: int = 0,
    min_obs: int = 2,
    dtype=np.float64,
) -> BAProblem:
    """Ring of cameras looking at a point cloud at the origin.

    Ground-truth geometry is perturbed (points jittered, pixel noise added)
    so the optimizer has a nontrivial basin to descend.
    """
    rng = np.random.default_rng(seed)
    # cameras on a ring of radius R in the xz-plane, looking at origin
    R = 5.0
    ang = np.linspace(0, 0.8 * np.pi, n_cams)
    centers = np.stack(
        [R * np.sin(ang), 0.1 * rng.standard_normal(n_cams), -R * np.cos(ang)],
        axis=1,
    )
    # rotation: camera z-axis points from center toward origin
    zax = -centers / np.linalg.norm(centers, axis=1, keepdims=True)
    up = np.tile(np.array([0.0, 1.0, 0.0]), (n_cams, 1))
    xax = np.cross(up, zax)
    xax /= np.linalg.norm(xax, axis=1, keepdims=True)
    yax = np.cross(zax, xax)
    Rm = np.stack([xax, yax, zax], axis=1)  # world->cam rows
    # quaternion from rotation matrix (w >= 0)
    q0 = np.zeros((n_cams, 4))
    for j in range(n_cams):
        q0[j] = _mat_to_quat(Rm[j])
    t = -np.einsum("cij,cj->ci", Rm, centers)

    fu = 800.0
    K = np.tile(np.array([fu, 320.0, 240.0, 1.0, 0.0]), (n_cams, 1))

    pts_true = rng.standard_normal((n_pts, 3)) * np.array([1.0, 1.0, 1.0])

    pc = _quat_rotate_np(q0[None, :, :], pts_true[:, None, :]) + t[None]
    uv = _project_np(K[None], pc)  # [P, C, 2]
    vis = (
        (pc[..., 2] > 0.5)
        & (np.abs(uv[..., 0] - 320.0) < 400.0)
        & (np.abs(uv[..., 1] - 240.0) < 300.0)
    )
    keep = vis.sum(axis=1) >= min_obs
    pts_true, uv, vis = pts_true[keep], uv[keep], vis[keep]
    P = len(pts_true)
    pt_idx, cam_idx = np.nonzero(vis)
    obs = uv[pt_idx, cam_idx] + noise_px * rng.standard_normal((len(pt_idx), 2))

    pts0 = pts_true + point_jitter * rng.standard_normal((P, 3))
    prob = BAProblem(
        K=K.astype(dtype), q0=q0.astype(dtype),
        cams=np.concatenate([np.zeros_like(t), t], axis=1).astype(dtype),
        pts=pts0.astype(dtype), obs=obs.astype(dtype),
        cam_idx=cam_idx.astype(np.int32), pt_idx=pt_idx.astype(np.int32),
    )
    prob.validate()
    return prob


def _mat_to_quat(R):
    """3x3 rotation matrix -> quaternion (w,x,y,z), w >= 0."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    else:
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(1.0 + R[i, i] - R[j, j] - R[k, k]) * 2
        q = np.empty(4)
        q[0] = (R[k, j] - R[j, k]) / s
        q[1 + i] = 0.25 * s
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
    if q[0] < 0:
        q = -q
    return q / np.linalg.norm(q)


def synthesize_points_for_cams(
    cams_path: str,
    n_pts: int,
    mean_obs: float = 5.0,
    noise_px: float = 1.0,
    point_jitter: float = 5e-4,
    seed: int = 0,
    look_sign: float = -1.0,
    dtype=np.float64,
) -> BAProblem:
    """Generate a consistent points/observations set for an existing camera
    file (BAL-convention cameras look down -z => look_sign=-1).

    Points are created by backprojecting random pixels of random cameras at
    random depths, then kept with the cameras whose reprojection stays within
    a plausible image window. Measurements are ground-truth projections plus
    pixel noise; the optimized initial points are jittered so the solver has
    real work.
    """
    from psba_tpu_torch.io.sba_text import read_cams

    rng = np.random.default_rng(seed)
    K, q0, t, _ = read_cams(cams_path, dtype=dtype)
    C = len(K)
    Rm = _quat_to_mat_batch(q0)
    fu = K[:, 0]
    half_w = np.median(fu) * 0.35  # plausible half image width (BAL: u0=0)
    depth_scale = np.median(np.linalg.norm(t, axis=1)) + 1.0

    pts_list, seen_target = [], max(n_pts, 1)
    batch = max(seen_target, 1024)
    vis_list = []
    while sum(len(p) for p in pts_list) < seen_target:
        j = rng.integers(0, C, size=batch)
        px = rng.uniform(-half_w, half_w, size=(batch, 2))
        depth = rng.uniform(0.2, 2.5, size=batch) * depth_scale
        # backproject: camera frame ray through pixel at given depth
        zc = look_sign * depth
        xc = px[:, 0] / fu[j] * zc
        yc = px[:, 1] / (fu[j] * K[j, 3]) * zc
        pc = np.stack([xc, yc, zc], axis=1)
        # world point: X = R^T (pc - t)
        X = np.einsum("cji,cj->ci", Rm[j], pc - t[j])
        # visibility in all cameras
        pca = np.einsum("cij,pj->pci", Rm, X) + t[None]  # [batch, C, 3]
        z = pca[..., 2]
        front = (look_sign * z) > 0.05 * depth_scale
        uv = np.stack(
            [fu[None] * pca[..., 0] / z, fu[None] * K[None, :, 3] * pca[..., 1] / z],
            axis=-1,
        )
        inwin = np.all(np.abs(uv) < half_w, axis=-1)
        vis = front & inwin
        nview = vis.sum(axis=1)
        keep = nview >= 2
        pts_list.append(X[keep])
        vis_list.append(vis[keep])
    X = np.concatenate(pts_list)[:seen_target]
    vis = np.concatenate(vis_list)[:seen_target]

    # cap views per point to hit the target mean observation count
    cap = max(2, int(round(mean_obs)))
    pt_idx, cam_idx = [], []
    for i in range(len(X)):
        cams_i = np.nonzero(vis[i])[0]
        if len(cams_i) > cap:
            cams_i = np.sort(rng.choice(cams_i, size=cap, replace=False))
        pt_idx.append(np.full(len(cams_i), i, dtype=np.int64))
        cam_idx.append(cams_i)
    pt_idx = np.concatenate(pt_idx).astype(np.int32)
    cam_idx = np.concatenate(cam_idx).astype(np.int32)

    pc = np.einsum("oij,oj->oi", Rm[cam_idx], X[pt_idx]) + t[cam_idx]
    uv = np.stack(
        [
            fu[cam_idx] * pc[:, 0] / pc[:, 2] + K[cam_idx, 1],
            fu[cam_idx] * K[cam_idx, 3] * pc[:, 1] / pc[:, 2] + K[cam_idx, 2],
        ],
        axis=1,
    )
    obs = uv + noise_px * rng.standard_normal(uv.shape)
    # depth-aware initial jitter: scale each point's perturbation by its
    # minimum |depth| across observed cameras, not by its world-coordinate
    # norm — a norm-relative jitter can push a near-plane point across
    # z = 0 (and BAL sets carry cameras with focal lengths up to ~1.6e6
    # that turn any angular error into millions of pixels; dubrovnik88
    # produced 6.6e9 px initial residuals and f32 overflow that way).
    # With depth scaling the initial angular error is bounded by
    # point_jitter for every camera.
    min_depth = np.full(len(X), np.inf)
    np.minimum.at(min_depth, pt_idx, np.abs(pc[:, 2]))
    pts0 = X + (
        point_jitter * min_depth[:, None] * rng.standard_normal(X.shape)
    )

    prob = BAProblem(
        K=K, q0=q0,
        cams=np.concatenate([np.zeros_like(t), t], axis=1),
        pts=pts0.astype(dtype), obs=obs.astype(dtype),
        cam_idx=cam_idx, pt_idx=pt_idx,
    )
    prob.validate()
    return prob


def _quat_to_mat_batch(q):
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack(
        [
            np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)], -1),
            np.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)], -1),
            np.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)], -1),
        ],
        axis=1,
    )
