"""Ring scenes at BAL's published camera and point counts.

A frozen copy of the port's synthetic generator: the camera ring of
`psba_tpu_torch/io/synthetic.py::synthetic_problem` and the points of
`synthesize_points_for_cams` (look_sign +1), as `chip_smoke.py::ring_problem`
combines them. It is copied so that later changes to the port's `io/` leave
the benchmark's inputs as they are, and rewritten in torch so that it runs
on the card in a few large calls from one `torch.Generator` seeded with the
run's seed. The draws differ from the original's numpy stream. The geometry
and the visibility test are the same; the views a point keeps follow a
track-length distribution instead of the original's cap of round(mean)
views, so that the observations are BAL's count:

  - C cameras on an arc of a ring of radius 5 in the xz-plane (0 to 0.8 pi),
    each lifted by 0.1 x N(0, 1) in y and looking at the origin; K = [800,
    320, 240, 1, 0]; the optimized rotation starts at zero;
  - each point is the back-projection of a uniform pixel within +-0.35 fu
    of a random camera, at a depth uniform in [0.2, 2.5] x (median |t| + 1);
    it is visible in a camera where it lies in front (z > 0.05 x that depth
    scale) and within +-0.35 fu of the centre; points seen by fewer than two
    cameras are drawn again;
  - the views a point keeps (`views_per_point`): the P quantiles of 2 + a
    geometric count whose mean is n_obs / P - 2, the same multiset for every
    seed, dealt to the points in an order drawn from the seed; each at most
    the point's visible views; then single views added to (or taken from)
    points drawn at random until there are n_obs observations in all. The
    views themselves are drawn at random among the visible;
  - observations are the true projections plus 1 px of Gaussian noise; the
    starting points are the true ones moved by 5e-4 x their smallest depth.

Every value handed out is a float64 that float32 holds exactly, so a
float32 program and a float64 reference start from the same numbers.
"""

from __future__ import annotations

import math

import numpy as np
import torch

F64 = torch.float64


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> unit quaternion (w, x, y, z), w >= 0."""
    tr = np.trace(R)
    if tr > 0:
        s = np.sqrt(tr + 1.0) * 2
        q = np.array([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                      (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
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


def _f32_exact(a: torch.Tensor) -> np.ndarray:
    """float64 numpy values that float32 holds exactly."""
    return a.to(torch.float32).to(F64).cpu().numpy()


def views_per_point(visible: torch.Tensor, n_obs: int, g) -> torch.Tensor:
    """How many of its `visible` views each point keeps (int64 [P]): the
    quantiles of 2 + Geometric(p) with mean n_obs / P, in an order drawn
    from `g`, at most `visible`, then moved one view at a time on points
    drawn from `g` until they sum to n_obs."""
    dev = visible.device
    P = len(visible)
    if int(visible.sum()) < n_obs or 2 * P > n_obs:
        raise ValueError(f"{P} points cannot hold {n_obs} observations")
    p = 1.0 / (n_obs / P - 1.0)
    q = (torch.arange(P, dtype=F64, device=dev) + 0.5) / P
    k = 2 + torch.floor(torch.log1p(-q) / math.log1p(-p)).to(torch.int64)
    k = k[torch.randperm(P, generator=g, device=dev)]
    k = torch.minimum(k, visible)
    while True:
        d = n_obs - int(k.sum())
        if d == 0:
            return k
        room = k < visible if d > 0 else k > 2
        keys = torch.rand(P, generator=g, device=dev)
        keys = torch.where(room, keys, torch.full_like(keys, 2.0))
        n = min(abs(d), int(room.sum()))
        k[torch.topk(keys, n, largest=False).indices] += 1 if d > 0 else -1


def ring_problem(n_cams: int, n_pts: int, n_obs: int, seed: int,
                 device, a: dict) -> dict:
    """The scene's arrays (numpy, on the host), drawn from `seed` on
    `device`, with n_obs observations. `a` is the configuration's `assumed`
    block (ring, K, noise, jitter, depths, image half width, chunk of points
    per call).

    Returns dict(K [C,5], q0 [C,4], cams [C,6], pts [P,3], obs [O,2],
    cam_idx [O] int32, pt_idx [O] int32), observations sorted by point and,
    within a point, by camera."""
    dev = torch.device(device)
    g = torch.Generator(device=dev)
    g.manual_seed(int(seed))
    C = int(n_cams)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=dev, dtype=F64)

    def uniform(lo, hi, *shape):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev,
                                           dtype=F64)

    # the camera ring, world -> camera rotations Rm and translations t
    ang = torch.linspace(0.0, a["ring_arc_pi"] * math.pi, C, dtype=F64,
                         device=dev)
    R = a["ring_radius"]
    centers = torch.stack([R * torch.sin(ang), a["ring_y_jitter"] * normal(C),
                           -R * torch.cos(ang)], dim=1)
    zax = -centers / torch.linalg.norm(centers, dim=1, keepdim=True)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=F64, device=dev).expand(C, 3)
    xax = torch.linalg.cross(up, zax, dim=1)
    xax = xax / torch.linalg.norm(xax, dim=1, keepdim=True)
    yax = torch.linalg.cross(zax, xax, dim=1)
    Rm = torch.stack([xax, yax, zax], dim=1)
    q0 = torch.as_tensor(np.stack([_mat_to_quat(r) for r in
                                   Rm.cpu().numpy()]), device=dev)
    # the program reads the rotation from q0: derive Rm from it again
    Rm = _quat_to_mat(q0)
    t = -torch.einsum("cij,cj->ci", Rm, centers)
    K = torch.tensor(a["K"], dtype=F64, device=dev).expand(C, 5).contiguous()
    fu, ar = K[:, 0], K[:, 3]
    half_w = float(fu.median()) * a["half_width_of_fu"]
    depth_scale = float(torch.linalg.norm(t, dim=1).median()) + 1.0
    look = a["look_sign"]
    chunk = int(a["points_per_call"])

    def camera_frame(X):                       # [n, 3] -> [n, C, 3]
        return torch.einsum("cij,nj->nci", Rm, X) + t[None]

    pts, seen = [], []
    have = 0
    while have < n_pts:
        B = chunk
        j = torch.randint(0, C, (B,), generator=g, device=dev)
        px = uniform(-half_w, half_w, B, 2)
        zc = look * uniform(a["depth_range"][0], a["depth_range"][1], B) \
            * depth_scale
        pc = torch.stack([px[:, 0] / fu[j] * zc,
                          px[:, 1] / (fu[j] * ar[j]) * zc, zc], dim=1)
        X = torch.einsum("nji,nj->ni", Rm[j], pc - t[j])
        P3 = camera_frame(X)
        z = P3[..., 2]
        vis = (look * z) > 0.05 * depth_scale
        vis &= torch.abs(fu[None] * P3[..., 0] / z) < half_w
        vis &= torch.abs(fu[None] * ar[None] * P3[..., 1] / z) < half_w
        keep = vis.sum(dim=1) >= 2
        pts.append(X[keep])
        seen.append(vis[keep])
        have += int(keep.sum())
    X = torch.cat(pts)[:n_pts]
    vis = torch.cat(seen)[:n_pts]
    del pts, seen
    views = views_per_point(vis.sum(dim=1), int(n_obs), g)
    # each point's views: the first views[i] of its visible cameras in an
    # order drawn at random
    pt_idx, cam_idx = [], []
    for b0 in range(0, n_pts, chunk):
        v, kb = vis[b0:b0 + chunk], views[b0:b0 + chunk]
        keys = torch.rand(v.shape, generator=g, device=dev)
        keys = torch.where(v, keys, torch.full_like(keys, 2.0))
        ki = torch.topk(keys, int(kb.max()), dim=1, largest=False).indices
        ki = torch.where(torch.arange(ki.shape[1], device=dev)[None]
                         < kb[:, None], ki, torch.full_like(ki, C))
        ki = torch.sort(ki, dim=1).values
        used = torch.nonzero(ki < C)           # by point, then by camera
        pt_idx.append(used[:, 0] + b0)
        cam_idx.append(ki[used[:, 0], used[:, 1]])
    del vis
    pt_idx, cam_idx = torch.cat(pt_idx), torch.cat(cam_idx)

    pc = torch.einsum("oij,oj->oi", Rm[cam_idx], X[pt_idx]) + t[cam_idx]
    uv = torch.stack([fu[cam_idx] * pc[:, 0] / pc[:, 2] + K[cam_idx, 1],
                      fu[cam_idx] * ar[cam_idx] * pc[:, 1] / pc[:, 2]
                      + K[cam_idx, 2]], dim=1)
    obs = uv + a["noise_px"] * normal(*uv.shape)
    min_depth = torch.full((n_pts,), math.inf, dtype=F64, device=dev)
    min_depth = min_depth.scatter_reduce(0, pt_idx, torch.abs(pc[:, 2]),
                                         reduce="amin")
    pts0 = X + a["point_jitter"] * min_depth[:, None] * normal(n_pts, 3)
    cams = torch.cat([torch.zeros_like(t), t], dim=1)
    return dict(
        K=_f32_exact(K), q0=_f32_exact(q0), cams=_f32_exact(cams),
        pts=_f32_exact(pts0), obs=_f32_exact(obs),
        cam_idx=cam_idx.to(torch.int32).cpu().numpy(),
        pt_idx=pt_idx.to(torch.int32).cpu().numpy(),
    )


def _quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))
