"""Front-end pipeline (PyTorch counterpart of psba_tpu.frontend.pipeline):
images or correspondences -> BAProblem.

`two_view_problem` runs the whole chain (detect -> describe -> match ->
essential -> pose -> triangulate) on an image pair and emits a BAProblem
for the solver. `sequence_problem` chains pairwise essential-matrix poses
over an image sequence into a scaled pose graph, links matches into
multi-view feature tracks, triangulates them and emits the multi-view
BAProblem. `build_problem_from_tracks` assembles a BAProblem from tracked
correspondences (the low-level entry point both use).

Numpy sits around the torch stages. The stages run on `device`: CUDA
unless the caller names another (an error where torch sees no card). The
problem is float64 on the host; `solve` takes it in float64 (the XLA
form) unless given dtype=torch.float32, which runs the kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from psba_tpu_torch.frontend.features import as_tensor, detect_and_describe
from psba_tpu_torch.frontend.matching import match_descriptors
from psba_tpu_torch.frontend.twoview import (
    decompose_essential,
    essential_8pt,
    essential_ransac,
    triangulate,
)
from psba_tpu_torch.io.synthetic import _mat_to_quat
from psba_tpu_torch.problem import BAProblem
from psba_tpu_torch.utils.device import resolve_device


def _estimate_E(x1n, x2n, valid, ransac_iters, fu, seed=0):
    """Essential-matrix estimation: fixed-iteration RANSAC over the
    8-point solver when ransac_iters > 0 (robust to mismatches that
    survive the ratio and mutual tests), plain weighted least squares
    otherwise. The Sampson threshold is 2 px in normalized coordinates.
    Returns (E, consensus_valid)."""
    if not ransac_iters:
        return essential_8pt(x1n, x2n, valid), valid
    E, inl = essential_ransac(x1n, x2n, valid, iters=int(ransac_iters),
                              thresh=2.0 / fu, seed=seed)
    # a degenerate consensus (far fewer than 8 inliers) falls back to the
    # whole match set so that the later stages still see correspondences
    return E, torch.where(torch.sum(inl) >= 8, inl, valid)


def _device(img, device) -> torch.device:
    """The stages' device: `device`, else a tensor image's own, else
    CUDA (resolve_device)."""
    if device is None and isinstance(img, torch.Tensor):
        return img.device
    return resolve_device(device, "psba_tpu_torch.frontend", "it")


def _normalizer(K):
    fu, u0, v0, ar, sk = [float(v) for v in K]

    def norm(p):
        x = (p[:, 0] - u0 - sk * ((p[:, 1] - v0) / (fu * ar))) / fu
        y = (p[:, 1] - v0) / (fu * ar)
        return torch.stack([x, y], dim=1)

    return norm


def two_view_problem(img1, img2, K, n_features: int = 256,
                     ransac_iters: int = 64, device=None) -> BAProblem:
    """Detect, match, estimate and triangulate an image pair into a
    BAProblem.

    K: [fu, u0, v0, ar, s] shared intrinsics. Camera 1 is gauge-fixed at
    identity; camera 2 takes the essential-matrix pose (unit-norm
    translation; BA refines up to the usual gauge freedom).
    `ransac_iters` > 0 runs fixed-iteration RANSAC around the 8-point
    solve (essential_ransac, seed 0); 0 = plain weighted least squares."""
    dev = _device(img1, device)
    xy1, s1, d1 = detect_and_describe(as_tensor(img1, dev), k=n_features)
    xy2, s2, d2 = detect_and_describe(as_tensor(img2, dev), k=n_features)
    idx2, valid = match_descriptors(d1, d2, s1, s2)
    m1 = xy1
    m2 = xy2[idx2.long()]

    fu = float(K[0])
    norm = _normalizer(K)
    x1n, x2n = norm(m1), norm(m2)
    E, valid = _estimate_E(x1n, x2n, valid, ransac_iters, fu)
    R, t = decompose_essential(E, x1n, x2n, valid)
    X = triangulate(R, t, x1n, x2n)
    z1 = X[:, 2]
    z2 = (X @ R.T.to(X.dtype) + t.to(X.dtype))[:, 2]
    keep = (valid & (z1 > 1e-3) & (z2 > 1e-3)).cpu().numpy()

    X = X.cpu().numpy()[keep]
    m1k, m2k = m1.cpu().numpy()[keep], m2.cpu().numpy()[keep]
    P = len(X)

    Rm = np.stack([np.eye(3), R.cpu().numpy()])
    tm = np.stack([np.zeros(3), t.cpu().numpy()])
    q0 = np.stack([_mat_to_quat(Rm[0]), _mat_to_quat(Rm[1])])
    Kc = np.tile(np.asarray(K, np.float64), (2, 1))

    obs = np.empty((2 * P, 2))
    obs[0::2] = m1k
    obs[1::2] = m2k
    pt_idx = np.repeat(np.arange(P, dtype=np.int32), 2)
    cam_idx = np.tile(np.array([0, 1], np.int32), P)
    prob = BAProblem(
        K=Kc, q0=q0.astype(np.float64),
        cams=np.concatenate([np.zeros((2, 3)), tm], axis=1),
        pts=X.astype(np.float64), obs=obs,
        cam_idx=cam_idx, pt_idx=pt_idx,
    )
    prob.validate()
    return prob


def sequence_problem(images, K, n_features: int = 256,
                     min_track_len: int = 2,
                     max_reproj_px: float = 4.0,
                     ransac_iters: int = 64, device=None) -> BAProblem:
    """Chain an image sequence (>= 2 views) into a multi-view BAProblem.

    Per consecutive pair: detect, match, estimate E (RANSAC seed = the
    pair's index), decompose; compose the relative rotations along the
    chain; resolve each pairwise translation's unknown scale from the
    triangulated depths of features shared with the previous pair (the
    median depth ratio); link the pairwise matches into feature tracks
    (mutual nearest-neighbour matches are injective, so chaining is
    unambiguous); triangulate every track from its first and last view
    with the chained global poses (one batched triangulation for each
    pair of first and last views); emit via `build_problem_from_tracks`.

    Camera 0 is gauge-fixed at identity; pair 0's unit-norm translation
    sets the global scale. `K` is the shared [fu, u0, v0, ar, s]. Tracks
    whose initial reprojection error exceeds `max_reproj_px` in any view
    (mismatches that slipped through the ratio and mutual tests) are
    dropped before the problem is emitted."""
    n = len(images)
    if n < 2:
        raise ValueError("sequence_problem needs at least 2 images")
    dev = _device(images[0], device)
    fu, u0, v0, ar, sk = [float(v) for v in K]
    norm = _normalizer(K)

    feats = [detect_and_describe(as_tensor(img, dev), k=n_features)
             for img in images]
    xy = [f[0].cpu().numpy() for f in feats]
    xyn = [norm(f[0]) for f in feats]

    # --- pairwise relative geometry
    pairs = []
    for i in range(n - 1):
        _, s1, d1 = feats[i]
        _, s2, d2 = feats[i + 1]
        idx2, valid = match_descriptors(d1, d2, s1, s2)
        x1n = xyn[i]
        x2n = xyn[i + 1][idx2.long()]
        E, valid = _estimate_E(x1n, x2n, valid, ransac_iters, fu, seed=i)
        R, t = decompose_essential(E, x1n, x2n, valid)
        X = triangulate(R, t, x1n, x2n)         # cam-i frame, unit ||t||
        z1 = X[:, 2].cpu().numpy()
        z2 = (X @ R.T.to(X.dtype) + t.to(X.dtype))[:, 2].cpu().numpy()
        keep = valid.cpu().numpy() & (z1 > 1e-3) & (z2 > 1e-3)
        pairs.append(dict(
            idx2=idx2.cpu().numpy(), keep=keep, R=R.cpu().numpy(),
            t=t.cpu().numpy(), depth1=z1,
        ))

    def tri(R_ab, t_ab, a, b):
        return triangulate(torch.as_tensor(R_ab, device=dev),
                           torch.as_tensor(t_ab, device=dev), a, b)

    # --- chain global poses with depth-ratio scale resolution
    Rg = [np.eye(3)]
    tg = [np.zeros(3)]
    for i, pr in enumerate(pairs):
        if i == 0:
            s = 1.0
        else:
            prev = pairs[i - 1]
            # global-scale depth (in cam i) of features shared with the
            # previous pair: re-triangulate pair i-1 under the chained
            # global poses of cams (i-1, i)
            R_ab = Rg[i] @ Rg[i - 1].T
            t_ab = tg[i] - R_ab @ tg[i - 1]
            Xp = tri(R_ab, t_ab, xyn[i - 1],
                     xyn[i][torch.as_tensor(prev["idx2"], device=dev).long()])
            depth_i = (Xp.cpu().numpy() @ R_ab.T + t_ab)[:, 2]
            global_depth = {
                int(prev["idx2"][a]): depth_i[a]
                for a in np.flatnonzero(prev["keep"])
            }
            ratios = [
                global_depth[a] / pr["depth1"][a]
                for a in np.flatnonzero(pr["keep"])
                if a in global_depth
                and pr["depth1"][a] > 1e-6 and global_depth[a] > 1e-6
            ]
            s = float(np.median(ratios)) if ratios else 1.0
        Rg.append(pr["R"] @ Rg[i])
        tg.append(pr["R"] @ tg[i] + s * pr["t"])

    # --- link matches into tracks (valid mutual-NN matches are injective)
    track_of = [dict() for _ in range(n)]   # feature idx -> track id
    track_views = []                        # track id -> [(cam, feat)]
    for i, pr in enumerate(pairs):
        for a in np.flatnonzero(pr["keep"]):
            b = int(pr["idx2"][a])
            tid = track_of[i].get(int(a))
            if tid is None:
                tid = len(track_views)
                track_views.append([(i, int(a))])
                track_of[i][int(a)] = tid
            if b not in track_of[i + 1]:
                track_of[i + 1][b] = tid
                track_views[tid].append((i + 1, b))

    # --- triangulate tracks in the global frame (first vs last view): one
    # batched triangulation per (first, last) camera pair
    cand = [v for v in track_views if len(v) >= max(2, min_track_len)]
    Xa_of = [None] * len(cand)
    by_pair = {}
    for k, views in enumerate(cand):
        by_pair.setdefault((views[0][0], views[-1][0]), []).append(k)
    for (ca, cb), ks in by_pair.items():
        R_ab = Rg[cb] @ Rg[ca].T
        t_ab = tg[cb] - R_ab @ tg[ca]
        fa = torch.as_tensor([cand[k][0][1] for k in ks], device=dev)
        fb = torch.as_tensor([cand[k][-1][1] for k in ks], device=dev)
        X = tri(R_ab, t_ab, xyn[ca][fa], xyn[cb][fb]).cpu().numpy()
        for k, Xa in zip(ks, X):
            Xa_of[k] = Xa
    tracks = []
    for views, Xa in zip(cand, Xa_of):
        (ca, _fa), (cb, _fb) = views[0], views[-1]
        R_ab = Rg[cb] @ Rg[ca].T
        t_ab = tg[cb] - R_ab @ tg[ca]
        if Xa[2] <= 1e-3 or (R_ab @ Xa + t_ab)[2] <= 1e-3:
            continue
        Xw = Rg[ca].T @ (Xa - tg[ca])
        # outlier gate: the chained initialization must reproject every
        # view of the track within max_reproj_px
        ok = True
        for (c, f) in views:
            Xc = Rg[c] @ Xw + tg[c]
            if Xc[2] <= 1e-3:
                ok = False
                break
            u = (fu * Xc[0] + sk * Xc[1] + u0 * Xc[2]) / Xc[2]
            v = (fu * ar * Xc[1] + v0 * Xc[2]) / Xc[2]
            if np.hypot(u - xy[c][f][0], v - xy[c][f][1]) > max_reproj_px:
                ok = False
                break
        if not ok:
            continue
        tracks.append((Xw, [(c, *xy[c][f]) for (c, f) in views]))

    q0 = np.stack([_mat_to_quat(R) for R in Rg])
    Kc = np.tile(np.asarray(K, np.float64), (n, 1))
    return build_problem_from_tracks(Kc, q0, np.stack(tg), tracks)


def build_problem_from_tracks(K, q0, t, tracks) -> BAProblem:
    """Assemble a BAProblem from feature tracks.

    tracks: list of (X0 [3] initial point, [(cam, u, v), ...]), e.g. the
    output of chaining pairwise front-end estimates into a pose graph.
    Cameras come in as (q0 [C, 4] quaternions, t [C, 3]); the local
    rotation starts at zero as in the text-file path."""
    pts, obs, cam_idx, pt_idx = [], [], [], []
    for X0, views in tracks:
        if len(views) < 2:
            continue
        pi = len(pts)
        pts.append(np.asarray(X0, np.float64))
        for (c, u, v) in views:
            obs.append((u, v))
            cam_idx.append(c)
            pt_idx.append(pi)
    C = len(q0)
    prob = BAProblem(
        K=np.asarray(K, np.float64).reshape(C, 5),
        q0=np.asarray(q0, np.float64),
        cams=np.concatenate(
            [np.zeros((C, 3)), np.asarray(t, np.float64)], axis=1
        ),
        pts=np.stack(pts),
        obs=np.asarray(obs, np.float64),
        cam_idx=np.asarray(cam_idx, np.int32),
        pt_idx=np.asarray(pt_idx, np.int32),
    )
    prob.validate()
    return prob
