"""BAL ("Bundle Adjustment in the Large") format support.

The reference bundles converted BAL camera files (data/*-cams.txt) but not
the large points files (SURVEY.md §2.4); this module reads raw BAL problem
files and converts them to the framework's representation so those problems
can be regenerated from BAL sources.

Raw BAL layout (grail.cs.washington.edu/projects/bal):
    n_cams n_pts n_obs
    cam_idx pt_idx u v          (n_obs lines)
    9 values per camera          (Rodrigues rotation, translation, f, k1, k2)
    3 values per point

BAL's projection convention is P = R X + t, p = -P_xy / P_z (camera looks
down -z), u = f * r(p) * p. The framework's pinhole model is the positive
form u = f * x / z (compute_exQT.cl:68-69). The conversion keeps (R, t)
and negates the measured observations, which yields identical residual
magnitudes: predicted_pos = f*x/z = -predicted_bal, so
(-u_meas) - predicted_pos = -(u_meas - predicted_bal). Radial distortion
(k1, k2) is dropped, matching the reference driver's treatment of varKD
intrinsics (PSBA/main.cpp:140-149).
"""

from __future__ import annotations

import numpy as np

from psba_tpu_torch.problem import BAProblem


def rodrigues_to_quat(r: np.ndarray) -> np.ndarray:
    """Angle-axis vectors [C,3] -> unit quaternions [C,4] (w,x,y,z)."""
    theta = np.linalg.norm(r, axis=1, keepdims=True)
    half = 0.5 * theta
    small = theta < 1e-12
    # sin(theta/2)/theta, series-expanded near zero
    k = np.where(small, 0.5 - theta**2 / 48.0, np.sin(half) / np.where(small, 1.0, theta))
    return np.concatenate([np.cos(half), r * k], axis=1)


def read_bal(path: str, dtype=np.float64):
    """Parse a raw BAL file.

    Returns (cam_params [C,9], pts [P,3], obs [O,2], cam_idx, pt_idx).
    The native C++ parser (io.native) reads the file where it is built or
    can be built; otherwise read_bal_numpy, with the same result."""
    from psba_tpu_torch.io import native

    if native.available():
        return native.read_bal(path, dtype=dtype)
    return read_bal_numpy(path, dtype=dtype)


def read_bal_numpy(path: str, dtype=np.float64):
    """read_bal's numpy parser."""
    with open(path, "r") as f:
        data = np.fromiter(f.read().split(), dtype=np.float64)
    C, P, O = int(data[0]), int(data[1]), int(data[2])
    hdr = 3
    ob = data[hdr : hdr + 4 * O].reshape(O, 4)
    cam_params = data[hdr + 4 * O : hdr + 4 * O + 9 * C].reshape(C, 9)
    pts = data[hdr + 4 * O + 9 * C : hdr + 4 * O + 9 * C + 3 * P].reshape(P, 3)
    return (
        cam_params.astype(dtype),
        pts.astype(dtype),
        ob[:, 2:4].astype(dtype),
        ob[:, 0].astype(np.int32),
        ob[:, 1].astype(np.int32),
    )


def bal_to_problem(path: str, dtype=np.float64, build_pairs=False) -> BAProblem:
    """Convert a raw BAL file to a BAProblem (distortion dropped,
    observations negated — see module docstring)."""
    cam_params, pts, obs, cam_idx, pt_idx = read_bal(path, dtype=dtype)
    C = len(cam_params)
    q0 = rodrigues_to_quat(cam_params[:, 0:3])
    # sign-fix scalar part like the text reader (misc.cpp:38-43)
    sg = np.where(q0[:, :1] >= 0.0, 1.0, -1.0)
    q0 = q0 * sg
    t = cam_params[:, 3:6]
    f = cam_params[:, 6:7]
    K = np.concatenate(
        [f, np.zeros((C, 2), dtype), np.ones((C, 1), dtype),
         np.zeros((C, 1), dtype)], axis=1,
    )
    # sort observations by point (framework invariant)
    order = np.argsort(pt_idx, kind="stable")
    obs, cam_idx, pt_idx = -obs[order], cam_idx[order], pt_idx[order]

    # drop points with zero observations (renumber densely)
    seen = np.zeros(len(pts), dtype=bool)
    seen[pt_idx] = True
    remap = np.cumsum(seen) - 1
    pts = pts[seen]
    pt_idx = remap[pt_idx].astype(np.int32)

    cams = np.concatenate([np.zeros_like(t), t], axis=1)
    prob = BAProblem(
        K=K.astype(dtype), q0=q0.astype(dtype), cams=cams.astype(dtype),
        pts=pts, obs=obs, cam_idx=cam_idx, pt_idx=pt_idx,
    )
    prob.validate()
    return prob.with_pairs() if build_pairs else prob


def write_sba_text(prob: BAProblem, cams_path: str, pts_path: str) -> None:
    """Export a problem to the reference's (cams, pts) text pair so both
    implementations can consume identical inputs."""
    from psba_tpu_torch.io.sba_text import write_cams

    write_cams(cams_path, prob.K, prob.q0, prob.cams)
    with open(pts_path, "w") as f:
        f.write("# X Y Z  nframes  frame0 x0 y0 ...\n")
        O = prob.n_obs
        starts = np.searchsorted(prob.pt_idx, np.arange(prob.n_pts + 1))
        for i in range(prob.n_pts):
            lo, hi = starts[i], starts[i + 1]
            parts = [f"{v:.9f}" for v in prob.pts[i]] + [str(hi - lo)]
            for o in range(lo, hi):
                parts.append(str(int(prob.cam_idx[o])))
                parts.append(f"{prob.obs[o, 0]:.9f}")
                parts.append(f"{prob.obs[o, 1]:.9f}")
            f.write(" ".join(parts) + "\n")
