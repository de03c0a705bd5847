"""Readers for the SBA "eucsbademo"-style text formats.

Camera file — one line per camera (readparams.cpp:169-232):
    N columns, the trailing 7 are always [q0 q1 q2 q3 tx ty tz];
    the leading N-7 are intrinsics: first 5 = [fu u0 v0 ar s], any further
    (varKD files: 5 radial/tangential coefficients) are parsed then dropped,
    as in the reference driver (PSBA/main.cpp:140-149).
    N == 7 means the file carries no intrinsics; a shared K must be passed.

Points file — one line per 3-D point (readparams.cpp:332-423):
    X Y Z  nframes  (frame u v [cov])*
    cov is an optional per-projection 2x2 covariance, full (4 values) or
    upper-triangular (3 values), auto-detected from the first line
    (readparams.cpp:247-290). It is parsed for parity and stored, but — like
    the reference — never used by the optimizer.

Loading semantics match the reference driver (PSBA/main.cpp:102-149 +
misc.cpp:21-49): the file quaternion is normalized with its scalar part
forced non-negative and saved as the fixed q0; the optimized local rotation
vector starts at zero; translation is taken as-is.
"""

from __future__ import annotations

import numpy as np

from psba_tpu_torch.problem import BAProblem


def _data_lines(path: str):
    with open(path, "r") as f:
        for line in f:
            s = line.strip()
            if not s or s.startswith("#"):
                continue
            yield s


def read_cams(path: str, shared_K=None, dtype=np.float64):
    """Read a camera file.

    Returns (K [C,5], q0 [C,4], t [C,3], dist [C,D] or None).
    """
    rows = [np.fromstring(s, sep=" ") for s in _data_lines(path)]
    if not rows:
        raise ValueError(f"no camera lines in {path}")
    ncols = len(rows[0])
    for i, r in enumerate(rows):
        if len(r) != ncols:
            raise ValueError(
                f"{path}: line {i} has {len(r)} values, expected {ncols}"
            )
    A = np.stack(rows).astype(dtype)
    if ncols < 7:
        raise ValueError(f"{path}: camera lines need >= 7 values, got {ncols}")
    n_intr = ncols - 7
    quat = A[:, n_intr : n_intr + 4]
    t = A[:, n_intr + 4 : n_intr + 7]
    dist = None
    if n_intr == 0:
        if shared_K is None:
            raise ValueError(
                f"{path}: 7-column camera file carries no intrinsics; "
                "pass shared_K=[fu,u0,v0,ar,s]"
            )
        K = np.broadcast_to(
            np.asarray(shared_K, dtype=dtype), (len(A), 5)
        ).copy()
    elif n_intr >= 5:
        K = A[:, :5].copy()
        if n_intr > 5:
            dist = A[:, 5:n_intr].copy()  # parsed then dropped (main.cpp:140-149)
    else:
        raise ValueError(f"{path}: unsupported camera line width {ncols}")

    # normalize + sign-fix (misc.cpp:21-49); q0 = normalized full quaternion
    mag = np.linalg.norm(quat, axis=1, keepdims=True)
    sg = np.where(quat[:, :1] >= 0.0, 1.0, -1.0)
    q0 = quat * (sg / mag)
    return K, q0, t, dist


def read_pts(path: str, n_cams: int, dtype=np.float64):
    """Read a points file.

    Returns (pts [P,3], obs [O,2], cam_idx [O], pt_idx [O], cov or None).
    Observations are emitted in file order: sorted by point, with each
    point's cameras in the order listed. The native C++ parser
    (io.native) reads the file where it is built or can be built;
    otherwise read_pts_numpy, with the same result.
    """
    from psba_tpu_torch.io import native

    if native.available():
        return native.read_pts(path, n_cams, dtype)
    return read_pts_numpy(path, n_cams, dtype)


def read_pts_numpy(path: str, n_cams: int, dtype=np.float64):
    """read_pts' numpy parser."""
    pts, obs, cam_idx, pt_idx, covs = [], [], [], [], []
    have_cov = None  # None until detected: 0 none, 3 tri, 4 full
    for ptno, s in enumerate(_data_lines(path)):
        v = np.fromstring(s, sep=" ")
        pts.append(v[:3])
        nframes = int(v[3])
        rest = v[4:]
        if have_cov is None:
            per = len(rest) / nframes if nframes else 3
            if per == 3 + 4:
                have_cov = 4
            elif per == 3 + 3:
                have_cov = 3
            else:
                have_cov = 0
        stride = 3 + have_cov
        if len(rest) != nframes * stride:
            raise ValueError(
                f"{path}: point {ptno} has {len(rest)} values for "
                f"{nframes} frames (stride {stride})"
            )
        r = rest.reshape(nframes, stride)
        frames = r[:, 0].astype(np.int64)
        if frames.max(initial=-1) >= n_cams:
            raise ValueError(
                f"{path}: point {ptno} references camera "
                f"{int(frames.max())} but only {n_cams} cameras exist"
            )
        cam_idx.append(frames)
        pt_idx.append(np.full(nframes, ptno, dtype=np.int64))
        obs.append(r[:, 1:3])
        if have_cov == 4:
            covs.append(r[:, 3:7].reshape(nframes, 2, 2))
        elif have_cov == 3:
            c = r[:, 3:6]
            full = np.stack(
                [c[:, 0], c[:, 1], c[:, 1], c[:, 2]], axis=1
            ).reshape(nframes, 2, 2)
            covs.append(full)
    P = len(pts)
    if P == 0:
        raise ValueError(f"no point lines in {path}")
    return (
        np.stack(pts).astype(dtype),
        np.concatenate(obs).astype(dtype),
        np.concatenate(cam_idx).astype(np.int32),
        np.concatenate(pt_idx).astype(np.int32),
        np.concatenate(covs).astype(dtype) if covs else None,
    )


def load_problem(
    cams_path: str,
    pts_path: str,
    shared_K=None,
    dtype=np.float64,
    build_pairs: bool = False,
) -> BAProblem:
    """Load a full problem from a (cams, pts) text file pair.

    Mirrors readInitialSBAEstimate + the driver's parameter surgery
    (main.cpp:102-149): local rotation zeroed, K split out and frozen.
    """
    K, q0, t, _dist = read_cams(cams_path, shared_K=shared_K, dtype=dtype)
    pts, obs, cam_idx, pt_idx, cov = read_pts(pts_path, len(K), dtype=dtype)
    cams = np.concatenate([np.zeros_like(t), t], axis=1)  # [v=0 | t]
    prob = BAProblem(
        K=K, q0=q0, cams=cams, pts=pts, obs=obs,
        cam_idx=cam_idx, pt_idx=pt_idx, obs_cov=cov,
    )
    prob.validate()
    return prob.with_pairs() if build_pairs else prob


def write_cams(path: str, K, q0, cams) -> None:
    """Write optimized cameras back in the 12-column varK format.

    The composed final rotation q_local(v) (x) q0 is stored as the file
    quaternion (the reference defines no writer; printers are commented out
    in readparams.h:14-22 — this is new functionality)."""
    import numpy as np

    v = cams[:, :3]
    t = cams[:, 3:]
    s = np.sqrt(np.maximum(1.0 - np.sum(v * v, axis=1), 0.0))
    ql = np.concatenate([s[:, None], v], axis=1)
    w = (
        ql[:, 0] * q0[:, 0]
        - np.sum(ql[:, 1:] * q0[:, 1:], axis=1)
    )
    vec = (
        ql[:, 0:1] * q0[:, 1:]
        + q0[:, 0:1] * ql[:, 1:]
        + np.cross(ql[:, 1:], q0[:, 1:])
    )
    with open(path, "w") as f:
        f.write("# fu, u0, v0, ar, s   quaternion translation\n")
        for j in range(len(K)):
            row = np.concatenate([K[j], [w[j]], vec[j], t[j]])
            f.write(" ".join(f"{x:.9f}" for x in row) + "\n")
