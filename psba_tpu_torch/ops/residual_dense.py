"""Dense-grid trial-step gain for the LM acceptance test.

Port of psba_tpu.ops.residual_dense.gain_dense_pallas. The acceptance test
needs two scalars per trial step:

  gain   = sum over observed cells of (eo - en)(eo + en)
  new_l2 = sum over observed cells of en^2

with eo / en the residuals at the old and the new parameters. The factored
form is exact in real numbers and keeps the difference of two nearly equal
sums meaningful in float32 near convergence. No [O, 2] residual is stored.

`gain_dense` launches csrc/gain_dense.cu on CUDA tensors (float32) and runs
`gain_dense_plain` on CPU tensors.
"""

from __future__ import annotations

import ctypes

import torch

from psba_tpu_torch.ops import _build
from psba_tpu_torch.ops.linearize_dense import (
    CAM_CHUNK,
    PTILE,
    camera_rows,
    cell_residual,
)


def gain_dense_plain(K, q0, cams, pts, new_cams, new_pts, obs_du, obs_dv,
                     valid_d, clamp=False):
    """Plain PyTorch version: returns (gain, new_l2) as 0-d tensors."""
    xo = pts.T
    xn = new_pts.T
    eou, eov = cell_residual(camera_rows(K, q0, cams), xo[0:1], xo[1:2],
                             xo[2:3], obs_du, obs_dv, valid_d, clamp)
    enu, env = cell_residual(camera_rows(K, q0, new_cams), xn[0:1],
                             xn[1:2], xn[2:3], obs_du, obs_dv, valid_d,
                             clamp)
    gain = ((eou - enu) * (eou + enu) + (eov - env) * (eov + env)).sum()
    return gain, (enu * enu + env * env).sum()


def _kernel():
    lib = _build.library("gain_dense")
    if (lib.psba_gain_dense_ptile() != PTILE
            or lib.psba_gain_dense_cam_chunk() != CAM_CHUNK):
        raise RuntimeError("gain_dense.cu tile constants differ from "
                           "psba_tpu_torch.ops.linearize_dense")
    fn = lib.psba_gain_dense
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 3 + (
        [ctypes.c_void_p] * 2
    )
    fn.restype = ctypes.c_int
    return fn


def gain_dense(K, q0, cams, pts, new_cams, new_pts, obs_du, obs_dv, valid_d,
               clamp=False):
    """Trial-step (gain, new_l2) on the dense grid, as 0-d tensors.

    CPU tensors run the plain version; CUDA tensors (float32, contiguous)
    launch csrc/gain_dense.cu and count one launch."""
    if valid_d.device.type == "cpu":
        return gain_dense_plain(K, q0, cams, pts, new_cams, new_pts, obs_du,
                                obs_dv, valid_d, clamp=clamp)
    dev = _build.cuda_inputs(
        "gain_dense", K=K, q0=q0, cams=cams, pts=pts, new_cams=new_cams,
        new_pts=new_pts, obs_du=obs_du, obs_dv=obs_dv, valid_d=valid_d,
    )
    C, P = valid_d.shape
    if (K.shape != (C, 5) or q0.shape != (C, 4) or cams.shape != (C, 6)
            or new_cams.shape != (C, 6) or pts.shape != (P, 3)
            or new_pts.shape != (P, 3) or obs_du.shape != (C, P)
            or obs_dv.shape != (C, P)):
        raise ValueError("gain_dense: inconsistent shapes")
    fn = _kernel()
    n_blocks = (-(-P // PTILE)) * (-(-C // CAM_CHUNK))
    kq = torch.cat([K, q0], dim=1).contiguous()
    part = torch.empty((n_blocks, 2), dtype=torch.float32, device=dev)
    err = fn(
        kq.data_ptr(), cams.data_ptr(), pts.data_ptr(), new_cams.data_ptr(),
        new_pts.data_ptr(), obs_du.data_ptr(), obs_dv.data_ptr(),
        valid_d.data_ptr(), C, P, int(bool(clamp)), part.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(err, "gain_dense")
    gain_dense.launches += 1
    s = part.sum(0)
    return s[0], s[1]


gain_dense.launches = 0
