"""Reprojection residuals over the observation stream (PyTorch counterpart
of psba_tpu.core.residual)."""

from __future__ import annotations

import torch

from psba_tpu_torch.models.pinhole import project_quat


def residuals(K, q0, cams, pts, obs, cam_idx, pt_idx,
              clamp: bool = False) -> torch.Tensor:
    """ex_o = x_o - proj(K_j, q_local(v_j) (x) q0_j, t_j, X_i)  -> [O, 2].

    K [C,5], q0 [C,4], cams [C,6] (v|t), pts [P,3], obs [O,2]."""
    v = cams[cam_idx, 0:3]
    t = cams[cam_idx, 3:6]
    pred = project_quat(K[cam_idx], q0[cam_idx], v, t, pts[pt_idx],
                        clamp=clamp)
    return obs - pred


def error_l2(ex: torch.Tensor, valid=None) -> torch.Tensor:
    """Sum of squared residuals; `valid` [O] optionally masks rows."""
    e2 = torch.sum(ex * ex, dim=-1)
    if valid is not None:
        e2 = torch.where(valid, e2, torch.zeros_like(e2))
    return torch.sum(e2)


def error_l2_diff(ex_old, ex_new, valid=None) -> torch.Tensor:
    """sum||ex_old||^2 - sum||ex_new||^2 in the factored form
    sum (e_old - e_new)(e_old + e_new), which keeps the gain meaningful in
    float32 near convergence (identical in exact arithmetic)."""
    s = torch.sum((ex_old - ex_new) * (ex_old + ex_new), dim=-1)
    if valid is not None:
        s = torch.where(valid, s, torch.zeros_like(s))
    return torch.sum(s)


def rms_error(ex_l2, n_obs):
    """The reference's reported metric sqrt(sum ||ex||^2) / n2Dprojs."""
    return torch.sqrt(torch.as_tensor(ex_l2)) / n_obs
