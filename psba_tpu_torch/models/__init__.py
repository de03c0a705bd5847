"""Camera and rotation models."""

from psba_tpu_torch.models.pinhole import project, project_quat
from psba_tpu_torch.models.quaternion import (
    compose_local,
    local_scalar,
    quat_multiply,
    quat_normalize_vec,
    quat_rotate,
    quat_to_matrix,
)

__all__ = [
    "compose_local",
    "local_scalar",
    "quat_multiply",
    "quat_normalize_vec",
    "quat_rotate",
    "quat_to_matrix",
    "project",
    "project_quat",
]
