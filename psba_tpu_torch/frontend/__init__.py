"""SfM front-end (PyTorch counterpart of psba_tpu.frontend): feature
detection and matching, two-view geometry, and the pipelines that chain
them into a BAProblem.

Harris corners and patch descriptors (features.py), mutual
nearest-neighbour matching with a ratio test (matching.py), the normalized
8-point essential matrix with RANSAC, cheirality-checked decomposition and
DLT triangulation (twoview.py), and the two-view and sequence pipelines
(pipeline.py). Torch ops only, no kernel of the package's own; they run on
the CUDA device unless the caller passes device="cpu".
"""

from psba_tpu_torch.frontend.features import detect_and_describe, harris_corners
from psba_tpu_torch.frontend.matching import match_descriptors
from psba_tpu_torch.frontend.pipeline import (
    build_problem_from_tracks,
    two_view_problem,
)
from psba_tpu_torch.frontend.twoview import (
    decompose_essential,
    essential_8pt,
    triangulate,
)

__all__ = [
    "harris_corners",
    "detect_and_describe",
    "match_descriptors",
    "essential_8pt",
    "decompose_essential",
    "triangulate",
    "two_view_problem",
    "build_problem_from_tracks",
]
