"""Problem I/O: SBA text formats, BAL conversion, synthetic generation.
Text is parsed by the native C++ reader (io.native) where it is built or
can be built, by numpy otherwise."""

from psba_tpu_torch.io.sba_text import load_problem, read_cams, read_pts
from psba_tpu_torch.io.bal import read_bal, bal_to_problem
from psba_tpu_torch.io.synthetic import synthesize_points_for_cams, synthetic_problem

__all__ = [
    "load_problem",
    "read_cams",
    "read_pts",
    "read_bal",
    "bal_to_problem",
    "synthesize_points_for_cams",
    "synthetic_problem",
]
