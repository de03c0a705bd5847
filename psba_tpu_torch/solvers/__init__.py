"""Solver types, the LM and TR loops and the `solve` controller."""

from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    resolve_damping,
    use_kernels,
)

__all__ = ["OptState", "ProblemArrays", "SolverConfig", "resolve_damping",
           "use_kernels"]
