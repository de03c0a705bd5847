"""Solver types, the dense3 LM loop and the `solve` controller."""

from psba_tpu_torch.solvers.types import (
    OptState,
    ProblemArrays,
    SolverConfig,
    resolve_damping,
)

__all__ = ["OptState", "ProblemArrays", "SolverConfig", "resolve_damping"]
