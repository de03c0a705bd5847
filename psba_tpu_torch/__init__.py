"""psba_tpu_torch — the PyTorch / CUDA port of psba_tpu.

Same layout and module names as psba_tpu, on torch tensors with an explicit
device and dtype:

  models/    quaternion and pinhole camera models
  core/      residual, analytic Jacobian, dense3 Schur reduction, SPD solve
  ops/       hand-written Hopper kernels (csrc/*.cu, built at first use by
             ops/_build.py), each beside its plain PyTorch version
  solvers/   SolverConfig / ProblemArrays / OptState, the dense3 LM loop and
             the `solve` controller
  convert    carry problem and state tensors across from psba_tpu

The problem container and readers are psba_tpu's jax-free host layer
(psba_tpu.problem, psba_tpu.io); this package never imports jax.
"""

from psba_tpu.problem import BAProblem

__all__ = ["BAProblem", "solve"]


def __getattr__(name):
    if name == "solve":
        from psba_tpu_torch.solvers.hybrid import solve

        return solve
    raise AttributeError(name)
