"""psba_tpu_torch — the PyTorch / CUDA port of psba_tpu.

Same layout and module names as psba_tpu, on torch tensors with an explicit
device and dtype:

  constants  solver constants and iteration flags
  problem    BAProblem, the host-side problem container (numpy)
  io/        SBA text, BAL and synthetic problem readers (numpy)
  utils/     phase timing and checkpointing
  models/    quaternion and pinhole camera models
  core/      residual, analytic Jacobian and jmultiply, the Schur reduction
             in both encodings (dense3 on the [C, P] grid, and the
             covisibility pairs above the dense cap), SPD solve, the GMW
             modified Cholesky
  ops/       hand-written Hopper kernels (csrc/*.cu, built at first use by
             ops/_build.py), each beside its plain PyTorch version
  solvers/   SolverConfig / ProblemArrays / OptState, the LM and TR loops
             on either encoding, and the hybrid `solve` controller, whose
             schur="auto" picks the encoding
  convert    carry problem and state tensors across from psba_tpu

`solve` runs on the CUDA device unless the caller passes device="cpu". This
package imports neither jax nor any module of psba_tpu.
"""

from psba_tpu_torch.problem import BAProblem

__all__ = ["BAProblem", "solve"]


def __getattr__(name):
    if name == "solve":
        from psba_tpu_torch.solvers.hybrid import solve

        return solve
    raise AttributeError(name)
