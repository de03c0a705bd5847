"""psba_tpu_torch — the PyTorch / CUDA port of psba_tpu.

Same layout and module names as psba_tpu, on torch tensors with an explicit
device and dtype:

  constants  solver constants and iteration flags
  problem    BAProblem, the host-side problem container (numpy)
  io/        SBA text, BAL and synthetic problem readers: the native C++
             parser (native/loader.cpp, built at first use by io/native.py)
             or numpy
  datasets   the registry of the reference project's datasets
  cli        `python -m psba_tpu_torch.cli`, float64 by default
  utils/     phase timing, checkpointing, NaN checks and block dumps, the
             device resolver (device.py) and the roofline model of the
             dense LM iteration on the H100 (roofline.py)
  models/    quaternion and pinhole camera models
  core/      residual, analytic Jacobian and jmultiply, the XLA-form block
             assembly, the Schur reduction in both encodings (dense3 on the
             [C, P] grid, the dense XLA form, and the covisibility pairs
             above the dense cap), SPD solve, the GMW modified Cholesky
  ops/       hand-written Hopper kernels (csrc/*.cu, built at first use by
             ops/_build.py), each beside its plain PyTorch version
  solvers/   SolverConfig / ProblemArrays / OptState, the LM and TR loops
             on either encoding and either path (the kernels in float32,
             the XLA form in float64; s_precision="high" accepted and
             run in full float32), and the hybrid `solve` controller with
             the float64 polish
  parallel/  the sharded solve and the sharded repeats runner over a
             torch.distributed group
  frontend/  Harris corners, descriptor matching, two-view geometry and the
             pipelines that turn images into a BAProblem
  convert    carry problem and state tensors across from psba_tpu

`solve`, the sharded solve, the front-end, the CLI and the direct entry
(solvers.types.ProblemArrays.from_problem, convert) run on the CUDA
device unless the caller asks for the CPU. This package imports neither
jax nor any module of psba_tpu.
"""

from psba_tpu_torch.problem import BAProblem

__all__ = ["BAProblem", "solve"]


def __getattr__(name):
    if name == "solve":
        from psba_tpu_torch.solvers.hybrid import solve

        return solve
    raise AttributeError(name)
