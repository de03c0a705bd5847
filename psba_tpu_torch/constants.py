"""Solver constants and iteration flags.

Mirrors the reference's compile-time configuration (PSBA/psba.h:3-18) as
runtime constants; the new framework exposes them through SolverConfig
(psba_tpu_torch.solvers.types) instead of #defines.
"""

# Levenberg-Marquardt constants (PSBA/psba.h:6-10)
PSBA_INIT_MU = 1e-3          # tau: initial damping = tau * max(diag(U,V))
PSBA_STOP_THRESH = 1e-12     # ||dp|| and error stop threshold
PSBA_EPSILON = 1e-12
PSBA_EPSILON2 = 1e-12        # TR relative-error stop threshold
PSBA_EPSILON_SQ = PSBA_EPSILON * PSBA_EPSILON

# Trust-region constants (PSBA/trust_region.cpp:18,91-92)
TR_MAX_DELTA = 10000.0       # radius cap
TR_INIT_DELTA = 1.0

# Shared LM+TR iteration cap (PSBA/levmar.cpp:100, trust_region.cpp:112)
MAX_TOTAL_ITERS = 50

# Iteration result flags (PSBA/psba.h:12-18)
ITER_TURN_TO_LM = 1
ITER_TURN_TO_TR = 2
ITER_CONTINUE = 3
ITER_ERR = 4
ITER_DP_NO_CHANGE = 5
ITER_ERR_SMALL_ENOUGH = 6
ITER_PASS = 7

FLAG_NAMES = {
    ITER_TURN_TO_LM: "TURN_TO_LM",
    ITER_TURN_TO_TR: "TURN_TO_TR",
    ITER_CONTINUE: "CONTINUE",
    ITER_ERR: "ERR",
    ITER_DP_NO_CHANGE: "DP_NO_CHANGE",
    ITER_ERR_SMALL_ENOUGH: "ERR_SMALL_ENOUGH",
    ITER_PASS: "PASS",
}

# Dense-Schur dispatch threshold: the blk_idx-gather formulation (see
# psba_tpu.core.schur.schur_S_dense) materializes two [6C, 3P] stacked
# block tensors (144 bytes per (cam, point) cell in f32); above this many
# C*P cells the covisibility pair list path is used instead. Measured
# (SCHUR_COMPARE.json, TPU v5e): dense beats the pair-list encoding by
# 10-15x on every BAL shape up to Rome-93 (C*P = 5.7M, 15.3 vs 112
# ms/LM-iter), so the threshold is set by MEMORY, not speed: 32M cells
# keeps ZW+ZY under ~9.2 GB of the chip's 16 GB HBM. Pairs remains the
# correct encoding only beyond that.
DENSE_SCHUR_MAX_ENTRIES = 32 * 1024 * 1024

# Parameter-block dimensions (PSBA/CL_files/PSBA.cl:5-7; fixed by the camera
# model: 3 local-rotation + 3 translation per camera, 3 per point, 2 per
# observation).
CNP = 6   # camera parameters: quaternion vector part (3) + translation (3)
PNP = 3   # 3-D point parameters
MNP = 2   # 2-D measurement dimension
K_DIM = 5  # pinhole intrinsics [fu, u0, v0, ar, s] (PSBA/psba.h:3)
