"""csrc/gain_dense.cu: the trial step's gain and new L2 on the dense grid.
In, the camera rows (9 C of K | q0, 6 C old and 6 C new), the old and new
points (3 P each), each observation's measurement and pair (4 per observed
cell); out, the two sums. Operations: 180 per observed cell (two residuals,
86 each, and the factored gain, 8), counted from csrc/."""

RECORDS = ("gain_dense_kernel",)
COUNTER = ("psba_tpu_torch.ops.residual_dense", "gain_dense", "launches")


def work(shape: dict) -> tuple:
    C, P, O = shape["C"], shape["P"], shape["O"]
    return 4 * (21 * C + 6 * P + 4 * O + 2), 180 * O
