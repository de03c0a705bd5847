"""csrc/residual_l2.cu with the old residual (the pair path's trial step):
the new residual, its L2 and the gain. In, the camera rows (15 C), the
points (3 P), each observation's measurement, pair and old residual (6 per
observation); out, the new residual (2 per observation) and two sums.
Operations: 99 per observation (the residual 86, its square 4, the factored
gain 9), counted from csrc/."""

RECORDS = ("residual_l2_kernel",)
COUNTER = ("psba_tpu_torch.ops.linearize_stream", "residual_l2", "launches")


def work(shape: dict) -> tuple:
    C, P, O = shape["C"], shape["P"], shape["O"]
    return 4 * (15 * C + 3 * P + 8 * O + 2), 99 * O
