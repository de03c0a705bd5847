"""csrc/linearize_stream.cu with the pair path's LM flags: the camera pass
and the point pass over the observation stream. In, the camera rows (15
C), the points (3 P), each observation's measurement and pair (4 per
observation); out, the residual (2) and W (18) per observation, U and ga
per camera (36 + 6), V and gb per point (9 + 3), the L2. Operations: 531
per observation (the cell model 300, the TR part 132, W 54, B^T B 27, B^T e
12, the mask 6), counted from csrc/."""

RECORDS = ("linearize_stream_kernel", "linearize_stream_points_kernel")
COUNTER = ("psba_tpu_torch.ops.linearize_stream", "linearize_stream",
           "launches")


def work(shape: dict) -> tuple:
    C, P, O = shape["C"], shape["P"], shape["O"]
    nbytes = 4 * (15 * C + 3 * P + 4 * O + 20 * O + 42 * C + 12 * P + 1)
    return nbytes, 531 * O
