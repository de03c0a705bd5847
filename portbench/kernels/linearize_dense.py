"""csrc/linearize_dense.cu with U / ga (the dense LM iteration's
linearization): the grid kernel and the kernel that finishes the sums.

What the inputs need, whatever implements the stage, in float32, each byte
once: in, the camera rows K | q0 | v, t (15 C), the points (3 P), each
observation's measurement and (camera, point) pair (2 + 2 per observed
cell); out, W = A^T B per observed cell (18), V and gb per point (9 + 3), U
and ga per camera (36 + 6). Operations: 498 per observed cell, counted from
csrc/ (the cell model 300; W 54, V 24, gb 12, U 84, ga 24)."""

RECORDS = ("linearize_dense_kernel", "linearize_dense_finish_kernel")
COUNTER = ("psba_tpu_torch.ops.linearize_dense", "linearize_dense",
           "launches")


def work(shape: dict) -> tuple:
    C, P, O = shape["C"], shape["P"], shape["O"]
    nbytes = 4 * (15 * C + 3 * P + 4 * O + 18 * O + 12 * P + 42 * C)
    return nbytes, 498 * O
