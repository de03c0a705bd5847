"""csrc/linearize_stream.cu's point pass, which runs only in the calls that
ask for W, V / gb or the Jacobians (the pair LM and pair TR iterations, not
the dense TR's U / ga) and which the program counts apart. Out, W (18 per
observation), V and gb per point (9 + 3); its inputs are counted with the
camera pass (linearize_stream.py). Operations: 93 per observation (W 54,
B^T B 27, B^T e 12), counted from csrc/; with the camera pass, the 531 of a
call with the pair path's LM flags."""

RECORDS = ("linearize_stream_points_kernel",)
COUNTER = ("psba_tpu_torch.ops.linearize_stream", "linearize_stream",
           "point_launches")


def work(shape: dict) -> tuple:
    P, O = shape["P"], shape["O"]
    return 4 * (18 * O + 12 * P), 93 * O
