"""csrc/linearize_stream.cu's camera pass over the observation stream, which
every call runs (the point pass, which only some calls run, is counted in
linearize_stream_points.py). In, the camera rows (15 C), the points (3 P),
each observation's measurement and pair (4 per observation); out, the
residual (2 per observation), U and ga per camera (36 + 6), the L2.
Operations: 438 per observation (the cell model 300, the TR part 132, the
mask 6), counted from csrc/."""

RECORDS = ("linearize_stream_kernel",)
COUNTER = ("psba_tpu_torch.ops.linearize_stream", "linearize_stream",
           "launches")


def work(shape: dict) -> tuple:
    C, P, O = shape["C"], shape["P"], shape["O"]
    return 4 * (15 * C + 3 * P + 4 * O + 2 * O + 42 * C + 1), 438 * O
