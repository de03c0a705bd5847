"""csrc/cholesky.cu: the reduced camera system S x = b, n = 6 C, solved by
Cholesky in float32. In, S and b (n^2 + n); out, x and the flag (n + 1).
Operations: n^3 / 3 for the factor, 2 n^2 for the two triangular solves."""

RECORDS = ("spd_solve_kernel",)
COUNTER = ("psba_tpu_torch.ops.cholesky", "spd_solve", "launches")


def work(shape: dict) -> tuple:
    n = 6 * shape["C"]
    return 4 * (n * n + 2 * n + 1), n ** 3 / 3.0 + 2.0 * n * n
