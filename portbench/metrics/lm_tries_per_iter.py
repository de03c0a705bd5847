"""LM loop: damping tries per LM iteration in the traced window. Every try
launches one trial-gain kernel (gain_dense on the dense grid, residual_l2
on the pairs), every iteration one iteration's worth of them, so the
program's launch counters give the tries."""


def read(rec: dict):
    if not rec["iters"]:
        return None
    tries = rec["counters"].get("gain_dense", 0) + rec["counters"].get(
        "residual_l2", 0)
    return tries / rec["iters"] if tries else None
