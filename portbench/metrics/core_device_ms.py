"""Schur and linear algebra: device milliseconds per LM iteration in work
not launched from csrc/ (cuBLAS products, torch element-wise ops, bmm,
sort, index_put_, cholesky_ex, copies and fills), from the trace."""


def read(rec: dict):
    if not rec["iters"]:
        return None
    csrc = sum(k["device_ms"] for k in rec["kernels"].values())
    other = sum(rec["device_ms"].values()) - csrc
    return other / rec["iters"]
