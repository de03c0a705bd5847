"""Kernels: the csrc/ kernels' share of their roofline in the traced
window, in percent: the sum over kernels of launches x bound (kernels/,
peaks.py) over the sum of their device time. Each bound counts what the
inputs need, so the share cannot pass 100%."""


def read(rec: dict):
    ks = [k for k in rec["kernels"].values() if k["launches"]]
    device = sum(k["device_ms"] for k in ks)
    if not ks or device <= 0:
        return None
    return 100.0 * sum(k["bound_ms"] for k in ks) / device
