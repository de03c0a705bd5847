"""Device: the share of the traced window, in percent, in which no
kernel, copy or fill ran (one minus the union of the device's intervals
over the window's length)."""


def read(rec: dict):
    if rec["window_s"] <= 0 or rec["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
