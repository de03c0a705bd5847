"""Reading a torch.profiler trace of the timed window.

`complete_profile` and `kernel_records` are copies of chip_smoke.py's: CUPTI
now and then drops some or all of a window's device records, so a profile is
taken again until it holds one record per launch that the program's counters
saw. The rest reduces a trace, as plain records, to what the per-layer
metrics read: the union of the device's busy intervals inside the window,
device time by name, and the longest idle gaps named by what the host was
doing then.
"""

from __future__ import annotations

import time
from collections import defaultdict


def is_kernel(record_name: str, name: str) -> bool:
    """True when a device record names the kernel `name`, or a template
    instance of it, in a namespace or not."""
    return (f"::{name}(" in record_name or f"::{name}<" in record_name
            or record_name == name
            or record_name.startswith((f"{name}(", f"{name}<")))


def kernel_records(events, name) -> list:
    """The device records of the kernel `name` among plain records (see
    `records`)."""
    return [e for e in events if e["device"] and is_kernel(e["name"], name)]


def records(prof) -> list:
    """Plain records of a profile: dict(name, device, start, end) with
    times in microseconds. Device records are kernels, copies and fills
    (the GPU side of user annotations is left out); host records are the
    torch ops and the harness's own spans."""
    import torch

    out = []
    for e in prof.events():
        device = e.device_type == torch.autograd.DeviceType.CUDA
        if device and e.is_user_annotation:
            continue
        out.append(dict(name=e.name, device=device,
                        start=float(e.time_range.start),
                        end=float(e.time_range.end)))
    return out


def complete_profile(run, counted, tries: int = 5):
    """torch.profiler (host and device) over run(), taken again until it
    holds one device record for each launch counted. `counted` lists
    (read_counter, the kernel names one counted launch runs). Returns
    (plain records, the run's return value). Raises after `tries`."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    lost = {}
    for attempt in range(1, tries + 1):
        before = [read() for read, _ in counted]
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            value = run()
            torch.cuda.synchronize()
        recs = records(prof)
        lost = {}
        for (read, names), b in zip(counted, before):
            launched = read() - b
            for k in names:
                seen = len(kernel_records(recs, k))
                if seen != launched:
                    lost[k] = f"{seen} records of {launched} launches"
        if not lost:
            return recs, value
        time.sleep(0.1 * attempt)
    raise RuntimeError(f"the profiler lost device records in {tries} "
                       f"profiles: {lost}")


def union(intervals, lo: float, hi: float) -> list:
    """The union of [start, end) intervals clipped to [lo, hi], as sorted
    disjoint intervals."""
    out = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def gaps(busy: list, lo: float, hi: float) -> list:
    """The idle intervals of [lo, hi] between the sorted disjoint busy
    intervals."""
    out, t = [], lo
    for s, e in busy:
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out


def host_activity(host: list, times: list) -> list:
    """For each time in `times`, the innermost host record that spans it,
    or "python" where none does (the interpreter between torch calls)."""
    import heapq

    host = sorted(host, key=lambda e: e["start"])
    order = sorted(range(len(times)), key=lambda i: times[i])
    out = ["python"] * len(times)
    active, k = [], 0                   # heap of (end, start, name)
    for i in order:
        t = times[i]
        while k < len(host) and host[k]["start"] <= t:
            e = host[k]
            heapq.heappush(active, (e["end"], e["start"], e["name"]))
            k += 1
        while active and active[0][0] <= t:
            heapq.heappop(active)
        if active:
            out[i] = min(active, key=lambda a: a[0] - a[1])[2]
    return out


def reduce_trace(recs: list, window: str, top: int = 10) -> dict:
    """What the metrics read from the plain records of one traced window,
    the host span named `window`: its length and busy seconds, device ms by
    name, and the breakdown (device ops by time, idle gaps by host
    activity, at most `top` each, in seconds)."""
    spans = [e for e in recs if not e["device"] and e["name"] == window]
    if len(spans) != 1:
        raise ValueError(f"{len(spans)} host spans named {window!r}")
    lo, hi = spans[0]["start"], spans[0]["end"]
    dev = [e for e in recs if e["device"] and e["end"] > lo
           and e["start"] < hi]
    busy = union([(e["start"], e["end"]) for e in dev], lo, hi)
    by_name = defaultdict(float)
    for e in dev:
        by_name[e["name"]] += (min(e["end"], hi) - max(e["start"], lo))
    host = [e for e in recs if not e["device"] and e is not spans[0]]
    idle_by = defaultdict(float)
    idle = gaps(busy, lo, hi)
    names = host_activity(host, [0.5 * (s + e) for s, e in idle])
    for (s, e), name in zip(idle, names):
        idle_by[name] += e - s
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(idle_by.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        window_s=(hi - lo) * 1e-6,
        busy_s=sum(e - s for s, e in busy) * 1e-6,
        device_ms={k: v * 1e-3 for k, v in by_name.items()},
        breakdown=dict(
            device_ops=[[k[:160], v * 1e-6] for k, v in ops],
            idle_gaps=[[k[:160], v * 1e-6] for k, v in idle]),
    )
