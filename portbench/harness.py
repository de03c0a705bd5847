"""The benchmark of psba_tpu_torch: one run of one cell.

Everything that belongs to one configuration, traffic mix, metric or kernel
lives in a file of its own that this module finds by name:

  BENCHMARK.json                    the cells and the metrics
  portbench/configs/<config>.json   a BAL deployment: counts, precision,
                                    the generator's assumptions
  portbench/traffic/<traffic>.json  the mix's parameters and its "driver"
  portbench/drivers/<driver>.py     what the window drives: Program (set-up,
                                    step, iterations, keep, answer), SPAN,
                                    Check (the plain reference, numbers),
                                    end_to_end(window totals) -> values
  portbench/limits/<cell>.json      the limits of the numbers compared
  portbench/metrics/<metric>.py     read(rec) -> value or None; a metric
                                    `<name>.<split>` without a file of its
                                    own is read by metrics/<name>.py
  portbench/kernels/<kernel>.py     RECORDS, COUNTER, work(shape)

An end-to-end metric `<name>.<split>` takes the value `<name>` that the
driver, or this module (setup_s, peak_mem_gib), gives. The program,
psba_tpu_torch, gives the system under test, its launch counters and its
kernel names; the inputs come from gen/ring.py, the peaks from peaks.py.
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import numpy as np

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "psba_tpu")
WINDOW = "portbench.window"
GIB = float(2 ** 30)


def forbidden_modules(modules=None) -> list:
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN (psba_tpu_torch is not psba_tpu)."""
    names = sys.modules if modules is None else modules
    return sorted(n for n in names if n.split(".")[0] in FORBIDDEN)


def manifest() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_module(path: Path):
    """A module from a file of the benchmark, by path."""
    name = "portbench_" + "_".join(path.relative_to(BENCH).with_suffix(
        "").parts).replace(".", "_").replace("-", "_")
    mod = sys.modules.get(name)
    if mod is None:
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return mod


def cell(name: str) -> dict:
    """The workload entry `name` with its configuration, traffic and
    limits read from their files, and its metrics."""
    bench = manifest()
    found = [w for w in bench["workloads"] if w["name"] == name]
    if len(found) != 1:
        raise SystemExit(f"portbench: no workload {name!r} in BENCHMARK.json")
    w = found[0]
    cfg = [c for c in bench["configs"] if c["name"] == w["config"]][0]

    def applies(m):
        return name in m.get("workloads", [name])

    return dict(
        workload=w,
        config=json.loads((ROOT / cfg["file"]).read_text()),
        traffic=json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                           .read_text()),
        limits=json.loads((BENCH / "limits" / f"{name}.json").read_text()),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)],
    )


def kernel_files() -> dict:
    """Every kernel count under kernels/, by file name."""
    return {p.stem: load_module(p)
            for p in sorted((BENCH / "kernels").glob("*.py"))}


def read_counter(counter) -> int:
    module, function, attr = counter
    return int(getattr(getattr(importlib.import_module(module), function),
                       attr))


def driver(spec: dict):
    """The module that drives the cell `spec`'s window: the one its
    traffic names."""
    return load_module(BENCH / "drivers" / f"{spec['traffic']['driver']}.py")


def metric_reader(name: str):
    """The reader of the per-layer metric `name`: metrics/<name>.py, or
    for `<base>.<split>` without a file of its own, metrics/<base>.py."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.exists():
        path = BENCH / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def end_to_end_value(name: str, values: dict):
    """The value of the end-to-end metric `name` among `values`, by its
    whole name or by the part before its first dot."""
    return values[name] if name in values else values[name.split(".")[0]]


def keep_rule(seed: int, most: int):
    """Which steps' answers are kept for the check: the first and a
    sample drawn from the seed (one in 16 on average, `most` at most);
    run_window adds the last."""
    draw = np.random.default_rng(seed % 2 ** 64).random(1 << 16) < 1.0 / 16
    kept = [0]

    def keep(r: int) -> bool:
        if r == 0:
            return True
        if kept[0] < most and draw[r % (1 << 16)]:
            kept[0] += 1
            return True
        return False

    return keep


def run_window(prog, span_name: str, seconds: float, seed: int,
               traced: bool, cuda: bool, most: int = 24):
    """Steps of prog back to back until `seconds` have passed; the window
    ends with the step running at that time and a synchronize. `traced`
    wraps the window and each step in spans (the step's named
    `span_name`). The kept steps go to the host as they come. Returns
    (window seconds, iterations, steps, kept)."""
    import contextlib

    import torch
    from torch.profiler import record_function

    span = record_function if traced else (
        lambda name: contextlib.nullcontext())
    keep = keep_rule(seed, most)
    kept = {}
    iters = repeats = 0
    with span(WINDOW):
        t0 = time.perf_counter()
        deadline = t0 + seconds
        while True:
            with span(span_name):
                st = prog.step()
            iters += prog.iterations(st)
            repeats += 1
            last = time.perf_counter() >= deadline
            if keep(repeats - 1) or last:
                kept[repeats - 1] = prog.keep(st)
            if last:
                break
        if cuda:
            torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    return window_s, iters, repeats, kept


def judge(check, answers: list, limits: dict):
    """(the worst over the answers of each number that `limits` names,
    beside its limit; the count of answers with a number over its
    limit)."""
    worst = {k: 0.0 for k in limits}
    failed = 0
    for a in answers:
        nums = check.numbers(a)
        failed += any(not nums[k] <= limits[k] for k in worst)
        for k in worst:
            worst[k] = max(worst[k], nums[k])
    return {k: dict(value=v, limit=float(limits[k]))
            for k, v in worst.items()}, failed


def smi_line() -> str:
    """The card's name and power limit, from nvidia-smi ("" without it)."""
    import subprocess

    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=30).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def run_cell(name: str, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", spec: dict | None = None,
             log=None) -> dict:
    """One run of the cell `name`: inputs from `seed`, the kernels built
    where they are not (timed apart, and inside set-up), the driver module's
    set-up and one warm-up step, the window (traced with `trace`), the
    memory peak, then the driver module's check. Returns the result line as a
    dict. `spec` replaces the files' (tests)."""
    import torch

    from portbench.gen.ring import ring_problem

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    spec = spec or cell(name)
    config, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    drv = driver(spec)
    cuda = torch.device(device).type == "cuda"
    arrays = ring_problem(config["n_cams"], config["n_pts"],
                          config["n_obs"], seed, device, config["assumed"])
    shape = dict(C=config["n_cams"], P=config["n_pts"],
                 O=len(arrays["obs"]))
    build_s = 0.0
    if cuda:
        from psba_tpu_torch.ops import _build

        build_s = _build.build(verbose=False)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    prog = drv.Program(arrays, config, traffic, device)
    warm = prog.step()                       # loads the kernels, warms up
    del warm
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    log(f"portbench: {name} seed {seed}: C={shape['C']} P={shape['P']} "
        f"O={shape['O']} driver={traffic['driver']}; set-up {setup_s:.3f} s"
        f" (of it the kernels' build {build_s:.3f} s)")

    kernels = kernel_files()
    counters = lambda: {n: read_counter(k.COUNTER)
                        for n, k in kernels.items()}

    def window(traced: bool, secs: float):
        before = counters()
        out = run_window(prog, drv.SPAN, secs, seed, traced, cuda)
        after = counters()
        return out, {n: after[n] - before[n] for n in kernels}

    if trace:
        from portbench import trace as tr

        counted = [(lambda c=k.COUNTER: read_counter(c), k.RECORDS)
                   for k in kernels.values()]
        recs, ((window_s, iters, repeats, kept), launches) = \
            tr.complete_profile(
                lambda: window(True, min(seconds,
                                         float(traffic["trace_seconds"]))),
                counted)
        red = tr.reduce_trace(recs, WINDOW)
        rec = dict(iters=iters, repeats=repeats, shape=shape,
                   window_s=red["window_s"], busy_s=red["busy_s"],
                   device_ms=red["device_ms"], counters=launches,
                   kernels={})
    else:
        (window_s, iters, repeats, kept), launches = window(False, seconds)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    answers = [prog.answer(k) for k in kept.values()]
    del kept, prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    if trace:
        from portbench import peaks

        for n, k in kernels.items():
            if launches[n]:
                nbytes, flops = k.work(shape)
                rec["kernels"][n] = dict(
                    launches=launches[n],
                    bound_ms=launches[n] * peaks.bound_ms(nbytes, flops),
                    device_ms=sum(ms for rn, ms in rec["device_ms"].items()
                                  if any(tr.is_kernel(rn, r)
                                         for r in k.RECORDS)))
        for m in spec["per_layer"]:
            value = metric_reader(m["name"]).read(rec)
            if value is not None:
                metrics[m["name"]] = dict(value=value, unit=m["unit"])
    else:
        values = dict(drv.end_to_end(dict(seconds=window_s,
                                          iterations=iters,
                                          repeats=repeats)),
                      peak_mem_gib=peak / GIB, setup_s=setup_s)
        for m in spec["end_to_end"]:
            metrics[m["name"]] = dict(
                value=end_to_end_value(m["name"], values), unit=m["unit"])

    t_check = time.perf_counter()
    check = drv.Check(arrays, config, traffic, device)
    checks, failed = judge(check, answers, limits)
    log(f"portbench: reference {check.summary}, "
        f"{time.perf_counter() - t_check:.1f} s")
    result = dict(
        correct=failed == 0, attempted=repeats, failed=failed,
        metrics=metrics,
        device=dict(platform="gpu" if cuda else "cpu",
                    kind=torch.cuda.get_device_name() if cuda else "cpu",
                    count=1, memory_peak_bytes=int(peak)),
        card=smi_line() if cuda else "",
        setup=dict(seconds=setup_s, build_s=build_s),
        window=dict(seconds=window_s, iterations=iters, repeats=repeats,
                    answers_checked=len(answers)),
    )
    if trace:
        result["device"].update(busy_s=rec["busy_s"],
                                window_s=rec["window_s"])
        result["breakdown"] = red["breakdown"]
    result["checks"] = checks
    return result
