#!/usr/bin/env python3
"""Smoke test of psba_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also a torch.profiler table of three
                                       # LM iterations, under chiprun_out/

Phases, in order; any failure raises and the script exits nonzero:
  1. environment: CUDA present, card name and power limit, kernels built
     from psba_tpu_torch/csrc (nvcc, seconds printed);
  2. every kernel against its plain PyTorch version on CUDA tensors at the
     main path's shapes (138 cameras x 19,878 requested points, the counts
     of BAL's Ladybug-138; and n = 126 / 828 reduced systems), with the
     tolerance stated and CUDA-event times (median after warm-up);
  3. the main path: psba_tpu_torch.solve on that problem in float32 with
     the launch counters reset just before and read just after;
  4. the same solve on tests/data/mini_bal.txt on CUDA and on the CPU
     (plain versions), held together;
  5. a JSON line of the kernels, then, last, the device JSON line.
It imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")


def need(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_ms(fn, warmup: int = 2, runs: int = 10) -> float:
    """Median milliseconds of fn() by CUDA events, after warm-up."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def compare(name, got, ref, tol):
    """max |got - ref| and its ratio to max |ref|; raise above tol."""
    import torch

    err = float(torch.max(torch.abs(got.double() - ref.double())))
    scale = float(torch.max(torch.abs(ref.double())))
    rel = err / max(scale, 1e-30)
    print(f"  {name:<22s} max_abs_err {err:.3e}  rel {rel:.3e}  "
          f"(tolerance rel {tol:.0e})", flush=True)
    need(rel <= tol and bool(torch.isfinite(got).all()),
         f"{name}: kernel and plain version disagree (rel {rel:.3e})")
    return err, rel


def main(argv) -> int:
    import numpy as np
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    import psba_tpu_torch
    from psba_tpu.io import bal_to_problem, synthetic_problem
    from psba_tpu_torch.core import linalg
    from psba_tpu_torch.ops import _build
    from psba_tpu_torch.ops import cholesky as chol
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import residual_dense as rd
    from psba_tpu_torch.solvers import ProblemArrays, SolverConfig

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = smi_line()
    print(f"[1] card: {card}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.get_device_name(0)}",
          flush=True)
    secs = _build.build()
    print(f"[1] kernel build: {secs:.1f} s", flush=True)

    # ---- phase 2: kernels against plain versions at the main path's shapes
    t0 = time.perf_counter()
    prob = synthetic_problem(n_cams=138, n_pts=19878, seed=0)
    print(f"[2] problem: C={prob.n_cams} P={prob.n_pts} O={prob.n_obs} "
          f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)
    f32 = torch.float32
    pa = ProblemArrays.from_problem(prob, dtype=f32, device=dev)
    rng = np.random.default_rng(0)
    cams = torch.as_tensor(prob.cams + np.concatenate(
        [1e-3 * rng.standard_normal((prob.n_cams, 3)),
         1e-2 * rng.standard_normal((prob.n_cams, 3))], axis=1),
        dtype=f32, device=dev)
    pts = torch.as_tensor(prob.pts, dtype=f32, device=dev)
    tables = (pa.obs_du, pa.obs_dv, pa.valid_d)
    rows = {}

    args = (pa.K, pa.q0, cams, pts, *tables)
    out_k = ld.linearize_dense(*args, want_u=True)
    out_p = ld.linearize_dense_plain(*args, want_u=True)
    torch.cuda.synchronize()
    # per-cell products (ZW) and sums over >= 10^4 f32 terms in another
    # order (V, U: 1e-4); B^T ex and A^T ex add residual-weighted terms of
    # both signs, so they carry the reference's cancellation gate (1e-3)
    errs = []
    for name, i, tol in (("ZW0", 0, 1e-5), ("ZW1", 1, 1e-5),
                         ("ZW2", 2, 1e-5), ("Vp", 3, 1e-4),
                         ("gbp", 4, 1e-3), ("U", 6, 1e-4), ("ga", 7, 1e-3)):
        errs.append(compare(f"linearize_dense {name}", out_k[i], out_p[i],
                            tol))
    need(out_k[5] == out_p[5], "padded widths differ")
    P = prob.n_pts
    need(bool((out_k[0][:, P:] == 0).all()) and bool(
        (out_k[3][:, :, P:] == torch.eye(3, device=dev)[:, :, None]).all()),
        "padded lanes are not ZW = 0 / V = I")
    del out_p
    rows["linearize_dense"] = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=cuda_ms(lambda: ld.linearize_dense(*args, want_u=True)),
        plain_ms=cuda_ms(lambda: ld.linearize_dense_plain(*args,
                                                          want_u=True),
                         warmup=1, runs=5),
    )

    new_cams = cams + torch.as_tensor(
        1e-4 * rng.standard_normal(cams.shape), dtype=f32, device=dev)
    new_pts = pts + torch.as_tensor(
        1e-3 * rng.standard_normal(pts.shape), dtype=f32, device=dev)
    gargs = (pa.K, pa.q0, cams, pts, new_cams, new_pts, *tables)
    g_k = torch.stack(rd.gain_dense(*gargs))
    g_p = torch.stack(rd.gain_dense_plain(*gargs))
    # two sums over 2.5M cells in another order; gain is a difference of
    # nearly equal sums, so 1e-3; new_l2 1e-4
    e1 = compare("gain_dense gain", g_k[0], g_p[0], 1e-3)
    e2 = compare("gain_dense new_l2", g_k[1], g_p[1], 1e-4)
    rows["gain_dense"] = dict(
        max_abs_err=max(e1[0], e2[0]), max_rel_err=max(e1[1], e2[1]),
        ms=cuda_ms(lambda: rd.gain_dense(*gargs)),
        plain_ms=cuda_ms(lambda: rd.gain_dense_plain(*gargs), runs=5),
    )

    chol_errs, chol_ms, chol_plain_ms = [], {}, {}
    for n in (126, 828):
        g = np.random.default_rng(n)
        A = g.standard_normal((n, n))
        S = torch.as_tensor(A @ A.T + n * np.eye(n), dtype=f32, device=dev)
        b = torch.as_tensor(g.standard_normal(n), dtype=f32, device=dev)
        x_k, ok_k = chol.spd_solve(S, b)
        x_p, ok_p = chol.spd_solve_plain(S, b)
        need(bool(ok_k) and bool(ok_p), f"spd_solve n={n}: not ok")
        # f32 factor-and-solve of a matrix with condition ~10 (5e-5)
        chol_errs.append(compare(f"spd_solve n={n}", x_k, x_p, 5e-5))
        chol_ms[n] = cuda_ms(lambda: chol.spd_solve(S, b))
        chol_plain_ms[n] = cuda_ms(lambda: chol.spd_solve_plain(S, b))
        print(f"  spd_solve n={n}: kernel {chol_ms[n]:.4f} ms, plain "
              f"{chol_plain_ms[n]:.4f} ms", flush=True)
    S_bad = torch.eye(828, device=dev)
    S_bad[5, 5] = -2.0
    x_bad, ok_bad = chol.spd_solve(S_bad, torch.ones(828, device=dev))
    need(not bool(ok_bad) and bool((x_bad == 0).all()),
         "spd_solve: indefinite matrix not flagged with x = 0")
    print("  spd_solve indefinite n=828: ok=False, x=0", flush=True)
    rows["spd_solve"] = dict(
        max_abs_err=max(e for e, _ in chol_errs),
        max_rel_err=max(r for _, r in chol_errs),
        ms=chol_ms[828], plain_ms=chol_plain_ms[828],
        ms_n126=chol_ms[126], plain_ms_n126=chol_plain_ms[126],
    )
    # device time of the kernel alone (the wrapper's time above includes
    # its torch epilogue and launch gaps): profiler, mean of 10 calls
    from torch.profiler import ProfilerActivity, profile as tprofile

    S828 = S
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ld.linearize_dense(*args, want_u=True)
            rd.gain_dense(*gargs)
            chol.spd_solve(S828, b)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for k in rows:
            if e.key.startswith(f"(anonymous namespace)::{k}_kernel"):
                rows[k]["kernel_ms"] = e.self_device_time_total / 1e3 / e.count
    for k, v in rows.items():
        need("kernel_ms" in v, f"{k}: kernel not seen by the profiler")
        print(f"[2] {k}: wrapper {v['ms']:.4f} ms (kernel alone "
              f"{v['kernel_ms']:.4f} ms), plain {v['plain_ms']:.4f} ms",
              flush=True)
    del out_k, pa
    torch.cuda.empty_cache()

    # ---- phase 3: the main path
    cfg = SolverConfig.for_dtype(f32, lm_switch_count=10_000,
                                 record_history=True)
    psba_tpu_torch.solve(prob, cfg._replace(max_iters=2), dtype=f32,
                         device=dev)   # warm-up: libraries, cuBLAS
    counters = (ld.linearize_dense, rd.gain_dense, chol.spd_solve)
    for fn in counters:
        fn.launches = 0
    linalg.spd_solve.oversized_launches = 0
    res = psba_tpu_torch.solve(prob, cfg, dtype=f32, device=dev)
    launches = {fn.__name__: fn.launches for fn in counters}
    print(f"[3] solve: {res}; damping {res.resolved_damping}", flush=True)
    print(f"[3] launches {launches}, oversized spd_solve "
          f"{linalg.spd_solve.oversized_launches}", flush=True)
    ms_iter = 1e3 * res.wall_s / max(res.iterations, 1)
    print(f"[3] initial_error {res.initial_error:.6e} final_error "
          f"{res.final_error:.6e} iterations {res.iterations} "
          f"ms/LM-iteration {ms_iter:.3f} flag {res.flag_name}", flush=True)
    need(np.isfinite(res.final_l2), "final_l2 not finite")
    need(res.final_error < res.initial_error, "error did not decrease")
    need(res.flag_name in ("DP_NO_CHANGE", "ERR_SMALL_ENOUGH", "CONTINUE"),
         f"abnormal LM stop {res.flag_name}")
    need(res.cams.shape == prob.cams.shape and res.pts.shape == prob.pts.shape
         and np.isfinite(res.cams).all() and np.isfinite(res.pts).all(),
         "output parameters malformed")
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the main path")

    if "--profile" in argv:
        profile(prob, cfg, dev)

    # ---- phase 4: whole path on CUDA against the CPU plain versions
    # At a fixed budget short of convergence both runs take the same
    # iterations; run to convergence, the last DP_NO_CHANGE step is decided
    # at the float32 noise floor, so there the count may differ by a few.
    mini = bal_to_problem(os.path.join(REPO, "tests", "data", "mini_bal.txt"))
    for budget, it_tol in ((20, 0), (cfg.max_iters, 3)):
        c = cfg._replace(max_iters=budget)
        r_gpu = psba_tpu_torch.solve(mini, c, dtype=f32, device=dev)
        r_cpu = psba_tpu_torch.solve(mini, c, dtype=f32, device="cpu")
        rel = abs(r_gpu.final_l2 - r_cpu.final_l2) / r_cpu.final_l2
        print(f"[4] mini_bal, {budget} iterations at most\n"
              f"[4]   cuda: {r_gpu}\n[4]   cpu:  {r_cpu}\n"
              f"[4]   final_l2 rel diff {rel:.3e} (tolerance 1e-3), "
              f"iterations {r_gpu.iterations} vs {r_cpu.iterations} "
              f"(tolerance {it_tol})", flush=True)
        need(r_gpu.flag == r_cpu.flag, "CUDA and CPU runs stop differently")
        need(abs(r_gpu.iterations - r_cpu.iterations) <= it_tol,
             "CUDA and CPU iteration counts differ")
        need(rel <= 1e-3, "CUDA and CPU final_l2 disagree")

    # ---- phase 5: output
    src = {
        "linearize_dense": ("psba_tpu_torch/csrc/linearize_dense.cu",
                            "psba_tpu/ops/linearize_dense.py:338"),
        "gain_dense": ("psba_tpu_torch/csrc/gain_dense.cu",
                       "psba_tpu/ops/residual_dense.py:135"),
        "spd_solve": ("psba_tpu_torch/csrc/cholesky.cu",
                      "psba_tpu/ops/cholesky_pallas.py:238"),
    }
    kernels = [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=launches[k], **rows[k])
        for k in ("linearize_dense", "spd_solve", "gain_dense")
    ]
    print(f"[5] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({"kernels": kernels, "lm_iter_ms": ms_iter,
                      "iterations": res.iterations,
                      "initial_error": res.initial_error,
                      "final_error": res.final_error}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile(prob, cfg, dev) -> None:
    """torch.profiler table of three LM iterations (lm_run alone, after a
    warm-up), kernel time by name, and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from psba_tpu_torch.solvers.lm import lm_run
    from psba_tpu_torch.solvers.types import (
        OptState,
        ProblemArrays,
        resolve_damping,
    )

    os.makedirs(OUT_DIR, exist_ok=True)
    f32 = torch.float32
    pa = ProblemArrays.from_problem(prob, dtype=f32, device=dev)
    cams = torch.as_tensor(prob.cams, dtype=f32, device=dev)
    pts = torch.as_tensor(prob.pts, dtype=f32, device=dev)
    c3 = resolve_damping(cfg._replace(max_iters=3), pa, cams, pts)
    lm_run(pa, OptState.init(pa, cams, pts), c3)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = lm_run(pa, OptState.init(pa, cams, pts), c3)
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    with tprofile(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        lm_run(pa, OptState.init(pa, cams, pts), c3)
        torch.cuda.synchronize()
    events = prof.key_averages()
    table = events.table(sort_by="self_cuda_time_total", row_limit=30)
    # kernel-level events only: the aten:: rows repeat their kernels' time
    busy = sum(
        e.self_device_time_total for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and not e.is_user_annotation
    ) / 1e3
    summary = (f"OptState.init + lm_run, {out.itno} iterations: wall "
               f"{wall_ms:.3f} ms (profiler off), device busy {busy:.3f} ms "
               f"(profiler on), idle share {1 - busy / wall_ms:.3f}")
    with open(os.path.join(OUT_DIR, "profile_lm3.txt"), "w") as f:
        f.write(summary + "\n" + table)
    print(summary + "\n" + table, flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
