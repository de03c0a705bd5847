#!/usr/bin/env python3
"""Smoke test of psba_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also torch.profiler tables of three
                                       # LM and three TR iterations, under
                                       # chiprun_out/

Phases, in order; any failure raises and the script exits nonzero:
  1. environment: CUDA present, card name and power limit, kernels built
     from psba_tpu_torch/csrc (nvcc, all sources at once, seconds printed);
  2. every kernel against its plain PyTorch version on CUDA tensors at the
     main path's shapes (138 cameras x 19,878 requested points, the counts
     of BAL's Ladybug-138; n = 126 / 828 reduced systems; the observation
     stream with the TR flags and with every flag; the J-gram at n = 1, 2,
     3), with the tolerance stated, CUDA-event times (median after warm-up),
     each kernel's device time from the profiler, its bound (the larger of
     bytes over HBM bandwidth and flops over the float32 rate) and, where one
     PyTorch call computes the same function, that call's time;
  3. the main paths, each with the launch counters reset just before and
     read just after: psba_tpu_torch.solve in float32 with the LM->TR switch
     off (the LM path, three kernels), then with the default SolverConfig
     (LM -> TR -> ..., all five kernels; ms per LM and per TR iteration and
     the GMW bootstrap's time printed);
  3g. TR from the start on the 6-camera synthetic problem with an unobserved
     camera appended (the GMW bootstrap), on CUDA and on the CPU;
  4. tests/data/mini_bal.txt on CUDA and on the CPU (plain versions), with
     the LM-only and the default config, held together;
  5. a JSON line of the kernels, then, last, the device JSON line.
It imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "chiprun_out")

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores. The bound of a kernel is the larger of its bytes over the
# first and its flops over the second.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# float32 operations per observed cell or observation, counted from
# csrc/cell_model.cuh and each kernel's own arithmetic: residual and forward
# model 86, Jacobian rows 211 (cell_linearize about 300 in all)
CELL_LINEARIZE_FLOPS = 300
CELL_RESIDUAL_FLOPS = 86
# the dense grid: W = A^T B (54), V (24), gb (12), U (84), ga (24)
LINEARIZE_DENSE_FLOPS = CELL_LINEARIZE_FLOPS + 198
# two residuals and the factored gain / new_l2 sums
GAIN_DENSE_FLOPS = 2 * CELL_RESIDUAL_FLOPS + 8
# the stream with the TR flags: mask (20), U (84), ga (24), l2 (4)
LINEARIZE_STREAM_FLOPS = CELL_LINEARIZE_FLOPS + 132


def jgram_flops(n: int) -> int:
    """Per observed cell: J x for n directions (2 rows x 17) and the
    n(n+1)/2 upper-triangle products (4 each)."""
    return CELL_LINEARIZE_FLOPS + 34 * n + 2 * n * (n + 1)


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


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take: bytes over HBM bandwidth or
    flops over the float32 rate, whichever is larger."""
    t_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
    t_ops = 1e3 * flops / F32_FLOPS_PER_S
    return dict(bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                bound_bytes=nbytes, bound_flops=flops)


def compare(name, got, ref, tol):
    """max |got - ref| and its ratio to max |ref|; raise above tol."""
    import torch

    err = float(torch.max(torch.abs(got.double() - ref.double())))
    scale = float(torch.max(torch.abs(ref.double())))
    rel = err / max(scale, 1e-30)
    print(f"  {name:<26s} max_abs_err {err:.3e}  rel {rel:.3e}  "
          f"(tolerance rel {tol:.0e})", flush=True)
    need(rel <= tol and bool(torch.isfinite(got).all()),
         f"{name}: kernel and plain version disagree (rel {rel:.3e})")
    return err, rel


def per_phase_iterations(res) -> dict:
    """Iterations spent in each phase kind, from SolveResult.phases."""
    out, prev = {}, 0
    for ph, itno, _flag in res.phases:
        out[ph] = out.get(ph, 0) + itno - prev
        prev = itno
    return out


def main(argv) -> int:
    import numpy as np
    import torch

    need(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    sys.path.insert(0, REPO)
    import psba_tpu_torch
    from psba_tpu_torch.core import linalg
    from psba_tpu_torch.io import bal_to_problem, synthetic_problem
    from psba_tpu_torch.ops import _build
    from psba_tpu_torch.ops import cholesky as chol
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import linearize_stream as ls
    from psba_tpu_torch.ops import residual_dense as rd
    from psba_tpu_torch.solvers import ProblemArrays, SolverConfig
    from psba_tpu_torch.solvers import tr as trmod

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
    C, P, O = prob.n_cams, prob.n_pts, prob.n_obs
    Pp = ld.padded_points(P)
    cam_bytes = 4 * 15 * C          # K | q0 | cams
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
        library_ms=None,
        # reads the three [C, P] tables; writes ZW [3, 6C, Pp], V, gb, U, ga
        **bound(cam_bytes + 12 * P + 12 * C * P
                + 4 * (18 * C * Pp + 12 * Pp + 42 * C),
                LINEARIZE_DENSE_FLOPS * O),
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
        library_ms=None,
        **bound(cam_bytes + 4 * 6 * C + 24 * P + 12 * C * P + 8,
                GAIN_DENSE_FLOPS * O),
    )

    chol_errs, chol_ms, chol_plain_ms, chol_lib_ms = [], {}, {}, {}
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

        def library(S=S, b=b):
            L, _info = torch.linalg.cholesky_ex(S)
            return torch.cholesky_solve(b[:, None], L)

        # in turns: kernel, library, library, kernel (medians of each)
        k1 = cuda_ms(lambda: chol.spd_solve(S, b))
        l1 = cuda_ms(library)
        l2 = cuda_ms(library)
        k2 = cuda_ms(lambda: chol.spd_solve(S, b))
        chol_ms[n], chol_lib_ms[n] = min(k1, k2), min(l1, l2)
        chol_plain_ms[n] = cuda_ms(lambda: chol.spd_solve_plain(S, b))
        print(f"  spd_solve n={n}: kernel {k1:.4f} / {k2:.4f} ms, "
              f"cholesky_ex + cholesky_solve {l1:.4f} / {l2:.4f} ms, plain "
              f"{chol_plain_ms[n]:.4f} ms", flush=True)
    S_bad = torch.eye(828, device=dev)
    S_bad[5, 5] = -2.0
    x_bad, ok_bad = chol.spd_solve(S_bad, torch.ones(828, device=dev))
    need(not bool(ok_bad) and bool((x_bad == 0).all()),
         "spd_solve: indefinite matrix not flagged with x = 0")
    print("  spd_solve indefinite n=828: ok=False, x=0", flush=True)
    n = 828
    rows["spd_solve"] = dict(
        max_abs_err=max(e for e, _ in chol_errs),
        max_rel_err=max(r for _, r in chol_errs),
        ms=chol_ms[n], plain_ms=chol_plain_ms[n], library_ms=chol_lib_ms[n],
        ms_n126=chol_ms[126], plain_ms_n126=chol_plain_ms[126],
        library_ms_n126=chol_lib_ms[126],
        # factor n^3/3, two triangular solves 2 n^2
        **bound(4 * (n * n + 2 * n), n ** 3 / 3 + 2 * n * n),
    )

    # the observation stream: TR flags (U / ga / l2 / ex), then every flag
    # with a valid mask. ex is obs - proj with proj ~ 1e3 px rounding at
    # ~6e-5 px: 1e-4 of max |ex|; A, B, W per observation 1e-5; U, V sums
    # of 10^2..10^4 terms in another order 1e-4, as l2; ga, gb 1e-3
    sargs = (pa.K, pa.q0, cams, pts, pa.obs, pa.cam_idx, pa.pt_idx)
    tr_flags = dict(want_point=False, want_w=False)
    valid = (torch.arange(O, device=dev) < O - 7).to(f32)
    names = ("ex", "l2", "U", "V", "W", "ga", "gb", "A", "B")
    tols = dict(ex=1e-4, l2=1e-4, U=1e-4, V=1e-4, W=1e-5, ga=1e-3, gb=1e-3,
                A=1e-5, B=1e-5)
    errs = []
    for label, vmask, kw in (("tr", None, tr_flags),
                             ("all", valid, dict(want_jac=True))):
        got = ls.linearize_stream(*sargs, vmask, C, P, tables=pa.stream,
                                  **kw)
        ref = ls.linearize_stream_plain(*sargs, vmask, C, P, **kw)
        torch.cuda.synchronize()
        for name, a, r in zip(names, got, ref):
            need((a is None) == (r is None), f"linearize_stream {name} slot")
            if a is not None:
                errs.append(compare(f"linearize_stream[{label}] {name}",
                                    a, r, tols[name]))
        del got, ref
    rows["linearize_stream"] = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=cuda_ms(lambda: ls.linearize_stream(
            *sargs, None, C, P, tables=pa.stream, **tr_flags)),
        plain_ms=cuda_ms(lambda: ls.linearize_stream_plain(
            *sargs, None, C, P, **tr_flags), warmup=1, runs=5),
        library_ms=None,
        # TR flags: reads obs and the two int32 index streams, writes ex
        **bound(cam_bytes + 12 * P + O * (8 + 8 + 8) + 4 * 42 * C,
                LINEARIZE_STREAM_FLOPS * O),
    )

    # the J-gram: n = 1 (Cauchy curvature), 2 (the {P_U, P_B} Gram), 3;
    # a sum over 2.5M cells in another order, 1e-4 of max |G|; the padded
    # lanes of dirs_p carry garbage that must not count
    gram = {}
    errs = []
    for n in (1, 2, 3):
        g = np.random.default_rng(100 + n)
        dc = torch.as_tensor(g.standard_normal((n, C, 6)), dtype=f32,
                             device=dev)
        dp = torch.as_tensor(g.standard_normal((n, 3, Pp)), dtype=f32,
                             device=dev)
        jargs = (pa.K, pa.q0, cams, pts, pa.valid_d, dc, dp)
        G_k = rd.jgram_dense(*jargs)
        G_p = rd.jgram_dense_plain(*jargs)
        errs.append(compare(f"jgram_dense n={n}", G_k, G_p, 1e-4))
        dp0 = dp.clone()
        dp0[:, :, P:] = 0.0
        need(bool((rd.jgram_dense(*jargs[:-1], dp0) == G_k).all()),
             "jgram_dense: padded lanes contribute")
        gram[n] = dict(
            jargs=jargs,
            ms=cuda_ms(lambda jargs=jargs: rd.jgram_dense(*jargs)),
            **bound(cam_bytes + 12 * P + 4 * C * P
                    + 4 * n * (6 * C + 3 * Pp) + 4 * n * n,
                    jgram_flops(n) * O),
        )
        print(f"  jgram_dense n={n}: {gram[n]['ms']:.4f} ms (bound "
              f"{gram[n]['bound_ms']:.4f} ms, {gram[n]['bound_by']})",
              flush=True)
    j2 = gram[2]["jargs"]
    rows["jgram_dense"] = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=gram[2]["ms"], ms_n1=gram[1]["ms"], ms_n3=gram[3]["ms"],
        plain_ms=cuda_ms(lambda: rd.jgram_dense_plain(*j2), warmup=1,
                         runs=5),
        library_ms=None,
        **{k: gram[2][k] for k in ("bound_ms", "bound_by", "bound_bytes",
                                   "bound_flops")},
    )

    # device time of each kernel alone (the wrapper's time above includes
    # its torch epilogue and launch gaps): profiler, mean of 10 calls
    from torch.profiler import ProfilerActivity, profile as tprofile

    S828 = S
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ld.linearize_dense(*args, want_u=True)
            rd.gain_dense(*gargs)
            chol.spd_solve(S828, b)
            ls.linearize_stream(*sargs, None, C, P, tables=pa.stream,
                                **tr_flags)
            rd.jgram_dense(*j2)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for k in rows:
            if f"(anonymous namespace)::{k}_kernel" in e.key:
                rows[k]["kernel_ms"] = e.self_device_time_total / 1e3 / e.count
    for k, v in rows.items():
        need("kernel_ms" in v, f"{k}: kernel not seen by the profiler")
        lib = ("none" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        print(f"[2] {k}: wrapper {v['ms']:.4f} ms (kernel alone "
              f"{v['kernel_ms']:.4f} ms), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), library "
              f"{lib}", flush=True)
    del out_k, pa, gram, j2
    torch.cuda.empty_cache()

    # ---- phase 3: the main paths
    kern = {"linearize_dense": ld.linearize_dense, "gain_dense": rd.gain_dense,
            "spd_solve": chol.spd_solve,
            "linearize_stream": ls.linearize_stream,
            "jgram_dense": rd.jgram_dense}
    lm_path = ("linearize_dense", "spd_solve", "gain_dense")

    def reset():
        for fn in kern.values():
            fn.launches = 0
        linalg.spd_solve.oversized_launches = 0

    def read():
        return {k: fn.launches for k, fn in kern.items()}

    gmw_log = []
    gmw_real = trmod.gmw_bootstrap_lambda

    def gmw_timed(S):
        torch.cuda.synchronize()
        t = time.perf_counter()
        lam = gmw_real(S)
        lam_v = float(lam)
        gmw_log.append((S.shape[0], 1e3 * (time.perf_counter() - t), lam_v,
                        S.device.type))
        return lam

    trmod.gmw_bootstrap_lambda = gmw_timed
    ok_flags = ("DP_NO_CHANGE", "ERR_SMALL_ENOUGH", "CONTINUE")

    # 3a. the LM path (switch off)
    cfg_lm = SolverConfig.for_dtype(f32, lm_switch_count=10_000,
                                    record_history=True)
    psba_tpu_torch.solve(prob, cfg_lm._replace(max_iters=2), dtype=f32,
                         device=dev)   # warm-up: libraries, cuBLAS
    reset()
    res_lm = psba_tpu_torch.solve(prob, cfg_lm, dtype=f32, device=dev)
    launches_lm = read()
    ms_lm_only = 1e3 * res_lm.wall_s / max(res_lm.iterations, 1)
    print(f"[3a] LM path: {res_lm}; damping {res_lm.resolved_damping}\n"
          f"[3a] launches {launches_lm}, oversized spd_solve "
          f"{linalg.spd_solve.oversized_launches}\n"
          f"[3a] initial_error {res_lm.initial_error:.6e} final_error "
          f"{res_lm.final_error:.6e} iterations {res_lm.iterations} "
          f"ms/LM-iteration {ms_lm_only:.3f} flag {res_lm.flag_name}",
          flush=True)
    need(np.isfinite(res_lm.final_l2), "LM path: final_l2 not finite")
    need(res_lm.final_error < res_lm.initial_error,
         "LM path: error did not decrease")
    need(res_lm.flag_name in ok_flags,
         f"LM path: abnormal stop {res_lm.flag_name}")
    for k in lm_path:
        need(launches_lm[k] > 0, f"kernel {k} not launched on the LM path")

    # 3b. the default hybrid solve (LM -> TR -> ...), no device named
    cfg = SolverConfig.for_dtype(f32, record_history=True)
    psba_tpu_torch.solve(prob, cfg._replace(max_iters=8), dtype=f32)
    gmw_log.clear()
    reset()
    res = psba_tpu_torch.solve(prob, cfg, dtype=f32)
    launches = read()
    per = per_phase_iterations(res)
    ms_it = {ph: 1e3 * res.phase_seconds[ph] / per[ph] for ph in per}
    gmw_ms = sum(t for _, t, _, _ in gmw_log)
    print(f"[3b] default solve: {res}; damping {res.resolved_damping}\n"
          f"[3b] phases {res.phases}\n[3b] launches {launches}, oversized "
          f"spd_solve {linalg.spd_solve.oversized_launches}\n"
          f"[3b] iterations per phase {per}; ms per LM iteration "
          f"{ms_it.get('lm', float('nan')):.3f}, per TR iteration "
          f"{ms_it.get('tr', float('nan')):.3f}\n"
          f"[3b] GMW bootstraps (n, ms, lambda) "
          f"{[(n_, round(t, 3), lam) for n_, t, lam, _ in gmw_log]}, "
          f"{gmw_ms:.3f} ms in all\n"
          f"[3b] initial_error {res.initial_error:.6e} final_error "
          f"{res.final_error:.6e} flag {res.flag_name}", flush=True)
    print(res.format_history(), flush=True)
    need(res.resolved_damping == "additive",
         f"damping resolved to {res.resolved_damping}")
    need("tr" in per, "the default solve never entered TR")
    need(np.isfinite(res.final_l2), "final_l2 not finite")
    need(res.final_error < res.initial_error, "error did not decrease")
    need(res.flag_name in ok_flags, f"abnormal stop {res.flag_name}")
    need(res.cams.shape == prob.cams.shape and res.pts.shape == prob.pts.shape
         and np.isfinite(res.cams).all() and np.isfinite(res.pts).all(),
         "output parameters malformed")
    for k, v in launches.items():
        need(v > 0, f"kernel {k} was not launched on the default path")

    if "--profile" in argv:
        profile(prob, cfg, dev)

    # ---- phase 3g: TR from the start through the GMW bootstrap
    small = synthetic_problem(n_cams=6, n_pts=150, seed=3)
    small = dataclasses.replace(
        small, K=np.concatenate([small.K, small.K[:1]]),
        q0=np.concatenate([small.q0, small.q0[:1]]),
        cams=np.concatenate([small.cams, small.cams[:1]]))
    c10 = cfg._replace(max_iters=10)
    for where in (dev, "cpu"):
        gmw_log.clear()
        r = psba_tpu_torch.solve(small, c10, dtype=f32, device=where,
                                 start="tr")
        lam = np.nanmax(r.history[:, 3])
        print(f"[3g] start=tr, unobserved camera, {where}: {r}; phases "
              f"{r.phases}; max lambda {lam:.6e}; GMW "
              f"{[(n_, round(t, 3), l_) for n_, t, l_, _ in gmw_log]} "
              f"(n, ms, lambda)", flush=True)
        need(r.phases[0][0] == "tr" and gmw_log, f"{where}: no GMW bootstrap")
        need(lam > 0.0, f"{where}: no lambda > 0 in the TR history")
        need(np.isfinite(r.final_l2) and r.final_l2 < r.initial_l2,
             f"{where}: start=tr did not descend")
    trmod.gmw_bootstrap_lambda = gmw_real

    # ---- phase 4: whole path on CUDA against the CPU plain versions
    # LM only: at a fixed budget short of convergence both runs take the
    # same iterations; run to convergence, the last DP_NO_CHANGE step is
    # decided at the float32 noise floor, so there the count may differ by
    # a few. Default config: the first TR step starts from a GMW-bootstrapped
    # lambda that float32 rounding decides (S is singular along the gauge),
    # so the two devices' TR trajectories part there; 15 iterations (LM to
    # 14, one TR step) are held to flag, phases and final_l2 1e-3, the full
    # run to final_l2 1e-3 and a normal stop on both.
    mini = bal_to_problem(os.path.join(REPO, "tests", "data", "mini_bal.txt"))
    checks = ((cfg_lm._replace(max_iters=20), "LM 20", True, 0),
              (cfg_lm, "LM full", False, 3),
              (cfg._replace(max_iters=15), "default 15", True, 0),
              (cfg, "default full", False, None))
    for c, label, strict, it_tol in checks:
        r_gpu = psba_tpu_torch.solve(mini, c, dtype=f32, device=dev)
        r_cpu = psba_tpu_torch.solve(mini, c, dtype=f32, device="cpu")
        rel = abs(r_gpu.final_l2 - r_cpu.final_l2) / r_cpu.final_l2
        print(f"[4] mini_bal, {label}\n[4]   cuda: {r_gpu} {r_gpu.phases}\n"
              f"[4]   cpu:  {r_cpu} {r_cpu.phases}\n"
              f"[4]   final_l2 rel diff {rel:.3e} (tolerance 1e-3)",
              flush=True)
        need(rel <= 1e-3, f"{label}: CUDA and CPU final_l2 disagree")
        if strict:
            need(r_gpu.flag == r_cpu.flag and r_gpu.phases == r_cpu.phases,
                 f"{label}: CUDA and CPU runs stop differently")
        else:
            need(r_gpu.flag_name in ok_flags and r_cpu.flag_name in ok_flags,
                 f"{label}: abnormal stop")
        if it_tol is not None:
            need(abs(r_gpu.iterations - r_cpu.iterations) <= it_tol,
                 f"{label}: CUDA and CPU iteration counts differ")
        if "default" in label:
            need("tr" in [ph for ph, _, _ in r_gpu.phases],
                 f"{label}: no TR phase")

    # ---- phase 5: output
    src = {
        "linearize_dense": ("psba_tpu_torch/csrc/linearize_dense.cu",
                            "psba_tpu/ops/linearize_dense.py:338"),
        "spd_solve": ("psba_tpu_torch/csrc/cholesky.cu",
                      "psba_tpu/ops/cholesky_pallas.py:238"),
        "gain_dense": ("psba_tpu_torch/csrc/gain_dense.cu",
                       "psba_tpu/ops/residual_dense.py:135"),
        "jgram_dense": ("psba_tpu_torch/csrc/jgram_dense.cu",
                        "psba_tpu/ops/residual_dense.py:276"),
        "linearize_stream": ("psba_tpu_torch/csrc/linearize_stream.cu",
                             "psba_tpu/ops/linearize_pallas.py:273"),
    }
    kernels = [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=launches[k], launches_lm_path=launches_lm[k], **rows[k])
        for k in src
    ]
    print(f"[5] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line(), flush=True)
    print(json.dumps({
        "kernels": kernels,
        "lm_iter_ms": ms_it.get("lm"), "tr_iter_ms": ms_it.get("tr"),
        "iterations": per, "phases": res.phases, "gmw_ms": gmw_ms,
        "initial_error": res.initial_error, "final_error": res.final_error,
        "lm_path": {"lm_iter_ms": ms_lm_only,
                    "iterations": res_lm.iterations,
                    "final_error": res_lm.final_error},
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def profile(prob, cfg, dev) -> None:
    """torch.profiler tables of three LM iterations (lm_run alone) and three
    TR iterations (tr_run alone, entered with lambda = 1 so the table shows
    a steady TR iteration rather than the GMW bootstrap), each after a
    warm-up: kernel time by name and the device's busy share."""
    import torch
    from torch.profiler import ProfilerActivity, profile as tprofile

    from psba_tpu_torch.solvers.lm import lm_run
    from psba_tpu_torch.solvers.tr import tr_run
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
    c3 = resolve_damping(cfg._replace(max_iters=3, lm_switch_count=10_000),
                         pa, cams, pts)
    aux = torch.tensor([cfg.init_delta, 1.0, 1.0, 2.0, 0.0, 0.0], dtype=f32,
                       device=dev)

    def lm():
        return lm_run(pa, OptState.init(pa, cams, pts), c3)

    def tr():
        st = OptState.init(pa, cams, pts)
        st.aux = aux
        return tr_run(pa, st, c3)

    for name, run in (("lm", lm), ("tr", tr)):
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
        with tprofile(activities=[ProfilerActivity.CPU,
                                  ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        events = prof.key_averages()
        table = events.table(sort_by="self_cuda_time_total", row_limit=30)
        # kernel-level events only: the aten:: rows repeat their kernels'
        # time
        busy = sum(
            e.self_device_time_total for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation
        ) / 1e3
        summary = (f"OptState.init + {name}_run, {out.itno} iterations: wall "
                   f"{wall_ms:.3f} ms (profiler off), device busy "
                   f"{busy:.3f} ms (profiler on), idle share "
                   f"{1 - busy / wall_ms:.3f}")
        with open(os.path.join(OUT_DIR, f"profile_{name}3.txt"), "w") as f:
            f.write(summary + "\n" + table)
        print(summary + "\n" + table, flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
