#!/usr/bin/env python3
"""Smoke test of psba_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also torch.profiler tables of three
                                       # LM and three TR iterations on the
                                       # dense and the pair path, under
                                       # chiprun_out/
    python3 chip_smoke.py --cap        # also ms per LM iteration of the
                                       # dense and the pair encoding at
                                       # Dubrovnik-356's counts
    python3 chip_smoke.py --spread     # also phase 4p's "pairs, default 15"
                                       # check 100 times in four arms (see
                                       # spread_measurement)

Phases, in order; any failure raises and the script exits nonzero:
  1. environment: CUDA present, card name and power limit, kernels built
     from psba_tpu_torch/csrc (nvcc, all sources at once, seconds printed);
  2. every kernel against its plain PyTorch version on CUDA tensors at the
     main paths' shapes (the trial-step residual and the observation stream
     with the pair path's LM and TR flags at final961_pairs below; the
     others at 138 cameras x 19,878 requested points, the counts of BAL's
     Ladybug-138: n = 126 / 828 reduced systems and n = 1024, the largest
     the kernel takes, each at every cluster size the card schedules, the
     observation stream with the TR flags and with every flag, the J-gram
     at n = 1, 2, 3), with the tolerance stated, CUDA-event times (median
     after warm-up), each kernel's device time from the profiler, its bound
     (the larger of bytes over HBM bandwidth and flops over the float32
     rate) and, where one PyTorch call computes the same function, that
     call's time;
  3. the dense main paths, each with the launch counters reset just before
     and read just after: psba_tpu_torch.solve in float32 with the LM->TR
     switch off (the LM path, three kernels), then with the default
     SolverConfig (LM -> TR -> ..., five kernels; ms per LM and per TR
     iteration and the GMW bootstrap's time printed);
  3p. the covisibility-pair main path at Final-961's counts
     (final961_pairs: 961 cameras of the synthetic ring, 187,103 points,
     about 9 observations each), which solve(schur="auto") must put on the
     pair encoding by itself: LM only, then the default config, counters
     reset and read around each;
  3g. TR from the start on the 6-camera synthetic problem with an unobserved
     camera appended (the GMW bootstrap), on CUDA and on the CPU;
  4. tests/data/mini_bal.txt on CUDA and on the CPU (plain versions), with
     the LM-only and the default config, held together;
  4p. the same on the pair encoding (where two CUDA runs of a fixed budget
     must also give the same final_l2), and pairs against dense on CUDA;
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
# the trial-step residual and its masked square (4)
RESIDUAL_L2_FLOPS = CELL_RESIDUAL_FLOPS + 4
# the stream with the pair path's flags: W = A^T B (54), B^T B (27),
# B^T ex (12), the mask of B (6)
PAIR_STREAM_FLOPS = LINEARIZE_STREAM_FLOPS + 99

# The pair path's configuration, final961_pairs: BAL's Final-961 camera and
# point counts (961 cameras, 187,103 points) on the synthetic ring, about 9
# observations per point. C * P = 180M cells, above the dense cap, so
# schur="auto" takes the pair encoding.
FINAL961 = dict(n_cams=961, n_pts=187_103, mean_obs=9.0)
# Dubrovnik-356's counts (80.7M cells, 5 observations per point): the --cap
# measurement, which placed the dense cap (DENSE_MAX_ENTRIES) below it.
DUBROVNIK356 = dict(n_cams=356, n_pts=226_730, mean_obs=5.0)


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


def ring_problem(n_cams: int, n_pts: int, mean_obs: float):
    """n_cams cameras of the synthetic_problem ring, written to a temporary
    12-column camera file, with points from synthesize_points_for_cams
    (look_sign +1, seed 0) and the covisibility pair list. Returns (problem,
    seconds to build it)."""
    import tempfile

    from psba_tpu_torch.io import synthesize_points_for_cams, synthetic_problem
    from psba_tpu_torch.io.sba_text import write_cams

    t0 = time.perf_counter()
    ring = synthetic_problem(n_cams=n_cams, n_pts=50, seed=0)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "cams.txt")
        write_cams(path, ring.K, ring.q0, ring.cams)
        prob = synthesize_points_for_cams(path, n_pts=n_pts,
                                          mean_obs=mean_obs, look_sign=1.0,
                                          seed=0)
    prob = prob.with_pairs()
    return prob, time.perf_counter() - t0


def check_residual_l2(prob, dev):
    """Kernel 6 against its plain version on CUDA tensors at `prob`'s shape
    (cameras perturbed from a seed), without and with a mask that drops the
    last 1,000 observations. Returns (its row of the kernels line, the
    unmasked arguments)."""
    import numpy as np
    import torch

    from psba_tpu_torch.ops import linearize_stream as ls

    f32 = torch.float32
    C, P, O = prob.n_cams, prob.n_pts, prob.n_obs
    rng = np.random.default_rng(2)
    cams = prob.cams + np.concatenate(
        [1e-3 * rng.standard_normal((C, 3)),
         1e-2 * rng.standard_normal((C, 3))], axis=1)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=f32, device=dev)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int32,
                                  device=dev)
    args = (f(prob.K), f(prob.q0), f(cams), f(prob.pts), f(prob.obs),
            i(prob.cam_idx), i(prob.pt_idx))
    valid = (torch.arange(O, device=dev) < O - 1000).to(f32)
    # ex = obs - proj: the kernel (with fused multiply-adds) and the plain
    # version each round the camera-frame point and the projection (up to
    # ~6e2 px) in float32, and points close to a camera (depth down to 0.3
    # against coordinates up to ~15) magnify that rounding to ~1e-3 px; so
    # ex is held to 1e-4 of max |ex| against the plain version and against
    # the float64 evaluation of the same inputs, as linearize_stream's ex.
    # l2, a sum of 1.7M positive terms in another order: 1e-5.
    ex64, _ = ls.residual_l2_plain(*(a.double() if a.is_floating_point()
                                     else a for a in args))
    errs, l2s = [], []
    for label, vm in (("no mask", None), ("mask", valid)):
        ex_k, l2_k = ls.residual_l2(*args, vm)
        ex_p, l2_p = ls.residual_l2_plain(*args, vm)
        torch.cuda.synchronize()
        need(ex_k.shape == (O, 2), f"residual_l2 ex shape {ex_k.shape}")
        errs.append(compare(f"residual_l2[{label}] ex", ex_k, ex_p, 1e-4))
        compare(f"residual_l2[{label}] ex vs f64", ex_k, ex64, 1e-4)
        compare(f"plain[{label}] ex vs f64", ex_p, ex64, 1e-4)
        errs.append(compare(f"residual_l2[{label}] l2", l2_k, l2_p, 1e-5))
        l2s.append(float(l2_k))
    tail = float((ex_k[-1000:] ** 2).sum())
    print(f"  residual_l2 l2 {l2s[0]:.6e}, masked {l2s[1]:.6e}, the dropped "
          f"tail {tail:.6e}", flush=True)
    need(abs(l2s[0] - l2s[1] - tail) <= 1e-5 * l2s[0],
         "residual_l2: the mask does not drop the last observations")
    row = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=cuda_ms(lambda: ls.residual_l2(*args)),
        plain_ms=cuda_ms(lambda: ls.residual_l2_plain(*args), warmup=1,
                         runs=5),
        library_ms=None,
        # reads K | q0 | cams, the points, obs and the two int32 index
        # streams once; writes ex
        **bound(4 * 15 * C + 12 * P + O * (8 + 8 + 8),
                RESIDUAL_L2_FLOPS * O),
    )
    return row, args


def check_pair_stream(prob, rargs, dev):
    """linearize_stream with the pair path's flags at `prob`'s shape: the
    LM flags (W and the point sums V, gb) and the TR flags (also A, B),
    each against its plain version with a valid mask, then timed without
    one, each with its own bound. Returns (the fields for the kernel's row,
    the timed calls for the profiler)."""
    import torch

    from psba_tpu_torch.ops import linearize_stream as ls

    f32 = torch.float32
    C, P, O = prob.n_cams, prob.n_pts, prob.n_obs
    t0 = time.perf_counter()
    tables = ls.build_stream_tables(prob.cam_idx, prob.pt_idx, C, P,
                                    device=dev)
    print(f"  stream tables: {tables.chunks.shape[0]} camera chunks, "
          f"{tables.runs.shape[0]} point runs, {tables.n_pieces} pieces "
          f"(built in {time.perf_counter() - t0:.2f} s)", flush=True)
    K, q0, cams, pts, obs = rargs[:5]
    args = (K, q0, cams, pts, obs,
            torch.as_tensor(prob.cam_idx, dtype=torch.int64, device=dev),
            torch.as_tensor(prob.pt_idx, dtype=torch.int64, device=dev))
    valid = (torch.arange(O, device=dev) < O - 1000).to(f32)
    names = ("ex", "l2", "U", "V", "W", "ga", "gb", "A", "B")
    # as the 138-camera stream check: ex 1e-4 of max |ex|; A, B, W 1e-5;
    # sums in another order 1e-4 (U, V, l2), residual-weighted 1e-3
    tols = dict(ex=1e-4, l2=1e-4, U=1e-4, V=1e-4, W=1e-5, ga=1e-3, gb=1e-3,
                A=1e-5, B=1e-5)
    out, calls = {}, {}
    errs = []
    cam_bytes = 4 * 15 * C
    for label, kw, extra in (("pairs_lm", {}, 0),
                             ("pairs_tr", dict(want_jac=True), 72)):
        got = ls.linearize_stream(*args, valid, C, P, tables=tables, **kw)
        ref = ls.linearize_stream_plain(*args, valid, C, P, **kw)
        torch.cuda.synchronize()
        for name, a, r in zip(names, got, ref):
            need((a is None) == (r is None), f"linearize_stream {name} slot")
            if a is not None:
                errs.append(compare(f"linearize_stream[{label}] {name}", a,
                                    r, tols[name]))
        again = ls.linearize_stream(*args, valid, C, P, tables=tables, **kw)
        for i in (2, 3, 5, 6):
            need(bool((again[i] == got[i]).all()),
                 f"linearize_stream[{label}]: {names[i]} differs between "
                 "two calls")
        del got, ref, again
        calls[label] = (lambda kw=kw: ls.linearize_stream(
            *args, None, C, P, tables=tables, **kw))
        out[f"ms_{label}"] = cuda_ms(calls[label])
        out[f"plain_ms_{label}"] = cuda_ms(
            lambda kw=kw: ls.linearize_stream_plain(*args, None, C, P, **kw),
            warmup=1, runs=5)
        # reads K | q0 | cams, the points, obs and the two int32 index
        # streams once; writes ex and W (and A, B), V | gb per point, U, ga
        b = bound(cam_bytes + 12 * P + O * (8 + 4 + 4 + 8 + 72 + extra)
                  + 48 * P + 4 * 42 * C, PAIR_STREAM_FLOPS * O)
        out.update({f"{k}_{label}": v for k, v in b.items()})
        print(f"  linearize_stream[{label}]: wrapper {out[f'ms_{label}']:.4f}"
              f" ms, plain {out[f'plain_ms_{label}']:.4f} ms, bound "
              f"{b['bound_ms']:.4f} ms ({b['bound_by']})", flush=True)
    print("  linearize_stream pair flags: V, gb, U, ga bit-identical over "
          "two calls", flush=True)
    out["max_abs_err_pairs"] = max(e for e, _ in errs)
    out["max_rel_err_pairs"] = max(r for _, r in errs)
    return out, calls


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
    from psba_tpu_torch.solvers.types import DENSE_MAX_ENTRIES

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

    # ---- phase 2: kernels against plain versions at the main paths' shapes
    f32 = torch.float32
    rows = {}
    big, big_s = ring_problem(**FINAL961)
    cnt = np.bincount(big.pt_idx)
    print(f"[2] final961_pairs: C={big.n_cams} P={big.n_pts} O={big.n_obs} "
          f"(mean {cnt.mean():.2f} observations per point), "
          f"{len(big.pair_o1)} covisibility pairs, C*P = "
          f"{big.n_cams * big.n_pts} cells (built in {big_s:.1f} s)",
          flush=True)
    rows["residual_l2"], rargs = check_residual_l2(big, dev)
    pair_stream, pair_calls = check_pair_stream(big, rargs, dev)

    t0 = time.perf_counter()
    prob = synthetic_problem(n_cams=138, n_pts=19878, seed=0)
    print(f"[2] problem: C={prob.n_cams} P={prob.n_pts} O={prob.n_obs} "
          f"(built in {time.perf_counter() - t0:.1f} s)", flush=True)
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
    chol_by_cluster = {}
    max_cluster = chol.max_cluster()
    print(f"  spd_solve: largest cluster the device schedules {max_cluster}",
          flush=True)
    for n in (126, 828, 1024):
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
        # every cluster size the device schedules, for the default's choice
        sweep, cs = {}, 1
        while cs <= max_cluster:
            x_c, ok_c = chol._launch(S, b, cs)
            compare(f"spd_solve n={n} cluster={cs}", x_c, x_p, 5e-5)
            sweep[cs] = cuda_ms(lambda cs=cs: chol._launch(S, b, cs))
            cs *= 2
        chol_by_cluster[n] = sweep
        print(f"  spd_solve n={n} (cluster "
              f"{chol.cluster_size(n, max_cluster)}): kernel {k1:.4f} / "
              f"{k2:.4f} ms, cholesky_ex + cholesky_solve {l1:.4f} / "
              f"{l2:.4f} ms, plain {chol_plain_ms[n]:.4f} ms; by cluster "
              f"size {({c: round(t, 4) for c, t in sweep.items()})}",
              flush=True)
        if n == 828:
            S828, b828 = S, b
    for i in (5, 13 * 32 + 7, 826):
        S_bad = S828.clone()
        S_bad[i, i] = -2.0
        x_bad, ok_bad = chol.spd_solve(S_bad, b828)
        need(not bool(ok_bad) and bool((x_bad == 0).all()),
             f"spd_solve: indefinite pivot {i} not flagged with x = 0")
    print("  spd_solve indefinite n=828 (pivot in the first, a middle and "
          "the last panel): ok=False, x=0", flush=True)
    n = 828
    rows["spd_solve"] = dict(
        max_abs_err=max(e for e, _ in chol_errs),
        max_rel_err=max(r for _, r in chol_errs),
        ms=chol_ms[n], plain_ms=chol_plain_ms[n], library_ms=chol_lib_ms[n],
        ms_n126=chol_ms[126], plain_ms_n126=chol_plain_ms[126],
        library_ms_n126=chol_lib_ms[126],
        ms_n1024=chol_ms[1024], plain_ms_n1024=chol_plain_ms[1024],
        library_ms_n1024=chol_lib_ms[1024],
        ms_by_cluster=chol_by_cluster, max_cluster=max_cluster,
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

    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(10):
            ld.linearize_dense(*args, want_u=True)
            rd.gain_dense(*gargs)
            chol.spd_solve(S828, b828)
            ls.linearize_stream(*sargs, None, C, P, tables=pa.stream,
                                **tr_flags)
            rd.jgram_dense(*j2)
            ls.residual_l2(*rargs)
        torch.cuda.synchronize()
    for e in prof.key_averages():
        for k in rows:
            if f"(anonymous namespace)::{k}_kernel" in e.key:
                rows[k]["kernel_ms"] = e.self_device_time_total / 1e3 / e.count
    # the pair flags run the camera pass and the point pass: their device
    # times, each a mean over 10 calls, and their sum
    for label, call in pair_calls.items():
        with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                call()
            torch.cuda.synchronize()
        parts = {}
        for e in prof.key_averages():
            for kname in ("linearize_stream_kernel",
                          "linearize_stream_points_kernel"):
                if f"(anonymous namespace)::{kname}" in e.key:
                    parts[kname] = e.self_device_time_total / 1e3 / 10
        need(len(parts) == 2, f"linearize_stream[{label}]: the profiler saw "
             f"{sorted(parts)}, not both passes")
        pair_stream[f"kernel_ms_{label}"] = sum(parts.values())
        pair_stream[f"kernel_ms_{label}_passes"] = parts
        print(f"[2] linearize_stream[{label}]: wrapper "
              f"{pair_stream[f'ms_{label}']:.4f} ms (kernels alone "
              f"{sum(parts.values()):.4f} ms: camera pass "
              f"{parts['linearize_stream_kernel']:.4f}, point pass "
              f"{parts['linearize_stream_points_kernel']:.4f}), plain "
              f"{pair_stream[f'plain_ms_{label}']:.4f} ms, bound "
              f"{pair_stream[f'bound_ms_{label}']:.4f} ms", flush=True)
    rows["linearize_stream"].update(pair_stream)
    del pair_calls
    for k, v in rows.items():
        need("kernel_ms" in v, f"{k}: kernel not seen by the profiler")
        lib = ("none" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        print(f"[2] {k}: wrapper {v['ms']:.4f} ms (kernel alone "
              f"{v['kernel_ms']:.4f} ms), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), library "
              f"{lib}", flush=True)
    del out_k, pa, gram, j2, rargs
    torch.cuda.empty_cache()

    # ---- phase 3: the main paths
    kern = {"linearize_dense": ld.linearize_dense, "gain_dense": rd.gain_dense,
            "spd_solve": chol.spd_solve,
            "linearize_stream": ls.linearize_stream,
            "jgram_dense": rd.jgram_dense, "residual_l2": ls.residual_l2}
    lm_path = ("linearize_dense", "spd_solve", "gain_dense")
    dense_path = lm_path + ("linearize_stream", "jgram_dense")

    def reset():
        for fn in kern.values():
            fn.launches = 0
        ls.linearize_stream.point_launches = 0
        linalg.spd_solve.oversized_launches = 0

    def read():
        got = {k: fn.launches for k, fn in kern.items()}
        got["linearize_stream_point_pass"] = (
            ls.linearize_stream.point_launches)
        return got

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
    for k in dense_path:
        need(launches[k] > 0, f"kernel {k} was not launched on the default "
             "path")

    # ---- phase 3p: the covisibility-pair path at final961_pairs
    need(big.n_cams * big.n_pts > DENSE_MAX_ENTRIES,
         "final961_pairs is not above the dense cap")
    psba_tpu_torch.solve(big, cfg_lm._replace(max_iters=2), dtype=f32,
                         device=dev)   # warm-up: batched GEMM, cholesky_ex
    pair_runs = {}
    for label, c in (("LM path", cfg_lm), ("default", cfg)):
        gmw_log.clear()
        reset()
        r = psba_tpu_torch.solve(big, c, dtype=f32, device=dev)
        got = read()
        oversized = linalg.spd_solve.oversized_launches
        per_p = per_phase_iterations(r)
        ms_p = {ph: 1e3 * r.phase_seconds[ph] / per_p[ph] for ph in per_p}
        pair_runs[label] = dict(res=r, launches=got, per=per_p, ms=ms_p,
                                oversized=oversized,
                                gmw=[(n_, t) for n_, t, _, _ in gmw_log])
        print(f"[3p] final961_pairs, {label}, schur='auto': {r}\n"
              f"[3p]   phases {r.phases}; iterations per phase {per_p}\n"
              f"[3p]   ms per LM iteration "
              f"{ms_p.get('lm', float('nan')):.3f}, per TR iteration "
              f"{ms_p.get('tr', float('nan')):.3f}\n"
              f"[3p]   launches {got}, oversized spd_solve (cholesky_ex, "
              f"n = {6 * big.n_cams}) {oversized}\n"
              f"[3p]   GMW bootstraps (n, ms, lambda) "
              f"{[(n_, round(t, 3), lam) for n_, t, lam, _ in gmw_log]}\n"
              f"[3p]   initial_error {r.initial_error:.6e} final_error "
              f"{r.final_error:.6e} flag {r.flag_name}", flush=True)
        need(np.isfinite(r.final_l2) and r.final_error < r.initial_error,
             f"pair path, {label}: error did not decrease")
        need(r.flag_name in ok_flags,
             f"pair path, {label}: abnormal stop {r.flag_name}")
        need(r.cams.shape == big.cams.shape and np.isfinite(r.cams).all()
             and np.isfinite(r.pts).all(),
             f"pair path, {label}: output parameters malformed")
        for k in ("linearize_stream", "linearize_stream_point_pass",
                  "residual_l2"):
            need(got[k] > 0, f"pair path, {label}: kernel {k} not launched")
        for k in ("linearize_dense", "gain_dense", "jgram_dense"):
            need(got[k] == 0, f"pair path, {label}: dense kernel {k} "
                 "launched, so schur='auto' did not take the pairs")
        need(oversized > 0, f"pair path, {label}: no oversized spd_solve")
    need("tr" in pair_runs["default"]["per"],
         "pair path, default: never entered TR")
    if "--profile" in argv:
        profile(prob, cfg, dev, "dense")
        profile(big, cfg, dev, "pairs")
    del big
    torch.cuda.empty_cache()

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
    # Phase 4p runs the same checks on the pair encoding, then pairs against
    # dense on CUDA: LM 20, final_l2 1e-3 and equal phases.
    mini = bal_to_problem(os.path.join(REPO, "tests", "data", "mini_bal.txt"))
    checks = ((cfg_lm._replace(max_iters=20), "LM 20", True, 0),
              (cfg_lm, "LM full", False, 3),
              (cfg._replace(max_iters=15), "default 15", True, 0),
              (cfg, "default full", False, None))
    for tag, schur in (("4", "dense"), ("4p", "pairs")):
        for c, label, strict, it_tol in checks:
            r_gpu = psba_tpu_torch.solve(mini, c, dtype=f32, device=dev,
                                         schur=schur)
            r_cpu = psba_tpu_torch.solve(mini, c, dtype=f32, device="cpu",
                                         schur=schur)
            rel = abs(r_gpu.final_l2 - r_cpu.final_l2) / r_cpu.final_l2
            print(f"[{tag}] mini_bal, schur={schur}, {label}\n"
                  f"[{tag}]   cuda: {r_gpu} {r_gpu.phases}\n"
                  f"[{tag}]   cpu:  {r_cpu} {r_cpu.phases}\n"
                  f"[{tag}]   final_l2 rel diff {rel:.3e} (tolerance 1e-3)",
                  flush=True)
            label = f"{schur}, {label}"
            need(rel <= 1e-3, f"{label}: CUDA and CPU final_l2 disagree")
            if schur == "pairs" and strict:
                # the pair path sums in a fixed order: a second CUDA run
                # gives the same bits
                again = psba_tpu_torch.solve(mini, c, dtype=f32, device=dev,
                                             schur=schur)
                need(again.final_l2 == r_gpu.final_l2,
                     f"{label}: two CUDA runs give different final_l2")
            if strict:
                need(r_gpu.flag == r_cpu.flag
                     and r_gpu.phases == r_cpu.phases,
                     f"{label}: CUDA and CPU runs stop differently")
            else:
                need(r_gpu.flag_name in ok_flags
                     and r_cpu.flag_name in ok_flags,
                     f"{label}: abnormal stop")
            if it_tol is not None:
                need(abs(r_gpu.iterations - r_cpu.iterations) <= it_tol,
                     f"{label}: CUDA and CPU iteration counts differ")
            if "default" in label:
                need("tr" in [ph for ph, _, _ in r_gpu.phases],
                     f"{label}: no TR phase")
    c20 = cfg_lm._replace(max_iters=20)
    r_p = psba_tpu_torch.solve(mini, c20, dtype=f32, device=dev,
                               schur="pairs")
    r_d = psba_tpu_torch.solve(mini, c20, dtype=f32, device=dev,
                               schur="dense")
    rel = abs(r_p.final_l2 - r_d.final_l2) / r_d.final_l2
    print(f"[4p] mini_bal, LM 20 on CUDA, pairs: {r_p} {r_p.phases}\n"
          f"[4p]   dense: {r_d} {r_d.phases}\n"
          f"[4p]   final_l2 rel diff {rel:.3e} (tolerance 1e-3)", flush=True)
    need(rel <= 1e-3 and r_p.phases == r_d.phases,
         "mini_bal LM 20: pairs and dense disagree on CUDA")

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
        "residual_l2": ("psba_tpu_torch/csrc/residual_l2.cu",
                        "psba_tpu/ops/linearize_pallas.py:347"),
    }
    pd, pl = pair_runs["default"], pair_runs["LM path"]
    src_names = list(src)
    # launches: the two default solves (dense 3b and pairs 3p) together,
    # then each main path on its own
    kernels = [
        dict(name=k, route="cuda", source=src[k][0], replaces=src[k][1],
             launches=launches[k] + pd["launches"][k],
             launches_dense_default=launches[k],
             launches_dense_lm_path=launches_lm[k],
             launches_pairs_default=pd["launches"][k],
             launches_pairs_lm_path=pl["launches"][k], **rows[k])
        for k in src
    ]
    kernels[src_names.index("linearize_stream")]["launches_point_pass"] = {
        path: got["linearize_stream_point_pass"]
        for path, got in (("dense_default", launches),
                          ("dense_lm_path", launches_lm),
                          ("pairs_default", pd["launches"]),
                          ("pairs_lm_path", pl["launches"]))}
    if "--cap" in argv:
        cap_measurement(cfg_lm, dev)
    if "--spread" in argv:
        spread_measurement(mini, cfg, dev)
    print(f"[5] total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(smi_line(), flush=True)
    pairs_line = {
        label: {"lm_iter_ms": v["ms"].get("lm"),
                "tr_iter_ms": v["ms"].get("tr"), "iterations": v["per"],
                "phases": v["res"].phases, "gmw_ms": v["gmw"],
                "oversized_spd_solve": v["oversized"],
                "initial_error": v["res"].initial_error,
                "final_error": v["res"].final_error}
        for label, v in pair_runs.items()
    }
    print(json.dumps({
        "kernels": kernels,
        "lm_iter_ms": ms_it.get("lm"), "tr_iter_ms": ms_it.get("tr"),
        "iterations": per, "phases": res.phases, "gmw_ms": gmw_ms,
        "initial_error": res.initial_error, "final_error": res.final_error,
        "lm_path": {"lm_iter_ms": ms_lm_only,
                    "iterations": res_lm.iterations,
                    "final_error": res_lm.final_error},
        "final961_pairs": pairs_line,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cap_measurement(cfg_lm, dev) -> None:
    """ms per LM iteration of schur="dense" and schur="pairs" at
    Dubrovnik-356's counts (80.7M cells): five LM iterations from the same
    start after a one-iteration warm-up, with the tries and the peak device
    memory of each run. Its numbers are in the comment of
    solvers.types.DENSE_MAX_ENTRIES."""
    import torch

    import psba_tpu_torch
    from psba_tpu_torch.ops import linearize_stream as ls
    from psba_tpu_torch.ops import residual_dense as rd

    prob, secs = ring_problem(**DUBROVNIK356)
    print(f"[cap] Dubrovnik-356 counts: C={prob.n_cams} P={prob.n_pts} "
          f"O={prob.n_obs}, {len(prob.pair_o1)} pairs, C*P = "
          f"{prob.n_cams * prob.n_pts} cells (built in {secs:.1f} s)",
          flush=True)
    f32 = torch.float32
    c5 = cfg_lm._replace(max_iters=5)
    for schur in ("pairs", "dense"):
        psba_tpu_torch.solve(prob, c5._replace(max_iters=1), dtype=f32,
                             device=dev, schur=schur)
        torch.cuda.reset_peak_memory_stats(dev)
        rd.gain_dense.launches = ls.residual_l2.launches = 0
        r = psba_tpu_torch.solve(prob, c5, dtype=f32, device=dev,
                                 schur=schur)
        tries = rd.gain_dense.launches + ls.residual_l2.launches
        ms = 1e3 * r.phase_seconds["lm"] / r.iterations
        print(f"[cap] schur={schur}: {r}; {r.iterations} LM iterations, "
              f"{tries} tries; {ms:.3f} ms per LM iteration, "
              f"{1e3 * r.phase_seconds['lm'] / tries:.3f} ms per try; peak "
              f"device memory "
              f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB",
              flush=True)
        torch.cuda.empty_cache()


def spread_measurement(mini, cfg, dev, runs: int = 100) -> None:
    """Phase 4p's "pairs, default 15" check (mini_bal, 15 iterations of the
    default config on the pair encoding: LM to 14, one TR step from the GMW
    bootstrap) run `runs` times on CUDA in four arms, each reading
    |final_l2 - CPU final_l2| / CPU final_l2 against one CPU run: as
    shipped (the pair path's bucket sums S, ea, eb by ops.reduce
    .indexed_sum, in a fixed order); with those sums by `index_add_` on the
    card (float atomics); with them on the host; and that with the reduced
    system solved by spd_solve's plain version on the card instead of the
    kernel. Prints each arm's readings (sorted) and writes them to
    chiprun_out/spread.json."""
    import numpy as np
    import torch

    import psba_tpu_torch
    from psba_tpu_torch.core import schur as schur_mod
    from psba_tpu_torch.ops import cholesky as chol
    from psba_tpu_torch.ops import reduce as red

    f32 = torch.float32
    c15 = cfg._replace(max_iters=15)
    ref = psba_tpu_torch.solve(mini, c15, dtype=f32, device="cpu",
                               schur="pairs").final_l2

    def atomic_sum(data, idx, n):
        idx = idx.long()
        idx = torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))
        out = torch.zeros((n + 1,) + tuple(data.shape[1:]), dtype=data.dtype,
                          device=data.device)
        return out.index_add_(0, idx, data)[:n]

    def host_sum(data, idx, n):
        return red.indexed_sum(data.cpu(), idx.cpu(), n).to(data.device)

    kernel_solve, shipped_sum = chol.spd_solve, schur_mod.indexed_sum
    arms = (("as shipped", shipped_sum, kernel_solve),
            ("bucket sums by index_add_ on the card", atomic_sum,
             kernel_solve),
            ("bucket sums on the host", host_sum, kernel_solve),
            ("bucket sums on the host, plain spd_solve", host_sum,
             chol.spd_solve_plain))
    out = {}
    try:
        for label, summer, solver in arms:
            schur_mod.indexed_sum, chol.spd_solve = summer, solver
            rel = sorted(
                abs(psba_tpu_torch.solve(mini, c15, dtype=f32, device=dev,
                                         schur="pairs").final_l2 - ref) / ref
                for _ in range(runs))
            out[label] = rel
            print(f"[spread] {label}: {runs} runs, min {rel[0]:.3e}, median "
                  f"{float(np.median(rel)):.3e}, max {rel[-1]:.3e}, "
                  f"{len(set(rel))} distinct, {sum(r > 1e-3 for r in rel)} "
                  f"over 1e-3", flush=True)
    finally:
        schur_mod.indexed_sum, chol.spd_solve = shipped_sum, kernel_solve
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "spread.json"), "w") as f:
        json.dump(out, f)


def profile(prob, cfg, dev, schur) -> None:
    """torch.profiler tables of three LM iterations (lm_run alone) and three
    TR iterations (tr_run alone, entered with lambda = 1 so the table shows
    a steady TR iteration rather than the GMW bootstrap) on the `schur`
    encoding, each after a warm-up: kernel time by name (written to
    chiprun_out/profile_<schur>_<lm|tr>3.txt) and the device's busy share
    (printed)."""
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
    pa = ProblemArrays.from_problem(prob, dtype=f32, device=dev, schur=schur)
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
        summary = (f"[profile] {schur}: OptState.init + {name}_run, "
                   f"{out.itno} iterations: wall {wall_ms:.3f} ms (profiler "
                   f"off), device busy {busy:.3f} ms (profiler on), idle "
                   f"share {1 - busy / wall_ms:.3f}")
        path = os.path.join(OUT_DIR, f"profile_{schur}_{name}3.txt")
        with open(path, "w") as f:
            f.write(summary + "\n" + table)
        print(f"{summary}; table in {os.path.relpath(path, REPO)}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
