#!/usr/bin/env python3
"""Smoke test of psba_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py              # the whole check, one card
    python3 chip_smoke.py --profile    # also torch.profiler tables of three
                                       # LM and three TR iterations on the
                                       # dense path (float32 and float64,
                                       # and ladybug138_real) and the pair
                                       # path, under chiprun_out/
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
     main paths' shapes (the trial-step residual, the observation stream
     with the pair path's LM and TR flags and the pair Schur product, also
     against float64, at final961_pairs below; the
     others at 138 cameras x 19,878 requested points, the counts of BAL's
     Ladybug-138: n = 126 / 828 reduced systems and n = 1024, the largest
     the kernel takes, each at every cluster size the card schedules, the
     observation stream with the TR flags and with every flag, the J-gram
     at n = 1-4 in both direction forms and on an empty grid, the dense
     linearization with and without U; the trial-step residual with and
     without its fused gain; these dense checks pass no occupancy table),
     with the tolerance stated, CUDA-event times
     (median after warm-up), each kernel's device time from the profiler
     (for linearize_dense, gain_dense, jgram_dense, residual_l2 and
     schur_pairs also their launches and torch ops per call, host time,
     and two calls checked bit-identical), its bound
     (the larger of bytes over HBM bandwidth and flops over the float32
     rate) and, where one PyTorch call computes the same function, that
     call's time;
  2t. the (camera, tile) skip of the three dense kernels on both dense
     problems, each clustered as the dense solve clusters it: the
     138-camera one (93% of its cells observed) and ladybug138_real (below,
     about 3%): masked kernel against masked plain version, against the
     unmasked kernel (the same bits) and with an observed tile's bit
     cleared; wrapper and device times masked and unmasked, the occupancy
     before and after clustering, and the bound of the masked work;
  3. the dense main paths (solve clusters the points on the dense
     encoding), each with the launch counters reset just before and read
     just after: psba_tpu_torch.solve in float32 with the LM->TR switch
     off (the LM path, three kernels), then with the default SolverConfig
     (LM -> TR -> ..., five kernels; ms per LM and per TR iteration and the
     GMW bootstrap's time printed);
  3r. the same two solves on ladybug138_real, which solve(schur="auto")
     must put on the dense encoding by itself, then three LM iterations
     (OptState.init + lm_run) in turns on the caller's point order without
     the occupancy table and on the clustered order with it: final L2
     within 1e-4, ms per iteration of each;
  3p. the covisibility-pair main path at Final-961's counts
     (final961_pairs: 961 cameras of the synthetic ring, 187,103 points,
     about 9 observations each), which solve(schur="auto") must put on the
     pair encoding by itself: LM only, then the default config, counters
     reset and read around each (the pair Schur kernel once a try);
  3d. the float64 path: the default float64 solve of the 138-camera problem
     (the XLA form: cuBLAS DGEMM, cuSOLVER, torch ops), counters reset and
     read around it (no kernel may launch), two runs with the same final
     L2 bits, ms per LM / TR iteration, the peak device memory, and each
     stage of a float64 dense LM try timed by CUDA events (the S DGEMM
     among them);
  3o. the float32 default solve of that problem with polish_iters=5: the
     float32 part launches the kernels, "lm64" comes last, and the polish
     ends at or below the float64 L2 where it starts;
  3p. the covisibility-pair main path at Final-961's counts (below);
  3x. three float64 LM iterations on final961_pairs (the XLA form of the
     pair family): ms per iteration and peak device memory;
  3g. TR from the start on the 6-camera synthetic problem with an unobserved
     camera appended (the GMW bootstrap), on CUDA and on the CPU;
  4. tests/data/mini_bal.txt on CUDA and on the CPU (plain versions), with
     the LM-only and the default config, held together;
  4p. the same on the pair encoding (where two CUDA runs of a fixed budget
     must also give the same final_l2), and pairs against dense on CUDA;
  4d. float64 on mini_bal, both encodings, CUDA against CPU: LM rows at a
     budget of 20 to 1e-9, then the default config, final L2 as in phase 4;
  6. the CLI on the card: the 138-camera problem written as an SBA text
     pair, `python -m psba_tpu_torch.cli` on it in float64 (the default)
     and with --f32 --polish 3, each in a subprocess; the points file's
     read time with the native and with the numpy reader;
  7. the sharded solve (psba_tpu_torch.parallel): 7a one NCCL rank in this
     process (init_distributed, solve_distributed), three float32 LM
     iterations on ladybug138_real (dense) and final961_pairs (pairs), the
     same bits as lm_run, ms per iteration, launches, collective bytes and
     ms per try; 7b two spawned ranks on the one card over gloo (NCCL
     takes one rank a device), the default solve of the 138-camera problem
     with s_reduce "psum" and "scatter", against phase 3b's solve, every
     dense kernel launched on each rank; (see one_rank_phase and
     two_rank_phase);
  3h. s_precision="high" (run in full float32 on the card, a named
     deviation from the reference's 3-pass products): (a) S of the
     138-camera problem's first try computed "high", "highest" and in
     single-pass TF32, each against float64 (the products' normwise
     relative error; high at most 2 x highest + 2^-21 and a tenth of
     TF32's), and CUDA-event ms of S and its products; (b, c) the default
     solve of the 138-camera problem and of ladybug138_real in turns
     "highest", "high", "high", "highest", counters reset and read around
     each: final L2 of "high" within 1e-3 of "highest", a normal stop, the
     dense kernels launched, TF32 off after each; ms per LM / TR iteration
     and peak device memory; (d) utils/roofline.summarize of a 138-camera
     LM iteration at both precisions;
  8. the front-end (psba_tpu_torch.frontend) on the card: 8 views at
     1024 x 768 of 600 planted points, n_features=1024, sequence_problem
     on CUDA against the CPU (corners, matches, poses to 1e-4), each
     stage's ms, then the problem solved on the card in float32 (counters
     reset and read around it; the LM path's kernels launched, RMS under
     1 px);
  9. the direct entry, as a bench drives lm_run: ProblemArrays.
     from_problem(p, dtype=float32) with no device -> OptState.init ->
     resolve_damping -> lm_run(iter_cap=3), counters reset and read
     around it, on the 138-camera problem (dense; linearize_dense,
     spd_solve, gain_dense launched) and on final961_pairs (pairs;
     linearize_stream, residual_l2): every tensor on cuda, the final L2
     the bits of the same run with device="cuda", ms per LM iteration;
     then parallel.shard.make_sharded_lm_repeat on one NCCL rank
     (lm_repeat_rank) on ladybug138_real, iter_cap 3 x 3 repeats:
     total_itno 9, acc_l2 the bits of 3 x the single run's L2, ms per
     repeat (see direct_entry_phase; the "direct" key);
  5. a JSON line of the kernels and the paths, then, last, the device JSON
     line.
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

sys.path.insert(0, REPO)
# the H100's peaks and the kernels' per-cell operation counts, from the
# port's roofline model (without the package beside it the script stops
# here)
from psba_tpu_torch.utils.roofline import (  # noqa: E402
    CELL_LINEARIZE_FLOPS,
    GAIN_DENSE_FLOPS,
    H100,
    LINEARIZE_DENSE_FLOPS,
    LINEARIZE_DENSE_U_FLOPS,
    LINEARIZE_STREAM_FLOPS,
    PAIR_STREAM_FLOPS,
    RESIDUAL_L2_FLOPS,
    RESIDUAL_L2_GAIN_FLOPS,
)

# H100 SXM peaks (NVIDIA data sheet): HBM3 bandwidth, float32 outside the
# tensor cores. The bound of a kernel is the larger of its bytes over the
# first and its flops over the second.
HBM_BYTES_PER_S = H100.hbm_gbps * 1e9
F32_FLOPS_PER_S = H100.f32_tflops * 1e12
# float64 on the tensor cores (DGEMM), same data sheet
F64_TC_FLOPS_PER_S = 67e12

# The pair path's configuration, final961_pairs: BAL's Final-961 camera and
# point counts (961 cameras, 187,103 points) on the synthetic ring, about 9
# observations per point. C * P = 180M cells, above the dense cap, so
# schur="auto" takes the pair encoding.
FINAL961 = dict(n_cams=961, n_pts=187_103, mean_obs=9.0)
# The dense path at a real density, ladybug138_real: BAL Ladybug-138-19878's
# camera and point counts on the synthetic ring, each point capped at
# round(4.3) = 4 views (about 80k observations against BAL's 85,217, some 3%
# of the 2.7M cells, where synthetic_problem(138, 19878) observes 93%).
# C * P is under the dense cap, so schur="auto" takes the dense encoding.
LADYBUG138_REAL = dict(n_cams=138, n_pts=19_878, mean_obs=4.3)
# Dubrovnik-356's counts (80.7M cells, 5 observations per point): the --cap
# measurement, which placed the dense cap (DENSE_MAX_ENTRIES) below it.
DUBROVNIK356 = dict(n_cams=356, n_pts=226_730, mean_obs=5.0)


def jgram_flops_full_model(n: int) -> int:
    """The J-gram's count before its redesign, per observed cell: the
    whole cell_linearize, then J x for n directions (2 rows x 17) and the
    n(n+1)/2 upper-triangle products (4 each)."""
    return CELL_LINEARIZE_FLOPS + 34 * n + 2 * n * (n + 1)


def jgram_flops(n: int) -> int:
    """Per observed cell, counted from csrc/jgram_dense.cu (an FMA as
    two, a product the compiler shares counted once): X0 = R(q0) X 15,
    w 9, p_c = R X + t 18, 1/p3 1, dp_c/dv 44 (g 9, cdot 5, M 30), the
    masked projection factors 6 (93 in all); per direction y = M omega +
    tau + R dp 36 and J x 8; per pair 4."""
    return 93 + 44 * n + 2 * n * (n + 1)


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


def kernel_records(prof, name) -> list:
    """The device records in a profile of the kernel `name`, or of a
    template instance of it."""
    import torch

    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and (f"::{name}(" in e.name or f"::{name}<" in e.name)]


def complete_profile(run, counted, activities, tries: int = 5):
    """torch.profiler over run(), taken again until it holds one device
    record for each launch the wrappers counted. `counted` lists (wrapper,
    counter attribute, the kernels one counted launch runs). CUPTI now and
    then drops some or all of a window's device records, at times in a few
    windows in a row; such a profile is taken again, up to `tries` in all.
    Returns the profile."""
    import torch
    from torch.profiler import profile as tprofile

    for attempt in range(1, tries + 1):
        before = [getattr(w, attr) for w, attr, _ in counted]
        with tprofile(activities=activities) as prof:
            run()
            torch.cuda.synchronize()
        lost = {}
        for (w, attr, names), b in zip(counted, before):
            launched = getattr(w, attr) - b
            for k in names:
                seen = len(kernel_records(prof, k))
                if seen != launched:
                    lost[k] = f"{seen} records of {launched} launches"
        if not lost:
            return prof
        print(f"  profile {attempt} of {tries} lost device records: {lost}",
              flush=True)
        time.sleep(0.1 * attempt)
    need(False, f"the profiler lost device records in {tries} profiles: "
         f"{lost}")


def call_profile(fn, wrapper, names, reps: int = 10) -> dict:
    """What one call of fn does on the card, from a complete profile of
    `reps` calls after a warm-up (`wrapper`'s counted launches each run the
    kernels `names`): its device launches (kernels, copies, fills) per call
    by name, and the torch ops it runs per call."""
    import re

    import torch
    from torch.profiler import ProfilerActivity

    fn()
    torch.cuda.synchronize()
    prof = complete_profile(
        lambda: [fn() for _ in range(reps)],
        [(wrapper, "launches", names)],
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    kernels, ops = {}, {}
    for e in prof.key_averages():
        if (e.device_type == torch.autograd.DeviceType.CUDA
                and not e.is_user_annotation):
            name = re.search(r"(\w+)\(", e.key)
            kernels[name.group(1) if name else e.key] = e.count / reps
        elif e.key.startswith("aten::"):
            ops[e.key] = e.count / reps
    return dict(launches_per_call=sum(kernels.values()), kernels=kernels,
                torch_ops=ops)


def clean_l2_kernel_ms(fn, wrapper, kernels, reps: int = 10) -> dict:
    """Device ms per call of each named kernel of fn (the kernels one
    counted launch of `wrapper` runs), median over `reps` calls, each after
    a read of 256 MB that leaves the 50 MB L2 holding no dirty line of an
    earlier kernel: the call's own traffic only."""
    import statistics

    import torch
    from torch.profiler import ProfilerActivity

    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            flush.sum()
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()

    prof = complete_profile(run, [(wrapper, "launches", kernels)],
                            [ProfilerActivity.CUDA])
    return {k: statistics.median(e.self_device_time_total / 1e3
                                 for e in kernel_records(prof, k))
            for k in kernels}


def host_ms(fn, reps: int = 200) -> float:
    """Median host milliseconds of one call of fn (the card idle when it
    starts): the wrapper's own work, launches included, not the device's."""
    import statistics

    import torch

    fn()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t))
    torch.cuda.synchronize()
    return statistics.median(times)


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
    last 1,000 observations, each also with the old residual (the
    residual at the unperturbed cameras), whose fused gain is held to
    error_l2_diff on the same tensors; two calls bit-identical, launches
    and torch ops per call, host time, and the kernel with L2 clean with
    and without the gain, each against its own bound. Returns (its row of
    the kernels line, the unmasked arguments)."""
    import numpy as np
    import torch

    from psba_tpu_torch.core.residual import error_l2_diff
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
    kq = torch.cat([args[0], args[1]], dim=1)
    ex_old = ls.residual_l2_plain(args[0], args[1], f(prob.cams),
                                  *args[3:])[0]
    eo2 = float((ex_old.double() ** 2).sum())
    valid = (torch.arange(O, device=dev) < O - 1000).to(f32)
    table_cams = ls._residual_kernel()[1]
    print(f"  residual_l2: camera table in shared memory up to "
          f"{table_cams} cameras (C = {C})", flush=True)
    need(C <= table_cams, "residual_l2: final961_pairs' cameras do not fit "
         "the shared-memory table")
    # ex = obs - proj: the kernel (with fused multiply-adds) and the plain
    # version each round the camera-frame point and the projection (up to
    # ~6e2 px) in float32, and points close to a camera (depth down to 0.3
    # against coordinates up to ~15) magnify that rounding to ~1e-3 px; so
    # ex is held to 1e-4 of max |ex| against the plain version and against
    # the float64 evaluation of the same inputs, as linearize_stream's ex.
    # l2, a sum of 1.7M positive terms in another order: 1e-5. The gain, a
    # sum of both signs, to 1e-5 of sum |eo|^2 against error_l2_diff of the
    # same ex_old and the kernel's ex.
    ex64, _ = ls.residual_l2_plain(*(a.double() if a.is_floating_point()
                                     else a for a in args))
    errs, l2s = [], []
    for label, vm in (("no mask", None), ("mask", valid)):
        ex_k, l2_k = ls.residual_l2(*args, vm, kq=kq)
        ex_p, l2_p = ls.residual_l2_plain(*args, vm)
        fused = ls.residual_l2(*args, vm, kq=kq, ex_old=ex_old)
        again = ls.residual_l2(*args, vm, kq=kq, ex_old=ex_old)
        torch.cuda.synchronize()
        need(ex_k.shape == (O, 2), f"residual_l2 ex shape {ex_k.shape}")
        errs.append(compare(f"residual_l2[{label}] ex", ex_k, ex_p, 1e-4))
        compare(f"residual_l2[{label}] ex vs f64", ex_k, ex64, 1e-4)
        compare(f"plain[{label}] ex vs f64", ex_p, ex64, 1e-4)
        errs.append(compare(f"residual_l2[{label}] l2", l2_k, l2_p, 1e-5))
        gain_ref = error_l2_diff(ex_old, fused[0],
                                 None if vm is None else vm > 0)
        g_err = abs(float(fused[2]) - float(gain_ref))
        print(f"  residual_l2[{label}] gain {float(fused[2]):.6e} vs "
              f"error_l2_diff {float(gain_ref):.6e}: |diff| {g_err:.3e} = "
              f"{g_err / eo2:.3e} of sum |eo|^2 (tolerance 1e-5)", flush=True)
        need(g_err <= 1e-5 * eo2 and bool(torch.isfinite(fused[2])),
             f"residual_l2[{label}]: fused gain and error_l2_diff disagree")
        errs.append((g_err, g_err / eo2))
        need(all(bool((a == b).all()) for a, b in zip(fused, again))
             and bool((fused[0] == ex_k).all()) and bool(fused[1] == l2_k),
             f"residual_l2[{label}]: two calls give different bits")
        l2s.append(float(l2_k))
    print("  residual_l2: ex, l2 and gain bit-identical over two calls, "
          "with and without the gain", flush=True)
    tail = float((ex_k[-1000:] ** 2).sum())
    print(f"  residual_l2 l2 {l2s[0]:.6e}, masked {l2s[1]:.6e}, the dropped "
          f"tail {tail:.6e}", flush=True)
    need(abs(l2s[0] - l2s[1] - tail) <= 1e-5 * l2s[0],
         "residual_l2: the mask does not drop the last observations")
    call = lambda: ls.residual_l2(*args, kq=kq)
    gcall = lambda: ls.residual_l2(*args, kq=kq, ex_old=ex_old)
    kname = "residual_l2_kernel"
    prof, gprof = (call_profile(call, ls.residual_l2, (kname,)),
                   call_profile(gcall, ls.residual_l2, (kname,)))
    for tag, pr in (("", prof), (" with the gain", gprof)):
        print(f"  residual_l2{tag}: per call {pr['launches_per_call']} "
              f"launches {pr['kernels']}, torch ops {pr['torch_ops']}",
              flush=True)
        # one allocation and its views, none of which launches device work
        need(pr["launches_per_call"] == 1
             and set(pr["torch_ops"]) <= {"aten::empty", "aten::as_strided"},
             f"residual_l2{tag}: not one launch, or a torch op beyond the "
             f"allocation of its outputs ({pr['kernels']}, "
             f"{pr['torch_ops']})")
    # reads K | q0 | cams, the points, obs and the two int32 index streams
    # once (and ex_old with the gain); writes ex
    b_plain = bound(4 * 15 * C + 12 * P + O * (8 + 8 + 8),
                    RESIDUAL_L2_FLOPS * O)
    b_gain = bound(4 * 15 * C + 12 * P + O * (8 + 8 + 8 + 8),
                   RESIDUAL_L2_GAIN_FLOPS * O)
    row = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=cuda_ms(call), host_ms=host_ms(call),
        kernel_ms_clean_l2=clean_l2_kernel_ms(call, ls.residual_l2,
                                              (kname,))[kname],
        launches_per_call=prof["launches_per_call"],
        torch_ops_per_call=prof["torch_ops"],
        ms_gain=cuda_ms(gcall), host_ms_gain=host_ms(gcall),
        kernel_ms_clean_l2_gain=clean_l2_kernel_ms(
            gcall, ls.residual_l2, (kname,))[kname],
        launches_per_call_gain=gprof["launches_per_call"],
        torch_ops_per_call_gain=gprof["torch_ops"],
        bound_ms_gain=b_gain["bound_ms"], bound_by_gain=b_gain["bound_by"],
        table_cameras=table_cams,
        plain_ms=cuda_ms(lambda: ls.residual_l2_plain(*args), warmup=1,
                         runs=5),
        plain_ms_gain=cuda_ms(lambda: ls.residual_l2_plain(
            *args, ex_old=ex_old), warmup=1, runs=5),
        library_ms=None,
        **b_plain,
    )
    print(f"  residual_l2: wrapper {row['ms']:.4f} ms (host "
          f"{row['host_ms']:.4f} ms), kernel with L2 clean "
          f"{row['kernel_ms_clean_l2']:.4f} ms, bound "
          f"{row['bound_ms']:.4f} ms; with the gain: wrapper "
          f"{row['ms_gain']:.4f} ms (host {row['host_ms_gain']:.4f} ms), "
          f"kernel with L2 clean {row['kernel_ms_clean_l2_gain']:.4f} ms, "
          f"bound {row['bound_ms_gain']:.4f} ms ({row['bound_by_gain']})",
          flush=True)
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


def check_schur_pairs(prob, dev):
    """The pair Schur kernel (ops.schur_pairs) on CUDA tensors at `prob`'s
    pair list, Y and W [O, 6, 3] unit normals from a seed: against its
    plain version (the batched product and index_put_ bucket sum it
    replaced) and against that sum in float64, each to 1e-5 of max |S|
    (bucket sums of up to thousands of float32 products of unit normals,
    in the kernel's lane order against index_put_'s; a kernel that drops,
    repeats or misplaces a pair is off by the size of a product, about a
    thousandth of max |S|), every entry finite, two calls bit-identical;
    then wrapper, host and plain times, launches and torch ops per call,
    and the bound. Returns (the kernel's row, its arguments)."""
    import torch

    from psba_tpu_torch.ops import schur_pairs as sp

    C, O = prob.n_cams, prob.n_obs
    i = lambda a: torch.as_tensor(a, dtype=torch.int64, device=dev)
    o1, o2, bucket = i(prob.pair_o1), i(prob.pair_o2), i(prob.pair_bucket)
    start = sp.pair_offsets(bucket, C)
    N = int(start[-1])
    g = torch.Generator(device=dev).manual_seed(0)
    Y = torch.randn((O, 6, 3), generator=g, device=dev)
    W = torch.randn((O, 6, 3), generator=g, device=dev)
    args = (Y, W, o1, o2, bucket, start, C)
    got = sp.schur_pairs(*args)
    again = sp.schur_pairs(*args)
    errs = [compare("schur_pairs vs plain", got,
                    sp.schur_pairs_plain(Y, W, o1, o2, bucket, C), 1e-5)]
    torch.cuda.empty_cache()
    errs.append(compare("schur_pairs vs float64", got, sp.schur_pairs_plain(
        Y.double(), W.double(), o1, o2, bucket, C), 1e-5))
    need(torch.equal(got.view(torch.int32), again.view(torch.int32)),
         "schur_pairs: two calls give different bits")
    del got, again
    torch.cuda.empty_cache()
    call = lambda: sp.schur_pairs(*args)
    prof = call_profile(call, sp.schur_pairs, ("schur_pairs_kernel",))
    # reads each pair's two indices once, each Y and W row once, the
    # offsets once; writes S once; 108 FMAs a pair
    row = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=cuda_ms(call), host_ms=host_ms(call),
        launches_per_call=prof["launches_per_call"],
        torch_ops_per_call=prof["torch_ops"],
        plain_ms=cuda_ms(lambda: sp.schur_pairs_plain(Y, W, o1, o2, bucket,
                                                      C), warmup=1, runs=5),
        library_ms=None, pairs=N,
        **bound(16 * N + 144 * O + 8 * (C * C + 1) + 144 * C * C, 216 * N),
    )
    print(f"  schur_pairs: {N} pairs in {C * C} buckets; wrapper "
          f"{row['ms']:.4f} ms (host {row['host_ms']:.4f} ms), plain "
          f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
          f"({row['bound_by']}); per call {prof['launches_per_call']} "
          f"launches {prof['kernels']}, torch ops {prof['torch_ops']}; two "
          "calls bit-identical", flush=True)
    need(prof["launches_per_call"] == 1
         and set(prof["torch_ops"]) <= {"aten::empty"},
         f"schur_pairs: not one launch and its output's allocation per "
         f"call ({prof['kernels']}, {prof['torch_ops']})")
    return row, args


def occupancy(prob, n_tiles):
    """[C, n_tiles] bool: camera c observes a point of 128-point tile t,
    from the observation list."""
    import numpy as np

    occ = np.zeros((prob.n_cams, n_tiles), bool)
    occ[prob.cam_idx, np.asarray(prob.pt_idx) // 128] = True
    return occ


def check_tile_skip(label, prob, dev) -> dict:
    """The three dense kernels with the occupancy table on `prob` clustered
    as the dense solve clusters it (BAProblem.with_tile_point_order):
    linearize_dense with and without U, gain_dense and jgram_dense at
    n = 1, 2, 4. Each masked kernel is held to its masked plain version
    (the phase-2 tolerances), to the unmasked kernel (the same bits; the
    walks keep their order) and to itself on a second call; with one
    observed tile's bit cleared, the kernel is held to the plain version
    with that table (so the skip is taken). Then in turns (unmasked,
    masked, masked, unmasked) the wrapper's CUDA-event median, and the
    kernels' device time with L2 clean, masked and unmasked; the (camera,
    tile) occupancy in the caller's order and clustered; and the bound of
    the masked work (the tables read only in occupied pairs) beside the
    unmasked one. Returns the summary for the kernels line."""
    import numpy as np
    import torch

    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.ops import residual_dense as rd
    from psba_tpu_torch.solvers import ProblemArrays

    f32 = torch.float32
    C, P, O = prob.n_cams, prob.n_pts, prob.n_obs
    Pp = ld.padded_points(P)
    n_tiles = Pp // ld.PTILE
    t0 = time.perf_counter()
    p2, _newpos = prob.with_tile_point_order()
    cluster_s = time.perf_counter() - t0
    pa = ProblemArrays.from_problem(p2, dtype=f32, device=dev,
                                    schur="dense")
    mask = pa.tile_mask
    need(np.array_equal(mask.cpu().numpy() > 0, occupancy(p2, n_tiles)),
         f"{label}: tile_mask is not the occupancy")
    occ_nat = float(occupancy(prob, n_tiles).mean())
    occ = float(mask.double().mean())
    # cells the masked kernels visit: each occupied pair's tile width
    width = torch.clamp(P - ld.PTILE * torch.arange(n_tiles, device=dev),
                        max=ld.PTILE)
    live_cells = int((mask * width).sum())
    print(f"[2t] {label}: C={C} P={P} O={O}, {O / (C * P):.4f} of the cells "
          f"observed; occupied (camera, tile) pairs {occ_nat:.4f} in the "
          f"caller's order, {occ:.4f} clustered ({int(mask.sum())} of "
          f"{mask.numel()}; clustering took {cluster_s:.2f} s on the host)",
          flush=True)
    rng = np.random.default_rng(5)
    f = lambda a: torch.as_tensor(a, dtype=f32, device=dev)
    cams = f(p2.cams + np.concatenate(
        [1e-3 * rng.standard_normal((C, 3)),
         1e-2 * rng.standard_normal((C, 3))], axis=1))
    pts = f(p2.pts)
    new = (cams + f(1e-4 * rng.standard_normal(cams.shape)),
           pts + f(1e-3 * rng.standard_normal(pts.shape)))
    base = (pa.K, pa.q0, cams, pts)
    cut = mask.clone()
    c_cut = C // 2
    cut[c_cut, int(torch.nonzero(cut[c_cut])[0])] = 0
    cam_bytes, mask_bytes = 4 * 15 * C, 4 * C * n_tiles
    lin_idx = {True: (0, 1, 2, 3, 4, 6, 7), False: (0, 1, 2, 3, 4)}
    lin_tol = {0: 1e-5, 1: 1e-5, 2: 1e-5, 3: 1e-4, 4: 1e-3, 6: 1e-4,
               7: 1e-3}
    lin_out = {0: "ZW0", 1: "ZW1", 2: "ZW2", 3: "Vp", 4: "gbp", 6: "U",
               7: "ga"}
    cases = {}
    for want_u in (True, False):
        idx = lin_idx[want_u]
        cases["linearize_dense" + ("" if want_u else "[no U]")] = dict(
            run=lambda fn, m, want_u=want_u, idx=idx: [
                fn(*base, pa.obs_du, pa.obs_dv, pa.valid_d, want_u=want_u,
                   kq=pa.kq, tile_mask=m)[i] for i in idx],
            kernel=ld.linearize_dense, plain=ld.linearize_dense_plain,
            tols=[lin_tol[i] for i in idx], outs=[lin_out[i] for i in idx],
            names=("linearize_dense_kernel",
                   "linearize_dense_finish_kernel"),
            bytes_fixed=cam_bytes + 12 * P + 4 * (
                18 * C * Pp + 12 * Pp + (42 * C if want_u else 0)),
            table_bytes=12,
            flops=(LINEARIZE_DENSE_FLOPS if want_u else
                   LINEARIZE_DENSE_FLOPS - LINEARIZE_DENSE_U_FLOPS) * O)
    cases["gain_dense"] = dict(
        run=lambda fn, m: list(fn(*base, *new, pa.obs_du, pa.obs_dv,
                                  pa.valid_d, kq=pa.kq, tile_mask=m)),
        kernel=rd.gain_dense, plain=rd.gain_dense_plain, tols=[1e-3, 1e-4],
        outs=["gain", "new_l2"], names=("gain_dense_kernel",), bytes_fixed=cam_bytes + 4 * 6 * C
        + 24 * P + 8, table_bytes=12, flops=GAIN_DENSE_FLOPS * O)
    for n in (1, 2, 4):
        g = np.random.default_rng(200 + n)
        dc = f(g.standard_normal((n, C, 6)))
        dp = f(g.standard_normal((n, 3, Pp)))
        cases[f"jgram_dense[n={n}]"] = dict(
            run=lambda fn, m, dc=dc, dp=dp: [fn(*base, pa.valid_d, dc, dp,
                                                kq=pa.kq, tile_mask=m)],
            kernel=rd.jgram_dense, plain=rd.jgram_dense_plain, tols=[1e-4],
            outs=["G"], names=("jgram_dense_kernel",),
            bytes_fixed=cam_bytes + 12 * P + 4 * n * (6 * C + 3 * P)
            + 4 * n * n, table_bytes=4, flops=jgram_flops(n) * O)
    out = dict(C=C, P=P, O=O, observed_share=O / (C * P),
               occupancy_natural=occ_nat, occupancy_clustered=occ,
               occupied_pairs=int(mask.sum()), pairs=mask.numel(),
               live_cells=live_cells, kernels={})
    for name, k in cases.items():
        kern = k["kernel"]
        # the plain versions take no K | q0 rows
        plain = lambda *a, kq=None, k=k, **kw: k["plain"](*a, **kw)
        plain_of = lambda m, k=k, plain=plain: k["run"](plain, m)
        masked, again = k["run"](kern, mask), k["run"](kern, mask)
        free = k["run"](kern, None)
        ref = plain_of(mask)
        torch.cuda.synchronize()
        errs = []
        for o, a, b, c, r, tol in zip(k["outs"], masked, again, free, ref,
                                      k["tols"]):
            errs.append(compare(f"{name} {o} masked", a, r, tol))
            need(bool((a == b).all()), f"{label} {name} {o}: two masked "
                 "calls give different bits")
            need(bool((a == c).all()), f"{label} {name} {o}: masked and "
                 "unmasked kernels give different bits")
        got, want = k["run"](kern, cut), plain_of(cut)
        for o, a, r, tol in zip(k["outs"], got, want, k["tols"]):
            compare(f"{name} {o} bit cleared", a, r, tol)
        need(not all(bool((a == b).all()) for a, b in zip(got, masked)),
             f"{label} {name}: clearing an observed tile changed nothing")
        del masked, again, free, ref, got, want
        call_m = lambda k=k: k["run"](kern, mask)
        call_u = lambda k=k: k["run"](kern, None)
        ms = [cuda_ms(c) for c in (call_u, call_m, call_m, call_u)]
        dev_u = sum(clean_l2_kernel_ms(call_u, kern, k["names"]).values())
        dev_m = sum(clean_l2_kernel_ms(call_m, kern, k["names"]).values())
        b_u = bound(k["bytes_fixed"] + k["table_bytes"] * C * P, k["flops"])
        b_m = bound(k["bytes_fixed"] + k["table_bytes"] * live_cells
                    + mask_bytes, k["flops"])
        row = dict(ms_unmasked=[ms[0], ms[3]], ms_masked=[ms[1], ms[2]],
                   kernel_ms_clean_l2_unmasked=dev_u,
                   kernel_ms_clean_l2_masked=dev_m,
                   bound_ms_unmasked=b_u["bound_ms"],
                   bound_by_unmasked=b_u["bound_by"],
                   bound_ms_masked=b_m["bound_ms"],
                   bound_by_masked=b_m["bound_by"],
                   max_abs_err=max(e for e, _ in errs),
                   max_rel_err=max(r for _, r in errs))
        out["kernels"][name] = row
        print(f"[2t] {label} {name}: kernels with L2 clean unmasked "
              f"{dev_u:.4f} ms, masked {dev_m:.4f} ms; wrapper in turns "
              f"{ms[0]:.4f} / {ms[1]:.4f} / {ms[2]:.4f} / {ms[3]:.4f} ms "
              f"(unmasked, masked, masked, unmasked); bound unmasked "
              f"{b_u['bound_ms']:.4f} ms ({b_u['bound_by']}), masked "
              f"{b_m['bound_ms']:.4f} ms ({b_m['bound_by']}); masked = "
              "unmasked bits, two calls the same bits, a cleared bit "
              "honoured", flush=True)
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
    from psba_tpu_torch.ops import schur_pairs as sp
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
    rows["schur_pairs"], spargs = check_schur_pairs(big, dev)

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
    # per-cell products (ZW) and sums over >= 10^4 f32 terms in another
    # order (V, U: 1e-4); B^T ex and A^T ex add residual-weighted terms of
    # both signs, so they carry the reference's cancellation gate (1e-3).
    # With U (the LM loop) and without (the TR loop); the calls pass the
    # solver's cached K | q0 rows, as the solver does
    lin_checks = (("ZW0", 0, 1e-5), ("ZW1", 1, 1e-5), ("ZW2", 2, 1e-5),
                  ("Vp", 3, 1e-4), ("gbp", 4, 1e-3), ("U", 6, 1e-4),
                  ("ga", 7, 1e-3))
    errs, lin = [], {}
    lin_kernels = ("linearize_dense_kernel", "linearize_dense_finish_kernel")
    for want_u in (True, False):
        tag = "U" if want_u else "no U"
        out_k = ld.linearize_dense(*args, want_u=want_u, kq=pa.kq)
        again = ld.linearize_dense(*args, want_u=want_u, kq=pa.kq)
        out_p = ld.linearize_dense_plain(*args, want_u=want_u)
        torch.cuda.synchronize()
        need(len(out_k) == len(out_p) == (8 if want_u else 6),
             f"linearize_dense[{tag}]: {len(out_k)} outputs")
        for name, i, tol in lin_checks[:7 if want_u else 5]:
            errs.append(compare(f"linearize_dense[{tag}] {name}", out_k[i],
                                out_p[i], tol))
            need(bool((again[i] == out_k[i]).all()),
                 f"linearize_dense[{tag}]: {name} differs between two calls")
        need(out_k[5] == out_p[5] == Pp, "padded widths differ")
        need(all(bool((out_k[i][:, P:] == 0).all()) for i in (0, 1, 2, 4))
             and bool((out_k[3][:, :, P:]
                       == torch.eye(3, device=dev)[:, :, None]).all()),
             f"linearize_dense[{tag}]: padded lanes are not ZW = gb = 0, "
             "V = I")
        if want_u:
            need(bool((out_k[6] == out_k[6].transpose(1, 2)).all()),
                 "linearize_dense: U is not symmetric")
        del out_k, again, out_p
        call = (lambda want_u=want_u: ld.linearize_dense(
            *args, want_u=want_u, kq=pa.kq))
        parts = clean_l2_kernel_ms(call, ld.linearize_dense, lin_kernels)
        lin[tag] = dict(ms=cuda_ms(call), host_ms=host_ms(call),
                        kernel_ms_clean_l2=sum(parts.values()),
                        kernel_ms_clean_l2_parts=parts,
                        **call_profile(call, ld.linearize_dense,
                                       lin_kernels))
        # reads the three [C, P] tables; writes ZW [3, 6C, Pp], V, gb (and
        # U, ga)
        lin[tag]["bound"] = bound(
            cam_bytes + 12 * P + 12 * C * P
            + 4 * (18 * C * Pp + 12 * Pp + (42 * C if want_u else 0)),
            (LINEARIZE_DENSE_FLOPS if want_u
             else LINEARIZE_DENSE_FLOPS - LINEARIZE_DENSE_U_FLOPS) * O)
        print(f"  linearize_dense[{tag}]: wrapper {lin[tag]['ms']:.4f} ms "
              f"(host {lin[tag]['host_ms']:.4f} ms), kernels with L2 clean "
              f"{lin[tag]['kernel_ms_clean_l2']:.4f} ms {parts}, bound "
              f"{lin[tag]['bound']['bound_ms']:.4f} ms; per call "
              f"{lin[tag]['launches_per_call']} launches "
              f"{lin[tag]['kernels']}, torch ops {lin[tag]['torch_ops']}; "
              "two calls bit-identical", flush=True)
        # its torch ops: one allocation and the views that cut it into the
        # outputs, none of which launches device work
        need(lin[tag]["launches_per_call"] <= 2
             and set(lin[tag]["torch_ops"]) <= {"aten::empty",
                                                "aten::as_strided"},
             f"linearize_dense[{tag}]: more than two launches or a torch op "
             f"beyond the allocation of its outputs ({lin[tag]['kernels']}, "
             f"{lin[tag]['torch_ops']})")
    rows["linearize_dense"] = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        ms=lin["U"]["ms"], host_ms=lin["U"]["host_ms"],
        kernel_ms_clean_l2=lin["U"]["kernel_ms_clean_l2"],
        kernel_ms_clean_l2_parts=lin["U"]["kernel_ms_clean_l2_parts"],
        launches_per_call=lin["U"]["launches_per_call"],
        torch_ops_per_call=lin["U"]["torch_ops"],
        ms_no_u=lin["no U"]["ms"], host_ms_no_u=lin["no U"]["host_ms"],
        kernel_ms_clean_l2_no_u=lin["no U"]["kernel_ms_clean_l2"],
        kernel_ms_clean_l2_parts_no_u=(
            lin["no U"]["kernel_ms_clean_l2_parts"]),
        launches_per_call_no_u=lin["no U"]["launches_per_call"],
        bound_ms_no_u=lin["no U"]["bound"]["bound_ms"],
        plain_ms=cuda_ms(lambda: ld.linearize_dense_plain(*args,
                                                          want_u=True),
                         warmup=1, runs=5),
        library_ms=None,
        **lin["U"]["bound"],
    )

    new_cams = cams + torch.as_tensor(
        1e-4 * rng.standard_normal(cams.shape), dtype=f32, device=dev)
    new_pts = pts + torch.as_tensor(
        1e-3 * rng.standard_normal(pts.shape), dtype=f32, device=dev)
    gargs = (pa.K, pa.q0, cams, pts, new_cams, new_pts, *tables)
    g_k = torch.stack(rd.gain_dense(*gargs, kq=pa.kq))
    g_again = torch.stack(rd.gain_dense(*gargs, kq=pa.kq))
    g_p = torch.stack(rd.gain_dense_plain(*gargs))
    # two sums over 2.5M cells in another order; gain is a difference of
    # nearly equal sums, so 1e-3; new_l2 1e-4
    e1 = compare("gain_dense gain", g_k[0], g_p[0], 1e-3)
    e2 = compare("gain_dense new_l2", g_k[1], g_p[1], 1e-4)
    need(bool((g_again == g_k).all()),
         "gain_dense: two calls give different bits")
    gcall = lambda: rd.gain_dense(*gargs, kq=pa.kq)
    gprof = call_profile(gcall, rd.gain_dense, ("gain_dense_kernel",))
    g_clean = clean_l2_kernel_ms(gcall, rd.gain_dense,
                                 ("gain_dense_kernel",))
    rows["gain_dense"] = dict(
        max_abs_err=max(e1[0], e2[0]), max_rel_err=max(e1[1], e2[1]),
        ms=cuda_ms(gcall), host_ms=host_ms(gcall),
        kernel_ms_clean_l2=g_clean["gain_dense_kernel"],
        launches_per_call=gprof["launches_per_call"],
        torch_ops_per_call=gprof["torch_ops"],
        plain_ms=cuda_ms(lambda: rd.gain_dense_plain(*gargs), runs=5),
        library_ms=None,
        **bound(cam_bytes + 4 * 6 * C + 24 * P + 12 * C * P + 8,
                GAIN_DENSE_FLOPS * O),
    )
    print(f"  gain_dense: wrapper {rows['gain_dense']['ms']:.4f} ms (host "
          f"{rows['gain_dense']['host_ms']:.4f} ms), kernel with L2 clean "
          f"{g_clean['gain_dense_kernel']:.4f} ms; per call "
          f"{gprof['launches_per_call']} launch {gprof['kernels']}, torch "
          f"ops {gprof['torch_ops']}; two calls bit-identical", flush=True)
    need(gprof["launches_per_call"] == 1,
         f"gain_dense: not one launch per call ({gprof['kernels']})")

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

    # the J-gram: n = 1 (Cauchy curvature), 2 (the {P_U, P_B} Gram), 3, 4;
    # a sum over 2.5M cells in another order, 1e-4 of max |G|; the padded
    # lanes of dirs_p carry garbage that must not count; the sequence form
    # (the TR loop's [P, 3] point parts, read in place) gives the stacked
    # form's bits; a grid with no observed cell gives exactly 0
    gram = {}
    errs = []
    for n in (1, 2, 3, 4):
        g = np.random.default_rng(100 + n)
        dc = torch.as_tensor(g.standard_normal((n, C, 6)), dtype=f32,
                             device=dev)
        dp = torch.as_tensor(g.standard_normal((n, 3, Pp)), dtype=f32,
                             device=dev)
        jargs = (pa.K, pa.q0, cams, pts, pa.valid_d, dc, dp)
        G_k = rd.jgram_dense(*jargs, kq=pa.kq)
        G_again = rd.jgram_dense(*jargs, kq=pa.kq)
        G_p = rd.jgram_dense_plain(*jargs)
        errs.append(compare(f"jgram_dense n={n}", G_k, G_p, 1e-4))
        need(bool((G_k == G_k.T).all()) and bool((G_again == G_k).all()),
             f"jgram_dense n={n}: G not symmetric, or two calls differ")
        dp0 = dp.clone()
        dp0[:, :, P:] = 0.0
        need(bool((rd.jgram_dense(*jargs[:-1], dp0, kq=pa.kq) == G_k).all()),
             "jgram_dense: padded lanes contribute")
        seq = (list(dc.unbind()), [dp[a, :, :P].T for a in range(n)])
        need(bool((rd.jgram_dense(*jargs[:-2], *seq, kq=pa.kq)
                   == G_k).all()),
             f"jgram_dense n={n}: the sequence form differs from the stacked")
        empty = (*jargs[:4], torch.zeros_like(pa.valid_d), dc, dp)
        need(bool((rd.jgram_dense(*empty, kq=pa.kq) == 0).all()),
             f"jgram_dense n={n}: no observed cell, yet G != 0")
        call = lambda jargs=jargs: rd.jgram_dense(*jargs, kq=pa.kq)
        scall = lambda jargs=jargs, seq=seq: rd.jgram_dense(
            *jargs[:-2], *seq, kq=pa.kq)
        jk = ("jgram_dense_kernel",)
        prof = call_profile(call, rd.jgram_dense, jk)
        sprof = call_profile(scall, rd.jgram_dense, jk)
        # reads K | q0 | cams, the points, the validity table and the
        # directions once; writes G
        dir_bytes = 4 * n * (6 * C + 3 * P)
        gram[n] = dict(
            jargs=jargs, ms=cuda_ms(call), host_ms=host_ms(call),
            ms_seq=cuda_ms(scall), host_ms_seq=host_ms(scall),
            kernel_ms_clean_l2=clean_l2_kernel_ms(
                call, rd.jgram_dense, jk)["jgram_dense_kernel"],
            # the fixed cost: every warp skips its cells
            kernel_ms_clean_l2_empty=clean_l2_kernel_ms(
                lambda empty=empty: rd.jgram_dense(*empty, kq=pa.kq),
                rd.jgram_dense, jk)["jgram_dense_kernel"],
            launches_per_call=prof["launches_per_call"],
            torch_ops_per_call=prof["torch_ops"],
            launches_per_call_seq=sprof["launches_per_call"],
            torch_ops_per_call_seq=sprof["torch_ops"],
            **bound(cam_bytes + 12 * P + 4 * C * P + dir_bytes + 4 * n * n,
                    jgram_flops(n) * O),
        )
        old = bound(cam_bytes + 12 * P + 4 * C * P + dir_bytes + 4 * n * n,
                    jgram_flops_full_model(n) * O)
        gram[n].update(bound_ms_full_model=old["bound_ms"],
                       bound_flops_full_model=old["bound_flops"])
        v = gram[n]
        print(f"  jgram_dense n={n}: wrapper {v['ms']:.4f} ms (host "
              f"{v['host_ms']:.4f} ms; sequence form {v['ms_seq']:.4f} / "
              f"host {v['host_ms_seq']:.4f} ms), kernel with L2 clean "
              f"{v['kernel_ms_clean_l2']:.4f} ms (empty grid "
              f"{v['kernel_ms_clean_l2_empty']:.4f} ms), bound "
              f"{v['bound_ms']:.4f} ms ({v['bound_by']}; counting the "
              f"full cell model {v['bound_ms_full_model']:.4f} ms); per call "
              f"{prof['launches_per_call']} launch {prof['kernels']}, torch "
              f"ops {prof['torch_ops']} (sequence form "
              f"{sprof['launches_per_call']}, {sprof['torch_ops']}); "
              "symmetric, two calls bit-identical, sequence form the same "
              "bits, empty grid 0", flush=True)
        for tag, pr in (("", prof), (" (sequence form)", sprof)):
            need(pr["launches_per_call"] == 1
                 and set(pr["torch_ops"]) <= {"aten::empty"},
                 f"jgram_dense n={n}{tag}: not one launch, or a torch op "
                 f"beyond the allocation of G ({pr['kernels']}, "
                 f"{pr['torch_ops']})")
    j2 = gram[2]["jargs"]
    keep = ("ms", "host_ms", "ms_seq", "host_ms_seq", "kernel_ms_clean_l2",
            "kernel_ms_clean_l2_empty", "launches_per_call",
            "torch_ops_per_call", "launches_per_call_seq",
            "torch_ops_per_call_seq", "bound_ms", "bound_ms_full_model")
    rows["jgram_dense"] = dict(
        max_abs_err=max(e for e, _ in errs),
        max_rel_err=max(r for _, r in errs),
        plain_ms=cuda_ms(lambda: rd.jgram_dense_plain(*j2), warmup=1,
                         runs=5),
        library_ms=None,
        **{k: gram[2][k] for k in keep + (
            "bound_by", "bound_bytes", "bound_flops",
            "bound_flops_full_model")},
        **{f"{k}_n{n}": gram[n][k] for n in (1, 3, 4) for k in keep},
    )

    # device time of each kernel alone (the wrapper's time above includes
    # its host work before the launch): profiler, mean of 10 calls in turns
    # with the others; linearize_dense's is its two kernels together
    from torch.profiler import ProfilerActivity

    def mean_ms(prof, k):
        recs = kernel_records(prof, k)
        return sum(e.self_device_time_total for e in recs) / 1e3 / len(recs)

    def in_turns():
        for _ in range(10):
            ld.linearize_dense(*args, want_u=True, kq=pa.kq)
            rd.gain_dense(*gargs, kq=pa.kq)
            chol.spd_solve(S828, b828)
            ls.linearize_stream(*sargs, None, C, P, tables=pa.stream,
                                **tr_flags)
            rd.jgram_dense(*j2, kq=pa.kq)
            ls.residual_l2(*rargs)
            sp.schur_pairs(*spargs)

    wrappers = dict(linearize_dense=ld.linearize_dense,
                    gain_dense=rd.gain_dense, spd_solve=chol.spd_solve,
                    linearize_stream=ls.linearize_stream,
                    jgram_dense=rd.jgram_dense, residual_l2=ls.residual_l2,
                    schur_pairs=sp.schur_pairs)
    need(set(wrappers) == set(rows), f"rows {sorted(rows)}")
    prof = complete_profile(
        in_turns,
        [(w, "launches", (f"{k}_kernel",)) for k, w in wrappers.items()]
        + [(ld.linearize_dense, "launches",
            ("linearize_dense_finish_kernel",))],
        [ProfilerActivity.CUDA])
    for k in rows:
        rows[k]["kernel_ms"] = mean_ms(prof, f"{k}_kernel")
    rows["linearize_dense"]["finish_kernel_ms"] = mean_ms(
        prof, "linearize_dense_finish_kernel")
    rows["linearize_dense"]["grid_kernel_ms"] = (
        rows["linearize_dense"]["kernel_ms"])
    rows["linearize_dense"]["kernel_ms"] += (
        rows["linearize_dense"]["finish_kernel_ms"])
    # the pair flags run the camera pass and the point pass: their device
    # times, each a mean over 10 calls, and their sum
    passes = ("linearize_stream_kernel", "linearize_stream_points_kernel")
    for label, call in pair_calls.items():
        prof = complete_profile(
            lambda call=call: [call() for _ in range(10)],
            [(ls.linearize_stream, "launches", passes[:1]),
             (ls.linearize_stream, "point_launches", passes[1:])],
            [ProfilerActivity.CUDA])
        parts = {k: mean_ms(prof, k) for k in passes}
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
        lib = ("none" if v["library_ms"] is None
               else f"{v['library_ms']:.4f} ms")
        print(f"[2] {k}: wrapper {v['ms']:.4f} ms (kernel alone "
              f"{v['kernel_ms']:.4f} ms), plain {v['plain_ms']:.4f} ms, "
              f"bound {v['bound_ms']:.4f} ms ({v['bound_by']}), library "
              f"{lib}", flush=True)
    del pa, gram, j2, rargs, spargs
    torch.cuda.empty_cache()

    # ---- phase 2t: the (camera, tile) skip on both dense problems
    lb, lb_s = ring_problem(**LADYBUG138_REAL)
    print(f"[2t] ladybug138_real: C={lb.n_cams} P={lb.n_pts} O={lb.n_obs} "
          f"({lb.n_obs / lb.n_pts:.2f} observations per point, "
          f"{lb.n_obs / (lb.n_cams * lb.n_pts):.4f} of the cells observed; "
          f"built in {lb_s:.1f} s)", flush=True)
    need(lb.n_cams * lb.n_pts <= DENSE_MAX_ENTRIES,
         "ladybug138_real is above the dense cap")
    tile_skip = {label: check_tile_skip(label, p, dev)
                 for label, p in (("synthetic138_dense", prob),
                                  ("ladybug138_real", lb))}
    for k in ("linearize_dense", "gain_dense", "jgram_dense"):
        rows[k]["tile_skip"] = {
            label: dict({f: v[f] for f in (
                "observed_share", "occupancy_natural",
                "occupancy_clustered")},
                **{n: r for n, r in v["kernels"].items()
                   if n.startswith(k)})
            for label, v in tile_skip.items()}
    torch.cuda.empty_cache()

    # ---- phase 3: the main paths
    kern = {"linearize_dense": ld.linearize_dense, "gain_dense": rd.gain_dense,
            "spd_solve": chol.spd_solve,
            "linearize_stream": ls.linearize_stream,
            "jgram_dense": rd.jgram_dense, "residual_l2": ls.residual_l2,
            "schur_pairs": sp.schur_pairs}
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
    need(launches_lm["schur_pairs"] == 0,
         "dense LM path: the pair kernel launched")

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

    # 3r. the dense main path at Ladybug-138's real density
    psba_tpu_torch.solve(lb, cfg_lm._replace(max_iters=2), dtype=f32,
                         device=dev)   # warm-up
    lb_runs = {}
    for label, c, path in (("LM path", cfg_lm, lm_path),
                           ("default", cfg, dense_path)):
        gmw_log.clear()
        reset()
        r = psba_tpu_torch.solve(lb, c, dtype=f32, device=dev)
        got = read()
        per_r = per_phase_iterations(r)
        ms_r = {ph: 1e3 * r.phase_seconds[ph] / per_r[ph] for ph in per_r}
        gmw = [(n_, t_) for n_, t_, _, _ in gmw_log]
        lb_runs[label] = dict(
            lm_iter_ms=ms_r.get("lm"), tr_iter_ms=ms_r.get("tr"),
            iterations=per_r, phases=r.phases, launches=got, gmw_ms=gmw,
            initial_error=r.initial_error, final_error=r.final_error,
            flag=r.flag_name)
        print(f"[3r] ladybug138_real, {label}, schur='auto': {r}\n"
              f"[3r]   phases {r.phases}; iterations per phase {per_r}\n"
              f"[3r]   ms per LM iteration "
              f"{ms_r.get('lm', float('nan')):.3f}, per TR iteration "
              f"{ms_r.get('tr', float('nan')):.3f}\n"
              f"[3r]   GMW bootstraps (n, ms, lambda) "
              f"{[(n_, round(t_, 3), l_) for n_, t_, l_, _ in gmw_log]}\n"
              f"[3r]   launches {got}\n"
              f"[3r]   initial_error {r.initial_error:.6e} final_error "
              f"{r.final_error:.6e} flag {r.flag_name}", flush=True)
        need(np.isfinite(r.final_l2) and r.final_error < r.initial_error,
             f"ladybug138_real, {label}: error did not decrease")
        need(r.flag_name in ok_flags,
             f"ladybug138_real, {label}: abnormal stop {r.flag_name}")
        need(r.cams.shape == lb.cams.shape and r.pts.shape == lb.pts.shape
             and np.isfinite(r.cams).all() and np.isfinite(r.pts).all(),
             f"ladybug138_real, {label}: output parameters malformed")
        for k in path:
            need(got[k] > 0, f"ladybug138_real, {label}: kernel {k} not "
                 "launched")
        need(got["residual_l2"] == 0, f"ladybug138_real, {label}: the pair "
             "path's residual_l2 launched, so schur='auto' did not take the "
             "dense encoding")
    need("tr" in lb_runs["default"]["iterations"],
         "ladybug138_real, default: never entered TR")
    lb_runs["lm3"] = lm_natural_vs_clustered(lb, cfg_lm, dev)

    # 3h. s_precision="high" (run in full float32: a named deviation)
    t3h = time.perf_counter()
    high = {"accuracy": high_accuracy(prob, cfg, dev)}
    torch.cuda.empty_cache()
    for label, p in (("synthetic138_dense", prob), ("ladybug138_real", lb)):
        high[label] = high_solves(label, p, cfg, dev, reset, read, ok_flags)
    # (d) the roofline of one 138-camera LM iteration at each precision,
    # against the mean ms per LM iteration of its two runs
    from psba_tpu_torch.utils import roofline

    high["roofline"] = {}
    for prec in ("highest", "high"):
        lm_ms = float(np.mean([v["lm_iter_ms"] for v in
                               high["synthetic138_dense"]
                               if v["precision"] == prec]))
        summ = roofline.summarize(prob.n_cams, prob.n_pts, prob.n_obs,
                                  lm_ms, precision=prec)
        it = roofline.lm_iter_roofline(prob.n_cams, prob.n_pts, prob.n_obs,
                                       precision=prec)
        high["roofline"][prec] = dict(summ, measured_lm_iter_ms=lm_ms,
                                      stage_ms=it.stage_ms)
        print(f"[3h] (d) roofline, {prec}, measured {lm_ms:.3f} ms per LM "
              f"iteration: {summ}; stage bounds (ms) "
              f"{ {k: round(v, 4) for k, v in it.stage_ms.items()} }",
              flush=True)
    high["seconds"] = time.perf_counter() - t3h
    print(f"[3h] {high['seconds']:.1f} s", flush=True)

    # 3d. the float64 path: the default solve in float64 (the XLA form)
    f64 = torch.float64
    cfg64 = SolverConfig.for_dtype(f64, record_history=True)
    psba_tpu_torch.solve(prob, cfg64._replace(max_iters=2), device=dev)
    f64_runs = []
    for _ in range(2):
        reset()
        torch.cuda.reset_peak_memory_stats(dev)
        r = psba_tpu_torch.solve(prob, cfg64, device=dev)
        f64_runs.append((r, read(), peak_gib(dev)))
    res64, launches64, peak64 = f64_runs[0]
    per64 = per_phase_iterations(res64)
    ms64 = {ph: 1e3 * res64.phase_seconds[ph] / per64[ph] for ph in per64}
    brk = f64_breakdown(prob, dev)
    print(f"[3d] float64 default solve: {res64}; damping "
          f"{res64.resolved_damping}\n[3d] phases {res64.phases}\n"
          f"[3d] iterations per phase {per64}; ms per LM iteration "
          f"{ms64.get('lm', float('nan')):.3f}, per TR iteration "
          f"{ms64.get('tr', float('nan')):.3f}; peak device memory "
          f"{peak64:.2f} / {f64_runs[1][2]:.2f} GiB\n"
          f"[3d] launches {launches64}; spd_solve_xla calls "
          f"{linalg.spd_solve_xla.calls}\n"
          f"[3d] float64 dense LM try (ms, CUDA events): once per "
          f"iteration {brk['once']} = {brk['once_ms']:.3f}; per try "
          f"{brk['per_try']} = {brk['try_ms']:.3f}\n"
          f"[3d] S DGEMM [{6 * prob.n_cams} x {3 * prob.n_pts}] x "
          f"[{3 * prob.n_pts} x {6 * prob.n_cams}]: "
          f"{brk['s_dgemm_ms']:.3f} ms a try, "
          f"{brk['s_dgemm_tflops']:.1f} TFLOP/s, bound "
          f"{brk['s_dgemm_bound_ms']:.3f} ms\n"
          f"[3d] initial_error {res64.initial_error:.6e} final_error "
          f"{res64.final_error:.6e} flag {res64.flag_name}; second run "
          f"final_l2 {f64_runs[1][0].final_l2!r} vs {res64.final_l2!r}",
          flush=True)
    need(np.isfinite(res64.final_l2)
         and res64.final_error < res64.initial_error,
         "float64 path: error did not decrease")
    need(res64.flag_name in ok_flags,
         f"float64 path: abnormal stop {res64.flag_name}")
    for r, got, _ in f64_runs:
        need(all(v == 0 for v in got.values()),
             f"float64 path launched a kernel: {got}")
    need(f64_runs[1][0].final_l2 == res64.final_l2
         and f64_runs[1][0].phases == res64.phases,
         "float64 path: two CUDA runs give different final L2 bits")
    need(res64.cams.dtype == np.float64 and np.isfinite(res64.cams).all()
         and np.isfinite(res64.pts).all(),
         "float64 path: output parameters malformed")

    # 3o. the float32 default solve with the float64 polish
    import tempfile

    from psba_tpu_torch.solvers.types import OptState
    from psba_tpu_torch.utils import checkpoint as ckpt

    with tempfile.TemporaryDirectory() as ck:
        reset()
        torch.cuda.reset_peak_memory_stats(dev)
        res_o = psba_tpu_torch.solve(prob, cfg, dtype=f32, device=dev,
                                     polish_iters=5, checkpoint_dir=ck,
                                     checkpoint_every=0)
        launches_o = read()
        peak_o = peak_gib(dev)
        n_main = res_o.phases[-2][1]
        main = np.load(os.path.join(ck, f"ckpt_{n_main:05d}.npz"))
        # the checkpoint holds the points in the dense solve's order
        pa64 = ProblemArrays.from_problem(prob.with_tile_point_order()[0],
                                          dtype=f64, device=dev)
        start64 = float(OptState.init(
            pa64, torch.as_tensor(main["cams"], dtype=f64, device=dev),
            torch.as_tensor(main["pts"], dtype=f64, device=dev)).ex_l2)
        del pa64, main
    print(f"[3o] float32 default + polish 5: {res_o}\n[3o] phases "
          f"{res_o.phases}; phase seconds "
          f"{ {k: round(v, 4) for k, v in res_o.phase_seconds.items()} }; "
          f"peak device memory {peak_o:.2f} GiB\n[3o] launches "
          f"{launches_o}\n[3o] polish: float64 L2 {start64!r} at its start "
          f"-> {res_o.final_l2!r}", flush=True)
    need(res_o.phases[-1][0] == "lm64" and res_o.iterations <= n_main + 5,
         f"polish: phases {res_o.phases}")
    for k in lm_path:
        need(launches_o[k] > 0, f"polish run: kernel {k} not launched in "
             "the float32 part")
    need(res_o.final_l2 <= start64, "polish: final L2 above its start")

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
        # S once a try: on the LM path each try is one residual_l2 launch;
        # TR builds S once a solve try, then tries models on it (none when
        # its step stops the run), so there the counts differ
        need(got["schur_pairs"] == got["residual_l2"] if c is cfg_lm
             else got["schur_pairs"] > 0,
             f"pair path, {label}: {got['schur_pairs']} pair-kernel "
             f"launches against {got['residual_l2']} tries")
        need(oversized > 0, f"pair path, {label}: no oversized spd_solve")
    need("tr" in pair_runs["default"]["per"],
         "pair path, default: never entered TR")
    # ---- phase 3x: float64 LM on final961_pairs (the XLA form)
    c3x = SolverConfig.for_dtype(f64, max_iters=3, lm_switch_count=10_000)
    reset()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    r3x = psba_tpu_torch.solve(big, c3x, device=dev)
    launches3x, peak3x = read(), peak_gib(dev)
    ms3x = 1e3 * r3x.phase_seconds["lm"] / max(r3x.iterations, 1)
    print(f"[3x] final961_pairs, float64 LM x3: {r3x}; {ms3x:.3f} ms per "
          f"LM iteration (the first included); peak device memory "
          f"{peak3x:.2f} GiB; launches {launches3x}", flush=True)
    need(r3x.iterations == 3 and r3x.final_l2 < r3x.initial_l2,
         "float64 pairs: three LM iterations did not descend")
    need(all(v == 0 for v in launches3x.values()),
         f"float64 pairs launched a kernel: {launches3x}")
    if "--profile" in argv:
        # the dense solve's point order
        clustered = prob.with_tile_point_order()[0]
        profile(clustered, cfg, dev, "dense")
        profile(clustered, cfg64, dev, "dense", f64=True)
        profile(lb.with_tile_point_order()[0], cfg, dev, "dense",
                name="ladybug138_real")
        profile(big, cfg, dev, "pairs")
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

    # ---- phase 4d: float64 on mini_bal, CUDA against CPU
    c64_lm = SolverConfig.for_dtype(f64, lm_switch_count=10_000,
                                    max_iters=20, record_history=True)
    for schur in ("dense", "pairs"):
        for c, label in ((c64_lm, "LM 20"), (cfg64, "default full")):
            r_gpu = psba_tpu_torch.solve(mini, c, device=dev, schur=schur)
            r_cpu = psba_tpu_torch.solve(mini, c, device="cpu", schur=schur)
            rel = abs(r_gpu.final_l2 - r_cpu.final_l2) / r_cpu.final_l2
            print(f"[4d] mini_bal float64, schur={schur}, {label}\n"
                  f"[4d]   cuda: {r_gpu} {r_gpu.phases}\n"
                  f"[4d]   cpu:  {r_cpu} {r_cpu.phases}\n"
                  f"[4d]   final_l2 rel diff {rel:.3e} (tolerance 1e-3)",
                  flush=True)
            need(rel <= 1e-3, f"float64 {schur}, {label}: CUDA and CPU "
                 "final_l2 disagree")
            if label == "LM 20":
                # every row of a fixed budget (near the optimum rho is a
                # ratio of rounding errors, so the full runs are not held
                # row by row)
                h_gap = float(np.max(np.abs(
                    r_gpu.history[:, 1:4] - r_cpu.history[:, 1:4])
                    / np.abs(r_cpu.history[:, 1:4])))
                print(f"[4d]   LM rows max rel diff {h_gap:.3e} (tolerance "
                      "1e-9)", flush=True)
                need(h_gap <= 1e-9 and r_gpu.phases == r_cpu.phases,
                     f"float64 {schur}, LM 20: LM rows part ({h_gap})")
            need(r_gpu.flag_name in ok_flags,
                 f"float64 {schur}, {label}: abnormal stop")

    # ---- phase 6: the CLI on the card
    cli = cli_phase(prob, res64)

    # ---- phase 7: the sharded solve (psba_tpu_torch.parallel)
    t7 = time.perf_counter()
    par = {"one_nccl_rank": one_rank_phase(lb, big, dev, reset, read),
           "two_gloo_ranks": two_rank_phase(prob, res, cfg, dev,
                                            dense_path)}
    par["seconds"] = time.perf_counter() - t7
    seen = {k: 0 for k in kern}
    for v in par["one_nccl_rank"].values():
        for k in kern:
            seen[k] += v["launches"][k]
    for k in kern:
        for x in par["two_gloo_ranks"]["psum"]["launches_per_rank"]:
            seen[k] += x[k]
    par["launches"] = seen
    print(f"[7] launches over phase 7 {seen}; {par['seconds']:.1f} s",
          flush=True)
    for k in kern:
        need(seen[k] > 0, f"phase 7: kernel {k} never launched")

    # ---- phase 8: the front-end on the card
    t8 = time.perf_counter()
    fe = frontend_phase(dev, reset, read, lm_path)
    fe["seconds"] = time.perf_counter() - t8
    print(f"[8] {fe['seconds']:.1f} s", flush=True)

    # ---- phase 9: the direct entry (from_problem with no device ->
    # OptState.init -> resolve_damping -> lm_run) and the sharded repeats
    # runner
    t9 = time.perf_counter()
    direct = direct_entry_phase(prob, big, lb, dev, reset, read, lm_path)
    direct["seconds"] = time.perf_counter() - t9
    del big
    print(f"[9] {direct['seconds']:.1f} s", flush=True)

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
        "schur_pairs": ("psba_tpu_torch/csrc/schur_pairs.cu",
                        "none: psba_tpu/core/schur.py::schur_S (XLA)"),
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
             launches_pairs_lm_path=pl["launches"][k],
             launches_sharded=par["launches"][k],
             launches_high={label: [v["launches"][k] for v in runs
                                    if v["precision"] == "high"]
                            for label, runs in high.items()
                            if label in ("synthetic138_dense",
                                         "ladybug138_real")},
             launches_frontend=fe["launches"][k],
             launches_direct={label: v["launches"][k]
                              for label, v in direct.items()
                              if isinstance(v, dict)}, **rows[k])
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
        "ladybug138_real": dict(lb_runs, tile_skip={
            label: {f: v[f] for f in (
                "C", "P", "O", "observed_share", "occupancy_natural",
                "occupancy_clustered", "occupied_pairs", "pairs",
                "live_cells")}
            for label, v in tile_skip.items()}),
        "float64": {
            "dense_default": {
                "lm_iter_ms": ms64.get("lm"), "tr_iter_ms": ms64.get("tr"),
                "iterations": per64, "phases": res64.phases,
                "peak_gib": peak64, "initial_error": res64.initial_error,
                "final_error": res64.final_error, "breakdown_ms": brk},
            "polish5": {"phases": res_o.phases, "peak_gib": peak_o,
                        "phase_seconds": res_o.phase_seconds,
                        "start_l2": start64, "final_l2": res_o.final_l2},
            "final961_pairs_lm3": {"lm_iter_ms": ms3x, "peak_gib": peak3x,
                                   "final_error": r3x.final_error},
            "cli": cli,
        },
        "parallel": par,
        "high": high,
        "frontend": fe,
        "direct": direct,
    }), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def lm_natural_vs_clustered(prob, cfg_lm, dev) -> dict:
    """Three LM iterations (OptState.init, then lm_run timed alone) on two
    builds of `prob`: the caller's point order without the occupancy table
    (a dataclasses.replace of its ProblemArrays) and the order the dense
    solve clusters to, with the table; in turns (natural, clustered,
    clustered, natural) after a warm-up of each. The final L2 of the two
    builds must agree to 1e-4 (float32 sums in another order). Returns ms
    per iteration of each run and both final L2."""
    import torch

    from psba_tpu_torch.ops import residual_dense as rd
    from psba_tpu_torch.solvers.lm import lm_run
    from psba_tpu_torch.solvers.types import (
        OptState,
        ProblemArrays,
        resolve_damping,
    )

    f32 = torch.float32
    c3 = cfg_lm._replace(max_iters=3)
    p2, _newpos = prob.with_tile_point_order()
    pa_nat = ProblemArrays.from_problem(prob, dtype=f32, device=dev)
    builds = {
        "natural": (dataclasses.replace(pa_nat, tile_mask=None), prob),
        "clustered": (ProblemArrays.from_problem(p2, dtype=f32, device=dev),
                      p2),
    }
    need(builds["clustered"][0].tile_mask is not None
         and builds["natural"][0].tile_mask is None,
         "lm3: the builds do not differ in their table")

    def run(label):
        pa, p = builds[label]
        cams = torch.as_tensor(p.cams, dtype=f32, device=dev)
        pts = torch.as_tensor(p.pts, dtype=f32, device=dev)
        c = resolve_damping(c3, pa, cams, pts)
        st = OptState.init(pa, cams, pts)
        tries = rd.gain_dense.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = lm_run(pa, st, c)
        l2 = float(st.ex_l2)
        ms = 1e3 * (time.perf_counter() - t0) / max(st.itno, 1)
        need(st.itno == 3, f"lm3 {label}: {st.itno} iterations")
        return ms, l2, rd.gain_dense.launches - tries

    for label in builds:
        run(label)
    out = {"natural": [], "clustered": []}
    for label in ("natural", "clustered", "clustered", "natural"):
        out[label].append(run(label))
    l2n, l2c = out["natural"][0][1], out["clustered"][0][1]
    rel = abs(l2c - l2n) / l2n
    res = dict(ms_natural=[r[0] for r in out["natural"]],
               ms_clustered=[r[0] for r in out["clustered"]],
               tries_natural=out["natural"][0][2],
               tries_clustered=out["clustered"][0][2],
               final_l2_natural=l2n, final_l2_clustered=l2c, rel=rel)
    print(f"[3r] lm_run x3 in turns: ms per LM iteration natural order, no "
          f"table {res['ms_natural']}, clustered with the table "
          f"{res['ms_clustered']}; tries {res['tries_natural']} / "
          f"{res['tries_clustered']}; final L2 {l2n!r} / {l2c!r}, rel "
          f"{rel:.3e} (tolerance 1e-4)", flush=True)
    need(rel <= 1e-4, "lm3: natural and clustered builds disagree")
    res["same_bits_each_build"] = (
        all(r[1] == l2n for r in out["natural"])
        and all(r[1] == l2c for r in out["clustered"]))
    return res


def cli_phase(prob, res64) -> dict:
    """Phase 6: `prob` written as an SBA text pair to a temporary directory;
    its points file read by the native and by the numpy reader (host
    seconds, the arrays equal); then `python -m psba_tpu_torch.cli` on it,
    float64 (the default) and --f32 --polish 3, each in a subprocess with
    --json. The float64 run must land within 1e-4 of phase 3d's final error
    (the text keeps nine decimals)."""
    import tempfile

    import numpy as np

    from psba_tpu_torch.io import native, sba_text
    from psba_tpu_torch.io.bal import write_sba_text

    out = {}
    with tempfile.TemporaryDirectory() as d:
        cams, pts = os.path.join(d, "cams.txt"), os.path.join(d, "pts.txt")
        t0 = time.perf_counter()
        write_sba_text(prob, cams, pts)
        out["write_s"] = time.perf_counter() - t0
        need(native.available(), f"native reader: {native.reader()}")
        t0 = time.perf_counter()
        a = native.read_pts(pts, prob.n_cams)
        out["read_native_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        b = sba_text.read_pts_numpy(pts, prob.n_cams)
        out["read_numpy_s"] = time.perf_counter() - t0
        need(all((x is None and y is None) or np.array_equal(x, y)
                 for x, y in zip(a, b)), "native and numpy readers differ")
        print(f"[6] {os.path.getsize(pts) / 2**20:.1f} MiB points file "
              f"written in {out['write_s']:.2f} s; read native "
              f"{out['read_native_s']:.3f} s, numpy "
              f"{out['read_numpy_s']:.3f} s", flush=True)
        env = dict(os.environ, PYTHONPATH=REPO)
        for label, extra in (("float64", ()),
                             ("f32_polish3", ("--f32", "--polish", "3"))):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "psba_tpu_torch.cli", "--cams", cams,
                 "--pts", pts, "--json", *extra],
                cwd=REPO, env=env, capture_output=True, text=True,
                timeout=600)
            secs = time.perf_counter() - t0
            need(proc.returncode == 0,
                 f"CLI {label} failed:\n{proc.stderr[-4000:]}")
            got = json.loads(proc.stdout.strip().splitlines()[-1])
            got["process_s"] = secs
            out[label] = got
            print(f"[6] CLI {label}: {proc.stderr.strip().splitlines()}\n"
                  f"[6]   {json.dumps(got)}", flush=True)
            need(got["final_error"] < got["initial_error"]
                 and got["flag"] in ("DP_NO_CHANGE", "ERR_SMALL_ENOUGH",
                                     "CONTINUE"),
                 f"CLI {label}: error did not decrease / abnormal stop")
        need(out["f32_polish3"]["phases"][-1][0] == "lm64",
             "CLI --f32 --polish 3: lm64 is not the last phase")
        rel = abs(out["float64"]["final_error"] - res64.final_error) / (
            res64.final_error)
        print(f"[6] CLI float64 final_error vs phase 3d: rel {rel:.3e} "
              "(tolerance 1e-4)", flush=True)
        need(rel <= 1e-4, "CLI float64 run and phase 3d disagree")
    return out


def collective_line(res, tries: int) -> dict:
    """A sharded solve's collectives (SolveResult.collectives) per tag and
    per try: calls, bytes, ms (ms only from a timed run)."""
    tags = {k: dict(calls=v["calls"], bytes=v["bytes"],
                    ms=1e3 * v["seconds"])
            for k, v in res.collectives.items()}
    total_b = sum(v["bytes"] for v in tags.values())
    total_ms = sum(v["ms"] for v in tags.values())
    return dict(tries=tries, by_tag=tags, bytes_per_try=total_b / tries,
                ms_per_try=total_ms / tries)


def one_rank_phase(lb, big, dev, reset, read) -> dict:
    """Phase 7a: one NCCL rank on cuda:0 (init_distributed with a file
    store in a temporary directory), psba_tpu_torch.parallel.distributed.
    solve_distributed on ladybug138_real (dense) and final961_pairs
    (pairs), three float32 LM iterations each, against OptState.init +
    lm_run on ProblemArrays.from_problem in the caller's point order, in
    turns (lm_run, sharded, sharded with each collective timed between two
    device synchronizations, lm_run): the same bits (cameras, points,
    final L2) in all four, ms per iteration of each, the launches of the
    untimed sharded run (counters reset just before it, read just after),
    and the timed run's collectives: calls, bytes and ms per try."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from psba_tpu_torch.parallel.distributed import (
        init_distributed,
        solve_distributed,
    )
    from psba_tpu_torch.parallel.shard import resolve_damping_host
    from psba_tpu_torch.solvers import OptState, ProblemArrays, SolverConfig
    from psba_tpu_torch.solvers.lm import lm_run

    f32 = torch.float32
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/store", 1, 0, device=dev,
                         backend="nccl" if dev.type == "cuda" else "gloo")
        print(f"[7a] process group: backend {dist.get_backend()}, world "
              f"size {dist.get_world_size()}", flush=True)
        try:
            for label, p, schur in (("ladybug138_real", lb, "dense"),
                                    ("final961_pairs", big, "pairs")):
                base = SolverConfig.for_dtype(f32, max_iters=3,
                                              lm_switch_count=10_000)
                cfg = resolve_damping_host(base, p, f32, dev)
                pa = ProblemArrays.from_problem(p, dtype=f32, device=dev,
                                                schur=schur)
                t = lambda a: torch.as_tensor(a, dtype=f32, device=dev)

                def single():
                    st = OptState.init(pa, t(p.cams), t(p.pts))
                    if dev.type == "cuda":
                        torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    st = lm_run(pa, st, cfg)
                    l2 = float(st.ex_l2)
                    ms = 1e3 * (time.perf_counter() - t0) / st.itno
                    return (st.cams.cpu().numpy(), st.pts.cpu().numpy(),
                            l2), ms

                ref, ms_one = single()
                reset()
                r = solve_distributed(p, cfg, dtype=f32, schur=schur,
                                      device=dev)
                launches = read()
                rt = solve_distributed(p, cfg, dtype=f32, schur=schur,
                                       device=dev, time_collectives=True)
                ref2, ms_two = single()
                del pa
                got = [(x.cams, x.pts, x.final_l2) for x in (r, rt)] + [ref2]
                same = all(np.array_equal(g[0], ref[0])
                           and np.array_equal(g[1], ref[1]) and g[2] == ref[2]
                           for g in got)
                tries = rt.collectives["lm_try"]["calls"]
                coll = collective_line(rt, tries)
                ms = [ms_one,
                      1e3 * r.phase_seconds["lm"] / r.iterations,
                      1e3 * rt.phase_seconds["lm"] / rt.iterations, ms_two]
                out[label] = dict(
                    schur=schur, iterations=r.iterations, tries=tries,
                    ms_per_iteration_in_turns=dict(zip(
                        ("lm_run", "sharded", "sharded_timed", "lm_run_2"),
                        ms)),
                    same_bits=same, launches=launches, collectives=coll,
                    final_l2=r.final_l2)
                print(f"[7a] {label} ({schur}), one NCCL rank, LM x3: "
                      f"{r}\n[7a]   same bits as lm_run in all four runs: "
                      f"{same}; final L2 {r.final_l2!r} vs {ref[2]!r}\n"
                      f"[7a]   ms per LM iteration in turns (lm_run, "
                      f"sharded, sharded timed, lm_run): "
                      f"{[round(x, 3) for x in ms]}\n[7a]   launches "
                      f"{launches}\n[7a]   collectives over {tries} tries "
                      f"(timed run): {coll['bytes_per_try']:.0f} bytes and "
                      f"{coll['ms_per_try']:.4f} ms per try; by tag "
                      f"{coll['by_tag']}", flush=True)
                need(same, f"7a {label}: one NCCL rank does not give "
                     "lm_run's bits")
                need(r.iterations == 3, f"7a {label}: {r.iterations} "
                     "iterations")
        finally:
            dist.destroy_process_group()
    return out


def warm_solve_rank(device, s_reduces, **kw) -> list:
    """A rank of phase 7b: a two-iteration warm-up solve (cuBLAS, the
    kernel libraries, gloo's connections), then parallel.distributed.
    solve_rank once for each S collective in `s_reduces`."""
    from psba_tpu_torch.parallel.distributed import (
        solve_distributed,
        solve_rank,
    )

    from psba_tpu_torch.ops import cholesky, linearize_dense
    from psba_tpu_torch.ops import linearize_stream, residual_dense
    from psba_tpu_torch.ops import schur_pairs

    cfg = kw.pop("cfg")
    solve_distributed(device=device, cfg=cfg._replace(max_iters=2), **kw)
    out = []
    for s in s_reduces:
        # every count to 0 just before the solve (solve_rank reads them
        # just after)
        for fn in (linearize_dense.linearize_dense, cholesky.spd_solve,
                   residual_dense.gain_dense, residual_dense.jgram_dense,
                   linearize_stream.linearize_stream,
                   linearize_stream.residual_l2, schur_pairs.schur_pairs):
            fn.launches = 0
        out.append(solve_rank(device, cfg=cfg._replace(s_reduce=s), **kw))
    return out


def two_rank_phase(prob, res, cfg, dev, dense_path) -> dict:
    """Phase 7b: two spawned ranks on cuda:0 over gloo (NCCL takes one rank
    a device), the default float32 hybrid solve of the 138-camera problem
    split in two, with s_reduce "psum" and then "scatter" (reduce_scatter
    + all_gather) in the same ranks, each collective timed (the device
    synchronized around it): the same first LM phase and the
    switch to TR as phase 3b's single-device solve `res`, final L2 within
    1e-3 of it, every dense-path kernel launched on each rank, and the
    gathered points and cameras reprojecting to the final L2 (float64,
    1e-3)."""
    import numpy as np
    import torch

    from psba_tpu_torch.core.residual import error_l2, residuals
    from psba_tpu_torch.parallel.distributed import gather_points, run_ranks

    f32, f64 = torch.float32, torch.float64
    out = {}
    s_reduces = ("psum", "scatter")
    t0 = time.perf_counter()
    per_rank = run_ranks([dev.type + ":0"] * 2, "gloo", warm_solve_rank,
                         timeout=600, s_reduces=s_reduces, prob=prob,
                         cfg=cfg._replace(record_history=False), dtype=f32,
                         schur="dense", time_collectives=True)
    secs = time.perf_counter() - t0
    print(f"[7b] two ranks on {dev.type}:0 over gloo: {secs:.1f} s with the "
          "spawn, the warm-up and both solves", flush=True)
    for k, s_reduce in enumerate(s_reduces):
        ranks = [x[k] for x in per_rank]
        r = gather_points([x["result"] for x in ranks])
        per = per_phase_iterations(r)
        ms = {ph: 1e3 * r.phase_seconds[ph] / per[ph] for ph in per}
        tries = (r.collectives["lm_try"]["calls"]
                 + r.collectives.get("tr_try", {"calls": 0})["calls"])
        coll = collective_line(r, tries)
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=f64, device=dev)
        i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                      device=dev)
        l2_at = float(error_l2(residuals(
            f(prob.K), f(prob.q0), f(r.cams), f(r.pts), f(prob.obs),
            i(prob.cam_idx), i(prob.pt_idx))))
        rel = abs(r.final_l2 - res.final_l2) / res.final_l2
        rel_at = abs(l2_at - r.final_l2) / r.final_l2
        out[s_reduce] = dict(
            backend="gloo", ranks=2, device=str(dev.type) + ":0",
            phases=r.phases, iterations=per, ms_per_iteration=ms,
            seconds_both_with_spawn=secs, final_l2=r.final_l2,
            final_error=r.final_error, rel_to_single=rel,
            rel_reprojected=rel_at, collectives=coll,
            launches_per_rank=[x["launches"] for x in ranks])
        print(f"[7b] two ranks on {dev.type}:0 over gloo, s_reduce="
              f"{s_reduce}: {r}\n[7b]   phases {r.phases} (single device "
              f"{res.phases}); ms per iteration {ms}\n[7b]   final L2 {r.final_l2!r} vs single "
              f"{res.final_l2!r}: rel {rel:.3e} (tolerance 1e-3); "
              f"reprojected in float64 rel {rel_at:.3e} (tolerance 1e-3)"
              f"\n[7b]   launches per rank "
              f"{[x['launches'] for x in ranks]}\n[7b]   collectives "
              f"(timed) over {tries} tries: {coll['bytes_per_try']:.0f} "
              f"bytes and {coll['ms_per_try']:.3f} ms per try; by tag "
              f"{coll['by_tag']}", flush=True)
        need(r.phases[0] == res.phases[0] and r.phases[1][0] == "tr",
             f"7b {s_reduce}: first LM phase or the switch to TR differs "
             "from the single-device solve")
        need(rel <= 1e-3 and rel_at <= 1e-3,
             f"7b {s_reduce}: final L2 off the single-device solve")
        need(r.flag_name in ("DP_NO_CHANGE", "ERR_SMALL_ENOUGH", "CONTINUE"),
             f"7b {s_reduce}: abnormal stop {r.flag_name}")
        for rank, x in enumerate(ranks):
            for k in dense_path:
                need(x["launches"][k] > 0,
                     f"7b {s_reduce}: rank {rank} launched no {k}")
        need(r.collectives["S"]["calls"] > 0, f"7b {s_reduce}: no S "
             "collective")
    return out


def all_tensors(obj) -> list:
    """Every tensor of a ProblemArrays (its stream tables included) or an
    OptState."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if dataclasses.is_dataclass(obj):
        return [t for f in dataclasses.fields(obj)
                for t in all_tensors(getattr(obj, f.name))]
    return []


def direct_entry_phase(prob, big, lb, dev, reset, read, lm_path) -> dict:
    """Phase 9, the direct entry as a bench drives it: ProblemArrays.
    from_problem(p, dtype=float32) with no device (and schur "auto") ->
    OptState.init -> resolve_damping -> lm_run(iter_cap=3) with no early
    stop and no switch to TR, counters reset just before OptState.init and
    read just after lm_run. (a) The 138-camera problem (dense) and (b)
    final961_pairs (pairs): every tensor on cuda, the path's kernels
    launched, the final L2 the bits of the same run built with
    device="cuda", ms per LM iteration of both. (c) parallel.distributed.
    lm_repeat_rank (make_sharded_lm_repeat) on one NCCL rank in this
    process on ladybug138_real, iter_cap 3, with 3 repeats and with 1:
    total_itno 9 and acc_l2 the bits of 0 + l2 + l2 + l2 in float32, l2
    the single run's; ms per repeat."""
    import tempfile

    import numpy as np
    import torch
    import torch.distributed as dist

    from psba_tpu_torch.parallel.distributed import (
        init_distributed,
        lm_repeat_rank,
    )
    from psba_tpu_torch.solvers import (
        OptState,
        ProblemArrays,
        SolverConfig,
        resolve_damping,
    )
    from psba_tpu_torch.solvers.lm import lm_run

    f32 = torch.float32
    base = SolverConfig.for_dtype(f32, stop_thresh=1e-30,
                                  lm_switch_count=10_000)
    out = {}
    for label, p, pairs, path in (
            ("synthetic138_dense", prob, False, lm_path),
            ("final961_pairs", big, True, ("linearize_stream",
                                           "residual_l2", "schur_pairs"))):
        runs = {}
        for where in ("default", "cuda"):
            kw = {} if where == "default" else {"device": "cuda"}
            pa = ProblemArrays.from_problem(p, dtype=f32, **kw)
            cams = torch.as_tensor(p.cams, dtype=f32, device=pa.K.device)
            pts = torch.as_tensor(p.pts, dtype=f32, device=pa.K.device)
            torch.cuda.synchronize()
            reset()
            state0 = OptState.init(pa, cams, pts)
            cfg = resolve_damping(base, pa, cams, pts)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st = lm_run(pa, state0, cfg, iter_cap=3)
            l2 = float(st.ex_l2)
            ms = 1e3 * (time.perf_counter() - t0) / max(st.itno, 1)
            got = read()
            devices = sorted({t.device.type for t in all_tensors(pa)
                              + all_tensors(st)})
            runs[where] = dict(pairs=pa.pairs, devices=devices,
                               damping=cfg.damping, itno=st.itno, l2=l2,
                               ms=ms, launches=got)
            del pa, state0, st
            torch.cuda.empty_cache()
        r, rc = runs["default"], runs["cuda"]
        same = r["l2"] == rc["l2"]
        out[label] = dict(
            encoding="pairs" if r["pairs"] else "dense",
            tensor_devices=r["devices"], damping=r["damping"],
            iterations=r["itno"], final_l2=r["l2"],
            same_bits_as_device_cuda=same,
            lm_iter_ms={"default": r["ms"], "device_cuda": rc["ms"]},
            launches=r["launches"])
        print(f"[9] {label}: from_problem with no device -> "
              f"{'pairs' if r['pairs'] else 'dense'}, tensors on "
              f"{r['devices']}; damping {r['damping']}; lm_run "
              f"iter_cap=3: {r['itno']} iterations, final L2 {r['l2']!r} "
              f"(device='cuda': {rc['l2']!r}, same bits {same})\n"
              f"[9]   ms per LM iteration {r['ms']:.3f} (device='cuda' "
              f"{rc['ms']:.3f})\n[9]   launches {r['launches']}",
              flush=True)
        need(r["devices"] == ["cuda"], f"9 {label}: tensors on "
             f"{r['devices']} with no device named")
        need(r["pairs"] == pairs, f"9 {label}: schur='auto' took the "
             "other encoding")
        need(r["itno"] == 3 and np.isfinite(r["l2"]),
             f"9 {label}: {r['itno']} iterations, final L2 {r['l2']}")
        need(same, f"9 {label}: final L2 differs from device='cuda'")
        for k in path:
            need(r["launches"][k] > 0, f"9 {label}: kernel {k} not "
                 "launched")
        if pairs:
            need(r["launches"]["schur_pairs"] == r["launches"]["residual_l2"],
                 f"9 {label}: not one pair-kernel launch a try")

    cfg = SolverConfig.for_dtype(f32, lm_switch_count=10_000)
    kw = dict(prob=lb, cfg=cfg, iter_cap=3, dtype=f32, schur="dense")
    with tempfile.TemporaryDirectory() as tmp:
        init_distributed(f"file://{tmp}/store", 1, 0, device=dev,
                         backend="nccl")
        try:
            lm_repeat_rank(dev, repeats=1, **kw)     # warm-up
            one = lm_repeat_rank(dev, repeats=1, **kw)
            reset()
            rep = lm_repeat_rank(dev, repeats=3, **kw)
            got = read()
        finally:
            dist.destroy_process_group()
    want = torch.zeros((), dtype=f32, device=dev)
    l2 = torch.tensor(one["acc_l2"], dtype=f32, device=dev)
    for _ in range(3):
        want = want + l2
    same = rep["acc_l2"] == float(want)
    ms_rep = 1e3 * rep["seconds"] / 3
    out["sharded_repeat"] = dict(
        problem="ladybug138_real", iter_cap=3, repeats=3,
        total_itno=rep["total_itno"], acc_l2=rep["acc_l2"],
        single_l2=one["acc_l2"], same_bits_as_3x_single=same,
        ms_per_repeat=ms_rep, ms_single=1e3 * one["seconds"],
        launches=got)
    print(f"[9] sharded repeats runner, one NCCL rank, ladybug138_real, "
          f"iter_cap 3 x 3: total_itno {rep['total_itno']}, acc_l2 "
          f"{rep['acc_l2']!r} vs 3 x {one['acc_l2']!r} = {float(want)!r} "
          f"(same bits {same})\n[9]   ms per repeat {ms_rep:.3f} (a single "
          f"run {1e3 * one['seconds']:.3f})\n[9]   launches {got}",
          flush=True)
    need(rep["total_itno"] == 9 and one["total_itno"] == 3,
         f"9 repeats: total_itno {rep['total_itno']}")
    need(same, "9 repeats: acc_l2 is not 3 x the single run's L2")
    for k in lm_path:
        need(got[k] > 0, f"9 repeats: kernel {k} not launched")
    return out


def s_error(S, S64) -> float:
    """Normwise relative error ||S - S64||_F / ||S64||_F."""
    import torch

    return float(torch.linalg.norm(S.double() - S64) / torch.linalg.norm(S64))


def high_accuracy(prob, cfg, dev) -> dict:
    """Phase 3h (a) and the S timings of (c): the first LM try of the
    138-camera problem's float32 solve (its starting point, mu = tau *
    max diag), S from that try's ZW3 and V three ways: "high" (the port
    runs it in full float32, a named deviation; called here after
    torch.set_float32_matmul_precision("high"), which is single-pass TF32
    in PyTorch, to show that the product's float32 pin holds against it),
    "highest" (float32) and single-pass TF32 (the products with TF32 on),
    each against float64 from the same float32 inputs. The limits are on
    the products' normwise relative error (S - blockdiag U against its
    float64 value; the damped diagonal would hide it in S):
    err_high <= 2 err_highest + 2^-21 (what "high" promises) and
    err_high <= err_tf32 / 10 (the check tells the products from
    TF32's). Then CUDA-event milliseconds of schur_S_dense3 per try and of
    its products alone (the same code under both precisions)."""
    import torch

    from psba_tpu_torch.core import schur as sc
    from psba_tpu_torch.ops import linearize_dense as ld
    from psba_tpu_torch.solvers import ProblemArrays

    f32 = torch.float32
    pa = ProblemArrays.from_problem(prob, dtype=f32, device=dev)
    cams = torch.as_tensor(prob.cams, dtype=f32, device=dev)
    pts = torch.as_tensor(prob.pts, dtype=f32, device=dev)
    ZW0, ZW1, ZW2, Vp, _gbp, _Pp, U, _ga = ld.linearize_dense(
        pa.K, pa.q0, cams, pts, pa.obs_du, pa.obs_dv, pa.valid_d,
        want_u=True, kq=pa.kq)
    ZW3 = (ZW0, ZW1, ZW2)
    mu = cfg.tau * float(sc.max_diag_planar(U, Vp, prob.n_pts))
    Ud = U + mu * torch.eye(6, dtype=f32, device=dev)
    Vinv, _ok = sc.inv3x3_planar3(sc.damp_v_planar(Vp, mu))
    d = lambda t: tuple(x.double() for x in t)
    S64, ZY64 = sc.schur_S_dense3(Ud.double(), d(ZW3), Vinv.double())
    C = Ud.shape[0]
    off64 = sum(ZY64[j] @ ZW3[j].double().T for j in range(3))
    del ZY64
    torch.set_float32_matmul_precision("high")
    try:
        S_hi, ZY3 = sc.schur_S_dense3(Ud, ZW3, Vinv)
        tf32_after = torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.set_float32_matmul_precision("highest")
    need(not tf32_after, "3h: allow_tf32 on after the 'high' product")
    S_fp, _ = sc.schur_S_dense3(Ud, ZW3, Vinv)
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        off_tf = sum(ZY3[j] @ ZW3[j].T for j in range(3))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    S_tf = (-off_tf).reshape(C, 6, C, 6)
    S_tf.diagonal(dim1=0, dim2=2).add_(Ud.permute(1, 2, 0))
    S_tf = S_tf.reshape(6 * C, 6 * C)
    err = {"high": s_error(S_hi, S64), "highest": s_error(S_fp, S64),
           "tf32": s_error(S_tf, S64)}
    blk = torch.block_diag(*Ud.double())
    err_off = {k: float(torch.linalg.norm((blk - S.double()) - off64)
                        / torch.linalg.norm(off64))
               for k, S in (("high", S_hi), ("highest", S_fp),
                            ("tf32", S_tf))}
    print(f"[3h] (a) S of the 138-camera problem's first try (n = {6 * C}, "
          f"Pp = {ZW0.shape[1]}): the products' normwise relative error "
          f"against float64 high {err_off['high']:.3e}, highest "
          f"{err_off['highest']:.3e}, single-pass TF32 "
          f"{err_off['tf32']:.3e}; of S high {err['high']:.3e}, highest "
          f"{err['highest']:.3e}, TF32 {err['tf32']:.3e}", flush=True)
    need(err_off["high"] <= 2 * err_off["highest"] + 2.0 ** -21,
         f"3h: 'high' products' error {err_off['high']:.3e} above 2 x "
         f"float32's {err_off['highest']:.3e} + 2^-21")
    need(err_off["high"] <= err_off["tf32"] / 10,
         f"3h: 'high' products' error {err_off['high']:.3e} not a tenth of "
         f"TF32's {err_off['tf32']:.3e}")
    del S64, off64, S_tf, off_tf, blk
    ms = {
        "S_try": cuda_ms(lambda: sc.schur_S_dense3(Ud, ZW3, Vinv)),
        "products": cuda_ms(
            lambda: sum(ZY3[j] @ ZW3[j].T for j in range(3))),
    }
    need(not torch.backends.cuda.matmul.allow_tf32,
         "3h: allow_tf32 left on after the timings")
    flops = 2.0 * (6 * C) ** 2 * 3 * ZW0.shape[1]
    print(f"[3h] (c) ms per try, CUDA events, both precisions: "
          f"schur_S_dense3 {ms['S_try']:.4f}; its products alone "
          f"{ms['products']:.4f} ms "
          f"({flops / ms['products'] / 1e9:.1f} TFLOP/s)", flush=True)
    return dict(err=err, err_products=err_off, ms=ms, n=6 * C,
                Pp=ZW0.shape[1], mu=mu)


def high_solves(label, prob, cfg, dev, reset, read, ok_flags) -> dict:
    """Phase 3h (b) and (c) on one problem: the default float32 solve in
    turns "highest", "high", "high", "highest", each with the launch
    counters set to 0 just before and read just after, the peak device
    memory reset before it. Each "high" run: final L2 within 1e-3 of the
    first "highest" run's, a normal stop, linearize_dense, spd_solve,
    gain_dense and jgram_dense launched, TF32 off after it."""
    import numpy as np
    import psba_tpu_torch
    import torch

    f32 = torch.float32
    psba_tpu_torch.solve(prob, cfg._replace(max_iters=8, s_precision="high"),
                         dtype=f32, device=dev)        # warm-up
    runs = []
    for prec in ("highest", "high", "high", "highest"):
        torch.cuda.reset_peak_memory_stats(dev)
        reset()
        r = psba_tpu_torch.solve(prob, cfg._replace(s_precision=prec),
                                 dtype=f32, device=dev)
        got = read()
        per = per_phase_iterations(r)
        runs.append(dict(
            precision=prec, final_l2=r.final_l2, flag=r.flag_name,
            phases=r.phases, iterations=per, launches=got,
            lm_iter_ms=1e3 * r.phase_seconds["lm"] / per["lm"],
            tr_iter_ms=(1e3 * r.phase_seconds["tr"] / per["tr"]
                        if "tr" in per else None),
            peak_gib=peak_gib(dev),
            allow_tf32_after=torch.backends.cuda.matmul.allow_tf32))
        v = runs[-1]
        print(f"[3h] {label} {prec}: {r}; phases {r.phases}; ms per LM "
              f"iteration {v['lm_iter_ms']:.3f}, per TR iteration "
              f"{v['tr_iter_ms'] or float('nan'):.3f}; peak "
              f"{v['peak_gib']:.3f} GiB; launches {got}", flush=True)
    base = runs[0]["final_l2"]
    for v in runs:
        need(np.isfinite(v["final_l2"]) and v["flag"] in ok_flags,
             f"3h {label} {v['precision']}: abnormal stop {v['flag']}")
        need(not v["allow_tf32_after"],
             f"3h {label} {v['precision']}: allow_tf32 on after the solve")
        if v["precision"] != "high":
            continue
        rel = abs(v["final_l2"] - base) / base
        v["rel_final_l2_to_highest"] = rel
        print(f"[3h] {label} high: final L2 rel to highest {rel:.3e} "
              "(tolerance 1e-3)", flush=True)
        need(rel <= 1e-3, f"3h {label}: 'high' final L2 {rel:.3e} from "
             "'highest'")
        for k in ("linearize_dense", "spd_solve", "gain_dense",
                  "jgram_dense"):
            need(v["launches"][k] > 0,
                 f"3h {label} high: kernel {k} not launched")
    return runs


def render(uv, H, W):
    """tests/test_frontend.py's render: a 5x5 texture for each point,
    seeded by its index, with a strong centre, on a dark gradient."""
    import numpy as np

    img = np.linspace(0, 0.1, W)[None, :] * np.ones((H, 1))
    for i, (u, v) in enumerate(uv):
        ui, vi = int(round(u)), int(round(v))
        if 3 <= ui < W - 3 and 3 <= vi < H - 3:
            tex = np.random.default_rng(1000 + i).uniform(0.2, 1.0, (5, 5))
            tex[2, 2] = 1.5
            img[vi - 2:vi + 3, ui - 2:ui + 3] += tex
    return img


def frontend_phase(dev, reset, read, lm_path) -> dict:
    """Phase 8: the front-end on the card. 8 views at 1024 x 768 of 600
    planted points (the render of tests/test_frontend.py; the camera turns
    0.02 rad about y and moves 0.15 to the side a view), n_features=1024:
    sequence_problem on CUDA against the same call on the CPU (the
    corners with a positive score as sets, the valid matches as sets of
    pixel pairs, the poses to 1e-4), each stage's milliseconds on the card,
    then the problem solved on the card in float32 (the kernels; the
    front-end's problem is float64, which would take the XLA form) with
    the counters set to 0 just before and read just after: the LM path's
    kernels launched and the RMS under 1 px."""
    import numpy as np
    import psba_tpu_torch
    import torch

    from psba_tpu_torch.frontend import pipeline as fp
    from psba_tpu_torch.frontend.features import detect_and_describe
    from psba_tpu_torch.frontend.matching import match_descriptors
    from psba_tpu_torch.frontend.twoview import (
        decompose_essential,
        triangulate,
    )
    from psba_tpu_torch.solvers import SolverConfig

    K = [800.0, 512.0, 384.0, 1.0, 0.0]
    rng = np.random.default_rng(0)
    X = rng.uniform([-3.0, -2.2, 7.0], [3.0, 2.2, 14.0], size=(600, 3))
    imgs = []
    for i in range(8):
        a = 0.02 * i
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        Xc = X @ R.T + np.array([-0.15 * i, 0.0, 0.0])
        imgs.append(render(Xc[:, :2] / Xc[:, 2:3] * K[0]
                           + np.array(K[1:3]), 768, 1024))
    kw = dict(n_features=1024)

    # CUDA against the CPU: corners, matches, poses
    feats = {}
    for d in ("cuda", "cpu"):
        feats[d] = [detect_and_describe(im, k=1024, device=d) for im in imgs]
    n_corners = []
    for fc, fh in zip(feats["cuda"], feats["cpu"]):
        sets = [set(map(tuple, f[0][f[1] > 0].cpu().numpy().tolist()))
                for f in (fc, fh)]
        n_corners.append(len(sets[0]))
        need(sets[0] == sets[1], "8: the corners (score > 0) on CUDA and "
             f"the CPU differ in {len(sets[0] ^ sets[1])}")
    n_matches = []
    for i in range(7):
        pairs = []
        for d in ("cuda", "cpu"):
            (xy1, s1, d1), (xy2, s2, d2) = feats[d][i], feats[d][i + 1]
            idx2, valid = match_descriptors(d1, d2, s1, s2)
            xy1, xy2 = xy1.cpu().numpy(), xy2.cpu().numpy()
            idx2, valid = idx2.cpu().numpy(), valid.cpu().numpy()
            pairs.append({(*xy1[a], *xy2[idx2[a]])
                          for a in np.flatnonzero(valid)})
        n_matches.append(len(pairs[0]))
        need(pairs[0] == pairs[1], f"8: pair {i}: the valid matches on CUDA "
             f"and the CPU differ in {len(pairs[0] ^ pairs[1])}")
    # twice on the card: the first call includes the libraries' first use
    # (the batched SVDs, the determinants)
    seq_s = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p_gpu = fp.sequence_problem(imgs, K, device="cuda", **kw)
        torch.cuda.synchronize()
        seq_s.append(time.perf_counter() - t)
    t = time.perf_counter()
    p_cpu = fp.sequence_problem(imgs, K, device="cpu", **kw)
    seq_cpu_s = time.perf_counter() - t
    pose_gap = {}
    for f in ("q0", "cams"):
        a, b = getattr(p_gpu, f), getattr(p_cpu, f)
        need(a.shape == b.shape, f"8: {f} shapes differ")
        pose_gap[f] = float(np.max(np.abs(a - b)) / max(np.abs(b).max(),
                                                         1.0))
    print(f"[8] front-end, 8 views 1024x768, 600 planted points: corners "
          f"(score > 0) per view {n_corners}, valid matches per pair "
          f"{n_matches}, all equal on CUDA and the CPU; poses CUDA vs CPU "
          f"q0 {pose_gap['q0']:.3e}, cams {pose_gap['cams']:.3e} "
          f"(tolerance 1e-4); problem C={p_gpu.n_cams} P={p_gpu.n_pts} "
          f"O={p_gpu.n_obs} (CPU: P={p_cpu.n_pts}); sequence_problem "
          f"{seq_s[0]:.3f} s (first call), {seq_s[1]:.3f} s on CUDA, "
          f"{seq_cpu_s:.3f} s on the CPU", flush=True)
    need(max(pose_gap.values()) <= 1e-4, f"8: poses differ {pose_gap}")

    # each stage on the card, in the order sequence_problem runs them
    def stage(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, 1e3 * (time.perf_counter() - t0)

    norm = fp._normalizer(K)
    st = {}
    fts, st["detect_describe_8"] = stage(lambda: [
        detect_and_describe(im, k=1024, device="cuda") for im in imgs])
    xyn = [norm(f[0]) for f in fts]
    m, st["match_7"] = stage(lambda: [
        match_descriptors(fts[i][2], fts[i + 1][2], fts[i][1],
                          fts[i + 1][1]) for i in range(7)])
    x2n = [xyn[i + 1][m[i][0].long()] for i in range(7)]
    ev, st["ransac_7"] = stage(lambda: [
        fp._estimate_E(xyn[i], x2n[i], m[i][1], 64, K[0], seed=i)
        for i in range(7)])
    rt, st["decompose_7"] = stage(lambda: [
        decompose_essential(ev[i][0], xyn[i], x2n[i], ev[i][1])
        for i in range(7)])
    _, st["triangulate_7"] = stage(lambda: [
        triangulate(rt[i][0], rt[i][1], xyn[i], x2n[i]) for i in range(7)])
    st["sequence_problem_first"] = 1e3 * seq_s[0]
    st["sequence_problem"] = 1e3 * seq_s[1]
    print("[8] stage ms on CUDA: " + ", ".join(
        f"{k} {v:.3f}" for k, v in st.items()), flush=True)

    cfg = SolverConfig.for_dtype(torch.float32)
    psba_tpu_torch.solve(p_gpu, cfg._replace(max_iters=2),
                         dtype=torch.float32, device=dev)    # warm-up
    reset()
    res = psba_tpu_torch.solve(p_gpu, cfg, dtype=torch.float32, device=dev)
    got = read()
    rms = float(np.sqrt(res.final_l2 / p_gpu.n_obs))
    rms0 = float(np.sqrt(res.initial_l2 / p_gpu.n_obs))
    print(f"[8] solve on the card, float32: {res}; phases {res.phases}; RMS "
          f"{rms0:.4f} -> {rms:.4f} px; launches {got}", flush=True)
    need(rms < 1.0 and res.final_l2 <= res.initial_l2,
         f"8: RMS {rms:.4f} px after the solve")
    for k in lm_path:
        need(got[k] > 0, f"8: kernel {k} not launched by the solve")
    return dict(corners=n_corners, matches=n_matches, pose_gap=pose_gap,
                C=p_gpu.n_cams, P=p_gpu.n_pts, O=p_gpu.n_obs,
                stage_ms=st, sequence_cpu_s=seq_cpu_s, rms_px=rms,
                initial_rms_px=rms0, phases=res.phases, launches=got)


def peak_gib(dev) -> float:
    import torch

    return torch.cuda.max_memory_allocated(dev) / 2**30


def f64_breakdown(prob, dev) -> dict:
    """CUDA-event ms (median of 10 after warm-up) of each stage of one
    float64 XLA-form LM iteration on the dense encoding at `prob`'s shape,
    from its starting state: once per iteration the Jacobians,
    assemble_blocks and stack_blocks (the gather); per try the damping with
    inv3x3_planar, schur_S_dense (the ZY planes, then the DGEMM, also timed
    alone, with its bound at the float64 tensor-core rate),
    reduced_rhs_dense, spd_solve_xla (cholesky_ex + cholesky_solve),
    back_substitute_dense and the trial residual with its gain."""
    import torch

    from psba_tpu_torch.core import hessian as th
    from psba_tpu_torch.core import linalg as tl
    from psba_tpu_torch.core import schur as ts
    from psba_tpu_torch.core.jacobian import jacobians
    from psba_tpu_torch.core.residual import error_l2_diff, residuals
    from psba_tpu_torch.solvers import ProblemArrays

    f64 = torch.float64
    pa = ProblemArrays.from_problem(prob, dtype=f64, device=dev)
    cams = torch.as_tensor(prob.cams, dtype=f64, device=dev)
    pts = torch.as_tensor(prob.pts, dtype=f64, device=dev)
    C, P = prob.n_cams, prob.n_pts
    idx = (pa.cam_idx, pa.pt_idx)
    ex = residuals(pa.K, pa.q0, cams, pts, pa.obs, *idx)
    A, B = jacobians(pa.K, pa.q0, cams, pts, *idx)
    U, V, W, ga, gb = th.assemble_blocks(A, B, ex, *idx, C, P)
    ZW, gbp = ts.stack_blocks(W, pa.blk_idx), ts.planar_gb(gb)
    mu = 1e-3 * float(th.max_diag(U, V))
    U_d, V_d = th.damp_uv(U, V, mu)
    Vp, _ok = ts.inv3x3_planar(V_d)
    S, ZY = ts.schur_S_dense(U_d, ZW, Vp)
    ea = ts.reduced_rhs_dense(ga, gbp, ZY)
    dpa, ok = tl.spd_solve_xla(S, ea.reshape(-1))
    need(bool(ok), "float64 breakdown: cholesky_ex failed")
    dpa = dpa.reshape(C, 6)
    _ebp, dpb = ts.back_substitute_dense(gbp, ZW, Vp, dpa)

    def trial():
        new = residuals(pa.K, pa.q0, cams + dpa, pts + dpb, pa.obs, *idx)
        return error_l2_diff(ex, new)

    once = {
        "jacobians": lambda: jacobians(pa.K, pa.q0, cams, pts, *idx),
        "assemble_blocks": lambda: th.assemble_blocks(A, B, ex, *idx, C, P),
        "stack_blocks": lambda: ts.stack_blocks(W, pa.blk_idx),
    }
    per_try = {
        "damp_inv3x3_planar": lambda: ts.inv3x3_planar(
            th.damp_uv(U, V, mu)[1]),
        "schur_S_dense": lambda: ts.schur_S_dense(U_d, ZW, Vp),
        "reduced_rhs_dense": lambda: ts.reduced_rhs_dense(ga, gbp, ZY),
        "spd_solve_xla": lambda: tl.spd_solve_xla(S, ea.reshape(-1)),
        "back_substitute_dense": lambda: ts.back_substitute_dense(
            gbp, ZW, Vp, dpa),
        "trial_residual_gain": trial,
    }
    out = {"once": {k: cuda_ms(f) for k, f in once.items()},
           "per_try": {k: cuda_ms(f) for k, f in per_try.items()}}
    out["s_dgemm_ms"] = cuda_ms(lambda: torch.matmul(ZY, ZW.T))
    n, k = 6 * C, 3 * P
    flops = 2.0 * n * n * k
    out["s_dgemm_tflops"] = flops / out["s_dgemm_ms"] / 1e9
    out["s_dgemm_bound_ms"] = max(1e3 * flops / F64_TC_FLOPS_PER_S,
                                  1e3 * 8.0 * (2 * n * k + n * n)
                                  / HBM_BYTES_PER_S)
    out["once_ms"] = sum(out["once"].values())
    out["try_ms"] = sum(out["per_try"].values())
    return out


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


def profile(prob, cfg, dev, schur, f64=False, name=None) -> None:
    """torch.profiler tables of three LM iterations (lm_run alone) and three
    TR iterations (tr_run alone, entered with lambda = 1 so the table shows
    a steady TR iteration rather than the GMW bootstrap) on the `schur`
    encoding, in float32 (the kernel path) or with `f64` in float64 (the
    XLA form), each after a warm-up: kernel time by name (written to
    chiprun_out/profile_<schur>[_f64]_<lm|tr>3.txt) and the device's busy
    share (printed); `name` replaces the encoding in the tag."""
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
    dt = torch.float64 if f64 else torch.float32
    tag = name or schur
    tag = f"{tag}_f64" if f64 else tag
    pa = ProblemArrays.from_problem(prob, dtype=dt, device=dev, schur=schur)
    cams = torch.as_tensor(prob.cams, dtype=dt, device=dev)
    pts = torch.as_tensor(prob.pts, dtype=dt, device=dev)
    c3 = resolve_damping(cfg._replace(max_iters=3, lm_switch_count=10_000),
                         pa, cams, pts)
    aux = torch.tensor([cfg.init_delta, 1.0, 1.0, 2.0, 0.0, 0.0], dtype=dt,
                       device=dev)

    def lm():
        return lm_run(pa, OptState.init(pa, cams, pts), c3)

    def tr():
        st = OptState.init(pa, cams, pts)
        st.aux = aux
        return tr_run(pa, st, c3)

    for phase, run in (("lm", lm), ("tr", tr)):
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
        summary = (f"[profile] {tag}: OptState.init + {phase}_run, "
                   f"{out.itno} iterations: wall {wall_ms:.3f} ms (profiler "
                   f"off), device busy {busy:.3f} ms (profiler on), idle "
                   f"share {1 - busy / wall_ms:.3f}")
        path = os.path.join(OUT_DIR, f"profile_{tag}_{phase}3.txt")
        with open(path, "w") as f:
            f.write(summary + "\n" + table)
        print(f"{summary}; table in {os.path.relpath(path, REPO)}",
              flush=True)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
