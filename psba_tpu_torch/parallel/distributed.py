"""Multi-process solve over a torch.distributed process group (PyTorch
counterpart of psba_tpu.parallel.distributed).

  - `init_distributed` starts the default process group (idempotent; a
    no-op for one process without a coordinator).
  - `solve_distributed` is called by every rank of a group with the same
    problem: each builds the same partition (parallel.shard.shard_problem),
    moves only its own shard to its device (`slice_local`,
    shard.local_arrays) and runs the hybrid LM / TR alternation with the
    group's reductions (parallel.ctx.MeshCtx). Every rank reads the same
    reduced scalars, so all take the same phase switches without another
    collective. Each returns its own points.
  - `run_ranks` starts one process per rank on this host (spawn; a
    FileStore in a temporary directory, so no network), runs a function in
    each (`solve_rank`: solve_distributed; `lm_repeat_rank`: the sharded
    repeats runner, parallel.shard.make_sharded_lm_repeat) and collects
    the results; a rank that fails, or a run past its timeout, stops them
    all and raises. parallel.shard.solve_sharded is built on it.
"""

from __future__ import annotations

import dataclasses
import os
import queue as queue_mod
import tempfile
import time
import traceback

import numpy as np
import torch

from psba_tpu_torch import constants as CC
from psba_tpu_torch.parallel.ctx import NO_MESH, MeshCtx
from psba_tpu_torch.parallel.shard import (
    ShardedProblem,
    local_arrays,
    resolve_damping_host,
    shard_problem,
)
from psba_tpu_torch.problem import BAProblem
from psba_tpu_torch.solvers.types import OptState, SolverConfig, torch_dtype
from psba_tpu_torch.utils.device import resolve_device


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None, device=None) -> None:
    """Start the default torch.distributed process group (idempotent; a
    no-op for one process without a coordinator).

    `coordinator_address` is an init_method: "tcp://host:port" or
    "file:///path". `backend` defaults to "nccl" for a CUDA `device`, "gloo"
    otherwise; with NCCL the group binds `device` at once."""
    import torch.distributed as dist

    if num_processes == 1 and coordinator_address is None:
        return
    if dist.is_initialized():
        if num_processes is not None and dist.get_world_size() != \
                num_processes:
            raise RuntimeError(
                f"a process group of {dist.get_world_size()} processes is "
                f"already running, not {num_processes}")
        return
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if backend is None:
        backend = "nccl" if dev is not None and dev.type == "cuda" else "gloo"
    kw = {}
    if backend == "nccl" and dev is not None:
        torch.cuda.set_device(dev)
        kw["device_id"] = dev
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes, rank=process_id, **kw)


def slice_local(sp: ShardedProblem, rank: int) -> ShardedProblem:
    """The shard of `rank` as a one-shard ShardedProblem (rows
    [rank * per, (rank + 1) * per) of the stacked arrays)."""

    def take(a, per, axis=0):
        if a is None:
            return None
        return np.take(a, range(rank * per, (rank + 1) * per), axis=axis)

    return dataclasses.replace(
        sp,
        n_devices=1,
        obs=take(sp.obs, sp.o_per),
        cam_idx=take(sp.cam_idx, sp.o_per),
        pt_idx=take(sp.pt_idx, sp.o_per),
        valid=take(sp.valid, sp.o_per),
        pts=take(sp.pts, sp.p_per),
        pt_valid=take(sp.pt_valid, sp.p_per),
        pt_starts=sp.pt_starts[rank:rank + 2] - sp.pt_starts[rank],
        pair_o1=take(sp.pair_o1, sp.n_per),
        pair_o2=take(sp.pair_o2, sp.n_per),
        pair_bucket=take(sp.pair_bucket, sp.n_per),
        blk=take(sp.blk, sp.p_per, axis=1),
        obs_du=take(sp.obs_du, sp.p_per, axis=1),
        obs_dv=take(sp.obs_dv, sp.p_per, axis=1),
        valid_d=take(sp.valid_d, sp.p_per, axis=1),
    )


def _rank_start(prob: BAProblem, cfg: SolverConfig | None, dtype, schur,
                device, group, who: str, timed: bool = False):
    """This rank's part of a sharded run of `prob` over `group` (default:
    the default process group if one runs, else one shard and no mesh):
    (cfg with its damping resolved on the whole problem, the shard's
    ProblemArrays on `device`, OptState.init of the shard with the
    group's L2, the MeshCtx, the one-shard ShardedProblem)."""
    import torch.distributed as dist

    if group is None and dist.is_available() and dist.is_initialized():
        group = dist.group.WORLD
    world = 1 if group is None else dist.get_world_size(group)
    rank = 0 if group is None else dist.get_rank(group)
    device = resolve_device(device, who)
    dt = torch_dtype(prob.pts.dtype if dtype is None else dtype)
    cfg = cfg or SolverConfig.for_dtype(dt)
    cfg = resolve_damping_host(cfg, prob, dt, device)
    local = slice_local(shard_problem(prob, world, schur=schur), rank)
    pa = local_arrays(local, dt, device, backend=cfg.backend)
    ctx = NO_MESH if group is None else MeshCtx(group, timed=timed)
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dt, device=device)
    state = OptState.init(pa, as_t(prob.cams), as_t(local.pts),
                          clamp=cfg.clamp_quat, ctx=ctx)
    return cfg, pa, state, ctx, local


def solve_distributed(prob: BAProblem, cfg: SolverConfig | None = None,
                      dtype=None, start="lm", schur="auto", device=None,
                      group=None, time_collectives: bool = False):
    """Hybrid solve of this rank's shard of `prob` over `group` (default:
    the default process group if one runs, else one shard and no mesh).

    Every rank of the group calls it with the same arguments but its own
    `device` (default: the current CUDA device; raises without a card).
    Returns a SolveResult whose cams, errors, iterations, flag and phases
    are the group's, and whose pts are this rank's real points (its range
    of shard_problem's pt_starts, in order). `collectives` holds
    the group's collectives by tag (MeshCtx.summary); with
    `time_collectives` each is timed between two device synchronizations."""
    from psba_tpu_torch.solvers.hybrid import SolveResult
    from psba_tpu_torch.solvers.lm import lm_run
    from psba_tpu_torch.solvers.tr import tr_run
    from psba_tpu_torch.utils.timing import PhaseTimers

    if start not in ("lm", "tr"):
        raise ValueError(f"start={start!r}: 'lm' or 'tr'")
    cfg, pa, state, ctx, local = _rank_start(
        prob, cfg, dtype, schur, device, group, "solve_distributed",
        timed=time_collectives)
    device = state.cams.device
    initial_l2 = float(state.ex_l2)
    timers = PhaseTimers()
    t0 = time.perf_counter()
    phase, phases = start, []
    while True:
        with timers.phase(phase):
            state = (lm_run if phase == "lm" else tr_run)(pa, state, cfg,
                                                          ctx=ctx)
        flag = state.flag
        phases.append((phase, state.itno, flag))
        if phase == "lm" and flag == CC.ITER_TURN_TO_TR:
            phase = "tr"
        elif phase == "tr" and flag == CC.ITER_TURN_TO_LM:
            phase = "lm"
        else:
            break
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    wall = time.perf_counter() - t0

    final_l2 = float(state.ex_l2)
    n_real = int(local.pt_starts[1])
    return SolveResult(
        cams=state.cams.cpu().numpy(),
        pts=state.pts[:n_real].cpu().numpy(),
        resolved_damping=cfg.damping,
        initial_l2=initial_l2, final_l2=final_l2,
        initial_error=float(np.sqrt(initial_l2) / prob.n_obs),
        final_error=float(np.sqrt(final_l2) / prob.n_obs),
        iterations=state.itno, flag=flag,
        flag_name=CC.FLAG_NAMES.get(flag, str(flag)),
        wall_s=wall, phases=phases, history=state.history,
        phase_report=timers.report(), phase_seconds=dict(timers.totals),
        collectives=ctx.summary(),
    )


def kernel_launches() -> dict:
    """The launch counters of the seven kernel wrappers, by name."""
    from psba_tpu_torch.ops import cholesky, linearize_dense
    from psba_tpu_torch.ops import linearize_stream, residual_dense
    from psba_tpu_torch.ops import schur_pairs

    return {
        "linearize_dense": linearize_dense.linearize_dense.launches,
        "spd_solve": cholesky.spd_solve.launches,
        "gain_dense": residual_dense.gain_dense.launches,
        "jgram_dense": residual_dense.jgram_dense.launches,
        "linearize_stream": linearize_stream.linearize_stream.launches,
        "residual_l2": linearize_stream.residual_l2.launches,
        "schur_pairs": schur_pairs.schur_pairs.launches,
    }


def solve_rank(device, **kw) -> dict:
    """solve_distributed(device=device, **kw) on the default group:
    {"result": its SolveResult, "launches": the kernels it launched}."""
    before = kernel_launches()
    res = solve_distributed(device=device, **kw)
    after = kernel_launches()
    return dict(result=res,
                launches={k: after[k] - before[k] for k in after})


def lm_repeat_rank(device, prob: BAProblem, iter_cap: int, repeats: int,
                   cfg: SolverConfig | None = None, dtype=None,
                   schur="auto") -> dict:
    """parallel.shard.make_sharded_lm_repeat on this rank's shard of
    `prob` over the default group, built as solve_distributed builds it:
    {"acc_l2": the summed final L2 (float), "total_itno": the summed
    iterations, "seconds": the runner's wall time between two device
    synchronizations, "launches": the kernels it launched}."""
    from psba_tpu_torch.parallel.shard import make_sharded_lm_repeat

    cfg, pa, state0, ctx, _ = _rank_start(prob, cfg, dtype, schur, device,
                                          None, "lm_repeat_rank")
    run = make_sharded_lm_repeat(cfg, ctx)
    dev = state0.cams.device
    sync = ((lambda: torch.cuda.synchronize(dev)) if dev.type == "cuda"
            else lambda: None)
    before = kernel_launches()
    sync()
    t0 = time.perf_counter()
    acc, itno = run(pa, state0, iter_cap, repeats)
    acc_l2 = float(acc)
    sync()
    secs = time.perf_counter() - t0
    after = kernel_launches()
    return dict(acc_l2=acc_l2, total_itno=itno, seconds=secs,
                launches={k: after[k] - before[k] for k in after})


def _rank_main(rank, world, backend, store, device, fn, kw, nthreads, out):
    """Body of a spawned rank: join the group, run fn, report."""
    import torch.distributed as dist

    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(nthreads)
        # the ranks share this host: keep their traffic on the loopback
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        extra = {"device_id": dev} if backend == "nccl" else {}
        dist.init_process_group(backend, store=dist.FileStore(store, world),
                                rank=rank, world_size=world, **extra)
        out.put(("ok", rank, fn(dev, **kw)))
    except BaseException:
        out.put(("error", rank, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(devices, backend: str, fn=solve_rank,
              timeout: float | None = None, **kw) -> list:
    """fn(device, **kw) in len(devices) ranks of one default process group
    on this host, rank r on devices[r] over `backend` ("nccl" or "gloo";
    gloo also takes CUDA tensors). `fn` must be a module-level function
    (the ranks are spawned); one rank runs in the calling process. Returns
    each rank's return value, in rank order. A failed rank, a rank that
    dies or a run past `timeout` seconds stops every rank and raises."""
    import multiprocessing as mp

    import torch.distributed as dist

    n = len(devices)
    if any(torch.device(d).type == "cuda" for d in devices):
        if not torch.cuda.is_available():
            raise RuntimeError("run_ranks: CUDA devices named, but torch "
                               "sees no CUDA device")
        # build the kernels once, before the ranks would race to
        from psba_tpu_torch.ops import _build

        _build.build()
    with tempfile.TemporaryDirectory(prefix="psba_ranks_") as tmp:
        store = os.path.join(tmp, "store")
        if n == 1:
            if dist.is_initialized():
                raise RuntimeError(
                    "run_ranks: a process group is already running here; "
                    "call solve_distributed inside it instead")
            dev = torch.device(devices[0])
            extra = {"device_id": dev} if backend == "nccl" else {}
            dist.init_process_group(backend, store=dist.FileStore(store, 1),
                                    rank=0, world_size=1, **extra)
            try:
                return [fn(dev, **kw)]
            finally:
                dist.destroy_process_group()
        ctx = mp.get_context("spawn")
        out = ctx.Queue()
        nthreads = max(1, torch.get_num_threads() // n)
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            r, n, backend, store, devices[r], fn, kw, nthreads, out))
            for r in range(n)]
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        results = [None] * n
        try:
            while any(r is None for r in results):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"run_ranks: {n} ranks still running "
                                       f"after {timeout} s")
                try:
                    kind, r, payload = out.get(timeout=0.5)
                except queue_mod.Empty:
                    for i, p in enumerate(procs):
                        if results[i] is None and p.exitcode not in (None,
                                                                     0):
                            raise RuntimeError(f"rank {i} died with exit "
                                               f"code {p.exitcode}")
                    continue
                if kind == "error":
                    raise RuntimeError(f"rank {r} failed:\n{payload}")
                results[r] = payload
            for p in procs:
                p.join(timeout=60)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
        return results


def gather_points(results: list) -> "SolveResult":
    """Rank 0's SolveResult with every rank's points in rank order (the
    caller's point order). Raises if the ranks disagree on the result."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        if (res.final_l2 != first.final_l2 or res.phases != first.phases
                or not np.array_equal(res.cams, first.cams)):
            raise RuntimeError(f"rank {r} ended apart from rank 0: "
                               f"{res} vs {first}")
    return dataclasses.replace(
        first, pts=np.concatenate([res.pts for res in results], axis=0))
