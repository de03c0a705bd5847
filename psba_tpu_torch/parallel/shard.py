"""Problem sharding and the sharded solve (PyTorch counterpart of
psba_tpu.parallel.shard).

Partitioning, as in the reference:
  - points are split into contiguous ranges with balanced observation
    counts; every observation lives with its point's shard, so per-point
    work (V, gb, eb, dpb) and the Schur covisibility pairs stay on the
    shard;
  - cameras, intrinsics and every solver control scalar are replicated;
  - the reduced camera system (U, ga, S, ea) and every global scalar are
    summed over the shards (parallel.ctx.MeshCtx), the only traffic
    between them. Per LM try that is S (36 C^2 floats), ea and a handful
    of scalars, whatever the number of points.

`shard_problem` is the numpy partition (the reference's arrays exactly);
`solve_sharded` starts one process per shard on this host
(parallel.distributed.run_ranks): NCCL with rank r on cuda:r, or gloo on
the CPU. Each process runs parallel.distributed.solve_distributed on its
shard, and the points come back in the caller's order.
`make_sharded_lm_repeat` is the timing runner of a rank: identical
fixed-length lm_run trajectories, their L2 and iterations summed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from psba_tpu_torch.parallel.ctx import MeshCtx
from psba_tpu_torch.problem import BAProblem, build_covis_pairs
from psba_tpu_torch.solvers.lm import lm_run
from psba_tpu_torch.solvers.types import (
    DENSE_MAX_ENTRIES,
    OptState,
    ProblemArrays,
    SolverConfig,
    resolve_damping,
)
from psba_tpu_torch.utils.device import resolve_device


@dataclasses.dataclass(frozen=True)
class ShardedProblem:
    """Host-side stacked shard arrays (leading axis = n_devices * local),
    the reference's ShardedProblem field for field."""

    n_devices: int
    o_per: int            # padded observations per shard
    p_per: int            # padded points per shard
    n_per: int            # padded covis pairs per shard (0 when dense)
    K: np.ndarray         # [C, 5] replicated
    q0: np.ndarray        # [C, 4]
    cams: np.ndarray      # [C, 6]
    obs: np.ndarray       # [D * o_per, 2]
    cam_idx: np.ndarray   # [D * o_per]
    pt_idx: np.ndarray    # [D * o_per] shard-local numbering
    valid: np.ndarray     # [D * o_per] bool
    pts: np.ndarray       # [D * p_per, 3] zero-padded
    pt_valid: np.ndarray  # [D * p_per] bool
    pt_starts: np.ndarray    # [D + 1] global point range per shard
    # the Schur encoding, one of the two (solvers.types.ProblemArrays)
    pair_o1: np.ndarray | None = None  # [D * n_per] shard-local obs numbers
    pair_o2: np.ndarray | None = None  # [D * n_per]
    pair_bucket: np.ndarray | None = None  # [D * n_per]; C*C marks padding
    blk: np.ndarray | None = None  # [C, D * p_per] shard-local obs numbers;
    # o_per marks unseen cells (split on the point axis, dim 1)
    obs_du: np.ndarray | None = None   # [C, D * p_per] float32
    obs_dv: np.ndarray | None = None   # [C, D * p_per] float32
    valid_d: np.ndarray | None = None  # [C, D * p_per] float32


def shard_problem(prob: BAProblem, n_devices: int,
                  schur: str = "auto") -> ShardedProblem:
    """Split a problem into point-contiguous shards with balanced
    observation counts. `schur` in {"auto", "dense", "pairs"} picks the
    per-shard encoding; "auto" decides on the largest shard's [C, p_per]
    table against solvers.types.DENSE_MAX_ENTRIES. Padded observations
    repeat the shard's first one (finite residuals) and are False in
    `valid`; padded points are zero; padded pairs carry bucket C*C."""
    from psba_tpu_torch.ops.linearize_dense import dense_obs_tables

    Pn, C = prob.n_pts, prob.n_cams
    if Pn < n_devices:
        raise ValueError(f"{n_devices} shards need at least as many points "
                         f"(the problem has {Pn})")
    cum = np.concatenate([[0], np.cumsum(
        np.bincount(prob.pt_idx, minlength=Pn))])
    # cut where the cumulative observation count crosses i * O / D
    targets = (np.arange(1, n_devices) * prob.n_obs) / n_devices
    cuts = np.searchsorted(cum[1:], targets, side="left") + 1
    pt_starts = np.concatenate([[0], cuts, [Pn]]).astype(np.int64)
    # strictly increasing (degenerate tiny shards)
    for i in range(1, len(pt_starts)):
        pt_starts[i] = max(pt_starts[i], pt_starts[i - 1] + 1)
    pt_starts[-1] = Pn
    if schur == "auto":
        max_p_per = int(np.max(np.diff(pt_starts)))
        schur = "dense" if C * max_p_per <= DENSE_MAX_ENTRIES else "pairs"
    if schur not in ("dense", "pairs"):
        raise ValueError(f"schur={schur!r}")
    dense = schur == "dense"

    shards = []
    for d in range(n_devices):
        p_lo, p_hi = pt_starts[d], pt_starts[d + 1]
        o_lo, o_hi = cum[p_lo], cum[p_hi]
        loc_pt = prob.pt_idx[o_lo:o_hi] - p_lo
        loc_cam = prob.cam_idx[o_lo:o_hi]
        if dense:
            o1 = o2 = bucket = np.zeros(0, np.int32)
        else:
            o1, o2, bucket = build_covis_pairs(loc_pt, loc_cam, C)
        shards.append(dict(
            obs=prob.obs[o_lo:o_hi], cam_idx=loc_cam, pt_idx=loc_pt,
            pts=prob.pts[p_lo:p_hi], o1=o1, o2=o2, bucket=bucket,
        ))

    o_per = max(len(s["cam_idx"]) for s in shards)
    p_per = max(len(s["pts"]) for s in shards)
    n_per = max(len(s["o1"]) for s in shards)

    def pad(a, n, fill=0):
        if len(a) == n:
            return a
        pad_shape = (n - len(a),) + a.shape[1:]
        return np.concatenate([a, np.full(pad_shape, fill, dtype=a.dtype)])

    obs, cam_idx, pt_idx, valid, pts, pt_valid = [], [], [], [], [], []
    po1, po2, pbk, blks = [], [], [], []
    odus, odvs, vds = [], [], []
    for s in shards:
        n_o, n_p = len(s["cam_idx"]), len(s["pts"])
        if dense:
            # o_per (the index of stack_blocks' appended zero row) marks
            # unseen cells
            b = np.full((C, p_per), o_per, dtype=np.int32)
            b[s["cam_idx"], s["pt_idx"]] = np.arange(n_o, dtype=np.int32)
            blks.append(b)
            du, dv, vd = dense_obs_tables(b, s["obs"], o_per)
            odus.append(du)
            odvs.append(dv)
            vds.append(vd)
        obs.append(s["obs"] if n_o == o_per else np.concatenate(
            [s["obs"], np.repeat(s["obs"][:1], o_per - n_o, 0)]))
        cam_idx.append(pad(s["cam_idx"], o_per, fill=int(s["cam_idx"][0])))
        pt_idx.append(pad(s["pt_idx"], o_per, fill=int(s["pt_idx"][0])))
        valid.append(np.arange(o_per) < n_o)
        pts.append(pad(s["pts"], p_per, fill=0.0))
        pt_valid.append(np.arange(p_per) < n_p)
        po1.append(pad(s["o1"], n_per, fill=0))
        po2.append(pad(s["o2"], n_per, fill=0))
        pbk.append(pad(s["bucket"], n_per, fill=C * C))

    cat = lambda xs: np.concatenate(xs, axis=0)
    return ShardedProblem(
        n_devices=n_devices, o_per=o_per, p_per=p_per, n_per=n_per,
        K=prob.K, q0=prob.q0, cams=prob.cams,
        obs=cat(obs), cam_idx=cat(cam_idx).astype(np.int32),
        pt_idx=cat(pt_idx).astype(np.int32), valid=cat(valid),
        pts=cat(pts), pt_valid=cat(pt_valid),
        pair_o1=None if dense else cat(po1).astype(np.int32),
        pair_o2=None if dense else cat(po2).astype(np.int32),
        pair_bucket=None if dense else cat(pbk).astype(np.int32),
        blk=np.concatenate(blks, axis=1) if dense else None,
        obs_du=np.concatenate(odus, axis=1) if dense else None,
        obs_dv=np.concatenate(odvs, axis=1) if dense else None,
        valid_d=np.concatenate(vds, axis=1) if dense else None,
        pt_starts=pt_starts,
    )


def local_arrays(sp: ShardedProblem, dtype, device,
                 backend: str = "auto") -> ProblemArrays:
    """The ProblemArrays of a one-shard ShardedProblem
    (distributed.slice_local) on `device`.

    The observations are reordered stably by point (the padding, which
    repeats the shard's first observation, moves behind that point's
    observations) so the stream kernels' point pass can walk them; the pair
    list and the dense table follow the new numbering. Every sum over the
    observations is then taken in another order than the reference's, and
    a shard without padding keeps its order. `valid` is None there."""
    if sp.n_devices != 1:
        raise ValueError("local_arrays takes one shard (slice_local)")
    o = np.argsort(sp.pt_idx, kind="stable")
    inv = np.empty_like(o)
    inv[o] = np.arange(len(o))
    enc = {}
    if sp.blk is not None:
        seen = sp.blk < sp.o_per
        enc["blk_idx"] = np.where(
            seen, inv[np.where(seen, sp.blk, 0)], sp.o_per).astype(np.int32)
    else:
        enc.update(pair_o1=inv[sp.pair_o1].astype(np.int32),
                   pair_o2=inv[sp.pair_o2].astype(np.int32),
                   pair_bucket=sp.pair_bucket)
    prob = BAProblem(K=sp.K, q0=sp.q0, cams=sp.cams, pts=sp.pts,
                     obs=sp.obs[o], cam_idx=sp.cam_idx[o],
                     pt_idx=sp.pt_idx[o], **enc)
    valid = sp.valid[o]
    return ProblemArrays.from_problem(
        prob, dtype=dtype, device=device,
        schur="dense" if sp.blk is not None else "pairs", backend=backend,
        valid=None if valid.all() else valid)


# observation cap of the host-side damping probe: it estimates an
# orders-of-magnitude diagonal ratio, so a fixed-stride subsample is plenty
_PROBE_MAX_OBS = 262_144


def resolve_damping_host(cfg: SolverConfig, prob: BAProblem, dtype,
                         device) -> SolverConfig:
    """Resolve damping="auto" before sharding, from the whole problem (a
    fixed-stride subsample beyond _PROBE_MAX_OBS observations): every rank
    runs the same probe on the same data and takes the same mode, with no
    collective."""
    if cfg.damping != "auto":
        return cfg
    O = prob.n_obs
    stride = max(1, -(-O // _PROBE_MAX_OBS))
    sl = np.s_[::stride]
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    i = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64,
                                  device=device)
    probe = ProblemArrays(K=f(prob.K), q0=f(prob.q0), obs=f(prob.obs[sl]),
                          cam_idx=i(prob.cam_idx[sl]),
                          pt_idx=i(prob.pt_idx[sl]))
    return resolve_damping(cfg, probe, f(prob.cams), f(prob.pts))


def make_sharded_lm_repeat(cfg: SolverConfig, ctx: MeshCtx):
    """Repeats runner of the sharded path: `run(pa, state0, iter_cap,
    repeats) -> (acc_l2, total_itno)`, called inside each rank of the
    group of `ctx` with its shard `pa` (local_arrays) and its state0
    (OptState.init with `ctx`). It runs `repeats` identical
    iter_cap-length lm_run trajectories from state0 and sums their final
    ex_l2 (a 0-d tensor in the state's dtype, on its device, added in
    order from zero) and their iterations (int); both are the group's,
    the same on every rank.

    The reference adds min(acc, 0) (= 0) to the cameras of each repeat so
    that XLA cannot hoist the loop-invariant trajectory out of its one
    fori_loop dispatch; eager PyTorch runs every repeat as called, so the
    perturbation is left out."""

    def run(pa: ProblemArrays, state0: OptState, iter_cap: int,
            repeats: int):
        acc = torch.zeros((), dtype=state0.cams.dtype,
                          device=state0.cams.device)
        itno = 0
        for _ in range(int(repeats)):
            out = lm_run(pa, state0, cfg, iter_cap=iter_cap, ctx=ctx)
            acc, itno = acc + out.ex_l2, itno + out.itno
        return acc, itno

    return run


def solve_sharded(prob: BAProblem, cfg: SolverConfig | None = None,
                  n_devices: int | None = None, dtype=None, start="lm",
                  schur="auto", device=None, timeout: float | None = None):
    """Hybrid solve of `prob` split over `n_devices` shards, one process
    each on this host (the host alternation of solvers.hybrid.solve).

    `device` "cuda" (the default) runs rank r on cuda:r over NCCL; more
    shards than cards raises, as does no card. "cpu" runs the ranks on the
    CPU over gloo (default 1 shard). One shard runs in the calling process
    with a process group of one. A rank that fails, or a run longer than
    `timeout` seconds, stops every rank and raises. Returns rank 0's
    SolveResult with the points of every shard in the caller's order."""
    from psba_tpu_torch.parallel.distributed import gather_points, run_ranks

    device = resolve_device(device, "solve_sharded")
    if device.type == "cuda":
        avail = torch.cuda.device_count()
        n = n_devices or avail
        if n > avail:
            raise ValueError(f"{n} devices requested, {avail} available")
        devices, backend = [f"cuda:{r}" for r in range(n)], "nccl"
    elif device.type == "cpu":
        n = n_devices or 1
        devices, backend = ["cpu"] * n, "gloo"
    else:
        raise ValueError(f"solve_sharded: device {device}")
    out = run_ranks(devices, backend, timeout=timeout, prob=prob, cfg=cfg,
                    dtype=dtype, start=start, schur=schur)
    return gather_points([o["result"] for o in out])


__all__ = ["ShardedProblem", "local_arrays", "make_sharded_lm_repeat",
           "resolve_damping_host", "shard_problem", "solve_sharded"]
