"""Rank functions for tests/test_torch_parallel.py and
tests/test_torch_entry.py, run by
psba_tpu_torch.parallel.distributed.run_ranks in spawned processes (a
module of its own, so a rank imports torch and the port only)."""

import time

import numpy as np
import torch


def mesh_reductions(device, seed):
    """Every MeshCtx reduction on this rank's inputs (made from seed +
    rank): the inputs and the results as numpy, and the counters."""
    import torch.distributed as dist

    from psba_tpu_torch.parallel.ctx import MeshCtx

    rank = dist.get_rank()
    ctx = MeshCtx(dist.group.WORLD)
    rng = np.random.default_rng(seed + rank)
    a = rng.standard_normal((3, 4))
    b = rng.standard_normal(7)      # 7 entries: not a multiple of 2 ranks
    t = lambda x: torch.as_tensor(x, device=device)
    many = ctx.psum(t(a), t(b), tag="many")
    return dict(
        a=a, b=b,
        psum=ctx.psum(t(a)).cpu().numpy(),
        psum_many=[x.cpu().numpy() for x in many],
        pmax=ctx.pmax(t(b)).cpu().numpy(),
        pand_all=bool(ctx.pand(torch.tensor(True, device=device))),
        pand_one=bool(ctx.pand(torch.tensor(rank == 0, device=device))),
        psum_rs=ctx.psum_rs(t(b)).cpu().numpy(),
        stats=ctx.summary(),
    )


def lm_repeats(device, repeats, **kw):
    """parallel.distributed.lm_repeat_rank with `repeats` repeats and with
    one, in the same ranks: (the repeated run's result, the single's)."""
    from psba_tpu_torch.parallel.distributed import lm_repeat_rank

    return (lm_repeat_rank(device, repeats=repeats, **kw),
            lm_repeat_rank(device, repeats=1, **kw))


def fail_on_rank_one(device):
    """Rank 1 raises; rank 0 waits in a collective that never completes."""
    import torch.distributed as dist

    if dist.get_rank() == 1:
        raise ValueError("rank 1 fails on purpose")
    x = torch.ones(1)
    dist.all_reduce(x)
    return float(x)


def sleep_long(device):
    """A rank that outlives any test's timeout."""
    time.sleep(600)
