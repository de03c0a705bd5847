"""Multi-device solve: mesh context, problem sharding, sharded and
multi-process solves (PyTorch counterpart of psba_tpu.parallel).

Points and their observations are split into contiguous point ranges, one
shard per process and device; cameras and every solver scalar are
replicated; the reduced camera system (U, ga, S, ea) and every global sum
cross the shards by torch.distributed collectives (ctx.MeshCtx). V-block
solves and the point back-substitution stay on their shard.
"""

from psba_tpu_torch.parallel.ctx import NO_MESH, MeshCtx

__all__ = ["MeshCtx", "NO_MESH", "shard_problem", "solve_sharded"]


def __getattr__(name):
    # shard.py imports the solvers, which import MeshCtx from this package
    if name in ("shard_problem", "solve_sharded"):
        from psba_tpu_torch.parallel import shard

        return getattr(shard, name)
    raise AttributeError(name)
