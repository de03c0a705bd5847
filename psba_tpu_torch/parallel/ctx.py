"""Mesh context over a torch.distributed process group (PyTorch counterpart
of psba_tpu.parallel.ctx).

With no group (NO_MESH) every reduction is the identity and the solvers run
on one device. With a group, `psum` / `pmax` are all_reduce(SUM / MAX),
`pand` is a SUM of "not ok" compared with 0, and `psum_rs` is
reduce_scatter + all_gather. The solvers call them exactly where the
reference reduces over its mesh axis: the U / ga / S / ea assembly, the
point-side parts of every sum and dot product, the max-diagonal damping
seed, the gradient's max and the V-block check.

Each call of a reduction is one collective: `psum(a, b, ...)` reduces
several tensors of one dtype in one all_reduce of their concatenation
(elementwise, so the same values as one call each). `stats` counts the
collectives by tag (calls, bytes sent into them, seconds); the seconds are
taken only with `timed=True`, which synchronizes the device before and
after each collective.
"""

from __future__ import annotations

import dataclasses
import time

import torch


@dataclasses.dataclass
class CollectiveStats:
    """Collectives of one tag: calls, bytes and (timed) seconds."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0


@dataclasses.dataclass(frozen=True, eq=False)
class MeshCtx:
    """A process group (None: no mesh) and the counters of its
    collectives."""

    group: object = None
    timed: bool = False
    stats: dict = dataclasses.field(default_factory=dict)

    def _run(self, tag: str, x: torch.Tensor, op) -> None:
        st = self.stats.setdefault(tag, CollectiveStats())
        st.calls += 1
        st.bytes += x.numel() * x.element_size()
        sync = self.timed and x.device.type == "cuda"
        if self.timed:
            if sync:
                torch.cuda.synchronize(x.device)
            t0 = time.perf_counter()
        op()
        if self.timed:
            if sync:
                torch.cuda.synchronize(x.device)
            st.seconds += time.perf_counter() - t0

    def psum(self, x: torch.Tensor, *more: torch.Tensor, tag: str = "psum"):
        """Sum over the group; several tensors go in one all_reduce and
        come back as a tuple."""
        if self.group is None:
            return (x, *more) if more else x
        import torch.distributed as dist

        xs = (x, *more)
        flat = torch.cat([t.reshape(-1) for t in xs]) if more else (
            x.reshape(-1).clone())
        self._run(tag, flat, lambda: dist.all_reduce(
            flat, op=dist.ReduceOp.SUM, group=self.group))
        if not more:
            return flat.reshape(x.shape)
        out, off = [], 0
        for t in xs:
            out.append(flat[off:off + t.numel()].reshape(t.shape))
            off += t.numel()
        return tuple(out)

    def pmax(self, x: torch.Tensor, tag: str = "pmax") -> torch.Tensor:
        """Max over the group."""
        if self.group is None:
            return x
        import torch.distributed as dist

        y = x.clone()
        self._run(tag, y, lambda: dist.all_reduce(
            y, op=dist.ReduceOp.MAX, group=self.group))
        return y

    def pand(self, ok: torch.Tensor, tag: str = "pand") -> torch.Tensor:
        """Logical AND of a boolean scalar over the group: any shard's
        local failure fails the whole step."""
        if self.group is None:
            return ok
        return self.psum(torch.logical_not(ok).to(torch.int32), tag=tag) == 0

    def psum_rs(self, x: torch.Tensor, tag: str = "psum_rs") -> torch.Tensor:
        """psum as reduce_scatter + all_gather of the flattened tensor,
        zero-padded to a multiple of the group size and cut back: the same
        result as psum up to the order of the sums."""
        if self.group is None:
            return x
        import torch.distributed as dist

        # the *_single names replace *_tensor in newer torch releases
        scatter = (getattr(dist, "reduce_scatter_single", None)
                   or dist.reduce_scatter_tensor)
        gather = (getattr(dist, "all_gather_single", None)
                  or dist.all_gather_into_tensor)
        d = dist.get_world_size(self.group)
        flat = x.reshape(-1)
        n = flat.numel()
        pad = (-n) % d
        if pad:
            flat = torch.cat([flat, flat.new_zeros(pad)])
        piece = flat.new_empty(flat.numel() // d)
        full = torch.empty_like(flat)

        def run():
            scatter(piece, flat, op=dist.ReduceOp.SUM, group=self.group)
            gather(full, piece, group=self.group)

        self._run(tag, flat, run)
        return full[:n].reshape(x.shape)

    def summary(self) -> dict:
        """{tag: {"calls", "bytes", "seconds"}} of the collectives so far."""
        return {k: dataclasses.asdict(v) for k, v in self.stats.items()}


NO_MESH = MeshCtx()
