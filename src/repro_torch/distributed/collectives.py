"""The sharded steps' collectives (training, prefill and decode), run
explicitly where GSPMD inserts them for the JAX package.

The training state lies as shards (``launch/steps.params_shardings``);
the model computes on plain tensors.  ``MeshAxes`` holds a
``DeviceMesh``'s process group and this rank's coordinate for every
axis larger than 1, and launches the collectives over them, counting
each (``CollectiveLog``).  ``gather_shards`` gathers a parameter shard
into the whole tensor as an autograd function whose backward hands
each rank the gradient of its own shard:

  * over an axis that carries the batch (``pod``, ``data``: its ranks
    computed on other rows), the gradients are summed and sliced
    (``reduce_scatter``);
  * over an axis that does not (``model``: its ranks computed on the
    same rows), the rank keeps its slice, with no sum.

The MoE block's expert parallelism (``models/moe.py``) runs on three
more: ``region_in`` (identity forward, all-reduce backward) on each
replicated tensor that enters the expert region, ``region_out``
(all-reduce forward, identity backward) on the region's output, and
``stat_all_reduce`` (all-reduce both ways) on the load-balancing
statistics; ``all_gather_axes`` stacks the per-rank routing counts.

Tensor parallelism over ``model`` (``TPShard``) runs the same pair around
each split sublayer (a column-split matmul after ``region_in``, a
row-split one before ``region_out``): the self- and cross-attention
(heads), the SSM (heads), the MLPs (``d_ff``).  Two more:
``seq_all_gather`` (all-gather forward, this rank's slice backward)
joins a query-row split attention's output rows, and ``max_all_reduce``
(no gradient) is the vocabulary-parallel loss's max.  Serving adds
kinds of their own on the same functions: the context-parallel decode's
``decode-max`` / ``decode-sum`` / ``decode-out`` (its log-sum-exp
join), ``logits-all-gather`` (the logits made whole) and
``state-all-gather`` (a split SSM state leaf gathered for a mixer that
computes whole).

An axis of size 1 launches nothing.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, NamedTuple, Optional, Set, Tuple

import torch
import torch.distributed as dist

from repro_torch.distributed.sharding import mesh_axis_names, mesh_shape

# torch >= 2.13 names them *_single; older releases have only these
_all_gather = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


class CollectiveLog:
    """Count and output bytes of the collectives launched, by kind;
    ``gathered`` maps a mesh axis to the names of the parameter leaves
    the sharded step gathered over it."""

    def __init__(self):
        self.kinds: Dict[str, Dict[str, float]] = {}
        self.gathered: Dict[str, Set[str]] = {}

    def add(self, kind: str, out: torch.Tensor) -> None:
        k = self.kinds.setdefault(kind, {"count": 0, "bytes": 0})
        k["count"] += 1
        k["bytes"] += out.numel() * out.element_size()


class MeshAxes:
    """A ``DeviceMesh``'s axes of size > 1: their process groups, this
    rank's coordinate on each, and the collectives over them."""

    def __init__(self, mesh, log: CollectiveLog):
        self.mesh = mesh
        self.size = mesh_shape(mesh)
        self.coord = dict(zip(mesh_axis_names(mesh), mesh.get_coordinate()))
        self.groups = {a: mesh.get_group(a)
                       for a, n in self.size.items() if n > 1}
        self.log = log

    def live(self, axes: Iterable[str]) -> Tuple[str, ...]:
        """The axes of ``axes`` larger than 1, in the given order."""
        return tuple(a for a in axes if self.size[a] > 1)

    def linear_rank(self, axes: Tuple[str, ...]) -> int:
        """This rank's row-major index over ``axes`` (the first major),
        the chunk a dim split over them in that order gives it."""
        r = 0
        for a in axes:
            r = r * self.size[a] + self.coord[a]
        return r

    def all_gather(self, x: torch.Tensor, dim: int, axis: str,
                   kind: str = "all-gather") -> torch.Tensor:
        """The shards of ``axis``'s ranks concatenated along ``dim``."""
        n = self.size[axis]
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((n * src.shape[0],) + tuple(src.shape[1:]))
        _all_gather(out, src, group=self.groups[axis])
        self.log.add(kind, out)
        return out.movedim(0, dim)

    def all_gather_axes(self, x: torch.Tensor, axes: Iterable[str],
                        kind: str = "all-gather") -> torch.Tensor:
        """``[n, *x.shape]``: every rank's ``x`` over ``axes``, stacked
        in ``linear_rank(axes)`` order (the minor axis gathered first)."""
        out = x[None]
        for a in reversed(self.live(axes)):
            out = self.all_gather(out, 0, a, kind)
        return out

    def reduce_scatter(self, x: torch.Tensor, dim: int,
                       axis: str) -> torch.Tensor:
        """The sum over ``axis``'s ranks, this rank's chunk of ``dim``."""
        n = self.size[axis]
        src = x.movedim(dim, 0).contiguous()
        out = src.new_empty((src.shape[0] // n,) + tuple(src.shape[1:]))
        _reduce_scatter(out, src, group=self.groups[axis])
        self.log.add("reduce-scatter", out)
        return out.movedim(0, dim)

    def chunk(self, x: torch.Tensor, dim: int, axis: str) -> torch.Tensor:
        """This rank's chunk of ``dim`` over ``axis``, no communication."""
        n = x.shape[dim] // self.size[axis]
        return x.narrow(dim, self.coord[axis] * n, n)

    def all_reduce(self, x: torch.Tensor, axes: Iterable[str],
                   kind: str = "all-reduce",
                   op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``x`` reduced by ``op`` (a sum unless named) over each of
        ``axes`` larger than 1 (in place where ``x`` is contiguous; a
        collective writes no strided view, so another tensor comes back
        for one)."""
        live = self.live(axes)
        if live and not x.is_contiguous():
            x = x.contiguous()
        for a in live:
            dist.all_reduce(x, op=op, group=self.groups[a])
            self.log.add(kind, x)
        return x

    def summed(self, x: torch.Tensor, axes: Tuple[str, ...],
               kind: str, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """A new tensor: ``x`` reduced over ``axes`` (``x`` untouched)."""
        return self.all_reduce(x.clone(memory_format=torch.contiguous_format),
                               axes, kind, op)


class _GatherShards(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes: MeshAxes, plan):
        ctx.axes, ctx.plan = axes, plan
        for dim, axis, _ in plan:
            x = axes.all_gather(x, dim, axis)
        return x

    @staticmethod
    def backward(ctx, g):
        for dim, axis, batch in reversed(ctx.plan):
            g = (ctx.axes.reduce_scatter(g, dim, axis) if batch
                 else ctx.axes.chunk(g, dim, axis))
        return g, None, None


class _RegionIn(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes: MeshAxes, names):
        ctx.axes, ctx.names = axes, names
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.axes.summed(g, ctx.names, "region-in"), None, None


class _RegionOut(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes: MeshAxes, names, kind):
        return axes.summed(x, names, kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None, None


class _SeqAllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes: MeshAxes, names, dim, kind):
        ctx.dim, ctx.n = dim, x.shape[dim]
        ctx.first = axes.linear_rank(names) * ctx.n
        for a in reversed(names):
            x = axes.all_gather(x, dim, a, kind)
        return x

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.first, ctx.n), None, None, None, None


class _StatAllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axes: MeshAxes, names):
        ctx.axes, ctx.names = axes, names
        return axes.summed(x, names, "stat-all-reduce")

    @staticmethod
    def backward(ctx, g):
        return ctx.axes.summed(g, ctx.names, "stat-all-reduce"), None, None


def region_in(x: torch.Tensor, axes: MeshAxes, names) -> torch.Tensor:
    """``x`` itself, whose gradient is summed over ``names``: a tensor
    every rank of ``names`` holds whole, entering a region where each
    computes only its part (its experts)."""
    names = axes.live(names)
    return _RegionIn.apply(x, axes, names) if names else x


def region_out(x: torch.Tensor, axes: MeshAxes, names,
               kind: str = "region-out") -> torch.Tensor:
    """The region's partial ``x`` summed over ``names``; the gradient
    passes unchanged (every rank of ``names`` holds it whole)."""
    names = axes.live(names)
    return _RegionOut.apply(x, axes, names, kind) if names else x


def stat_all_reduce(x: torch.Tensor, axes: MeshAxes, names) -> torch.Tensor:
    """``x`` summed over ``names``, and its gradient too: statistics of
    the ranks' rows whose consumers on every rank each reach every
    rank's addend."""
    names = axes.live(names)
    return _StatAllReduce.apply(x, axes, names) if names else x


def seq_all_gather(x: torch.Tensor, axes: MeshAxes, names, dim: int,
                   kind: str = "seq-all-gather") -> torch.Tensor:
    """The ranks' ``x`` of ``names`` concatenated along ``dim`` in
    ``linear_rank(names)`` order; the gradient of the whole is this
    rank's slice of it (every rank of ``names`` holds it whole)."""
    names = axes.live(names)
    return _SeqAllGather.apply(x, axes, names, dim, kind) if names else x


def max_all_reduce(x: torch.Tensor, axes: MeshAxes, names,
                   kind: str = "max-all-reduce") -> torch.Tensor:
    """The elementwise max of ``x`` over ``names``, with no gradient."""
    names = axes.live(names)
    x = x.detach()
    return axes.summed(x, names, kind, dist.ReduceOp.MAX) if names else x


class TPShard(NamedTuple):
    """One rank's place in a tensor-parallel split over ``model``: the
    ``MeshAxes``, the live axes the split runs over, this rank's index
    in it and its size.  A split built by ``simulated`` has no live
    axis: its collectives are identities, so one device computes the
    rank's partial (its sum over ``region_out``, its rows before
    ``seq_gather``), which the caller joins.  ``NO_TP`` is the split of
    one rank, the unsharded model.

    A split sublayer reads the rank's chunk of a weight through
    ``part``: the weight comes whole (the chunk is cut out) or as the
    chunk itself (the sharded step keeps it split, not gathered)."""
    axes: Optional[MeshAxes] = None
    names: Tuple[str, ...] = ()
    rank: int = 0
    size: int = 1

    @classmethod
    def over(cls, axes: MeshAxes, names=("model",)) -> "TPShard":
        """The split over the live axes of ``names`` that the mesh has."""
        live = axes.live(a for a in names if a in axes.size)
        return cls(axes, live, axes.linear_rank(live),
                   math.prod(axes.size[a] for a in live))

    @classmethod
    def simulated(cls, rank: int, size: int) -> "TPShard":
        return cls(None, (), rank, size)

    def splits(self, n: int) -> bool:
        """Whether a dim of ``n`` entries is split: more than one rank,
        each with a whole, non-empty chunk."""
        return 1 < self.size <= n and n % self.size == 0

    def part(self, w: torch.Tensor, dim: int, full: int) -> torch.Tensor:
        """This rank's chunk of ``dim`` (of ``full`` entries) of ``w``."""
        n = full // self.size
        if w.shape[dim] == n:
            return w
        if w.shape[dim] != full:
            raise ValueError(f"dim {dim} of {tuple(w.shape)} is neither "
                             f"{full} nor this rank's {n}")
        return w.narrow(dim, self.rank * n, n)

    def region_in(self, x: torch.Tensor) -> torch.Tensor:
        return region_in(x, self.axes, self.names) if self.names else x

    def region_out(self, x: torch.Tensor,
                   kind: str = "region-out") -> torch.Tensor:
        return region_out(x, self.axes, self.names, kind) \
            if self.names else x

    def seq_gather(self, x: torch.Tensor, dim: int,
                   kind: str = "seq-all-gather") -> torch.Tensor:
        return seq_all_gather(x, self.axes, self.names, dim, kind) \
            if self.names else x

    def max(self, x: torch.Tensor, kind: str = "max-all-reduce"
            ) -> torch.Tensor:
        return max_all_reduce(x, self.axes, self.names, kind) \
            if self.names else x.detach()


NO_TP = TPShard()


def gather_shards(x: torch.Tensor, axes: MeshAxes, plan) -> torch.Tensor:
    """The whole tensor from this rank's shard ``x``.  ``plan`` is a
    tuple of (tensor dim, mesh axis, the axis carries the batch), the
    gathers in order: within a dim the last (minor) mesh axis first.
    An empty plan returns ``x`` itself."""
    return _GatherShards.apply(x, axes, plan) if plan else x


def shard_plan(spec, axes: MeshAxes, batch_axes) -> tuple:
    """The gather plan of a tensor placed by ``spec`` (a legalized
    PartitionSpec): one entry per split (dim, axis) of size > 1."""
    plan = []
    for dim, entry in enumerate(spec):
        names = () if entry is None else (
            (entry,) if isinstance(entry, str) else tuple(entry))
        for a in reversed(axes.live(names)):
            plan.append((dim, a, a in batch_axes))
    return tuple(plan)


def split_axes(spec) -> Tuple[str, ...]:
    """Every mesh axis a spec splits some dim over."""
    out = []
    for entry in spec:
        if entry is not None:
            out.extend((entry,) if isinstance(entry, str) else entry)
    return tuple(out)
