"""Collectives of the port on ``torch.distributed``: the lowering of
combo-channel fan-out to one collective per call.

The reference (``brpc_tpu/parallel/__init__.py``) runs each collective as a
``shard_map`` program over a device mesh. Here one process holds one rank,
and every function takes what the reference's ``shard_map`` body is given,
this rank's block of the global array (``x``), and returns what that body
returns, in rank order over ``group`` (default: the world). Concatenating
the ranks' results along the sharded axis gives the reference's global
result. The mapping is the reference's:

    ParallelChannel broadcast + concat merger   -> all_gather
    ParallelChannel broadcast + sum merger      -> all_reduce
    PartitionChannel scatter  + sum merger      -> reduce_scatter
    PartitionChannel scatter  + scatter merger  -> all_to_all
    StreamingRPC neighbor pipeline              -> ring_shift

The same code runs on gloo (CPU tensors) and on NCCL (CUDA tensors). No
collective here sends to its own rank: a one-rank shift is a copy.

Tensor parallelism's collectives, differentiable (the reference lets XLA
place them from ``_param_specs``, __graft_entry__.py:37): ``tp_enter``
before a column-sharded product (identity; its backward sums the ranks'
gradients), ``tp_reduce`` after a row-sharded one (a sum; its backward is
the identity), and ``tp_gather`` for an output sharded on one axis (the
ranks' shards concatenated; its backward keeps this rank's slice).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = [
    "rank_and_size", "peer", "all_gather", "all_reduce", "reduce_scatter",
    "all_to_all", "all_to_all_axes", "ring_shift", "ring_shift_start",
    "fanout_call", "tp_enter", "tp_reduce", "tp_gather",
]

# The single-tensor collectives under their current names, or the names
# older torch releases give them.
_all_gather_tensor = (getattr(dist, "all_gather_single", None)
                      or dist.all_gather_into_tensor)
_reduce_scatter_tensor = (getattr(dist, "reduce_scatter_single", None)
                          or dist.reduce_scatter_tensor)


def rank_and_size(group=None) -> tuple:
    """(this process's rank in ``group``, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def peer(group, group_rank: int) -> int:
    """The global rank of ``group``'s rank ``group_rank`` (point-to-point
    calls and ``broadcast`` name their peer by its global rank)."""
    return group_rank if group is None else dist.get_global_rank(group,
                                                                 group_rank)


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """ParallelChannel broadcast+concat: every rank gets the ranks' blocks
    concatenated on dim 0 in rank order (the reference's tiled
    ``all_gather``)."""
    _, n = rank_and_size(group)
    x = x.contiguous()
    out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    _all_gather_tensor(out, x, group=group)
    return out


def all_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """ParallelChannel broadcast+sum-merge: the sum of the ranks' blocks,
    on every rank (``x`` is not changed)."""
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """PartitionChannel gather+sum-per-partition: ``x`` is this rank's
    ``[1, W, ...]`` row of the stacked per-rank arrays; rank i keeps chunk i
    (of W / n) of the ranks' sum, as ``[1, W / n, ...]``."""
    _, n = rank_and_size(group)
    full = x[0].contiguous()
    if full.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 1 ({full.shape[0]}) is not "
                         f"divisible by the group size {n}")
    out = torch.empty((full.shape[0] // n,) + tuple(full.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter_tensor(out, full, group=group)
    return out[None]


def all_to_all_axes(x: torch.Tensor, split_axis: int, concat_axis: int,
                    group=None) -> torch.Tensor:
    """The tiled ``jax.lax.all_to_all``: ``x``'s ``split_axis`` is cut into
    n equal chunks, chunk j goes to rank j, and the n chunks a rank
    receives are concatenated on ``concat_axis`` in the senders' rank
    order."""
    _, n = rank_and_size(group)
    size = x.shape[split_axis]
    if size % n:
        raise ValueError(f"all_to_all: axis {split_axis} ({size}) is not "
                         f"divisible by the group size {n}")
    # [n, ...]: chunk j first, in the layout all_to_all_single sends.
    chunks = x.unflatten(split_axis, (n, size // n)).movedim(split_axis, 0)
    chunks = chunks.contiguous()
    got = torch.empty_like(chunks)
    dist.all_to_all_single(got, chunks, group=group)
    # got[i] is rank i's chunk for this rank: lay them along concat_axis.
    return got.movedim(0, concat_axis).flatten(concat_axis, concat_axis + 1)


def all_to_all(x: torch.Tensor, group=None) -> torch.Tensor:
    """PartitionChannel scatter+scatter-merge: ``x`` is this rank's
    ``[1, W]`` block (or ``[b, W, ...]``); its axis 1 is cut into n
    chunks, rank i receives chunk i of every rank, and the received chunks
    are laid back out in ``x``'s shape, chunk-major (the reference's
    ``all_to_all`` on axis 1 into axis 0, then its reshape)."""
    return all_to_all_axes(x, 1, 0, group).reshape(x.shape)


def ring_shift_start(tensors, shift: int = 1, group=None):
    """Post the shift of each tensor in ``tensors`` to rank (r + shift) mod
    n and its receive from rank (r - shift) mod n -> (received buffers,
    wait): the buffers hold the peer's tensors once ``wait()`` returns.
    A shift by a multiple of n copies."""
    r, n = rank_and_size(group)
    if shift % n == 0:
        copies = [t.clone() for t in tensors]
        return copies, lambda: None
    dst, src = peer(group, (r + shift) % n), peer(group, (r - shift) % n)
    sent = [t.contiguous() for t in tensors]
    got = [torch.empty_like(t) for t in sent]
    ops = []
    for t, g in zip(sent, got):
        ops.append(dist.P2POp(dist.isend, t, dst, group))
        ops.append(dist.P2POp(dist.irecv, g, src, group))
    reqs = dist.batch_isend_irecv(ops)

    def wait():
        # ``sent`` stays referenced until the sends are done.
        for req in reqs:
            req.wait()
        sent.clear()

    return got, wait


def ring_shift(x: torch.Tensor, shift: int = 1, group=None) -> torch.Tensor:
    """StreamingRPC neighbor pipeline: rank r's block moves to rank
    (r + shift) mod n; returns the block from rank (r - shift) mod n."""
    (got,), wait = ring_shift_start([x], shift, group)
    wait()
    return got


def fanout_call(fn, x: torch.Tensor, merger: str = "concat",
                group=None) -> torch.Tensor:
    """The generic fan-out: ``x`` is broadcast from rank 0 of ``group``,
    every rank computes ``fn(rank, x)``, and the results are merged per
    ``merger``: "concat" (on dim 0, in rank order) or "sum". The
    ParallelChannel CallMethod shape (reference: CallMapper/ResponseMerger,
    brpc/parallel_channel.h:37-148)."""
    if merger not in ("concat", "sum"):
        raise ValueError(f"unknown merger {merger!r}")
    r, _ = rank_and_size(group)
    full = x.clone().contiguous()
    dist.broadcast(full, peer(group, 0), group=group)
    out = fn(r, full)
    if merger == "sum":
        return all_reduce(out, group)
    return all_gather(out, group)


class _TpEnter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _TpReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _TpGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        r, _ = rank_and_size(group)
        ctx.dim, ctx.rank, ctx.size = dim, r, x.shape[dim]
        return all_gather(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size,
                        ctx.size).contiguous(), None, None


def tp_enter(x: torch.Tensor, group=None) -> torch.Tensor:
    """Identity; in the backward, the sum of the ranks' gradients: where a
    replicated activation enters a column-sharded product, each rank's
    gradient covers only its shard's columns."""
    return _TpEnter.apply(x, group)


def tp_reduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum of the ranks' partial results of a row-sharded product, on
    every rank; its gradient passes through unchanged."""
    return _TpReduce.apply(x, group)


def tp_gather(x: torch.Tensor, dim: int, group=None) -> torch.Tensor:
    """The ranks' shards of ``x`` concatenated on ``dim`` in rank order;
    the backward keeps this rank's slice of the gradient."""
    return _TpGather.apply(x, dim % x.dim(), group)
