"""Pipeline parallelism: GPipe-style microbatch rotation over a group.

The port of ``brpc_tpu/parallel/pipeline.py``: consecutive model stages
live on consecutive ranks, activations hop rank to rank (the StreamingRPC
neighbor-pipeline analogue), and M microbatches keep every stage busy
after the fill.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist

from brpc_tpu_torch.parallel import peer, rank_and_size

__all__ = ["pipeline_forward"]


def pipeline_forward(stage_fn: Callable, stage_params: torch.Tensor,
                     x: torch.Tensor, group=None) -> torch.Tensor:
    """Run the group's stages in sequence over ``x``'s microbatches.

    stage_params: this rank's ``[k, ...]`` slice of the per-stage params
    stacked on dim 0 (the reference's layout is k = 1: one stage per
    rank); the rank applies its k stages in order. x: ``[M, ...]``
    microbatches, the same on every rank. stage_fn(params_i, act) -> act
    of the same shape. Returns ``[M, ...]`` outputs on every rank, equal to
    applying all the stages in sequence to each microbatch.

    The reference's schedule, without its idle ticks: over M + n - 1
    ticks, rank r takes microbatch t - r at tick t (rank 0 from ``x``, the
    others from what rank r - 1 sent it), so it computes only when
    0 <= t - r < M, and sends on to rank r + 1 while its own next
    microbatch computes. The last rank writes output t - (n - 1) and
    broadcasts the outputs at the end (the reference's psum of zeros and
    the last rank's outputs).
    """
    r, n = rank_and_size(group)
    M = x.shape[0]
    ys = torch.zeros_like(x)
    sends = []
    for i in range(M):
        if r == 0:
            act = x[i]
        else:
            act = torch.empty_like(x[i])
            dist.recv(act, peer(group, r - 1), group=group)
        for p in stage_params:
            act = stage_fn(p, act)
        if r == n - 1:
            ys[i] = act
        else:
            act = act.contiguous()
            sends.append((act, dist.isend(act, peer(group, r + 1),
                                          group=group)))
    for _, req in sends:
        req.wait()
    dist.broadcast(ys, peer(group, n - 1), group=group)
    return ys
