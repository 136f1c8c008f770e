"""Rank bodies of the gloo worlds in tests/test_torch_parallel.py. They run
in spawned processes (``brpc_tpu_torch.parallel.world.run``), which import
this module by name: it imports torch, numpy and the port only, never JAX.
Each takes numpy arrays of the global inputs, computes on this rank's block
(rows [rank b, (rank + 1) b) of the sharded axis) and returns numpy."""

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch import parallel as par
from brpc_tpu_torch.models import moe
from brpc_tpu_torch.ops import ring_attention as ra
from brpc_tpu_torch.parallel.pipeline import pipeline_forward

SHIFTS = (1, -1, 2, 4)


def _block(a: np.ndarray, rank: int, n: int, axis: int = 0) -> torch.Tensor:
    b = a.shape[axis] // n
    return torch.from_numpy(np.ascontiguousarray(
        np.take(a, range(rank * b, (rank + 1) * b), axis=axis)))


def collectives(rank, n, x_gather, x_reduce, per_rank, x_a2a, x_a2a3,
                x_shift, x_fan):
    out = {
        "all_gather": par.all_gather(_block(x_gather, rank, n)),
        "all_reduce": par.all_reduce(_block(x_reduce, rank, n)),
        "reduce_scatter": par.reduce_scatter(_block(per_rank, rank, n)),
        "all_to_all": par.all_to_all(_block(x_a2a, rank, n)),
        "all_to_all_3d": par.all_to_all(_block(x_a2a3, rank, n)),
    }
    for s in SHIFTS:
        out[f"ring_shift_{s}"] = par.ring_shift(_block(x_shift, rank, n), s)
    # Only rank 0's x matters: fanout_call broadcasts it.
    x = torch.from_numpy(x_fan) if rank == 0 else torch.zeros(x_fan.shape)
    for merger in ("concat", "sum"):
        out[f"fanout_{merger}"] = par.fanout_call(
            lambda r, full: full * (r + 1), x, merger)
    return {k: v.numpy() for k, v in out.items()}


def ring(rank, n, cases):
    """ring_attention on this rank's sequence block of each (q, k, v,
    causal) case, then on the whole sequence of the first case with each
    rank alone in a group of its own (n == 1)."""
    outs = [ra.ring_attention(_block(q, rank, n, 1), _block(k, rank, n, 1),
                              _block(v, rank, n, 1), causal).numpy()
            for q, k, v, causal in cases]
    alone = [dist.new_group([r]) for r in range(n)]
    q, k, v, causal = cases[0]
    single = ra.ring_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal,
                               group=alone[rank])
    return outs, single.numpy()


def _tanh_stage(w, a):
    return torch.tanh(a @ w)


def pipeline(rank, n, ws, x):
    """pipeline_forward for each stack of stages in ``ws``, split evenly
    over the ranks (k = len(w) / n stages each)."""
    return [pipeline_forward(_tanh_stage, _block(w, rank, n),
                             torch.from_numpy(x)).numpy() for w in ws]


def moe_ranks(rank, n, params, x, capacities):
    p = moe.moe_shard(moe.moe_params_from_numpy(params, device="cpu"), rank,
                      n)
    xs = _block(x, rank, n)
    return [moe.moe_forward(p, xs, c).numpy() for c in capacities]


def misbehave(rank, n):
    """Rank 0 raises, rank 1 exits without a result, the others hang."""
    if rank == 0:
        raise ValueError("rank 0 fails on purpose")
    if rank == 1:
        import os
        os._exit(3)
    import time
    time.sleep(600)
