"""The twin of ``__graft_entry__.py:97`` ``dryrun_multichip``: one SGD step
of the tiny model with its parameters tensor-parallel and its batch
data-parallel, then the sequence-, expert- and pipeline-parallel legs
against their oracles.

The reference builds a ``dp x tp`` mesh (tp = 2 if n is even, else 1) and
lets XLA shard the jitted step by ``_param_specs`` (:37). Here each of n
ranks is one process of a ``torch.distributed`` world (gloo on the CPU,
NCCL on a card); rank r is mesh position (r // tp, r % tp), as the
reference's ``reshape(dp, tp)`` lays the devices out. Each rank holds its
tp shards (``shard``): column shards of wq, wk, wv, w_gate and w_up, row
shards of wo and w_down, the embedding split on D and w_out on the
vocabulary, the gains whole. It runs ``transformer.train_logits`` with
its tp group (the collectives of ``parallel.tp_enter`` / ``tp_reduce`` /
``tp_gather``), takes the mean loss over its own rows of the batch (split
``P("dp", None)``), averages the gradients over its dp group and updates
``p - lr g`` in f32.

Rank code: imports torch, numpy and this package only. On the CPU run it
in a gloo world, ``parallel.world.run(4, dryrun.dryrun_rank, None, None,
None, "cpu")``; on a card, in an NCCL process group, ``dryrun_rank(0, 1)``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from brpc_tpu_torch import parallel, train
from brpc_tpu_torch.models import moe
from brpc_tpu_torch.models import transformer as tt
from brpc_tpu_torch.ops import ring_attention as ra
from brpc_tpu_torch.parallel.pipeline import pipeline_forward
from brpc_tpu_torch.utils import resolve_device

__all__ = ["mesh_groups", "shard", "unshard", "train_step_tp",
           "train_twin", "dryrun_rank"]

# The split axis of each sharded leaf (_param_specs): layer matrices are
# [L, in, out], so column shards cut axis 2 and row shards axis 1.
_LAYER_AXES = {"wq": 2, "wk": 2, "wv": 2, "w_gate": 2, "w_up": 2,
               "wo": 1, "w_down": 1}
_TOP_AXES = {"embed": 1, "w_out": 1}


def mesh_groups(n: int) -> tuple:
    """This rank's place in the dp x tp mesh of an n-rank world -> (dp
    index, tp index, dp group, tp group). Every rank creates every group,
    in one order."""
    tp = 2 if n % 2 == 0 else 1
    dp = n // tp
    r = dist.get_rank()
    tp_groups = [dist.new_group([d * tp + j for j in range(tp)])
                 for d in range(dp)]
    dp_groups = [dist.new_group([d * tp + j for d in range(dp)])
                 for j in range(tp)]
    return r // tp, r % tp, dp_groups[r % tp], tp_groups[r // tp]


def _cut(t, axis: int, r: int, n: int):
    w = t.shape[axis] // n
    return t.narrow(axis, r * w, w).contiguous()


def shard(params: dict, r: int, tp: int) -> dict:
    """Rank r's tp shards of full parameters (``_param_specs``)."""
    return {"embed": _cut(params["embed"], 1, r, tp),
            "layers": {k: (_cut(t, _LAYER_AXES[k], r, tp)
                           if k in _LAYER_AXES else t)
                       for k, t in params["layers"].items()},
            "ln_out": params["ln_out"],
            "w_out": _cut(params["w_out"], 1, r, tp)}


def unshard(shards: list) -> dict:
    """The tp ranks' shards (numpy trees, in tp order) -> full numpy
    parameters."""
    first = shards[0]
    return {
        **{k: np.concatenate([s[k] for s in shards], axis=_TOP_AXES[k])
           for k in _TOP_AXES},
        "ln_out": first["ln_out"],
        "layers": {k: (np.concatenate([s["layers"][k] for s in shards],
                                      axis=_LAYER_AXES[k])
                       if k in _LAYER_AXES else a)
                   for k, a in first["layers"].items()},
    }


def _tp_loss(params, tokens, cfg, tp_group):
    logits = tt.train_logits(params, tokens[:, :-1], cfg, tp_group)
    return tt.cross_entropy(logits, tokens[:, 1:])


def train_step_tp(params: dict, tokens: torch.Tensor, cfg, dp_group,
                  tp_group, lr: float = 1e-3) -> tuple:
    """One SGD step on this rank's shards and its rows of the batch ->
    (new shards, the batch's mean loss)."""
    loss, grads = train.value_and_grad(_tp_loss, params, tokens, cfg,
                                       tp_group)
    dp = dist.get_world_size(dp_group)
    grads = [parallel.all_reduce(g, dp_group) / dp for g in grads]
    return (train.sgd_update(params, grads, lr),
            parallel.all_reduce(loss, dp_group) / dp)


def train_twin(rank: int, n: int, cfg, params: dict, tokens: np.ndarray,
               device) -> dict:
    """The dp x tp step of an n-rank world on full numpy ``params`` and
    the global batch ``tokens`` [dp * b, S + 1] -> {"loss", "params" (this
    rank's new shards, numpy), "dp", "tp" (its mesh position)}."""
    dev = resolve_device(device)
    dp_i, tp_i, dp_group, tp_group = mesh_groups(n)
    tp = dist.get_world_size(tp_group)
    dp = n // tp
    b = tokens.shape[0] // dp
    mine = shard(tt.train_params_from_numpy(params, cfg, dev), tp_i, tp)
    rows = torch.as_tensor(tokens[dp_i * b:(dp_i + 1) * b], device=dev)
    new, loss = train_step_tp(mine, rows, cfg, dp_group, tp_group)
    if not torch.isfinite(loss):
        raise AssertionError(f"non-finite loss {float(loss)}")
    return {"loss": float(loss), "params": tt.train_params_to_numpy(new),
            "dp": dp_i, "tp": tp_i}


def _leg_sp(rank: int, n: int, dev) -> dict:
    """sp: causal ring attention over the world against the dense oracle
    (the reference's atol 2e-3), and its gradient against the dense
    oracle's (rtol 1e-3, atol 1e-4, tests/test_ring_attention.py:71). The
    reference's shapes but D 32, the smallest head dim of K5 and K5b."""
    B, S, H, D = 2, 8 * n, 2, 32
    s = S // n
    rng = np.random.default_rng(7)
    full = [torch.tensor(rng.standard_normal((B, S, H, D)),
                         dtype=torch.float32, device=dev).requires_grad_(True)
            for _ in range(3)]
    mine = [t.detach()[:, rank * s:(rank + 1) * s].clone()
            .requires_grad_(True) for t in full]
    out = ra.ring_attention(*mine, causal=True)
    dense = ra.attention_reference(*full, causal=True)
    err = float((out - dense[:, rank * s:(rank + 1) * s]).detach().abs()
                .max())
    if not err <= 2e-3:
        raise AssertionError(f"sp: ring attention off by {err}")
    (out ** 2).sum().backward()
    (dense ** 2).sum().backward()
    for name, m, f in zip("qkv", mine, full):
        want = f.grad[:, rank * s:(rank + 1) * s]
        if not torch.allclose(m.grad, want, rtol=1e-3, atol=1e-4):
            raise AssertionError(
                f"sp: d/d{name} off by {float((m.grad - want).abs().max())}")
    return {"max_abs_err": err}


def _leg_ep(rank: int, n: int, dev) -> dict:
    """ep: expert-parallel MoE, 2 experts a rank, against its oracle (the
    reference's atol 1e-3)."""
    gen = torch.Generator(device=dev).manual_seed(11)
    p = moe.moe_init(gen, 16, 32, 2 * n, device=dev)
    x = torch.randn((n, 4, 16), generator=gen, device=dev)
    got = moe.moe_forward(moe.moe_shard(p, rank, n), x[rank:rank + 1], 8 * n)
    want = moe.moe_reference(p, x, 8 * n)[rank:rank + 1]
    err = float((got - want).abs().max())
    if not err <= 1e-3:
        raise AssertionError(f"ep: MoE off by {err}")
    return {"max_abs_err": err}


def _leg_pp(rank: int, n: int, dev) -> dict:
    """pp: GPipe over the first min(4, n) ranks, one stage of tanh(a @ w)
    each, against the stages in sequence (the reference's atol 1e-4)."""
    m = min(4, n)
    group = dist.new_group(list(range(m))) if m < n else None
    gen = torch.Generator(device=dev).manual_seed(13)
    w = torch.randn((m, 8, 8), generator=gen, device=dev) * 0.3
    x = torch.randn((m + 2, 3, 8), generator=gen, device=dev)
    if rank >= m:
        return {}
    got = pipeline_forward(lambda wi, a: torch.tanh(a @ wi),
                           w[rank:rank + 1], x, group)
    want = x
    for i in range(m):
        want = torch.tanh(want @ w[i])
    err = float((got - want).abs().max())
    if not err <= 1e-4:
        raise AssertionError(f"pp: pipeline off by {err}")
    return {"max_abs_err": err}


def dryrun_rank(rank: int, n: int, cfg=None, params=None, tokens=None,
                device=None) -> dict:
    """Rank ``rank``'s part of the dry run in an n-rank world whose process
    group is up: the dp x tp step (``cfg`` defaults to the tiny config,
    ``params`` to seeded f32 ones, ``tokens`` to the reference's zeros of
    [dp * 2, max_seq // 4 + 1]), then the sp, ep and pp legs, each held to
    its oracle. Raises on a mismatch; returns the step's result with each
    leg's error."""
    dev = resolve_device(device)
    cfg = cfg or tt.TransformerConfig.tiny()
    dp = n // (2 if n % 2 == 0 else 1)
    if params is None:  # the same on every rank: a seeded CPU generator
        params = tt.train_params_to_numpy(tt.init_params(
            dataclasses.replace(cfg, dtype=torch.float32),
            torch.Generator().manual_seed(0), device="cpu"))
    if tokens is None:
        tokens = np.zeros((dp * 2, cfg.max_seq // 4 + 1), np.int32)
    res = train_twin(rank, n, cfg, params, tokens, dev)
    res["sp"] = _leg_sp(rank, n, dev)
    res["ep"] = _leg_ep(rank, n, dev)
    res["pp"] = _leg_pp(rank, n, dev)
    return res
