"""Expert-parallel Mixture-of-Experts block (Switch-style top-1 routing).

The port of ``brpc_tpu/models/moe.py``: experts are sharded across the
group and tokens travel to their expert's owner over ``all_to_all`` (the
PartitionChannel scatter+scatter-merge shape). Capacity-based dispatch as
in the reference: each expert takes at most C tokens of each rank's shard,
and tokens past it keep only the residual. Plain PyTorch: the reference
computes this with XLA einsums and collectives and has no kernel of its
own.

The reference's semantics are kept where they are fragile: a token's
slot is counted by a cumsum in the input's dtype (in bfloat16 slots past
256 collide, as in the reference), GELU is the tanh approximation
(``jax.nn.gelu``'s default), and capacity holds per rank's shard in
``moe_forward`` but over all tokens in ``moe_reference``.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from brpc_tpu_torch.parallel import all_to_all_axes, rank_and_size
from brpc_tpu_torch.utils import resolve_device

__all__ = ["moe_init", "moe_params_from_numpy", "moe_shard", "moe_forward",
           "moe_reference"]


def moe_init(gen: torch.Generator, d_model: int, d_ff: int, n_experts: int,
             device=None) -> dict:
    """Parameters: router + per-expert 2-layer MLP (stacked on dim 0),
    drawn from ``gen`` at the reference's scales, in f32."""
    dev = resolve_device(device)
    scale = d_model ** -0.5

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=gen.device).to(dev)

    return {
        "router": normal(d_model, n_experts) * scale,
        "w_in": normal(n_experts, d_model, d_ff) * scale,
        "w_out": normal(n_experts, d_ff, d_model) * d_ff ** -0.5,
    }


def moe_params_from_numpy(params: dict, device=None) -> dict:
    """The reference's ``moe_init`` params as numpy arrays -> tensors on the
    port's device (``cuda`` unless ``device`` says otherwise)."""
    dev = resolve_device(device)
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in params.items()}


def moe_shard(params: dict, rank: int, n: int) -> dict:
    """Rank ``rank``'s share of ``params`` in a group of n: the router
    whole, experts [rank E/n, (rank + 1) E/n) of ``w_in`` and ``w_out``."""
    E = params["router"].shape[1]
    if E % n:
        raise ValueError(f"n_experts {E} must divide the group size {n}")
    lo, hi = rank * E // n, (rank + 1) * E // n
    return {"router": params["router"], "w_in": params["w_in"][lo:hi],
            "w_out": params["w_out"][lo:hi]}


def _route(x2d: torch.Tensor, router: torch.Tensor, capacity: int,
           n_experts: int) -> tuple:
    """Top-1 routing with capacity -> (dispatch, combine): dispatch[s, e, c]
    one-hot token -> slot; combine = dispatch * gate prob."""
    probs = torch.softmax(x2d @ router, dim=-1)            # [S, E]
    top_p, top_e = probs.max(dim=-1)                       # first on ties
    onehot = F.one_hot(top_e, n_experts).to(x2d.dtype)     # [S, E]
    # Position of each token within its expert's queue, in x's dtype as in
    # the reference; drop past capacity.
    pos = torch.cumsum(onehot, dim=0, dtype=x2d.dtype) * onehot - 1.0
    keep = (pos >= 0) & (pos < capacity)
    slots = torch.arange(capacity, device=x2d.device, dtype=x2d.dtype)
    pos_c = (pos[..., None] == slots).to(x2d.dtype)       # [S, E, C]
    dispatch = pos_c * keep[..., None].to(x2d.dtype)
    combine = dispatch * top_p[:, None, None]
    return dispatch, combine


def _experts(expert_in: torch.Tensor, w_in: torch.Tensor,
             w_out: torch.Tensor) -> torch.Tensor:
    h = F.gelu(torch.einsum("ecd,edf->ecf", expert_in, w_in),
               approximate="tanh")
    return torch.einsum("ecf,efd->ecd", h, w_out)


def moe_reference(params: dict, x: torch.Tensor, capacity: int
                  ) -> torch.Tensor:
    """Single-device oracle: the same routing math over all tokens, dense
    experts. x: [B, T, D]."""
    B, T, D = x.shape
    E = params["router"].shape[1]
    x2d = x.reshape(B * T, D)
    dispatch, combine = _route(x2d, params["router"], capacity, E)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, x2d)  # [E, C, D]
    expert_out = _experts(expert_in, params["w_in"], params["w_out"])
    y = torch.einsum("sec,ecd->sd", combine, expert_out)
    return (x2d + y).reshape(B, T, D)  # the residual carries dropped tokens


def moe_forward(params: dict, x: torch.Tensor, capacity: int,
                group=None) -> torch.Tensor:
    """Expert-parallel forward of this rank's tokens ``x`` ([B / n, T, D])
    with this rank's experts (``moe_shard``: the router whole, ``w_in`` and
    ``w_out`` of E / n experts). Routes its own tokens with capacity per
    shard, ships each expert's slots to its owner, runs the local experts
    on the slots of every rank, and ships the results back."""
    _, n = rank_and_size(group)
    Bl, T, D = x.shape
    E = params["router"].shape[1]
    if E != n * params["w_in"].shape[0]:
        raise ValueError(f"{params['w_in'].shape[0]} local experts of {E} "
                         f"in a group of {n}")
    x2d = x.reshape(Bl * T, D)
    dispatch, combine = _route(x2d, params["router"], capacity, E)
    expert_in = torch.einsum("sec,sd->ecd", dispatch, x2d)  # [E, C, D]
    # To the owners: [E / n, n C, D], rank i's slots at [:, i C:(i + 1) C].
    expert_in = all_to_all_axes(expert_in, 0, 1, group)
    expert_out = _experts(expert_in, params["w_in"], params["w_out"])
    # Back to the tokens' owners: [E, C, D].
    expert_out = all_to_all_axes(expert_out, 1, 0, group)
    y = torch.einsum("sec,ecd->sd", combine, expert_out)
    return (x2d + y).reshape(Bl, T, D)
