"""The training step: the counterpart of the SGD step that
``__graft_entry__.py:125-133`` (``dryrun_multichip``'s ``train_step``)
jits over the reference's ``loss_fn``: the loss and its gradients in one
pass, then ``p - lr g`` on every f32 master parameter. The reference has
no other optimiser."""

from __future__ import annotations

import torch

from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.utils import resolve_device


def flatten(params: dict) -> list:
    """The parameter tree's leaves in a fixed order (the one ``unflatten``
    reads)."""
    return ([params["embed"]]
            + [params["layers"][k] for k in sorted(params["layers"])]
            + [params["ln_out"], params["w_out"]])


def unflatten(leaves: list, like: dict) -> dict:
    """``flatten``'s inverse, with ``like``'s keys."""
    names = sorted(like["layers"])
    return {"embed": leaves[0],
            "layers": dict(zip(names, leaves[1:1 + len(names)])),
            "ln_out": leaves[-2], "w_out": leaves[-1]}


def sgd_update(params: dict, grads: list, lr: float) -> dict:
    """``p - lr g`` on every leaf in f32, as new tensors."""
    with torch.no_grad():
        return unflatten([p - lr * g.to(p.dtype)
                          for p, g in zip(flatten(params), grads)], params)


def value_and_grad(loss, params: dict, *args, **kwargs) -> tuple:
    """``loss(params, *args, **kwargs)`` and its gradient in every leaf of
    ``params`` (a list in ``flatten``'s order), the reference's
    ``jax.value_and_grad``."""
    leaves = [p.detach().requires_grad_(True) for p in flatten(params)]
    value = loss(unflatten(leaves, params), *args, **kwargs)
    return value.detach(), list(torch.autograd.grad(value, leaves))


def train_step(params: dict, tokens, cfg, lr: float = 1e-3,
               device=None) -> tuple:
    """One SGD step on ``transformer.loss_fn`` -> (new params, loss). On a
    card the forward runs K2 and K3, the backward K2b and K3b. ``device``
    as ``loss_fn`` takes it."""
    dev = resolve_device(device)
    loss, grads = value_and_grad(transformer.loss_fn, params, tokens, cfg,
                                 device=dev)
    return sgd_update(params, grads, lr), loss
