"""Llama-style decoder-only transformer in PyTorch: the counterpart of
brpc_tpu/models/transformer.py.

Parameters are a plain dict with the reference's layout: stacked ``[L, ...]``
layer weights, matrices laid out for ``x @ W``. Matrices and the embedding
live in the model dtype on the device, cast once at load (the reference
keeps them f32 and casts per matmul: the values are the same); norm gains
stay f32, as the reference's f32 norm math reads them.

- ``forward``: full recompute over a batch, in plain torch (no kernel). It
  is the greedy oracle the tests and the smoke hold the serving path to.
- ``prefill``: one right-padded sequence; returns the last real position's
  logits and the KV of every layer, ``[L, P, KV, Dh]`` (the reference pads
  its cache to max_seq; the pages cut from either are the same).
- ``decode_step``: one token per lane for a batch of lanes over the paged
  KV pool, written in place and read through the block tables (the
  reference vmaps a per-sequence step over a dense gathered view).

RMSNorm, prefill attention and paged decode attention go through the
wrappers in ``brpc_tpu_torch.ops`` (kernels on a CUDA tensor).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brpc_tpu_torch.ops import attention, norm
from brpc_tpu_torch.utils import resolve_device


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab: int = 32000
    d_model: int = 512
    n_layers: int = 4
    n_heads: int = 8
    n_kv_heads: int = 8
    d_ff: int = 1408
    max_seq: int = 2048
    rope_theta: float = 500000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_head(self) -> int:
        return self.d_model // self.n_heads

    @property
    def wire_dtype(self) -> np.dtype:
        """numpy dtype of the model dtype's bytes on the wire: float32, or
        for bfloat16 ``ml_dtypes.bfloat16`` where importable, else raw
        uint16 (the same bytes)."""
        if self.dtype == torch.float32:
            return np.dtype(np.float32)
        if self.dtype == torch.bfloat16:
            try:
                import ml_dtypes
                return np.dtype(ml_dtypes.bfloat16)
            except ImportError:
                return np.dtype(np.uint16)
        raise TypeError(f"no wire dtype for {self.dtype}")

    @staticmethod
    def tiny() -> "TransformerConfig":
        """Small enough for CPU unit tests (H == KV)."""
        return TransformerConfig(
            vocab=256, d_model=128, n_layers=2, n_heads=4, n_kv_heads=4,
            d_ff=256, max_seq=128,
        )

    @staticmethod
    def llama3_8b() -> "TransformerConfig":
        return TransformerConfig(
            vocab=128256, d_model=4096, n_layers=32, n_heads=32, n_kv_heads=8,
            d_ff=14336, max_seq=8192,
        )


Params = Dict[str, object]
_MATRICES = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")
_GAINS = ("ln_attn", "ln_mlp")


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters from ``generator`` (which must live on
    ``device``): N(0, 1/fan_in) matrices, unit gains, the reference's
    shapes. Drawn in f32 one layer at a time and cast into the model dtype,
    so the transient stays one layer's matrix."""
    dev = resolve_device(device)
    L, D, H, KV, Dh, F_ = (cfg.n_layers, cfg.d_model, cfg.n_heads,
                           cfg.n_kv_heads, cfg.d_head, cfg.d_ff)

    def dense(fan_in, shape):
        out = torch.empty(shape, dtype=cfg.dtype, device=dev)
        for dst in (out.unbind(0) if len(shape) == 3 else (out,)):
            dst.copy_(torch.randn(dst.shape, generator=generator,
                                  device=dev, dtype=torch.float32)
                      / math.sqrt(fan_in))
        return out

    layers = {
        "wq": dense(D, (L, D, H * Dh)),
        "wk": dense(D, (L, D, KV * Dh)),
        "wv": dense(D, (L, D, KV * Dh)),
        "wo": dense(H * Dh, (L, H * Dh, D)),
        "w_gate": dense(D, (L, D, F_)),
        "w_up": dense(D, (L, D, F_)),
        "w_down": dense(F_, (L, F_, D)),
        "ln_attn": torch.ones((L, D), dtype=torch.float32, device=dev),
        "ln_mlp": torch.ones((L, D), dtype=torch.float32, device=dev),
    }
    return {
        "embed": dense(1, (cfg.vocab, D)),
        "layers": layers,
        "ln_out": torch.ones((D,), dtype=torch.float32, device=dev),
        "w_out": dense(D, (D, cfg.vocab)),
    }


def params_from_numpy(tree, cfg: TransformerConfig, device=None) -> Params:
    """The reference's parameter pytree as numpy arrays (``jax.tree.map(
    np.asarray, params)``) -> this package's parameters on ``device``:
    matrices and embedding in the model dtype, gains in f32."""
    dev = resolve_device(device)

    def mat(a):
        return torch.tensor(np.asarray(a, np.float32), dtype=cfg.dtype,
                            device=dev)

    def gain(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    layers = tree["layers"]
    out_layers = {name: mat(layers[name]) for name in _MATRICES}
    out_layers.update({name: gain(layers[name]) for name in _GAINS})
    return {
        "embed": mat(tree["embed"]),
        "layers": out_layers,
        "ln_out": gain(tree["ln_out"]),
        "w_out": mat(tree["w_out"]),
    }


def _layer(params: Params, l: int) -> dict:
    return {name: w[l] for name, w in params["layers"].items()}


def _rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float):
    return norm.rms_norm(x, gain, eps)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last dim, positions 0..S-1; x: [B, S, H,
    Dh]. Half-split rotation (first half, second half)."""
    _, S, _, Dh = x.shape
    half = Dh // 2
    dev = x.device
    freqs = torch.exp(
        -torch.log(torch.tensor(theta, dtype=torch.float32, device=dev))
        * torch.arange(0, half, dtype=torch.float32, device=dev) / half)
    angles = (torch.arange(S, dtype=torch.float32, device=dev)[:, None]
              * freqs[None, :])
    cos = torch.cos(angles)[None, :, None, :]
    sin = torch.sin(angles)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


_ROPE_TABLES: dict = {}


def _rope_tables(cfg: TransformerConfig, device):
    """cos/sin tables over [max_seq, Dh/2] (f32; gathered per position),
    cached per (config geometry, device)."""
    key = (cfg.max_seq, cfg.d_head, cfg.rope_theta, str(device))
    hit = _ROPE_TABLES.get(key)
    if hit is not None:
        return hit
    half = cfg.d_head // 2
    freqs = torch.exp(
        -torch.log(torch.tensor(cfg.rope_theta, dtype=torch.float32,
                                device=device))
        * torch.arange(0, half, dtype=torch.float32, device=device) / half)
    angles = (torch.arange(cfg.max_seq, dtype=torch.float32,
                           device=device)[:, None] * freqs[None, :])
    tables = (torch.cos(angles), torch.sin(angles))
    _ROPE_TABLES[key] = tables
    return tables


def _rope_apply(x: torch.Tensor, cos: torch.Tensor,
                sin: torch.Tensor) -> torch.Tensor:
    """Rotate x: [..., Dh] by per-position tables broadcast over heads."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def _mlp(x: torch.Tensor, lp: dict, cfg: TransformerConfig, rms) -> torch.Tensor:
    h = rms(x, lp["ln_mlp"], cfg.norm_eps)
    gate = F.silu(h @ lp["w_gate"])
    up = h @ lp["w_up"]
    return x + (gate * up) @ lp["w_down"]


# ---- full recompute (the oracle) --------------------------------------------

def _attention_plain(q, k, v):
    """Causal multi-head attention; q: [B, S, H, Dh], k/v: [B, S, KV, Dh]."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    if KV != H:
        k = k.repeat_interleave(H // KV, dim=2)
        v = v.repeat_interleave(H // KV, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * attention.softmax_scale(Dh)
    span = torch.arange(S, device=q.device)
    mask = span[:, None] >= span[None, :]
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(-1e30, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                        v.float()).to(q.dtype)


def forward(params: Params, tokens: torch.Tensor,
            cfg: TransformerConfig) -> torch.Tensor:
    """tokens: [B, S] int -> logits [B, S, vocab] f32. Plain torch
    throughout (``_rope``, plain RMSNorm and attention): the reference full
    recompute, calling no kernel."""
    B, S = tokens.shape
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    rms = norm.rms_norm_plain
    x = params["embed"][tokens.long()]
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = rms(x, lp["ln_attn"], cfg.norm_eps)
        q = _rope((h @ lp["wq"]).reshape(B, S, H, Dh), cfg.rope_theta)
        k = _rope((h @ lp["wk"]).reshape(B, S, KV, Dh), cfg.rope_theta)
        v = (h @ lp["wv"]).reshape(B, S, KV, Dh)
        o = _attention_plain(q, k, v).reshape(B, S, H * Dh)
        x = x + o @ lp["wo"]
        x = _mlp(x, lp, cfg, rms)
    x = rms(x, params["ln_out"], cfg.norm_eps)
    return (x @ params["w_out"]).float()


# ---- serving: prefill + paged decode ----------------------------------------

def prefill(params: Params, tokens: torch.Tensor, length: int,
            cfg: TransformerConfig):
    """Prefill ONE sequence. tokens: [P] right-padded to a bucket; length:
    the true prompt length. Returns (logits [vocab] f32 at position
    length-1, k, v each [L, P, KV, Dh]). Pad positions write KV too, as in
    the reference; decode overwrites them from ``length`` on before any
    query can attend them."""
    P = tokens.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    dev = tokens.device
    cos_t, sin_t = _rope_tables(cfg, dev)
    cos = cos_t[:P][:, None, :]  # [P, 1, half] broadcast over heads
    sin = sin_t[:P][:, None, :]
    x = params["embed"][tokens.long()]  # [P, D]
    k_all = torch.empty((cfg.n_layers, P, KV, Dh), dtype=cfg.dtype,
                        device=dev)
    v_all = torch.empty_like(k_all)
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = _rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q = _rope_apply((h @ lp["wq"]).reshape(P, H, Dh), cos, sin)
        k = _rope_apply((h @ lp["wk"]).reshape(P, KV, Dh), cos, sin)
        v = (h @ lp["wv"]).reshape(P, KV, Dh)
        k_all[l] = k
        v_all[l] = v
        o = attention.prefill_attention(q, k, v, length)
        x = x + o.reshape(P, H * Dh) @ lp["wo"]
        x = _mlp(x, lp, cfg, _rms_norm)
    # The norm is row-wise: normalising the one row read equals the
    # reference's norm-all-then-take.
    last = _rms_norm(x[length - 1:length], params["ln_out"], cfg.norm_eps)
    logits = last[0] @ params["w_out"]
    return logits.float(), k_all, v_all


def decode_step(params: Params, tokens: torch.Tensor, pos: torch.Tensor,
                tables: torch.Tensor, k_pool: torch.Tensor,
                v_pool: torch.Tensor, cfg: TransformerConfig,
                ) -> torch.Tensor:
    """One token per lane for every lane at once. tokens, pos: [S] int32;
    tables: [S, max_pages] int32 block tables; k_pool/v_pool: [NB, L,
    page, KV, Dh]. Per layer, the lane's new K/V row lands in place at
    (tables[lane, pos // page], layer, pos % page), then attention reads
    the pool through the tables (K1 on the card). Returns logits [S,
    vocab] f32; the pools are updated in place."""
    S = tokens.shape[0]
    H, KV, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    page = k_pool.shape[2]
    cos_t, sin_t = _rope_tables(cfg, tokens.device)
    pos_l = pos.long()
    cos = cos_t[pos_l][:, None, :]  # [S, 1, half]
    sin = sin_t[pos_l][:, None, :]
    blk = tables.long().gather(1, (pos_l // page)[:, None])[:, 0]
    off = pos_l % page
    x = params["embed"][tokens.long()]  # [S, D]
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        h = _rms_norm(x, lp["ln_attn"], cfg.norm_eps)
        q = _rope_apply((h @ lp["wq"]).reshape(S, H, Dh), cos, sin)
        k = _rope_apply((h @ lp["wk"]).reshape(S, KV, Dh), cos, sin)
        v = (h @ lp["wv"]).reshape(S, KV, Dh)
        k_pool[:, l][blk, off] = k
        v_pool[:, l][blk, off] = v
        o = attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                             pos, l)
        x = x + o.reshape(S, H * Dh) @ lp["wo"]
        x = _mlp(x, lp, cfg, _rms_norm)
    x = _rms_norm(x, params["ln_out"], cfg.norm_eps)
    return (x @ params["w_out"]).float()


def greedy_reference(params: Params, cfg: TransformerConfig, prompt,
                     n: int, device: Optional[torch.device] = None) -> list:
    """Greedy rollout of ``n`` tokens through ``forward`` (full recompute
    per token): the oracle for the serving path's token streams."""
    dev = resolve_device(device)
    seq = [int(t) for t in prompt]
    out = []
    for _ in range(n):
        toks = torch.tensor([seq], dtype=torch.long, device=dev)
        tok = int(forward(params, toks, cfg)[0, -1].argmax())
        out.append(tok)
        seq.append(tok)
    return out
