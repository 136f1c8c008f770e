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
- ``prefill_stream``: the same prefill, handing each layer's K/V to a
  callback as soon as they exist (the prefill worker streams them out).
- ``prefill_resume``: the suffix of a prompt whose prefix is cached in the
  paged pool, written in place and read through the sequence's block table
  (the reference runs over a dense gathered prefix view).
- ``decode_step``: one token per lane for a batch of lanes over the paged
  KV pool, written in place and read through the block tables (the
  reference vmaps a per-sequence step over a dense gathered view).

RMSNorm, prefill attention and the two paged attentions go through the
wrappers in ``brpc_tpu_torch.ops`` (kernels on a CUDA tensor). The three
serving paths share one layer stack (``_decoder``), in which every norm but
the first takes the residual add before it into the same launch
(``add_rms_norm``); ``forward`` keeps the reference's unfused order.

Training (``loss_fn``, the counterpart of the reference's ``loss_fn``) runs
on f32 master parameters (``train_params_from_numpy``, as the reference's
``init_params`` keeps them), each matrix cast to the model dtype where it is
used, so the gradients land in f32. Its forward is the reference's
``forward`` on the kernels, differentiable: causal attention (K2 with its
log-sum-exp; K2b backward) and the norms (K3 and its fused add; K3b
backward); matmuls, RoPE, SwiGLU, the embedding and the cross-entropy stay
plain torch under autograd. ``loss_fn_plain`` is the same loss through the
plain ``forward``: the oracle.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from brpc_tpu_torch import parallel
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
    matrices and embedding in the model dtype, gains in f32. A leaf may
    also be a torch tensor (a bf16 one off the TPS1 wire, or one already
    on the device); it is cast, without a round trip through numpy."""
    dev = resolve_device(device)

    def cast(a, dtype):
        if isinstance(a, torch.Tensor):
            return a.to(device=dev, dtype=dtype)
        return torch.tensor(np.asarray(a, np.float32), dtype=dtype,
                            device=dev)

    def mat(a):
        return cast(a, cfg.dtype)

    def gain(a):
        return cast(a, torch.float32)

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


def _ffn(h: torch.Tensor, lp: dict) -> torch.Tensor:
    """The SwiGLU MLP of the normed stream h: the delta the residual adds."""
    return (F.silu(h @ lp["w_gate"]) * (h @ lp["w_up"])) @ lp["w_down"]


def _qkv(h: torch.Tensor, lp: dict, cfg: TransformerConfig, cos, sin):
    """q [n, H, Dh] and k [n, KV, Dh] rotated by the per-row tables, v
    [n, KV, Dh], from the normed stream h [n, D]."""
    n, H, KV, Dh = h.shape[0], cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    q = _rope_apply((h @ lp["wq"]).reshape(n, H, Dh), cos, sin)
    k = _rope_apply((h @ lp["wk"]).reshape(n, KV, Dh), cos, sin)
    return q, k, (h @ lp["wv"]).reshape(n, KV, Dh)


def _decoder(params: Params, x: torch.Tensor, cfg: TransformerConfig,
             attend) -> tuple:
    """The layer stack of the serving paths over the embedded rows x [n,
    D]. ``attend(l, lp, h)`` is layer l's attention of the normed stream h,
    projected by wo: [n, D]. Each norm but the first takes the residual add
    before it into one launch (``norm.add_rms_norm``): x + attention out
    with ln_mlp, x + MLP out with the next layer's ln_attn. Returns (x,
    delta): the stream before the last MLP's residual add and that add's
    delta, which the caller folds into its final norm."""
    eps = cfg.norm_eps
    h = norm.rms_norm(x, params["layers"]["ln_attn"][0], eps)
    delta = None
    for l in range(cfg.n_layers):
        lp = _layer(params, l)
        if delta is not None:
            x, h = norm.add_rms_norm(x, delta, lp["ln_attn"], eps)
        x, h = norm.add_rms_norm(x, attend(l, lp, h), lp["ln_mlp"], eps)
        delta = _ffn(h, lp)
    return x, delta


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
        x = x + _ffn(rms(x, lp["ln_mlp"], cfg.norm_eps), lp)
    x = rms(x, params["ln_out"], cfg.norm_eps)
    return (x @ params["w_out"]).float()


# ---- serving: prefill + paged decode ----------------------------------------

def _prefill(params: Params, tokens: torch.Tensor, length: int,
             cfg: TransformerConfig, on_kv) -> torch.Tensor:
    """The prefill of ``prefill`` and ``prefill_stream``: ``on_kv(l, k,
    v)`` receives layer l's K/V [P, KV, Dh] as soon as they exist, before
    its attention. Returns the logits [vocab] f32 at position length-1."""
    P = tokens.shape[0]
    H, Dh = cfg.n_heads, cfg.d_head
    cos_t, sin_t = _rope_tables(cfg, tokens.device)
    cos = cos_t[:P][:, None, :]  # [P, 1, half] broadcast over heads
    sin = sin_t[:P][:, None, :]

    def attend(l, lp, h):
        q, k, v = _qkv(h, lp, cfg, cos, sin)
        on_kv(l, k, v)
        o = attention.prefill_attention(q, k, v, length)
        return o.reshape(P, H * Dh) @ lp["wo"]

    x, delta = _decoder(params, params["embed"][tokens.long()], cfg, attend)
    # The norm is row-wise: normalising the one row read equals the
    # reference's norm-all-then-take.
    r = slice(length - 1, length)
    last = norm.rms_norm(x[r] + delta[r], params["ln_out"], cfg.norm_eps)
    return (last[0] @ params["w_out"]).float()


def prefill(params: Params, tokens: torch.Tensor, length: int,
            cfg: TransformerConfig):
    """Prefill ONE sequence. tokens: [P] right-padded to a bucket; length:
    the true prompt length. Returns (logits [vocab] f32 at position
    length-1, k, v each [L, P, KV, Dh]). Pad positions write KV too, as in
    the reference; decode overwrites them from ``length`` on before any
    query can attend them."""
    P = tokens.shape[0]
    k_all = torch.empty((cfg.n_layers, P, cfg.n_kv_heads, cfg.d_head),
                        dtype=cfg.dtype, device=tokens.device)
    v_all = torch.empty_like(k_all)

    def keep(l, k, v):
        k_all[l] = k
        v_all[l] = v

    logits = _prefill(params, tokens, length, cfg, keep)
    return logits, k_all, v_all


def prefill_stream(params: Params, tokens: torch.Tensor, length: int,
                   cfg: TransformerConfig, on_layer) -> torch.Tensor:
    """Layer-wise prefill for disaggregated serving: the math of
    ``prefill`` (K2 and the fused norms), but ``on_layer(l, k, v)`` fires
    as soon as layer l's K/V exist (k/v [P, KV, Dh], unpadded), so layer
    l's transfer can start while layer l+1 is enqueued. Returns the logits
    [vocab] f32 at position length-1."""
    return _prefill(params, tokens, length, cfg, on_layer)


def prefill_resume(params: Params, tokens: torch.Tensor, start: int,
                   length: int, table: torch.Tensor, k_pool: torch.Tensor,
                   v_pool: torch.Tensor, cfg: TransformerConfig
                   ) -> torch.Tensor:
    """Suffix prefill for a prefix-cache hit. The pages of ``table`` ([pages]
    int32 block ids covering positions [0, length)) already hold positions
    [0, start); ``tokens`` holds the prompt's tokens for positions
    [start, length) (anything past ``length - start`` is ignored). Per
    layer, the suffix rows' K/V land in place at (table[p // page], layer,
    p % page), then attention reads the pool through the table: query
    start + i attends every position <= start + i (K4 on the card). The
    same math as ``prefill`` restricted to the suffix. Only the real rows
    are computed, so no pad row reaches a page; rows of the last page past
    ``length`` keep what they held, and decode overwrites them from
    ``length`` on before any query attends them. Returns logits [vocab] f32
    at position length-1; the pools are updated in place."""
    n = length - start
    H, Dh = cfg.n_heads, cfg.d_head
    page = k_pool.shape[2]
    dev = tokens.device
    cos_t, sin_t = _rope_tables(cfg, dev)
    pos = torch.arange(start, length, device=dev)
    cos = cos_t[pos][:, None, :]  # [n, 1, half] broadcast over heads
    sin = sin_t[pos][:, None, :]
    blk = table.long()[pos // page]
    off = pos % page

    def attend(l, lp, h):
        q, k, v = _qkv(h, lp, cfg, cos, sin)
        k_pool[:, l][blk, off] = k
        v_pool[:, l][blk, off] = v
        o = attention.paged_prefill_attention(q, k_pool, v_pool, table,
                                              start, l)
        return o.reshape(n, H * Dh) @ lp["wo"]

    x, delta = _decoder(params, params["embed"][tokens[:n].long()], cfg,
                        attend)
    r = slice(n - 1, n)
    last = norm.rms_norm(x[r] + delta[r], params["ln_out"], cfg.norm_eps)
    return (last[0] @ params["w_out"]).float()


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
    H, Dh = cfg.n_heads, cfg.d_head
    page = k_pool.shape[2]
    cos_t, sin_t = _rope_tables(cfg, tokens.device)
    pos_l = pos.long()
    cos = cos_t[pos_l][:, None, :]  # [S, 1, half]
    sin = sin_t[pos_l][:, None, :]
    blk = tables.long().gather(1, (pos_l // page)[:, None])[:, 0]
    off = pos_l % page

    def attend(l, lp, h):
        q, k, v = _qkv(h, lp, cfg, cos, sin)
        k_pool[:, l][blk, off] = k
        v_pool[:, l][blk, off] = v
        o = attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                             pos, l)
        return o.reshape(S, H * Dh) @ lp["wo"]

    x, delta = _decoder(params, params["embed"][tokens.long()], cfg, attend)
    _, h = norm.add_rms_norm(x, delta, params["ln_out"], cfg.norm_eps)
    return (h @ params["w_out"]).float()


# ---- training: the loss on the kernels, and its plain oracle -----------------

def train_params_from_numpy(tree, cfg: TransformerConfig,
                            device=None) -> Params:
    """The reference's parameter pytree as numpy arrays -> f32 master
    parameters on ``device`` (every leaf, gains and matrices alike, in f32
    as the reference's ``init_params`` keeps them; the training forward
    casts each matrix to ``cfg.dtype`` where it is used)."""
    dev = resolve_device(device)
    if tuple(np.shape(tree["embed"])) != (cfg.vocab, cfg.d_model):
        raise ValueError(f"embed is {np.shape(tree['embed'])}, the config "
                         f"wants ({cfg.vocab}, {cfg.d_model})")

    def f32(a):
        return torch.tensor(np.asarray(a, np.float32), device=dev)

    return {"embed": f32(tree["embed"]),
            "layers": {name: f32(a) for name, a in tree["layers"].items()},
            "ln_out": f32(tree["ln_out"]), "w_out": f32(tree["w_out"])}


def train_params_to_numpy(params: Params) -> dict:
    """Master parameters (or gradients of the same layout) -> the
    reference's pytree of numpy arrays."""
    def a(t):
        return t.detach().float().cpu().numpy()

    return {"embed": a(params["embed"]),
            "layers": {name: a(t) for name, t in params["layers"].items()},
            "ln_out": a(params["ln_out"]), "w_out": a(params["w_out"])}


def _model_view(params: Params, cfg: TransformerConfig) -> Params:
    """f32 master parameters as ``forward`` reads them: matrices and the
    embedding cast to the model dtype (differentiably), gains as they
    are."""
    dt = cfg.dtype
    return {"embed": params["embed"].to(dt),
            "layers": {name: (w.to(dt) if name in _MATRICES else w)
                       for name, w in params["layers"].items()},
            "ln_out": params["ln_out"], "w_out": params["w_out"].to(dt)}


def train_logits(params: Params, tokens: torch.Tensor,
                 cfg: TransformerConfig, tp_group=None) -> torch.Tensor:
    """The training forward: tokens [B, S] -> logits [B, S, vocab] f32,
    differentiable in the f32 master ``params``. The reference's ``forward``
    (brpc_tpu/models/transformer.py:163, its ``_block`` :142) with ``_rope``
    over positions 0..S-1, ``attention.causal_attention`` (K2, K2b) and the
    norms of ``norm.rms_norm_train`` / ``add_rms_norm_train`` (K3, K3b),
    every norm but the first taking the residual add before it.

    With ``tp_group`` the parameters are this rank's tensor-parallel shards
    (``dryrun.shard``): column shards of wq, wk, wv, w_gate and w_up, row
    shards of wo and w_down (their partial products summed over the
    group), the embedding split on D and w_out on the vocabulary (each
    gathered on its split axis), gains whole. Head counts follow from the
    shards' widths."""
    dt = cfg.dtype
    B, S = tokens.shape
    Dh, eps, lay = cfg.d_head, cfg.norm_eps, params["layers"]

    def enter(t):
        return t if tp_group is None else parallel.tp_enter(t, tp_group)

    def reduce(t):
        return t if tp_group is None else parallel.tp_reduce(t, tp_group)

    def gather(t):
        return t if tp_group is None else parallel.tp_gather(t, -1,
                                                             tp_group)

    def proj(h, name, l):
        return h @ lay[name][l].to(dt)

    x = gather(params["embed"].to(dt)[tokens.long()])
    h = norm.rms_norm_train(x, lay["ln_attn"][0], eps)
    delta = None
    for l in range(cfg.n_layers):
        if delta is not None:
            x, h = norm.add_rms_norm_train(x, delta, lay["ln_attn"][l], eps)
        h = enter(h)
        q = _rope(proj(h, "wq", l).reshape(B, S, -1, Dh), cfg.rope_theta)
        k = _rope(proj(h, "wk", l).reshape(B, S, -1, Dh), cfg.rope_theta)
        v = proj(h, "wv", l).reshape(B, S, -1, Dh)
        o = attention.causal_attention(q, k, v).reshape(B, S, -1)
        x, h = norm.add_rms_norm_train(x, reduce(proj(o, "wo", l)),
                                       lay["ln_mlp"][l], eps)
        h = enter(h)
        delta = reduce(proj(F.silu(proj(h, "w_gate", l))
                            * proj(h, "w_up", l), "w_down", l))
    _, h = norm.add_rms_norm_train(x, delta, params["ln_out"], eps)
    return gather(enter(h) @ params["w_out"].to(dt)).float()


def cross_entropy(logits: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
    """The mean next-token negative log-likelihood, as the reference's
    ``loss_fn`` takes it: log_softmax over the vocabulary in f32, then the
    targets' entries."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    return -logp.gather(-1, targets.long()[..., None])[..., 0].mean()


def loss_fn(params: Params, tokens, cfg: TransformerConfig,
            device=None) -> torch.Tensor:
    """Next-token cross-entropy over tokens [B, S + 1] (the counterpart of
    brpc_tpu/models/transformer.py:176), through ``train_logits``: on a
    card the forward runs K2 and K3 and the backward K2b and K3b. The
    tokens go to ``device`` (``cuda`` unless the caller names another),
    where ``params`` must live."""
    tokens = torch.as_tensor(tokens, device=resolve_device(device))
    return cross_entropy(train_logits(params, tokens[:, :-1], cfg),
                         tokens[:, 1:])


def loss_fn_plain(params: Params, tokens, cfg: TransformerConfig,
                  device=None) -> torch.Tensor:
    """``loss_fn`` through the plain ``forward`` (no kernel; autograd
    differentiates its plain torch): the oracle the tests and the smoke
    hold ``loss_fn`` to."""
    tokens = torch.as_tensor(tokens, device=resolve_device(device))
    logits = forward(_model_view(params, cfg), tokens[:, :-1], cfg)
    return cross_entropy(logits, tokens[:, 1:])


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
