"""Attention of the serving path: the K1 (paged decode), K2 (prefill) and
K4 (paged suffix prefill) kernels' wrappers, each with its plain PyTorch
version, and K4's split-K planner with a plain model of its split and
merge passes and a per-row error measure (for the tests).

The plain versions repeat the reference's arithmetic
(brpc_tpu/models/transformer.py): logits in f32 from the model-dtype
operands times 1/sqrt(Dh), -1e30 on masked keys, f32 softmax, the
probabilities cast to the model dtype, and the product with V accumulated
in f32. A wrapper given CPU tensors runs its plain version; given CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from brpc_tpu_torch.ops import _build

_NEG = -1e30


@functools.lru_cache(maxsize=None)
def softmax_scale(d_head: int) -> float:
    """1/sqrt(Dh) rounded as the reference rounds it (f32 sqrt, f32
    division); exact as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d_head)))


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return _build.DTYPE_FLOAT32
    if t.dtype == torch.bfloat16:
        return _build.DTYPE_BFLOAT16
    raise TypeError(f"unsupported dtype {t.dtype}")


def _repeat_kv(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return x.repeat_interleave(rep, dim=dim) if rep > 1 else x


# ---- K1: decode attention over the paged pool ------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                 layer: int) -> torch.Tensor:
    """q: [S, H, Dh]; k_pool/v_pool: [NB, L, page, KV, Dh]; tables:
    [S, max_pages] int32; pos: [S] int32 -> o [S, H, Dh]. Gathers the
    pages up to the largest position and masks keys past each lane's pos
    (the reference's dense view, cut to the pages in play)."""
    S, H, Dh = q.shape
    page, KV = k_pool.shape[2], k_pool.shape[3]
    npages = int(pos.max()) // page + 1
    idx = tables[:, :npages].long()
    kg = k_pool[:, layer][idx].reshape(S, npages * page, KV, Dh)
    vg = v_pool[:, layer][idx].reshape(S, npages * page, KV, Dh)
    kr, vr = _repeat_kv(kg, H // KV, 2), _repeat_kv(vg, H // KV, 2)
    logits = torch.einsum("shd,sthd->sht", q.float(), kr.float()) \
        * softmax_scale(Dh)
    span = torch.arange(npages * page, device=q.device)
    mask = span[None, :] <= pos.long()[:, None]
    logits = torch.where(mask[:, None, :], logits,
                         torch.tensor(_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("sht,sthd->shd", probs.float(),
                        vr.float()).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, pos,
                           layer: int) -> torch.Tensor:
    """Decode attention of one token per lane at position ``pos[lane]``
    over layer ``layer`` of the paged pool, read through ``tables``. On a
    CUDA tensor launches csrc/paged_decode_attention.cu (K1)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                            layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    S, H, Dh = q.shape
    NB, L, page, KV, Dh2 = k_pool.shape
    if (Dh2 != Dh or v_pool.shape != k_pool.shape
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or not (k_pool.is_contiguous() and v_pool.is_contiguous())):
        raise ValueError("paged_decode_attention: pools must be contiguous "
                         "[NB, L, page, KV, Dh] in q's dtype")
    if (tables.dtype != torch.int32 or pos.dtype != torch.int32
            or tables.shape[0] != S or pos.shape != (S,)
            or tables.device != q.device or pos.device != q.device):
        raise ValueError("paged_decode_attention: tables [S, pages] and pos "
                         "[S] must be int32 on q's device")
    if not 0 <= layer < L or H % KV:
        raise ValueError("paged_decode_attention: bad layer or head counts")
    qc, tc, pc = q.contiguous(), tables.contiguous(), pos.contiguous()
    out = torch.empty_like(qc)
    k_l, v_l = k_pool[:, layer], v_pool[:, layer]
    rc = _build.lib().brpc_paged_decode_attention(
        _dtype_code(q), qc.data_ptr(), k_l.data_ptr(), v_l.data_ptr(),
        tc.data_ptr(), pc.data_ptr(), out.data_ptr(), S, H, KV, Dh, page,
        tc.shape[1], k_pool.stride(0), k_pool.stride(2), k_pool.stride(3),
        softmax_scale(Dh), _build.stream(q))
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---- K2: prefill attention, causal with a pad-key mask ---------------------

def prefill_attention_plain(q, k, v, length: int) -> torch.Tensor:
    """q: [P, H, Dh]; k, v: [P, KV, Dh]; key k visible to query q when
    k <= q and k < length -> o [P, H, Dh]."""
    P, H, Dh = q.shape
    KV = k.shape[1]
    kr, vr = _repeat_kv(k, H // KV, 1), _repeat_kv(v, H // KV, 1)
    logits = torch.einsum("qhd,khd->hqk", q.float(), kr.float()) \
        * softmax_scale(Dh)
    span = torch.arange(P, device=q.device)
    mask = (span[:, None] >= span[None, :]) & (span[None, :] < length)
    logits = torch.where(mask[None], logits,
                         torch.tensor(_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs.float(),
                        vr.float()).to(q.dtype)


def prefill_attention(q, k, v, length: int) -> torch.Tensor:
    """Causal prefill attention of one sequence with keys at or past
    ``length`` masked. On a CUDA tensor launches
    csrc/prefill_attention.cu (K2)."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    P, H, Dh = q.shape
    KV = k.shape[1]
    if (k.shape != (P, KV, Dh) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype or H % KV
            or not 1 <= length <= P):
        raise ValueError("prefill_attention: q [P, H, Dh], k/v [P, KV, Dh] "
                         "of one dtype, 1 <= length <= P")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    rc = _build.lib().brpc_prefill_attention(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        out.data_ptr(), P, int(length), H, KV, Dh, softmax_scale(Dh),
        _build.stream(q))
    _build.check(rc, "prefill_attention")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0


# ---- K4: suffix-prefill attention over the paged pool ----------------------

# From csrc/attention_tile.cuh: a block holds TILE_ROWS (query, head) rows
# of one KV head, a split covers whole tiles of TILE_KEYS keys, and an SM
# holds BLOCKS_PER_SM blocks of the bf16 core at once, so the planner aims
# the grid at that many blocks per SM.
_TILE = _build.header_constants("attention_tile.cuh")
TILE_ROWS = _TILE["kTileRows"]
TILE_KEYS = _TILE["kTileKeys"]
BLOCKS_PER_SM = _TILE["kMmaMinBlocks"]
# A split holds at least this many key tiles: fewer would spend more on the
# partial's write and the merge than the split saves.
MIN_SPLIT_TILES = 2


def plan_splits(n_q: int, n_heads: int, n_kv_heads: int, start: int,
                sms: int) -> tuple:
    """K4's split-K plan -> (tiles_per_split, n_splits). The grid has
    ceil(n_q * H / KV / 64) query tiles per KV head; where that leaves the
    card's ``sms`` SMs short of ``BLOCKS_PER_SM`` blocks each, the key
    range [0, start + n_q) is cut at 64-key tile boundaries into that many
    more splits of equal tile counts, each of at least
    ``MIN_SPLIT_TILES`` tiles. Derived from the shape and the SM count
    only."""
    q_tiles = -(-(n_q * (n_heads // n_kv_heads)) // TILE_ROWS)
    blocks = q_tiles * n_kv_heads
    tiles = -(-(start + n_q) // TILE_KEYS)
    want = -(-(BLOCKS_PER_SM * sms) // blocks)
    per = max(MIN_SPLIT_TILES, -(-tiles // want))
    return per, -(-tiles // per)


def split_ranges(start: int, n_q: int, tiles_per_split: int,
                 n_splits: int) -> list:
    """The key ranges [lo, hi) of a plan's splits."""
    end, w = start + n_q, tiles_per_split * TILE_KEYS
    return [(s * w, min((s + 1) * w, end)) for s in range(n_splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _gather_pages(pool, table, layer: int, npages: int) -> torch.Tensor:
    page, KV, Dh = pool.shape[2:]
    idx = table[:npages].long()
    return pool[:, layer][idx].reshape(npages * page, KV, Dh)


def paged_prefill_attention_plain(q, k_pool, v_pool, table, start: int,
                                  layer: int) -> torch.Tensor:
    """q: [n, H, Dh] at positions start .. start + n - 1; k_pool/v_pool:
    [NB, L, page, KV, Dh]; table: [pages] int32 covering positions
    [0, start + n) -> o [n, H, Dh]. Gathers the table's pages into a dense
    view and masks keys past each query's position (the reference's
    prefix view, cut to the pages in play)."""
    n, H, Dh = q.shape
    page, KV = k_pool.shape[2], k_pool.shape[3]
    npages = -(-(start + n) // page)
    kg = _gather_pages(k_pool, table, layer, npages)
    vg = _gather_pages(v_pool, table, layer, npages)
    kr, vr = _repeat_kv(kg, H // KV, 1), _repeat_kv(vg, H // KV, 1)
    logits = torch.einsum("qhd,khd->hqk", q.float(), kr.float()) \
        * softmax_scale(Dh)
    span = torch.arange(npages * page, device=q.device)
    qpos = start + torch.arange(n, device=q.device)
    mask = span[None, :] <= qpos[:, None]
    logits = torch.where(mask[None], logits,
                         torch.tensor(_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs.float(),
                        vr.float()).to(q.dtype)


def paged_prefill_split_partials(q, k_pool, v_pool, table, start: int,
                                 layer: int, tiles_per_split: int,
                                 n_splits: int) -> tuple:
    """The plain model of K4's split pass: per split s, over the keys of
    its range a row may see, the row max m[s] of the scaled f32 logits,
    the sum l[s] of exp(logit - m[s]), and the unnormalised partial
    o[s] = round(exp(logit - m[s])) . V in f32. A row that sees no key of
    a split has m = -inf, l = 0, o = 0. Returns (o [S, n, H, Dh],
    m [S, n, H], l [S, n, H]), all f32. For the tests: the main path never
    calls it."""
    n, H, Dh = q.shape
    page, KV = k_pool.shape[2], k_pool.shape[3]
    end = start + n
    kg = _gather_pages(k_pool, table, layer, -(-end // page))[:end]
    vg = _gather_pages(v_pool, table, layer, -(-end // page))[:end]
    kr, vr = _repeat_kv(kg, H // KV, 1), _repeat_kv(vg, H // KV, 1)
    logits = torch.einsum("qhd,khd->qhk", q.float(), kr.float()) \
        * softmax_scale(Dh)
    keys = torch.arange(end, device=q.device)
    qpos = start + torch.arange(n, device=q.device)
    o, m, l = [], [], []
    for lo, hi in split_ranges(start, n, tiles_per_split, n_splits):
        seen = (keys[None, :] <= qpos[:, None]) & (keys >= lo)[None, :] \
            & (keys < hi)[None, :]
        x = torch.where(seen[:, None, :], logits,
                        torch.tensor(-float("inf"), device=q.device))
        ms = x.max(dim=-1).values
        p = torch.exp(x - torch.where(torch.isinf(ms), 0.0, ms)[..., None])
        o.append(torch.einsum("qhk,khd->qhd", p.to(q.dtype).float(),
                              vr.float()))
        m.append(ms)
        l.append(p.sum(dim=-1))
    return torch.stack(o), torch.stack(m), torch.stack(l)


def merge_splits_plain(o, m, l) -> torch.Tensor:
    """The plain model of K4's merge pass: sum_s w_s o[s] / sum_s w_s l[s]
    with w_s = exp(m[s] - max_s m[s]), 0 where m[s] = -inf. f32."""
    w = torch.where(torch.isinf(m), 0.0, torch.exp(m - m.max(dim=0).values))
    return (w[..., None] * o).sum(dim=0) / (w * l).sum(dim=0)[..., None]


def paged_prefill_attention_split_plain(q, k_pool, v_pool, table,
                                        start: int, layer: int,
                                        sms: int) -> torch.Tensor:
    """K4's split-K arithmetic in plain PyTorch: the split pass of the plan
    for ``sms`` SMs, then the merge, rounded to q's dtype. For the tests;
    the main path never calls it."""
    n, H, _ = q.shape
    per, n_splits = plan_splits(n, H, k_pool.shape[3], start, sms)
    o, m, l = paged_prefill_split_partials(q, k_pool, v_pool, table, start,
                                           layer, per, n_splits)
    return merge_splits_plain(o, m, l).to(q.dtype)


def max_row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest relative error of one output row (a (query, head)
    vector over the last dim): max over rows of |got - want| / |want| in
    the 2-norm, in f32. Unlike an elementwise atol it scales with each
    row, so it sees one 64-key tile missing from a 4000-key row, whose
    outputs are about as small as bf16's atol. For the tests and the
    on-card smoke; the main path never calls it."""
    g, w = got.float(), want.float()
    num = (g - w).norm(dim=-1)
    return float((num / w.norm(dim=-1).clamp_min(1e-30)).max())


def paged_prefill_attention(q, k_pool, v_pool, table, start: int,
                            layer: int) -> torch.Tensor:
    """Attention of the suffix rows at positions ``start + i`` over every
    key at or before their position, read through ``table`` from layer
    ``layer`` of the paged pool (the cached prefix plus the suffix rows
    already written). On a CUDA tensor launches
    csrc/paged_prefill_attention.cu (K4): one call runs the split pass of
    ``plan_splits`` for the card's SM count and, with more than one
    split, the merge pass, and returns the first launch error."""
    if q.device.type == "cpu":
        return paged_prefill_attention_plain(q, k_pool, v_pool, table, start,
                                             layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: unsupported device "
                         f"{q.device}")
    n, H, Dh = q.shape
    NB, L, page, KV, Dh2 = k_pool.shape
    if (Dh2 != Dh or v_pool.shape != k_pool.shape
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or not (k_pool.is_contiguous() and v_pool.is_contiguous())):
        raise ValueError("paged_prefill_attention: pools must be contiguous "
                         "[NB, L, page, KV, Dh] in q's dtype")
    if (table.dtype != torch.int32 or table.dim() != 1
            or table.device != q.device
            or table.shape[0] * page < start + n):
        raise ValueError("paged_prefill_attention: table must be int32 [pages]"
                         " on q's device, covering start + n positions")
    if not 0 <= layer < L or H % KV or start < 0 or n < 1:
        raise ValueError("paged_prefill_attention: bad layer, head counts, "
                         "start or query count")
    qc, tc = q.contiguous(), table.contiguous()
    out = torch.empty_like(qc)
    per, n_splits = plan_splits(n, H, KV, int(start), _sm_count(q.device))
    # Split scratch, one allocation: partial O [S, n * H, Dh], then (m, l)
    # [S, n * H, 2], f32.
    o_part = ml_part = None
    if n_splits > 1:
        scratch = torch.empty(n_splits * n * H * (Dh + 2),
                              dtype=torch.float32, device=q.device)
        o_part = scratch.data_ptr()
        ml_part = o_part + n_splits * n * H * Dh * 4
    layer_off = layer * k_pool.stride(1) * k_pool.element_size()
    rc = _build.lib().brpc_paged_prefill_attention(
        _dtype_code(q), qc.data_ptr(), k_pool.data_ptr() + layer_off,
        v_pool.data_ptr() + layer_off, tc.data_ptr(), out.data_ptr(), o_part,
        ml_part, n, int(start), H, KV, Dh, page, k_pool.stride(0),
        k_pool.stride(2), k_pool.stride(3), softmax_scale(Dh), per, n_splits,
        _build.stream(q))
    _build.check(rc, "paged_prefill_attention")
    paged_prefill_attention.launches += 1
    return out


paged_prefill_attention.launches = 0
