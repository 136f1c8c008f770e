"""Attention of the serving path: the K1 (paged decode), K2 (prefill) and
K4 (paged suffix prefill) kernels' wrappers, each with its plain PyTorch
version; the training path's causal attention over a batch (K2 with its
log-sum-exp, and K2b, its backward) as an autograd function; the split-K
planners of K4 and K1 with plain models of their split and merge passes,
and a per-row error measure (for the tests).

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


# ---- split-K plans of K1 and K4 --------------------------------------------

# From csrc/attention_tile.cuh: a block of the tile core holds TILE_ROWS
# (query, head) rows of one KV head, a split covers whole tiles of
# TILE_KEYS keys, and an SM holds BLOCKS_PER_SM blocks of the bf16 core at
# once, so the bf16 planner aims the grid at that many blocks per SM.
_TILE = _build.header_constants("attention_tile.cuh")
TILE_ROWS = _TILE["kTileRows"]
TILE_KEYS = _TILE["kTileKeys"]
BLOCKS_PER_SM = _TILE["kMmaMinBlocks"]
# From csrc/attention_f32.cuh: a block of the f32 forward core (K4's f32
# route) holds F32_FWD_ROWS rows, and one such block fills an SM. Its key
# tiles are TILE_KEYS wide too (K4 asserts it), so both plans cut alike.
_F32 = _build.header_constants("attention_f32.cuh")
F32_FWD_ROWS = _F32["kF32FwdRows"]
# K1's f32 route runs that core in a layout of F32_DECODE_ROWS rows (up to
# that many of a lane's H / KV query heads), F32_DECODE_BLOCKS blocks an
# SM, over splits of F32_DECODE_SPLIT_TILES tiles.
F32_DECODE_ROWS = _F32["kF32DecodeRows"]
F32_DECODE_BLOCKS = _F32["kF32DecodeBlocks"]
F32_DECODE_SPLIT_TILES = _F32["kF32DecodeSplitTiles"]
# A split holds at least this many key tiles: fewer would spend more on the
# partial's write and the merge than the split saves.
MIN_SPLIT_TILES = 2


def _plan(blocks: int, keys: int, sms: int) -> tuple:
    """Split-K plan of a grid of ``blocks`` blocks per split over the key
    range [0, keys) -> (tiles_per_split, n_splits): where the blocks leave
    the card's ``sms`` SMs short of ``BLOCKS_PER_SM`` blocks each, the range
    is cut at 64-key tile boundaries into that many more splits of equal
    tile counts, each of at least ``MIN_SPLIT_TILES`` tiles."""
    tiles = -(-keys // TILE_KEYS)
    want = -(-(BLOCKS_PER_SM * sms) // blocks)
    per = max(MIN_SPLIT_TILES, -(-tiles // want))
    return per, -(-tiles // per)


@functools.lru_cache(maxsize=4096)
def _plan_one_wave(blocks: int, keys: int, sms: int) -> tuple:
    """The f32 core's split-K plan of a grid of ``blocks`` blocks per
    split over the key range [0, keys) -> (tiles_per_split, n_splits):
    among the cuts into splits of at least ``MIN_SPLIT_TILES`` tiles (or
    one split), the one of least cost, the waves of one block per SM
    times the tiles a block walks; ties go to fewer splits."""
    tiles = -(-keys // TILE_KEYS)
    best = None
    for per in range(tiles, 0, -1):  # splits only grow
        n = -(-tiles // per)
        if n > 1 and per < MIN_SPLIT_TILES:
            break
        cost = -(-(blocks * n) // sms) * per
        if best is None or cost < best[0]:
            best = (cost, per, n)
    return best[1], best[2]


def plan_splits(n_q: int, n_heads: int, n_kv_heads: int, start: int,
                sms: int, dtype: torch.dtype = torch.bfloat16) -> tuple:
    """K4's split-K plan for the core of ``dtype`` -> (tiles_per_split,
    n_splits) over the keys [0, start + n_q), from the shape and the SM
    count only. bf16 (the tile core): ceil(n_q * H / KV / TILE_ROWS) query
    tiles per KV head, the grid aimed at ``BLOCKS_PER_SM`` blocks per SM.
    f32 (the SIMT forward core, one block per SM): F32_FWD_ROWS-row query
    tiles, the cut of least waves x tiles per split, so that a short grid
    runs in as few waves of as short splits as it can."""
    rows = n_q * (n_heads // n_kv_heads)
    if dtype == torch.float32:
        return _plan_one_wave(-(-rows // F32_FWD_ROWS) * n_kv_heads,
                              start + n_q, sms)
    return _plan(-(-rows // TILE_ROWS) * n_kv_heads, start + n_q, sms)


def plan_decode_splits(n_lanes: int, n_kv_heads: int, max_keys: int,
                       sms: int, dtype: torch.dtype = torch.bfloat16
                       ) -> tuple:
    """K1's split-K plan for the core of ``dtype`` -> (tiles_per_split,
    n_splits): one item per (lane, KV head, split), whose rows are the
    lane's H / KV query heads, over the keys [0, max_keys), the bound the
    block table's width gives (pages x page size). From host integers
    only: the lanes' positions stay on the device, and a split past a
    lane's position is empty for it.

    bf16 (the tile core, one block per item): the grid aimed at
    ``BLOCKS_PER_SM`` blocks per SM. f32 (the SIMT forward core, a
    persistent grid of ``decode_grid`` blocks that run only the items
    holding a key, ``decode_schedule``): splits of
    ``F32_DECODE_SPLIT_TILES`` tiles, so that a long lane spreads over
    many SMs, or one split, and no merge, where the lanes' KV heads alone
    give every block slot (``F32_DECODE_BLOCKS`` an SM) an item. The split
    size is the fastest of 1, 2 and 4 tiles at phase 3's first two K1
    cases (``tools/torch_f32_sweep.py --decode . D1x16x2 D4x16x2``,
    PERF.md section 6)."""
    if dtype == torch.float32:
        tiles = -(-max_keys // TILE_KEYS)
        if (n_lanes * n_kv_heads >= F32_DECODE_BLOCKS * sms
                or tiles <= F32_DECODE_SPLIT_TILES):
            return tiles, 1
        return F32_DECODE_SPLIT_TILES, -(-tiles // F32_DECODE_SPLIT_TILES)
    return _plan(n_lanes * n_kv_heads, max_keys, sms)


def decode_grid(n_lanes: int, n_heads: int, n_kv_heads: int,
                n_splits: int, sms: int) -> int:
    """Blocks of K1's f32 launch: one per item (lane, KV head, chunk of up
    to F32_DECODE_ROWS of its query heads, split), at most
    F32_DECODE_BLOCKS per SM (the kernel derives the same from the card's
    SM count)."""
    chunks = -(-(n_heads // n_kv_heads) // F32_DECODE_ROWS)
    return min(n_lanes * n_kv_heads * chunks * n_splits,
               F32_DECODE_BLOCKS * sms)


def decode_live_splits(pos: int, max_keys: int, tiles_per_split: int) -> int:
    """The splits of K1's plan that hold a key of a lane at ``pos``: its
    keys [0, pos + 1), clipped at the table's ``max_keys``."""
    keys = min(max(pos + 1, 0), max_keys)
    return -(-keys // (tiles_per_split * TILE_KEYS))


def decode_schedule(pos, n_heads: int, n_kv_heads: int,
                    tiles_per_split: int, n_splits: int, max_keys: int,
                    sms: int) -> list:
    """The items (lane, KV head, chunk, split) that each block of K1's f32
    launch runs, in order, for lanes at ``pos``: every block forms the
    lane-major sequence (lane, split, KV head, chunk) of the items that
    hold a key (``decode_live_splits`` of each lane) and block b runs items
    b, b + grid, ... of it. Items past a lane's pos are in no block's list,
    and the merge reads only the live splits."""
    grid = decode_grid(len(pos), n_heads, n_kv_heads, n_splits, sms)
    chunks = -(-(n_heads // n_kv_heads) // F32_DECODE_ROWS)
    live = [(lane, kvh, chunk, split) for lane, p in enumerate(pos)
            for split in range(decode_live_splits(int(p), max_keys,
                                                  tiles_per_split))
            for kvh in range(n_kv_heads) for chunk in range(chunks)]
    return [live[b::grid] for b in range(grid)]


def split_ranges(start: int, n_q: int, tiles_per_split: int,
                 n_splits: int) -> list:
    """The key ranges [lo, hi) of a plan's splits."""
    end, w = start + n_q, tiles_per_split * TILE_KEYS
    return [(s * w, min((s + 1) * w, end)) for s in range(n_splits)]


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def paged_decode_split_partials(q, k_pool, v_pool, tables, pos,
                                layer: int, tiles_per_split: int,
                                n_splits: int) -> tuple:
    """The plain model of K1's split pass: lane s is K4's split pass
    (``paged_prefill_split_partials``) with start = pos[s], one query and
    table tables[s]; a split past pos[s] gives m = -inf, l = 0, o = 0.
    Returns (o [n_splits, S, H, Dh], m [n_splits, S, H], l [n_splits, S,
    H]), f32. For the tests: the main path never calls it."""
    parts = [paged_prefill_split_partials(
        q[s:s + 1], k_pool, v_pool, tables[s], int(pos[s]), layer,
        tiles_per_split, n_splits) for s in range(q.shape[0])]
    return tuple(torch.cat([p[i] for p in parts], dim=1) for i in range(3))


def paged_decode_attention_split_plain(q, k_pool, v_pool, tables, pos,
                                       layer: int, sms: int,
                                       dtype: torch.dtype = torch.bfloat16
                                       ) -> torch.Tensor:
    """K1's split-K arithmetic in plain PyTorch: the split pass of the plan
    ``plan_decode_splits`` makes for the table's width, ``sms`` SMs and
    the core of ``dtype``, then the merge, rounded to q's dtype. For the
    tests; the main path never calls it."""
    S, H, _ = q.shape
    page, KV = k_pool.shape[2], k_pool.shape[3]
    per, n_splits = plan_decode_splits(S, KV, tables.shape[1] * page, sms,
                                       dtype)
    o, m, l = paged_decode_split_partials(q, k_pool, v_pool, tables, pos,
                                          layer, per, n_splits)
    return merge_splits_plain(o, m, l).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, pos,
                           layer: int) -> torch.Tensor:
    """Decode attention of one token per lane at position ``pos[lane]``
    over layer ``layer`` of the paged pool, read through ``tables``
    ([S, pages] int32; every pos[s] < pages * page). On a CUDA tensor
    launches csrc/paged_decode_attention.cu (K1): one call runs the split
    pass of ``plan_decode_splits`` (from the table's width, the card's SM
    count and q's dtype: bf16 on the tile core, f32 on the SIMT forward
    core's persistent grid; pos stays on the device) and, with more than
    one split, the merge pass, and returns the first launch error."""
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
            or tables.dim() != 2 or tables.shape[0] != S
            or pos.shape != (S,) or tables.device != q.device
            or pos.device != q.device):
        raise ValueError("paged_decode_attention: tables [S, pages] and pos "
                         "[S] must be int32 on q's device")
    if not 0 <= layer < L or H % KV or H // KV > TILE_ROWS:
        raise ValueError("paged_decode_attention: bad layer or head counts")
    qc, tc, pc = q.contiguous(), tables.contiguous(), pos.contiguous()
    width = tc.shape[1]
    per, n_splits = plan_decode_splits(S, KV, width * page,
                                       _sm_count(q.device), q.dtype)
    # One allocation: the output, then with splits the f32 scratch, partial
    # O [n_splits, S * H, Dh] and (m, l) [n_splits, S * H, 2].
    rows = S * H
    o_part = ml_part = None
    if n_splits == 1:
        out = torch.empty_like(qc)
    else:
        out_f32 = rows * Dh * q.element_size() // 4
        buf = torch.empty(out_f32 + n_splits * rows * (Dh + 2),
                          dtype=torch.float32, device=q.device)
        out = buf[:out_f32].view(q.dtype).view(S, H, Dh)
        o_part = buf.data_ptr() + out_f32 * 4
        ml_part = o_part + n_splits * rows * Dh * 4
    layer_off = layer * k_pool.stride(1) * k_pool.element_size()
    rc = _build.lib().brpc_paged_decode_attention(
        _dtype_code(q), qc.data_ptr(), k_pool.data_ptr() + layer_off,
        v_pool.data_ptr() + layer_off, tc.data_ptr(), pc.data_ptr(),
        out.data_ptr(), o_part, ml_part, S, H, KV, Dh, page, width,
        k_pool.stride(0), k_pool.stride(2), k_pool.stride(3),
        softmax_scale(Dh), per, n_splits, _build.stream(q))
    _build.check(rc, "paged_decode_attention")
    _build.count_launch(paged_decode_attention)
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
    return _k2(q[None], k[None], v[None], int(length), None)[0]


def _k2(q, k, v, length: int, lse) -> torch.Tensor:
    """Launches K2 over a batch: q [B, S, H, Dh], k/v [B, S, KV, Dh], keys
    at or past ``length`` masked; with ``lse`` (f32 [B, S, H]) its epilogue
    writes each row's log-sum-exp there. -> o [B, S, H, Dh]."""
    B, S, H, Dh = q.shape
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    rc = _build.lib().brpc_prefill_attention(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        out.data_ptr(), None if lse is None else lse.data_ptr(), B, S,
        length, H, k.shape[2], Dh, softmax_scale(Dh), _build.stream(q))
    _build.check(rc, "prefill_attention")
    _build.count_launch(prefill_attention)
    return out


prefill_attention.launches = 0


# ---- K2 and K2b for training: causal attention over a batch -----------------

HEAD_DIMS = (32, 64, 128)


def _check_causal_shapes(name, q, k, v):
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    if (k.shape != (B, S, KV, Dh) or v.shape != k.shape or H % KV
            or k.dtype != q.dtype or v.dtype != q.dtype
            or k.device != q.device or v.device != q.device):
        raise ValueError(f"{name}: q [B, S, H, Dh], k/v [B, S, KV, Dh] of "
                         f"one dtype on one device, KV dividing H")
    if q.device.type == "cuda" and Dh not in HEAD_DIMS:
        raise ValueError(f"{name}: Dh must be one of {HEAD_DIMS} on a card")


def causal_attention_plain(q, k, v) -> tuple:
    """brpc_tpu/models/transformer.py:123 ``_attention`` in plain torch,
    with the rows' log-sum-exp beside it. q: [B, S, H, Dh]; k, v: [B, S,
    KV, Dh] -> (o [B, S, H, Dh] in q's dtype, lse [B, S, H] f32): f32
    logits times 1/sqrt(Dh), -1e30 above the diagonal, f32 softmax, the
    probabilities cast to q's dtype, P.V accumulated in f32; lse =
    log sum_k exp(logit) in natural units."""
    B, S, H, Dh = q.shape
    rep = H // k.shape[2]
    kr, vr = _repeat_kv(k, rep, 2), _repeat_kv(v, rep, 2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) \
        * softmax_scale(Dh)
    span = torch.arange(S, device=q.device)
    mask = span[:, None] >= span[None, :]
    logits = torch.where(mask[None, None], logits,
                         torch.tensor(_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(),
                     vr.float()).to(q.dtype)
    return o, torch.logsumexp(logits, dim=-1).transpose(1, 2).contiguous()


def prefill_attention_backward_plain(q, k, v, o, lse, do) -> tuple:
    """The backward of ``causal_attention_plain`` from its saved LSE
    (FlashAttention-2's, what K2b computes): P = exp(logit - lse) below the
    diagonal, delta = rowsum(dO o), dS = P (dO.V - delta); dq = scale dS.K,
    dk = scale dS^T.Q and dv = round(P)^T.dO (P rounded to q's dtype, as
    the forward's P.V takes it), dk and dv summed over each KV head's
    H / KV query heads. All sums in f32; -> (dq, dk, dv) in q's dtype."""
    B, S, H, Dh = q.shape
    KV = k.shape[2]
    rep = H // KV
    scale = softmax_scale(Dh)
    kr, vr = _repeat_kv(k, rep, 2).float(), _repeat_kv(v, rep, 2).float()
    qf, dof = q.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bhqk", qf, kr) * scale
    span = torch.arange(S, device=q.device)
    mask = (span[:, None] >= span[None, :])[None, None]
    p = torch.where(mask, torch.exp(logits - lse.transpose(1, 2)[..., None]),
                    0.0)
    delta = (dof * o.float()).sum(-1).transpose(1, 2)        # [B, H, S]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vr)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kr) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(q.dtype).float(), dof)
    dk = dk.reshape(B, S, KV, rep, Dh).sum(3)
    dv = dv.reshape(B, S, KV, rep, Dh).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# From csrc/attention_backward.cuh: a block of the bf16 backward core owns
# BWD_OWN_ROWS rows (keys in the dK/dV pass, queries in the dQ pass), each
# consumer warpgroup BWD_WG_ROWS of them, and column tiles of BWD_COLS
# rows stream past them through BWD_STAGES stages.
_BWD = _build.header_constants("attention_backward.cuh")
BWD_OWN_ROWS = _BWD["kBwdOwnRows"]
BWD_WG_ROWS = _BWD["kBwdWgRows"]
BWD_COLS = _BWD["kBwdCols"]
BWD_STAGES = _BWD["kBwdStages"]
# From csrc/attention_f32.cuh: a block of the f32 backward core owns
# F32_BWD_OWN_ROWS rows and walks column tiles of F32_BWD_COLS as one.
F32_BWD_OWN_ROWS = _F32["kF32BwdOwnRows"]
F32_BWD_COLS = _F32["kF32BwdCols"]
# (own rows of a block, rows that skip a tile together, rows of a column
# tile).
BWD_TILES = (BWD_OWN_ROWS, BWD_WG_ROWS, BWD_COLS)
F32_BWD_TILES = (F32_BWD_OWN_ROWS, F32_BWD_OWN_ROWS, F32_BWD_COLS)


def backward_tile_plan(sq: int, sk: int, n_heads: int, n_kv_heads: int,
                       diag: int, causal: bool,
                       tiles: tuple = BWD_TILES) -> dict:
    """The (own tile, column tile) pairs that each pass of the backward
    core (K2b, K5b) computes, as its blocks walk them: {"kv": [...], "q":
    [...]}, each pair (own head, column head, own rows [lo, hi), columns
    [c0, c1), crosses) for every batch entry alike. Key j is visible to
    query i when j <= diag + i (or always without ``causal``). ``tiles`` =
    (own, group, cols): BWD_TILES for the bf16 core, F32_BWD_TILES for the
    f32 one. A dK/dV block owns ``own`` keys of one KV head and walks, for
    each of its query heads, ``cols``-query tiles from max(0, first key -
    diag); a dQ block owns ``own`` queries and walks key tiles from 0 up to
    its causal edge. Each group of ``group`` rows (a warpgroup of the bf16
    core, the whole block of the f32 core) skips the tiles in which its
    rows see no key; ``crosses`` marks the tiles on which it applies the
    causal test. Columns past the array's end arrive as zeros and are left
    out of [c0, c1)."""
    own, group, cols = tiles
    rep = n_heads // n_kv_heads
    plan = {"kv": [], "q": []}
    for kv in (True, False):
        own_n, own_heads = (sk, n_kv_heads) if kv else (sq, n_heads)
        for head in range(own_heads):
            for own0 in range(0, own_n, own):
                if kv:
                    col_heads = range(head * rep, (head + 1) * rep)
                    end = sq
                    begin = max(0, own0 - diag) if causal else 0
                else:
                    col_heads = (head // rep,)
                    end = (max(0, min(sk, diag + own0 + own))
                           if causal else sk)
                    begin = 0
                for ch in col_heads:
                    for c0 in range(min(begin, end), end, cols):
                        c1 = min(c0 + cols, end)
                        for lo in range(own0, min(own0 + own, own_n),
                                        group):
                            hi = min(lo + group, own_n)
                            if kv:
                                seen = not causal or lo <= diag + c1 - 1
                                cross = causal and (
                                    lo + group - 1 > diag + c0)
                            else:
                                seen = not causal or c0 <= diag + hi - 1
                                cross = causal and (
                                    c0 + cols - 1 > diag + lo)
                            if seen:
                                plan["kv" if kv else "q"].append(
                                    (head, ch, lo, hi, c0, c1, cross))
    return plan


def attention_backward_tiles_plain(q, k, v, o, lse, do, diag: int = 0,
                                   causal: bool = True,
                                   tiles: tuple = BWD_TILES) -> tuple:
    """The backward of causal (or, for a ring block, offset) attention
    computed tile by tile along ``backward_tile_plan`` with ``tiles``, as
    the core with those tiles computes its two passes: P = exp(logit - lse)
    and dS = P (dO.V - delta) per tile, the causal test only on tiles that
    cross the diagonal, dv += round(P)^T.dO, dk += scale dS^T.Q (dK/dV
    pass) and dq += scale dS.K (dQ pass). q, o, do: [B, sq, H, Dh]; k, v:
    [B, sk, KV, Dh]; lse [B, sq, H] f32 -> (dq, dk, dv) in f32. For the
    tests: the main path never calls it."""
    B, sq, H, Dh = q.shape
    sk, KV = k.shape[1], k.shape[2]
    scale = softmax_scale(Dh)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)                        # [B, sq, H]
    dq = torch.zeros(qf.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    plan = backward_tile_plan(sq, sk, H, KV, diag, causal, tiles)

    def tile(xo, yo, xc, yc, l, dl, cross, keys, queries):
        s = torch.einsum("brd,bcd->brc", xo, xc) * scale
        p = torch.exp(s - l)
        if cross:
            p = torch.where(keys <= diag + queries, p, 0.0)
        ds = p * (torch.einsum("brd,bcd->brc", yo, yc) - dl)
        return p, ds

    rows = torch.arange(max(sq, sk), device=q.device)
    for kvh, h, lo, hi, c0, c1, cross in plan["kv"]:
        p, ds = tile(kf[:, lo:hi, kvh], vf[:, lo:hi, kvh], qf[:, c0:c1, h],
                     dof[:, c0:c1, h], lse[:, None, c0:c1, h],
                     delta[:, None, c0:c1, h], cross, rows[lo:hi, None],
                     rows[None, c0:c1])
        dv[:, lo:hi, kvh] += torch.einsum(
            "brc,bcd->brd", p.to(q.dtype).float(), dof[:, c0:c1, h])
        dk[:, lo:hi, kvh] += torch.einsum(
            "brc,bcd->brd", ds, qf[:, c0:c1, h]) * scale
    for h, kvh, lo, hi, c0, c1, cross in plan["q"]:
        _, ds = tile(qf[:, lo:hi, h], dof[:, lo:hi, h], kf[:, c0:c1, kvh],
                     vf[:, c0:c1, kvh], lse[:, lo:hi, h, None],
                     delta[:, lo:hi, h, None], cross, rows[None, c0:c1],
                     rows[lo:hi, None])
        dq[:, lo:hi, h] += torch.einsum(
            "brc,bcd->brd", ds, kf[:, c0:c1, kvh]) * scale
    return dq, dk, dv


def causal_attention_forward(q, k, v) -> tuple:
    """The training forward of causal attention -> (o, lse), as
    ``causal_attention_plain`` gives them. On a CUDA tensor launches K2
    (csrc/prefill_attention.cu) over the batch with its LSE epilogue
    (counted on ``prefill_attention``)."""
    _check_causal_shapes("causal_attention", q, k, v)
    if q.device.type == "cpu":
        return causal_attention_plain(q, k, v)
    if q.device.type != "cuda":
        raise ValueError(f"causal_attention: unsupported device {q.device}")
    B, S, H, Dh = q.shape
    lse = torch.empty((B, S, H), dtype=torch.float32, device=q.device)
    return _k2(q, k, v, S, lse), lse


def attention_backward(q, k, v, o, lse, do) -> tuple:
    """dq, dk, dv of causal attention from the forward's o and LSE and the
    output's gradient do. On a CUDA tensor launches csrc/attention_backward.cu
    (K2b: the delta pre-pass, the dK/dV pass and the dQ pass in one call);
    on a CPU tensor runs ``prefill_attention_backward_plain``."""
    _check_causal_shapes("attention_backward", q, k, v)
    B, S, H, Dh = q.shape
    if (o.shape != q.shape or do.shape != q.shape or lse.shape != (B, S, H)
            or o.dtype != q.dtype or do.dtype != q.dtype
            or lse.dtype != torch.float32):
        raise ValueError("attention_backward: o and do [B, S, H, Dh] in q's "
                         "dtype, lse [B, S, H] f32")
    if q.device.type == "cpu":
        return prefill_attention_backward_plain(q, k, v, o, lse, do)
    if q.device.type != "cuda":
        raise ValueError(f"attention_backward: unsupported device {q.device}")
    qc, kc, vc, oc, doc = (t.contiguous() for t in (q, k, v, o, do))
    lc = lse.contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (qc, kc, vc))
    delta = torch.empty_like(lc)
    rc = _build.lib().brpc_attention_backward(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        oc.data_ptr(), doc.data_ptr(), lc.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, S, H, k.shape[2], Dh,
        softmax_scale(Dh), _build.stream(q))
    _build.check(rc, "attention_backward")
    _build.count_launch(attention_backward)
    return dq, dk, dv


attention_backward.launches = 0


class _CausalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v):
        o, lse = causal_attention_forward(q, k, v)
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        return attention_backward(*ctx.saved_tensors, do.contiguous())


def causal_attention(q, k, v) -> torch.Tensor:
    """Differentiable causal attention of the training forward. q: [B, S,
    H, Dh]; k, v: [B, S, KV, Dh] -> o [B, S, H, Dh] in q's dtype. A CPU
    tensor runs the plain forward and the plain backward; a CUDA tensor
    runs K2 with its LSE, and K2b for the gradient."""
    return _CausalAttention.apply(q, k, v)


# ---- K4: suffix-prefill attention over the paged pool ----------------------

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
    for ``sms`` SMs and q's dtype (as the wrapper plans), then the merge,
    rounded to q's dtype. For the tests; the main path never calls it."""
    n, H, _ = q.shape
    per, n_splits = plan_splits(n, H, k_pool.shape[3], start, sms, q.dtype)
    o, m, l = paged_prefill_split_partials(q, k_pool, v_pool, table, start,
                                           layer, per, n_splits)
    return merge_splits_plain(o, m, l).to(q.dtype)


# Gradient rows are held relative to at least this share of the tensor's
# largest row (``max_row_rel_err``'s ``floor``): a causal first query's dq
# is exactly 0 in exact arithmetic and holds only rounding noise.
GRAD_ROW_FLOOR = 1e-2
# The bf16 ring's gradient against dense attention's f32 autograd: in bf16
# the backward takes delta = rowsum(dO o) from the bf16-rounded output and
# rounds P and dS to bf16 as tensor-core operands, and where a row's
# dP - delta nearly cancels its relative error has no useful bound (one
# row at 0.30 at S 8192, NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py). So
# the bf16 ring is held row by row to the same backward over one dense
# block on its own output, and each gradient tensor to dense autograd in
# the relative 2-norm within this. Both for the tests and the on-card
# smoke; the main path reads neither.
RING_BF16_GRAD_TOL = 1e-2


def max_row_rel_err(got: torch.Tensor, want: torch.Tensor,
                    floor: float = 0.0) -> float:
    """The largest relative error of one output row (a (query, head)
    vector over the last dim): max over rows of |got - want| / |want| in
    the 2-norm, in f32. Unlike an elementwise atol it scales with each
    row, so it sees one 64-key tile missing from a 4000-key row, whose
    outputs are about as small as bf16's atol. With ``floor`` a row is
    held relative to at least ``floor`` times the largest row of
    ``want``: for gradients, whose rows may be exactly 0 in exact
    arithmetic (a causal first query's dq: its softmax has one key) and
    hold only rounding noise. For the tests and the on-card smoke; the
    main path never calls it."""
    g, w = got.float(), want.float()
    num = (g - w).norm(dim=-1)
    den = w.norm(dim=-1)
    den = den.clamp_min(max(1e-30, floor * float(den.max())))
    return float((num / den).max())


def paged_prefill_attention(q, k_pool, v_pool, table, start: int,
                            layer: int) -> torch.Tensor:
    """Attention of the suffix rows at positions ``start + i`` over every
    key at or before their position, read through ``table`` from layer
    ``layer`` of the paged pool (the cached prefix plus the suffix rows
    already written). On a CUDA tensor launches
    csrc/paged_prefill_attention.cu (K4): one call runs the split pass of
    ``plan_splits`` for the card's SM count and q's dtype (bf16: the tile
    core on the tensor cores; f32: the SIMT forward core) and, with more
    than one split, the merge pass, and returns the first launch error."""
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
    per, n_splits = plan_splits(n, H, KV, int(start), _sm_count(q.device),
                                q.dtype)
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
    _build.count_launch(paged_prefill_attention)
    return out


paged_prefill_attention.launches = 0
