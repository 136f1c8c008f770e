"""K1's split-K and K3's fused residual add on the CPU: the decode planners
(bf16, and f32 with its persistent grid's item schedule) against their
contract, the plain model of K1's split and merge passes
(``paged_decode_attention_split_plain``: K4's split pass per lane with
start = pos, one query) against K1's plain version at either plan's cuts,
the fused norm's plain version, and the engine sending only the table
columns in play. The plain
versions are held against the JAX reference in tests/test_torch_ops.py;
the kernels against them on a card in tests/test_torch_kernels_card.py.
"""

import numpy as np
import pytest
import torch

from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.ops import attention, norm

SMS = 132  # the H100 SXM's SM count
HEADS = [(4, 4, 32), (8, 2, 64)]  # (H, KV, Dh): MHA and GQA 4:1
HEAD_IDS = ["mha", "gqa4"]
PAGE = 16

# An idle lane (pos 0 through garbage block 0), pos 15 (last row of a
# page), pos 16 (first row of a fresh page), the last key of split 0 and
# the first of split 1 (two 64-key tiles a split), and the longest lane;
# the shorter lanes see nothing of its later splits.
DECODE_POS = [0, 15, 16, 127, 128, 300]
IDLE = 0  # the lane whose table row is all garbage block 0


def _decode_inputs(H, KV, Dh, pos, width, seed, dtype=torch.float32,
                   idle=(IDLE,)):
    """Lanes at ``pos`` with their pages scattered over a 2-layer pool and
    a table of ``width`` columns (columns past a lane's pages, and every
    column of an idle lane, are garbage block 0)."""
    rng = np.random.default_rng(seed)
    S, L = len(pos), 2
    need = [0 if s in idle else p // PAGE + 1 for s, p in enumerate(pos)]
    nb = sum(need) + 1
    shape = (nb, L, PAGE, KV, Dh)
    k_pool = torch.from_numpy(rng.standard_normal(shape, np.float32))
    v_pool = torch.from_numpy(rng.standard_normal(shape, np.float32))
    order = rng.permutation(np.arange(1, nb)).astype(np.int32)
    tables = np.zeros((S, width), np.int32)
    used = 0
    for s, n in enumerate(need):
        tables[s, :n] = order[used:used + n]
        used += n
    q = torch.from_numpy(rng.standard_normal((S, H, Dh), np.float32))
    return (q.to(dtype), k_pool.to(dtype), v_pool.to(dtype),
            torch.from_numpy(tables), torch.tensor(pos, dtype=torch.int32))


@pytest.mark.parametrize("width", [19, 40], ids=["pages_in_play", "wide"])
@pytest.mark.parametrize("H,KV,Dh", HEADS, ids=HEAD_IDS)
def test_decode_split_model_matches_plain_f32(H, KV, Dh, width):
    """Per-lane partials over the plan of the table's width, merged, equal
    the one-pass plain version in f32 within 1e-6 (summation order only).
    The plan splits; a split wholly past a lane's pos has max -inf, sum 0
    and O 0 for every row of that lane, and no row is empty in every
    split."""
    q, k_pool, v_pool, tables, pos = _decode_inputs(H, KV, Dh, DECODE_POS,
                                                    width, H + width)
    per, n_splits = attention.plan_decode_splits(len(DECODE_POS), KV,
                                                 width * PAGE, SMS)
    assert per == attention.MIN_SPLIT_TILES and n_splits > 2
    o, m, l = attention.paged_decode_split_partials(
        q, k_pool, v_pool, tables, pos, 1, per, n_splits)
    empty = torch.isinf(m)
    w = per * attention.TILE_KEYS
    for s, p in enumerate(DECODE_POS):
        for k in range(n_splits):
            assert bool(empty[k, s].all()) == (k * w > p), (s, k)
    assert (m[empty] < 0).all() and (l[empty] == 0).all()
    assert (o[empty] == 0).all()
    assert not empty.all(dim=0).any()
    got = attention.paged_decode_attention_split_plain(
        q, k_pool, v_pool, tables, pos, 1, SMS)
    want = attention.paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                                  pos, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


# The card's bf16 bounds (tests/test_torch_kernels_card.py): elementwise
# atol 2e-2 + rtol 1e-2, and each (lane, head) row within 1e-2 of its norm.
ROW_TOL_BF16 = 1e-2


def test_decode_split_model_bf16_inside_card_tolerance():
    """bf16 at the main path's last-step positions (Llama's GQA 4:1 at a
    narrow head): the merged splits stay inside the kernels' bf16 bounds
    of the one-pass plain version, elementwise and row by row."""
    pos = [n + 31 for n in (16, 1024, 100, 517, 64, 300, 800, 33)]
    width = max(pos) // PAGE + 1
    q, k_pool, v_pool, tables, pos_t = _decode_inputs(
        8, 2, 64, pos, width, 5, torch.bfloat16, idle=())
    assert attention.plan_decode_splits(len(pos), 2, width * PAGE,
                                        SMS)[1] > 1
    got = attention.paged_decode_attention_split_plain(
        q, k_pool, v_pool, tables, pos_t, 0, SMS)
    want = attention.paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                                  pos_t, 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=2e-2)
    assert attention.max_row_rel_err(got, want) <= ROW_TOL_BF16


@pytest.mark.parametrize("drop", ["first", "middle", "last"])
def test_row_bound_catches_one_dropped_tile_of_a_long_lane(drop):
    """A lane 4000 keys deep beside short ones, one split per 64-key tile:
    merging every split passes the row bound, and leaving out one tile of
    the long lane (the first, a middle one, or the partial last one) fails
    it, though every other lane is untouched."""
    pos = [4000, 7, 70, 0]
    width = 4000 // PAGE + 1
    q, k_pool, v_pool, tables, pos_t = _decode_inputs(
        8, 2, 64, pos, width, 17, torch.bfloat16, idle=(3,))
    want = attention.paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                                  pos_t, 0)
    tiles = -(-(4000 + 1) // attention.TILE_KEYS)
    o, m, l = attention.paged_decode_split_partials(
        q, k_pool, v_pool, tables, pos_t, 0, 1, tiles)
    whole = attention.merge_splits_plain(o, m, l).to(torch.bfloat16)
    assert attention.max_row_rel_err(whole, want) <= ROW_TOL_BF16
    cut = {"first": 0, "middle": tiles // 2, "last": tiles - 1}[drop]
    o, m, l = o.clone(), m.clone(), l.clone()
    o[cut, 0], m[cut, 0], l[cut, 0] = 0.0, -float("inf"), 0.0  # lane 0 only
    merged = attention.merge_splits_plain(o, m, l).to(torch.bfloat16)
    assert attention.max_row_rel_err(merged[0:1], want[0:1]) > ROW_TOL_BF16
    assert attention.max_row_rel_err(merged[1:], want[1:]) <= ROW_TOL_BF16


# (lanes, KV, max_keys): the main path's last step (66 pages), a full
# 512-column table, one page, one lane over a long cache, the CPU test's
# shape, and a batch whose lanes alone fill the card.
DECODE_PLANS = [(8, 8, 66 * 16), (8, 8, 512 * 16), (8, 8, 16),
                (1, 1, 100_000), (6, 2, 19 * 16), (64, 8, 2048)]


@pytest.mark.parametrize("S,KV,max_keys", DECODE_PLANS)
def test_decode_plan_covers_keys_once_on_tile_boundaries(S, KV, max_keys):
    """The splits cover [0, max_keys) once, cut on 64-key tiles, none empty;
    each holds at least MIN_SPLIT_TILES tiles (but for a short last one),
    a grid the lanes alone fill keeps one split, and where the keys allow,
    the grid gives every SM a block."""
    per, n_splits = attention.plan_decode_splits(S, KV, max_keys, SMS)
    assert per >= attention.MIN_SPLIT_TILES
    ranges = attention.split_ranges(0, max_keys, per, n_splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == max_keys
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2
        assert lo % attention.TILE_KEYS == 0 and hi % attention.TILE_KEYS == 0
    assert all(lo < hi for lo, hi in ranges)
    tiles = -(-max_keys // attention.TILE_KEYS)
    fill = attention.BLOCKS_PER_SM * SMS
    if S * KV >= fill or tiles <= attention.MIN_SPLIT_TILES:
        assert n_splits == 1
    elif tiles >= attention.MIN_SPLIT_TILES * -(-SMS // (S * KV)):
        assert S * KV * n_splits >= SMS


def test_f32_decode_plan_and_schedule_cover_every_item_once():
    """K1's f32 plan (the SIMT core's persistent grid): over
    DECODE_PLANS its splits cover [0, max_keys) once, cut on 64-key tiles,
    in splits of F32_DECODE_SPLIT_TILES tiles (one split where the lanes'
    KV heads alone give each block slot an item, or the keys fit one
    split); the grid is one block per item up to F32_DECODE_BLOCKS per SM;
    and for lanes at the table's last key, at a ragged mix (idle lanes at
    0) and at a pos past the table, with groups of 4 and of 32 query heads
    (two chunks of F32_DECODE_ROWS), the blocks run each (lane, KV head,
    chunk, split) that holds a key once, no other, and at most one item
    more than any other block."""
    rng = np.random.default_rng(4)
    slots = attention.F32_DECODE_BLOCKS * SMS
    for S, KV, max_keys in DECODE_PLANS:
        case = f"S={S} KV={KV} max_keys={max_keys}"
        per, n_splits = attention.plan_decode_splits(S, KV, max_keys, SMS,
                                                     torch.float32)
        tiles = -(-max_keys // attention.TILE_KEYS)
        if S * KV >= slots or tiles <= attention.F32_DECODE_SPLIT_TILES:
            assert (per, n_splits) == (tiles, 1), case
        else:
            assert per == attention.F32_DECODE_SPLIT_TILES, case
        ranges = attention.split_ranges(0, max_keys, per, n_splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == max_keys, case
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2 and lo % attention.TILE_KEYS == 0, case
        assert all(lo < hi for lo, hi in ranges), case
        ragged = rng.integers(0, max_keys, S)
        ragged[::3] = 0
        for group in (4, 32):
            H = KV * group
            chunks = -(-group // attention.F32_DECODE_ROWS)
            grid = attention.decode_grid(S, H, KV, n_splits, SMS)
            assert grid == min(S * KV * chunks * n_splits, slots), case
            for pos in ([max_keys - 1] * S, list(ragged),
                        [max_keys + 5] + [0] * (S - 1)):
                blocks = attention.decode_schedule(pos, H, KV, per, n_splits,
                                                   max_keys, SMS)
                assert len(blocks) == grid, case
                seen = [item for block in blocks for item in block]
                want = {(s, k, c, sp) for s in range(S) for k in range(KV)
                        for c in range(chunks)
                        for sp, (lo, _) in enumerate(ranges)
                        if lo <= min(int(pos[s]), max_keys - 1)}
                assert len(seen) == len(set(seen)), case
                assert set(seen) == want, case
                sizes = [len(block) for block in blocks]
                assert max(sizes) - min(sizes) <= 1, case


def test_decode_split_model_at_f32_cuts_matches_plain():
    """At the f32 plan's cuts (splits of F32_DECODE_SPLIT_TILES tiles over
    a 40-column table), the per-lane partials merged equal the one-pass
    plain version in f32 within 1e-6, for the MHA and GQA-4 heads, with
    an idle lane; so does the split model that follows the f32 plan."""
    width = 40
    for H, KV, Dh in HEADS:
        case = f"H={H} KV={KV} Dh={Dh}"
        q, k_pool, v_pool, tables, pos = _decode_inputs(H, KV, Dh,
                                                        DECODE_POS, width,
                                                        7 + H)
        per, n_splits = attention.plan_decode_splits(
            len(DECODE_POS), KV, width * PAGE, SMS, torch.float32)
        assert per == attention.F32_DECODE_SPLIT_TILES and n_splits > 2, case
        o, m, l = attention.paged_decode_split_partials(
            q, k_pool, v_pool, tables, pos, 1, per, n_splits)
        w = per * attention.TILE_KEYS
        for s, p in enumerate(DECODE_POS):
            for k in range(n_splits):
                assert bool(torch.isinf(m[k, s]).all()) == (k * w > p), \
                    (case, s, k)
        want = attention.paged_decode_attention_plain(q, k_pool, v_pool,
                                                      tables, pos, 1)
        got = attention.merge_splits_plain(o, m, l)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=case)
        got = attention.paged_decode_attention_split_plain(
            q, k_pool, v_pool, tables, pos, 1, SMS, torch.float32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6, err_msg=case)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_plain_is_the_add_then_the_norm(dtype):
    """The fused norm's plain version is exactly x + delta in x's dtype
    (the new residual stream) and rms_norm_plain of that sum; the wrapper
    takes it for CPU tensors."""
    rng = np.random.default_rng(8)
    x = torch.from_numpy(rng.standard_normal((5, 96), np.float32)).to(dtype)
    d = torch.from_numpy(rng.standard_normal((5, 96), np.float32)).to(dtype)
    g = torch.from_numpy((1.0 + 0.1 * rng.standard_normal(96)).astype(
        np.float32))
    s, h = norm.add_rms_norm_plain(x, d, g, 1e-5)
    assert s.dtype == h.dtype == dtype
    assert torch.equal(s, x + d)
    assert torch.equal(h, norm.rms_norm_plain(x + d, g, 1e-5))
    s2, h2 = norm.add_rms_norm(x, d, g, 1e-5)
    assert torch.equal(s2, s) and torch.equal(h2, h)


def test_engine_sends_only_the_table_columns_in_play():
    """The engine's decode step gets the block table cut to the most pages
    any active lane holds, not its max_seq / page columns: K1 plans its
    splits over that width. (No prefix cache: its host tier is one store
    per process, which the tier tests hold to their own pages.)"""
    from brpc_tpu_torch import serving

    cfg = transformer.TransformerConfig.tiny()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(3),
                                     device="cpu")
    eng = serving.ServingEngine(params, cfg, max_batch_size=2, slots=2,
                                max_prompt=48, kv_page_tokens=8,
                                prefix_cache=False, autostart=False,
                                device="cpu")
    widths = []
    decode = eng._decode

    def spy(params, tokens, pos, tables, k_pool, v_pool):
        in_play = max(len(s["blocks"]) for s in eng._seq if s is not None)
        widths.append((tables.shape[1], in_play))
        assert tables.is_contiguous()
        assert all(int(p) < tables.shape[1] * 8 for p in pos)
        return decode(params, tokens, pos, tables, k_pool, v_pool)

    eng._decode = spy
    try:
        eng.start()
        addr = f"127.0.0.1:{eng.port}"
        out = [serving.generate(addr, list(range(1, 1 + n)), 12, 60_000)
               for n in (3, 30)]
    finally:
        eng.close()
    assert [len(t) for t in out] == [12, 12]
    assert widths and all(w == in_play for w, in_play in widths), widths
    assert max(w for w, _ in widths) < cfg.max_seq // 8
