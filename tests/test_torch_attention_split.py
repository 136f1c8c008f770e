"""K4's split-K on the CPU: the wrapper's split planner against its
contract, and the plain model of the split and merge passes
(``paged_prefill_split_partials`` + ``merge_splits_plain``) against K4's
plain version. The plain version is held against the JAX reference in
tests/test_torch_ops.py; the kernel against both plain versions on a card
in tests/test_torch_kernels_card.py.
"""

import os
import re

import numpy as np
import pytest
import torch

from brpc_tpu_torch.ops import attention

SMS = 132  # the H100 SXM's SM count
HEADS = [(4, 4, 32), (8, 2, 64)]  # (H, KV, Dh): MHA and GQA 4:1
HEAD_IDS = ["mha", "gqa4"]

# (start, n): page- and tile-aligned start; mid-page start with a split
# boundary (512) inside the suffix; one query over 4000 keys; a long
# suffix whose first rows see nothing of the later splits; a turn-2 resume.
SPLIT_CASES = [(1024, 40), (500, 40), (4000, 1), (100, 200), (1008, 40)]


def _pool(H, KV, Dh, start, n, seed, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    L, page = 2, 16
    pages = -(-(start + n) // page)
    nb = pages + 3
    shape = (nb, L, page, KV, Dh)
    k_pool = torch.from_numpy(rng.standard_normal(shape, np.float32))
    v_pool = torch.from_numpy(rng.standard_normal(shape, np.float32))
    table = torch.from_numpy(
        rng.permutation(np.arange(1, nb))[:pages].astype(np.int32))
    q = torch.from_numpy(rng.standard_normal((n, H, Dh), np.float32))
    return q.to(dtype), k_pool.to(dtype), v_pool.to(dtype), table


@pytest.mark.parametrize("start,n", SPLIT_CASES)
@pytest.mark.parametrize("H,KV,Dh", HEADS, ids=HEAD_IDS)
def test_split_model_matches_plain_f32(H, KV, Dh, start, n):
    """Partials per split, merged, equal the one-pass softmax in f32
    within 1e-6 (summation order only), and the plan really splits."""
    q, k_pool, v_pool, table = _pool(H, KV, Dh, start, n, start + n)
    per, n_splits = attention.plan_splits(n, H, KV, start, SMS)
    assert n_splits > 1
    got = attention.paged_prefill_attention_split_plain(
        q, k_pool, v_pool, table, start, 1, SMS)
    want = attention.paged_prefill_attention_plain(q, k_pool, v_pool, table,
                                                   start, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("start,n", [(100, 200), (500, 40)])
@pytest.mark.parametrize("H,KV,Dh", HEADS, ids=HEAD_IDS)
def test_fully_masked_splits_get_weight_zero(H, KV, Dh, start, n):
    """Some (row, split) pairs see no key: their max is -inf and their sum
    0, the merge gives them weight 0 (no NaN), and no row is masked in
    every split."""
    q, k_pool, v_pool, table = _pool(H, KV, Dh, start, n, 7)
    per, n_splits = attention.plan_splits(n, H, KV, start, SMS)
    o, m, l = attention.paged_prefill_split_partials(
        q, k_pool, v_pool, table, start, 1, per, n_splits)
    empty = torch.isinf(m)
    assert empty.any()
    assert (m[empty] < 0).all() and (l[empty] == 0).all()
    assert (o[empty] == 0).all()
    assert not empty.all(dim=0).any()
    assert not empty[0].any()  # split 0 holds key 0, which every row sees
    merged = attention.merge_splits_plain(o, m, l)
    assert torch.isfinite(merged).all()
    want = attention.paged_prefill_attention_plain(q, k_pool, v_pool, table,
                                                   start, 1)
    np.testing.assert_allclose(merged.numpy(), want.numpy(), rtol=0,
                               atol=1e-6)


# The card's bf16 bounds (tests/test_torch_kernels_card.py): elementwise
# atol 2e-2 + rtol 1e-2, and each (query, head) row within 1e-2 of its
# norm.
ROW_TOL_BF16 = 1e-2


@pytest.mark.parametrize("start,n", [(4000, 1), (100, 200), (1008, 40)])
def test_split_model_bf16_inside_card_tolerance(start, n):
    """bf16: the merge rescales P.V sums whose probabilities were rounded
    within their split; that stays inside the kernels' bf16 bounds of the
    one-pass plain version, elementwise and row by row."""
    H, KV, Dh = 8, 2, 64
    q, k_pool, v_pool, table = _pool(H, KV, Dh, start, n, 11,
                                     torch.bfloat16)
    got = attention.paged_prefill_attention_split_plain(
        q, k_pool, v_pool, table, start, 0, SMS)
    want = attention.paged_prefill_attention_plain(q, k_pool, v_pool, table,
                                                   start, 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want.float().numpy(),
                               rtol=1e-2, atol=2e-2)
    assert attention.max_row_rel_err(got, want) <= ROW_TOL_BF16


@pytest.mark.parametrize("start,n", [(4000, 1), (1008, 40), (517, 300)])
def test_row_bound_catches_one_dropped_key_tile(start, n):
    """The row bound has the power the elementwise one lacks: with one
    split per 64-key tile, merging every split passes it, and leaving out
    any one tile (the first, a middle one, or the partial last one) fails
    it. At one query over 4000 keys the elementwise bound alone can miss
    such a cut: a tile moves each output by about atol."""
    H, KV, Dh = 8, 2, 64
    q, k_pool, v_pool, table = _pool(H, KV, Dh, start, n, 13,
                                     torch.bfloat16)
    want = attention.paged_prefill_attention_plain(q, k_pool, v_pool, table,
                                                   start, 0)
    tiles = -(-(start + n) // attention.TILE_KEYS)
    o, m, l = attention.paged_prefill_split_partials(
        q, k_pool, v_pool, table, start, 0, 1, tiles)
    whole = attention.merge_splits_plain(o, m, l).to(torch.bfloat16)
    assert attention.max_row_rel_err(whole, want) <= ROW_TOL_BF16
    for drop in (0, tiles // 2, tiles - 1):
        keep = [s for s in range(tiles) if s != drop]
        cut = attention.merge_splits_plain(o[keep], m[keep], l[keep])
        assert attention.max_row_rel_err(cut.to(torch.bfloat16),
                                         want) > ROW_TOL_BF16


# (n, H, KV, start): the phase-3 shapes at Llama-3-8B heads, a long suffix,
# tiny heads deep in a cache, and odd key counts.
PLAN_SHAPES = [(40, 32, 8, 1008), (300, 32, 8, 517), (1, 32, 8, 4000),
               (200, 32, 8, 100), (1, 4, 4, 4000), (3, 8, 2, 61),
               (129, 8, 2, 0), (1, 32, 8, 100_000)]


@pytest.mark.parametrize("n,H,KV,start", PLAN_SHAPES)
def test_plan_covers_keys_once_on_tile_boundaries(n, H, KV, start):
    per, n_splits = attention.plan_splits(n, H, KV, start, SMS)
    ranges = attention.split_ranges(start, n, per, n_splits)
    assert ranges[0][0] == 0 and ranges[-1][1] == start + n
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2  # no gap, no overlap
        assert lo % attention.TILE_KEYS == 0 and hi % attention.TILE_KEYS == 0
    assert all(lo < hi for lo, hi in ranges)  # no empty split


@pytest.mark.parametrize("n,H,KV,start", [(1, 32, 8, 0), (40, 32, 8, 50),
                                          (1, 4, 4, 127), (2000, 32, 8, 0)])
def test_plan_keeps_one_split_for_short_ranges_or_full_grids(n, H, KV, start):
    """One split where the keys fit MIN_SPLIT_TILES tiles, or where the
    query tiles alone give every SM BLOCKS_PER_SM blocks."""
    assert attention.plan_splits(n, H, KV, start, SMS)[1] == 1


@pytest.mark.parametrize("n,H,KV,start", [(40, 32, 8, 1008), (1, 32, 8, 4000),
                                          (200, 32, 8, 100), (300, 32, 8, 517),
                                          (1, 32, 8, 100_000)])
def test_plan_fills_the_card_where_keys_allow(n, H, KV, start):
    per, n_splits = attention.plan_splits(n, H, KV, start, SMS)
    q_tiles = -(-(n * H // KV) // attention.TILE_ROWS)
    tiles = -(-(start + n) // attention.TILE_KEYS)
    # the keys allow it: enough tiles for every SM to get a block
    assert tiles >= attention.MIN_SPLIT_TILES * -(-SMS // (q_tiles * KV))
    assert q_tiles * KV * n_splits >= SMS


# The f32 plans of PLAN_SHAPES' first four (the phase-3 shapes) at 132 SMs:
# (tiles_per_split, n_splits), with the grid of 128-row blocks they give.
F32_PLANS = {(200, 32, 8, 100): (3, 2, 112), (40, 32, 8, 1008): (3, 6, 96),
             (1, 32, 8, 4000): (4, 16, 128)}


def test_f32_plan_takes_the_least_cost_cut():
    """K4's f32 plan (the SIMT core: one block per SM, rows from
    csrc/attention_f32.cuh) covers [0, start + n) once on 64-key
    boundaries with no empty split, and of every cut into splits of at
    least MIN_SPLIT_TILES tiles (or one split) it takes the least waves x
    tiles per split, the fewest splits on a tie."""
    with open(os.path.join(attention._build._SRC_DIR,
                           "attention_f32.cuh")) as f:
        rows = int(re.search(r"constexpr int kF32FwdRows = (\d+);",
                             f.read()).group(1))
    assert attention.F32_FWD_ROWS == rows
    for n, H, KV, start in PLAN_SHAPES:
        case = f"n={n} H={H} KV={KV} start={start}"
        per, n_splits = attention.plan_splits(n, H, KV, start, SMS,
                                              torch.float32)
        ranges = attention.split_ranges(start, n, per, n_splits)
        assert ranges[0][0] == 0 and ranges[-1][1] == start + n, case
        for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
            assert hi == lo2, case
            assert lo % 64 == 0 and hi % 64 == 0, case
        assert all(lo < hi for lo, hi in ranges), case
        blocks = -(-(n * H // KV) // rows) * KV
        tiles = -(-(start + n) // 64)
        cuts = sorted({(-(-tiles // s), -(-tiles // -(-tiles // s)))
                       for s in range(1, tiles + 1)}, key=lambda c: c[1])
        costs = [(-(-(blocks * s) // SMS) * p, s) for p, s in cuts
                 if s == 1 or p >= attention.MIN_SPLIT_TILES]
        assert (-(-(blocks * n_splits) // SMS) * per, n_splits) == \
            min(costs), f"{case}: plan ({per}, {n_splits}) of {costs}"
        if (n, H, KV, start) in F32_PLANS:
            assert (per, n_splits, blocks * n_splits) == \
                F32_PLANS[(n, H, KV, start)], case


def test_f32_plan_cuts_merge_to_plain():
    """At the f32 plan's cuts, the plain split pass merged equals the
    one-pass softmax in f32 within 1e-6, as at the bf16 plan's."""
    for H, KV, Dh in HEADS:
        for start, n in SPLIT_CASES:
            case = f"H={H} KV={KV} Dh={Dh} start={start} n={n}"
            q, k_pool, v_pool, table = _pool(H, KV, Dh, start, n,
                                             start + 2 * n)
            per, n_splits = attention.plan_splits(n, H, KV, start, SMS,
                                                  torch.float32)
            o, m, l = attention.paged_prefill_split_partials(
                q, k_pool, v_pool, table, start, 1, per, n_splits)
            got = attention.merge_splits_plain(o, m, l)
            want = attention.paged_prefill_attention_plain(
                q, k_pool, v_pool, table, start, 1)
            np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                       atol=1e-6, err_msg=case)
            assert torch.equal(
                attention.paged_prefill_attention_split_plain(
                    q, k_pool, v_pool, table, start, 1, SMS), got), case
