"""The port's CUDA kernels and serving engine on a card, against the port's
own plain PyTorch versions. Every test is marked ``cuda`` and skips where
no card is visible; the file imports no JAX, so it runs on a machine with
PyTorch and a card only:

    python3 -m pytest -m cuda tests/test_torch_kernels_card.py -q
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from brpc_tpu_torch import disagg, ops, serving
from brpc_tpu_torch.models import transformer
from brpc_tpu_torch.ops import attention, norm

HEADS = [(4, 4, 32), (4, 2, 32), (8, 2, 64), (32, 8, 128)]  # (H, KV, Dh)

# |kernel - plain| <= atol + rtol |plain|. f32 differs in summation order
# only; bf16 keeps 8 significant bits and the kernels round probabilities
# before the division by the softmax sum, where the plain versions round
# after it.
CARD_TOL = {torch.float32: (1e-4, 1e-4), torch.bfloat16: (2e-2, 1e-2)}
# Attention outputs are also held row by row: |kernel - plain| <=
# ROW_TOL |plain| in the 2-norm of each (query, head) vector. Over
# thousands of keys the outputs are about as small as CARD_TOL's atol, so
# CARD_TOL alone would pass a kernel that drops a 64-key tile, which
# ROW_TOL catches (tests/test_torch_attention_split.py); bf16 rounding keeps
# each row within 5.4e-3 (chip_smoke.py's row_rel_err on an H100).
ROW_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-2}


def _assert_rows_close(got, want, dtype):
    err = attention.max_row_rel_err(got, want)
    assert err <= ROW_TOL[dtype], (
        f"a row's relative error {err:.3e} is above {ROW_TOL[dtype]}")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _decode_inputs(H, KV, Dh, dev, dtype):
    """Five lanes at ragged positions (first row, page edges, last row of
    max_seq 128) with their pages scattered over a 3-layer pool."""
    rng = np.random.default_rng(0)
    S, L, page, max_pages = 5, 3, 16, 8
    pos = np.array([0, 15, 16, 77, 127], np.int32)
    n_blocks = 1 + sum(p // page + 1 for p in pos)
    order = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((S, max_pages), np.int32)  # unused: garbage block 0
    used = 0
    for s, p in enumerate(pos):
        n = p // page + 1
        tables[s, :n] = order[used:used + n]
        used += n

    def normal(shape):
        return torch.from_numpy(rng.standard_normal(shape, np.float32)).to(
            device=dev, dtype=dtype)

    pool_shape = (n_blocks, L, page, KV, Dh)
    return (normal((S, H, Dh)), normal(pool_shape), normal(pool_shape),
            torch.from_numpy(tables).to(dev), torch.from_numpy(pos).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", HEADS)
def test_kernels_match_plain_on_card(cuda_device, dtype, H, KV, Dh):
    atol, rtol = CARD_TOL[dtype]
    dev = cuda_device
    args = _decode_inputs(H, KV, Dh, dev, dtype)
    n = attention.paged_decode_attention.launches
    got = attention.paged_decode_attention(*args, 2)
    assert attention.paged_decode_attention.launches == n + 1
    want = attention.paged_decode_attention_plain(*args, 2)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    _assert_rows_close(got, want, dtype)
    x = torch.randn((70, H, Dh), device=dev).to(dtype)
    kv = torch.randn((70, KV, Dh), device=dev).to(dtype)
    got = attention.prefill_attention(x, kv, kv * 0.5, 41)
    want = attention.prefill_attention_plain(x, kv, kv * 0.5, 41)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    _assert_rows_close(got, want, dtype)
    g = torch.rand(H * Dh, device=dev) + 0.5
    rows = x.reshape(70, H * Dh)
    torch.testing.assert_close(norm.rms_norm(rows, g, 1e-5).float(),
                               norm.rms_norm_plain(rows, g, 1e-5).float(),
                               atol=atol, rtol=rtol)
    # The fused residual add: the sum exactly as torch rounds it, the norm
    # within the tolerance.
    delta = torch.randn_like(rows)
    n = norm.add_rms_norm.launches
    s, h = norm.add_rms_norm(rows, delta, g, 1e-5)
    assert norm.add_rms_norm.launches == n + 1
    s_want, h_want = norm.add_rms_norm_plain(rows, delta, g, 1e-5)
    assert torch.equal(s, s_want)
    torch.testing.assert_close(h.float(), h_want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("P,length", [(2048, 1060), (130, 77)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", HEADS)
def test_prefill_attention_matches_plain_on_card(cuda_device, H, KV, Dh,
                                                 dtype, P, length):
    """K2 against its plain version: a 1060-token prompt in its 2048
    bucket (key tiles past the length skipped, pad rows still computed)
    and a ragged short one."""
    atol, rtol = CARD_TOL[dtype]
    gen = torch.Generator(device=cuda_device).manual_seed(P + length)
    q = torch.randn((P, H, Dh), generator=gen, device=cuda_device).to(dtype)
    k = torch.randn((P, KV, Dh), generator=gen, device=cuda_device).to(dtype)
    v = torch.randn((P, KV, Dh), generator=gen, device=cuda_device).to(dtype)
    before = attention.prefill_attention.launches
    got = attention.prefill_attention(q, k, v, length)
    assert attention.prefill_attention.launches == before + 1
    want = attention.prefill_attention_plain(q, k, v, length)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    _assert_rows_close(got, want, dtype)


# K1 at Llama-3-8B heads, 8 lanes: (positions, table columns (None: the
# pages in play), idle lanes (pos 0, every column garbage block 0)). The
# main path's last decode step; a lane at max_seq - 1 beside short ones
# over the full 512-column table; every lane idle but one; short and long
# lanes over the full table.
DECODE_CASES = {
    "main_last_step": ([n + 31 for n in (16, 1024, 100, 517, 64, 300, 800,
                                         33)], None, ()),
    "pos_8191": ([8191, 0, 15, 16, 100, 64, 33, 7], 512, ()),
    "idle_but_one": ([0] * 7 + [1055], None, range(7)),
    "full_table": ([0, 15, 16, 300, 2047, 1000, 517, 64], 512, ()),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", list(DECODE_CASES))
def test_paged_decode_attention_matches_plain_on_card(cuda_device, case,
                                                      dtype):
    """K1 (split-K over each lane's table, the plan from the table's width)
    against its plain version on the last layer of a strided pool."""
    atol, rtol = CARD_TOL[dtype]
    pos, width, idle = DECODE_CASES[case]
    H, KV, Dh, L, page = 32, 8, 128, 2, 16
    dev = cuda_device
    gen = torch.Generator(device=dev).manual_seed(len(case))
    need = [0 if s in idle else p // page + 1 for s, p in enumerate(pos)]
    width = width or max(need)
    nb = sum(need) + 1
    k_pool = torch.randn((nb, L, page, KV, Dh), generator=gen,
                         device=dev).to(dtype)
    v_pool = torch.randn_like(k_pool)
    perm = torch.randperm(nb - 1, generator=gen, device=dev).int() + 1
    tables = torch.zeros((len(pos), width), dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(need):
        tables[s, :n] = perm[used:used + n]
        used += n
    pos_t = torch.tensor(pos, dtype=torch.int32, device=dev)
    q = torch.randn((len(pos), H, Dh), generator=gen, device=dev).to(dtype)
    before = attention.paged_decode_attention.launches
    got = attention.paged_decode_attention(q, k_pool, v_pool, tables, pos_t,
                                           L - 1)
    assert attention.paged_decode_attention.launches == before + 1
    want = attention.paged_decode_attention_plain(q, k_pool, v_pool, tables,
                                                  pos_t, L - 1)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    _assert_rows_close(got, want, dtype)


# (start, n): page-aligned, mid-page start ending mid-page, one query deep,
# and a long suffix whose split plan leaves its first rows no key in the
# later splits
RESUME_CASES = [(1008, 40), (517, 300), (4000, 1), (100, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("start,n", RESUME_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("H,KV,Dh", HEADS)
def test_paged_prefill_attention_matches_plain_on_card(cuda_device, H, KV,
                                                       Dh, dtype, start, n):
    """K4 against its plain version on a shuffled table over the last
    layer of a strided pool."""
    atol, rtol = CARD_TOL[dtype]
    L, page = 2, 16
    gen = torch.Generator(device=cuda_device).manual_seed(start + n)
    pages = -(-(start + n) // page)
    nb = pages + 4
    k_pool = torch.randn((nb, L, page, KV, Dh), generator=gen,
                         device=cuda_device).to(dtype)
    v_pool = torch.randn_like(k_pool)
    table = (torch.randperm(nb - 1, generator=gen, device=cuda_device)[:pages]
             + 1).int()
    q = torch.randn((n, H, Dh), generator=gen, device=cuda_device).to(dtype)
    before = attention.paged_prefill_attention.launches
    got = attention.paged_prefill_attention(q, k_pool, v_pool, table, start,
                                            L - 1)
    assert attention.paged_prefill_attention.launches == before + 1
    want = attention.paged_prefill_attention_plain(q, k_pool, v_pool, table,
                                                   start, L - 1)
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)
    _assert_rows_close(got, want, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_engine_on_card_prefix_hits_stream_plain_greedy(cuda_device,
                                                        n_kv_heads):
    """The f32 engine on the card with the prefix cache: a mid-page prefix
    hit while the shared tail is live (a copy-on-write), then the next
    turn off the finished sequence, each streaming exactly the plain
    forward's greedy tokens, with K4 launched once per layer per resume."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(transformer.TransformerConfig.tiny(),
                              dtype=torch.float32, n_kv_heads=n_kv_heads)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(2),
        device=cuda_device)
    base = list(range(1, 19))
    ops.reset_launch_counts()
    with serving.ServingEngine(params, cfg, max_batch_size=4, slots=4,
                               max_prompt=48) as eng:
        addr = f"127.0.0.1:{eng.port}"
        with serving.ServingClient(addr, timeout_ms=60_000) as c:
            it = c.generate(base, 12)
            first = next(it)
            mid = serving.generate(addr, base + [90, 91, 92], 6)
            got_base = [first] + list(it)
        turn2 = base + got_base + [7, 8]
        got2 = serving.generate(addr, turn2, 6)
        s = eng.stats()
    assert s["resumes"] == 2 and s["kv_prefix_cow_copies"] >= 1
    assert ops.launch_counts()["paged_prefill_attention"] == \
        cfg.n_layers * s["resumes"]
    for prompt, toks, n in ((base, got_base, 12),
                            (base + [90, 91, 92], mid, 6), (turn2, got2, 6)):
        assert toks == transformer.greedy_reference(params, cfg, prompt, n,
                                                    device=cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_engine_on_card_streams_plain_greedy(cuda_device, n_kv_heads):
    """The f32 engine on the card (kernels on every prefill and decode
    step) streams exactly the plain forward's greedy tokens."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(transformer.TransformerConfig.tiny(),
                              dtype=torch.float32, n_kv_heads=n_kv_heads)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(1),
        device=cuda_device)
    prompts = [[5, 11, 23], [1, 2, 3, 4, 5, 6, 7, 8, 9], [200], [17] * 16]
    ops.reset_launch_counts()
    with serving.ServingEngine(params, cfg, max_batch_size=4, slots=4,
                               max_prompt=16) as eng:
        got = [serving.generate(f"127.0.0.1:{eng.port}", p, 6, 60_000)
               for p in prompts]
        steps, prefills = eng.stats()["model_steps"], eng.stats()["prefills"]
    counts = ops.launch_counts()
    L = cfg.n_layers
    assert counts["paged_decode_attention"] == L * steps
    assert counts["prefill_attention"] == L * prefills
    # Every norm but the first of a pass takes its residual add along; a
    # prefill's one-row final norm stays unfused.
    assert counts["rms_norm"] == steps + 2 * prefills
    assert counts["add_rms_norm"] == 2 * L * steps + (2 * L - 1) * prefills
    for p, toks in zip(prompts, got):
        assert toks == transformer.greedy_reference(params, cfg, p, 6,
                                                    device=cuda_device)


@pytest.mark.cuda
def test_disagg_on_card_streams_plain_greedy(cuda_device):
    """The f32 disaggregated path on the card: the port's router, a
    layer-wise prefill worker and a decode worker, each on its own stream,
    stream exactly the plain forward's greedy tokens; K2 and the norms run
    on the prefill worker, K1 and the norms on the decode worker, counted
    apart per worker."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = dataclasses.replace(transformer.TransformerConfig.tiny(),
                              dtype=torch.float32, n_kv_heads=2)
    params = transformer.init_params(
        cfg, torch.Generator(device=cuda_device).manual_seed(3),
        device=cuda_device)
    torch.cuda.synchronize()
    prompts = [[9, 8, 7], [40 + i for i in range(21)], [3] * 16]
    pw = disagg.PrefillWorker(params, cfg, max_prompt=32,
                              prefix_cache=False)
    dw = disagg.DecodeWorker(params, cfg, slots=4, max_prompt=32,
                             prefix_cache=False)
    router = disagg.DisaggRouter([f"127.0.0.1:{pw.port}"],
                                 [f"127.0.0.1:{dw.port}"],
                                 worker_timeout_ms=60_000)
    try:
        got = [serving.generate(f"127.0.0.1:{router.port}", p, 6, 60_000)
               for p in prompts]
        deadline = time.monotonic() + 30
        while dw.in_flight() and time.monotonic() < deadline:
            time.sleep(0.01)
        steps = dw.stats()["model_steps"]
        assert pw.layerwise and pw.stats()["layers_streamed"] == \
            cfg.n_layers * len(prompts)
    finally:
        router.close()
        pw.close()
        dw.close()
    L, n = cfg.n_layers, len(prompts)
    assert pw.launches == {"rms_norm": 2 * n,
                           "add_rms_norm": (2 * L - 1) * n,
                           "prefill_attention": L * n}
    assert dw.launches == {"rms_norm": steps,
                           "add_rms_norm": 2 * L * steps,
                           "paged_decode_attention": L * steps}
    for p, toks in zip(prompts, got):
        assert toks == transformer.greedy_reference(params, cfg, p, 6,
                                                    device=cuda_device)
