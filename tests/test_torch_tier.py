"""The port's host KV tier against brpc_tpu's, on the CPU, mirroring the
non-peer tests of tests/test_tier.py: spill on pool eviction and fill on
match, generations after host fills equal to the JAX engine's and the
uncached stream, finished sequences admitted for the next chat turn, the
TTL gc, the kv_tier_* metrics, and a hot set larger than the pool. Host
page bytes are the reference's byte for byte; the index's host-side
verbs (spill, export_chains, admit_host, plan_peer_fill, digests) give the
reference's answers. Tiny float32 config and its grouped-query variant.

    python -m pytest tests/test_torch_tier.py -q
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import kv_cache as jkv
from brpc_tpu import runtime as jrt
from brpc_tpu import serving as jserving
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import kv_cache as tkv
from brpc_tpu_torch import runtime, serving
from brpc_tpu_torch.models import transformer as tt


def _configs(n_kv_heads, jdtype=jnp.float32, tdtype=torch.float32):
    return (dataclasses.replace(jt.TransformerConfig.tiny(), dtype=jdtype,
                                n_kv_heads=n_kv_heads),
            dataclasses.replace(tt.TransformerConfig.tiny(), dtype=tdtype,
                                n_kv_heads=n_kv_heads))


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def models(request):
    jcfg, tcfg = _configs(request.param)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


ENGINE_KW = dict(max_batch_size=2, slots=2, max_queue_delay_us=500)


def _port_engine(models, **kw):
    _, _, tcfg, tp = models
    return serving.ServingEngine(tp, tcfg, device="cpu", **{**ENGINE_KW,
                                                            **kw})


def _jax_engine(models, **kw):
    jcfg, jp, _, _ = models
    return jserving.ServingEngine(jp, jcfg, **{**ENGINE_KW, **kw})


def _streams(make, script):
    """``script``'s result and the engine's stats once it has vacated
    every finished sequence (a client sees its terminal frame before the
    engine admits and releases the sequence's pages)."""
    eng = make()
    try:
        res = script(f"127.0.0.1:{eng.port}", eng)
        deadline = time.monotonic() + 30
        while eng.in_flight() and time.monotonic() < deadline:
            time.sleep(0.01)
        return res, eng.stats()
    finally:
        eng.close()


def _prefill_into(pool, index, params, cfg, page, prompt):
    """Prefill ``prompt`` with the port and admit its pages (the caller
    releases)."""
    P = len(prompt)
    padded = np.zeros(serving.prompt_bucket(P, cfg.max_seq // 2), np.int32)
    padded[:P] = prompt
    _logits, k, v = tt.prefill(params, torch.from_numpy(padded), P, cfg)
    blocks = pool.alloc(tkv.pages_for(P, page))
    k_pages, v_pages = tkv.prefill_cache_pages(k, v, P, page)
    pool.write_blocks(blocks, k_pages, v_pages)
    index.admit(np.asarray(prompt, np.int32), blocks)
    return blocks


# ---- host page codec --------------------------------------------------------

@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_host_page_bytes_identical_to_jax(dtype, n_kv_heads):
    """The same KV gives the reference's host-store entry bytes, and the
    bytes decode back to the same pages."""
    import ml_dtypes

    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jcfg, tcfg = _configs(n_kv_heads, jdt, tdt)
    page = 8
    rng = np.random.default_rng(11)
    shape = (jcfg.n_layers, page, jcfg.n_kv_heads, jcfg.d_head)
    k = rng.standard_normal(shape, np.float32)
    v = rng.standard_normal(shape, np.float32)
    npdt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want = jkv.encode_host_page(jnp.asarray(k, jdt), jnp.asarray(v, jdt))
    got = tkv.encode_host_page(torch.from_numpy(k).to(tdt),
                               torch.from_numpy(v).to(tdt))
    assert got == want
    assert len(got) == tkv.host_page_bytes(tcfg, page) \
        == jkv.host_page_bytes(jcfg, page)
    kd, vd = tkv.decode_host_page(got, tcfg, page)
    jk, jv = jkv.decode_host_page(want, jcfg, page)
    assert kd.dtype == tdt and kd.shape == shape
    np.testing.assert_array_equal(kd.float().numpy(),
                                  np.asarray(jk, npdt).astype(np.float32))
    np.testing.assert_array_equal(vd.float().numpy(),
                                  np.asarray(jv, npdt).astype(np.float32))


@pytest.mark.parametrize("n", [1, 8, 16, 37])
def test_content_keys_match_jax(n):
    toks = np.random.default_rng(n).integers(0, 1 << 20, n).astype(np.int32)
    assert tkv.prefix_hash(toks) == jkv.prefix_hash(toks)
    assert tkv.page_key(toks, 8) == jkv.page_key(toks, 8)
    assert tkv.page_key(toks, 16) == jkv.page_key(toks, 16)


# ---- tier state machine -----------------------------------------------------

def test_spill_fill_roundtrip_index_level(models):
    """Evicting an indexed page spills it to the host store; the next
    match fills it back byte-exactly instead of missing; a host entry the
    store dropped is a plain miss (three-way tier verdict)."""
    _, _, tcfg, tp = models
    page = 8
    pool = tkv.PagedKvPool(tcfg, 5, page, device="cpu")  # 4 usable blocks
    idx = tkv.PrefixIndex(pool, page,
                          token_bytes=tkv.kv_token_bytes(tcfg),
                          host_tier=True)
    prompt = np.arange(1, 17, dtype=np.int32)  # 2 pages
    blocks = _prefill_into(pool, idx, tp, tcfg, page, prompt)
    ref_k = pool.k[blocks].clone()
    ref_v = pool.v[blocks].clone()
    pool.release(blocks)
    for i in range(2):  # admission exported both pages, in host layout
        data = runtime.kv_host_get(
            tkv.page_key(prompt[:(i + 1) * page], page))
        assert data.tobytes() == tkv.encode_host_page(ref_k[i], ref_v[i])
    s1 = runtime.kv_tier_stats()
    grab = pool.alloc(4)  # churn the whole pool: both entries flip
    assert grab is not None
    pool.release(grab)

    got, use = idx.match(prompt, len(prompt) - 1)
    assert use == len(prompt) - 1 and len(got) == 2
    assert torch.equal(pool.k[got], ref_k)
    assert torch.equal(pool.v[got], ref_v)
    pool.release(got)
    s2 = runtime.kv_tier_stats()
    assert s2["kv_tier_fills"] >= s1["kv_tier_fills"] + 2
    assert idx.host_hits >= 1

    grab = pool.alloc(4)
    pool.release(grab)
    for i in range(2):
        runtime.kv_host_drop(tkv.page_key(prompt[:(i + 1) * page], page))
    got, use = idx.match(prompt, len(prompt) - 1)
    assert use == 0 and got == []


def test_host_fill_generation_byte_exact(models):
    """After pool churn evicts the hot prefix, the host tier serves it
    back and the generation equals the uncached engine's and the JAX
    engine's."""
    hot = list(range(1, 21))

    def script(addr, eng):
        gen = (serving.generate if isinstance(eng, serving.ServingEngine)
               else jserving.generate)
        out = [gen(addr, hot, 6)]
        for i in range(4):  # churn far past the pool
            gen(addr, [50 + 7 * i] * 24, 2)
        return out + [gen(addr, hot, 6)]

    ref, _ = _streams(lambda: _port_engine(models, prefix_cache=False),
                      lambda addr, eng: [serving.generate(addr, hot, 6)])
    jres, js = _streams(lambda: _jax_engine(models, kv_blocks=9), script)
    tres, ts = _streams(lambda: _port_engine(models, kv_blocks=9), script)
    assert tres == [ref[0], ref[0]]
    assert tres == jres
    assert ts["kv_tier_spills"] > 0
    assert ts["kv_prefix_host_hits"] >= 1
    assert ts["kv_prefix_host_hits"] == js["kv_prefix_host_hits"]
    assert ts["kv_prefix_hits"] == js["kv_prefix_hits"]


def test_decode_pages_admitted_on_finish_multi_turn(models):
    """A finished sequence's pages (prompt + generated reply) are
    admitted: the next chat turn resumes off the whole last turn and
    equals the uncached stream."""
    turn1 = list(range(1, 18))

    def script(addr, eng):
        gen = (serving.generate if isinstance(eng, serving.ServingEngine)
               else jserving.generate)
        reply = gen(addr, turn1, 6)
        prefills_after_turn1 = eng.prefills
        turn2 = turn1 + reply + [3, 1, 4]
        return reply, turn2, gen(addr, turn2, 5), prefills_after_turn1

    (reply, turn2, out2, p1), ts = _streams(lambda: _port_engine(models),
                                            script)
    jres, js = _streams(lambda: _jax_engine(models), script)
    ref, _ = _streams(lambda: _port_engine(models, prefix_cache=False),
                      lambda addr, eng: serving.generate(addr, turn2, 5))
    assert p1 == 1
    assert ts["prefills"] == 1 and ts["resumes"] == 1
    assert ts["kv_prefix_hits"] >= 1
    assert out2 == ref
    assert (reply, turn2, out2) == jres[:3]
    assert ts["kv_prefix_bytes_shared"] == js["kv_prefix_bytes_shared"]


def test_prefix_gc_ages_out_cold_entries(models):
    """The TTL sweep drops idle entries and their spilled host pages
    (kv_prefix_gc_evictions counts them)."""
    _, _, tcfg, tp = models
    page = 8
    pool = tkv.PagedKvPool(tcfg, 5, page, device="cpu")
    idx = tkv.PrefixIndex(pool, page,
                          token_bytes=tkv.kv_token_bytes(tcfg),
                          host_tier=True)
    prompt = np.arange(1, 17, dtype=np.int32)
    blocks = _prefill_into(pool, idx, tp, tcfg, page, prompt)
    pool.release(blocks)
    hk = tkv.page_key(prompt[:page], page)
    assert runtime.kv_host_has(hk)

    base = runtime.metrics().get("kv_prefix_gc_evictions", 0)
    assert idx.gc(max_age_s=3600) == 0  # fresh entries survive a real TTL
    dropped = idx.gc(max_age_s=-1)      # everything is now "cold"
    assert dropped >= 2
    assert idx.gc_evictions == dropped
    assert not runtime.kv_host_has(hk)  # the host page went with the entry
    got, use = idx.match(prompt, len(prompt) - 1)
    assert use == 0 and got == []
    assert runtime.metrics().get("kv_prefix_gc_evictions", 0) \
        >= base + dropped


def test_tier_metrics_surface(models):
    """kv_tier_{host_pages,spills,fills,peer_fills,spill_bytes} and the
    kv_tier_fill_us recorder ride /vars and the metrics dump; the engine's
    stats fold them in."""
    eng = _port_engine(models)
    try:
        addr = f"127.0.0.1:{eng.port}"
        serving.generate(addr, list(range(1, 15)), 3)
        s = eng.stats()
        m = runtime.metrics()
        page_vars = jrt.http_vars(addr, "kv_tier")
    finally:
        eng.close()
    for k in ("kv_tier_host_pages", "kv_tier_spills", "kv_tier_fills",
              "kv_tier_peer_fills", "kv_tier_spill_bytes"):
        assert k in s, k
        assert k in m, k
        assert k in page_vars, (k, page_vars)
    assert "kv_tier_fill_us_latency_p99" in m
    assert "kv_prefix_gc_evictions" in m
    assert s["kv_tier_host_pages"] > 0  # the engine exported its pages


def test_eviction_pressure_with_spill_tier_hot_set_exceeds_pool(models):
    """A hot set far exceeding the pool cycles through spill and fill and
    every family stays exact."""
    families = [[f * 20 + t for t in range(1, 19)] for f in range(1, 5)]

    def script(addr, eng):
        gen = (serving.generate if isinstance(eng, serving.ServingEngine)
               else jserving.generate)
        return [gen(addr, fam, 4) for _round in range(3) for fam in families]

    refs, _ = _streams(lambda: _port_engine(models, prefix_cache=False),
                       lambda addr, eng: [serving.generate(addr, fam, 4)
                                          for fam in families])
    # 6 usable blocks; each family needs 2 prompt pages.
    tres, ts = _streams(lambda: _port_engine(models, kv_blocks=7), script)
    jres, js = _streams(lambda: _jax_engine(models, kv_blocks=7), script)
    assert tres == refs * 3
    assert tres == jres
    assert ts["kv_tier_spills"] > 0
    assert ts["kv_prefix_host_hits"] > 0
    assert ts["kv_alloc_failures"] == 0
    assert ts["kv_prefix_host_hits"] == js["kv_prefix_host_hits"]


# ---- host-side verbs of the index (the disaggregated slice pulls with them) --

def _host_verbs_script(kv, rt, pool, cfg, page):
    """Admit two chains over random pages, spill, graft host-only entries
    into a fresh index, and plan a peer fill: every answer on the way."""
    rng = np.random.default_rng(21 + cfg.n_kv_heads)
    n = pool.num_blocks - 1
    shape = (n, cfg.n_layers, page, cfg.n_kv_heads, cfg.d_head)
    pool.write_blocks(list(range(1, n + 1)),
                      rng.standard_normal(shape, np.float32),
                      rng.standard_normal(shape, np.float32))
    # random tokens: the host store is process-wide, so keys stay unique
    a = rng.integers(0, 1 << 20, 20).astype(np.int32)  # 2 pages + 4 tail
    b = np.concatenate([a[:8], rng.integers(0, 1 << 20, 8).astype(np.int32)])
    idx = kv.PrefixIndex(pool, page, token_bytes=kv.kv_token_bytes(cfg),
                         host_tier=True)
    for toks in (a, b):
        blocks = pool.alloc(kv.pages_for(len(toks), page))
        idx.admit(toks, blocks)
        pool.release(blocks)
        idx.match(toks, len(toks) - 1)  # a hit each: digests rank by hits
    trace = [idx.spill(), idx.digest(), idx.page_digest(),
             sorted(c.tolist() for c in idx.export_chains())]
    other = kv.PrefixIndex(pool, page, token_bytes=kv.kv_token_bytes(cfg),
                           host_tier=True)
    c = rng.integers(0, 1 << 20, 24).astype(np.int32)
    trace.append(other.plan_peer_fill(a, len(a) - 1))
    other.admit_host(a, len(a))
    trace.append(other.plan_peer_fill(a, len(a) - 1))
    trace.append(other.plan_peer_fill(c, len(c)))
    got, use = other.match(a, len(a) - 1)  # host-only entries fill
    trace += [use, len(got), other.counters()]
    pool.release(got)
    trace.append([rt.kv_host_has(kv.page_key(a[:(i + 1) * page], page))
                  for i in range(2)])
    return trace


def test_index_host_verbs_match_jax(models):
    jcfg, _, tcfg, _ = models
    page = 8
    tpool = tkv.PagedKvPool(tcfg, 9, page, device="cpu")
    jpool = jkv.PagedKvPool(jcfg, 9, page)
    got = _host_verbs_script(tkv, runtime, tpool, tcfg, page)
    want = _host_verbs_script(jkv, jrt, jpool, jcfg, page)
    assert got == want
    # a fresh index pulls both full pages; after admit_host none; the
    # unrelated chain all three
    assert len(got[4]) == 2 and got[5] == [] and len(got[6]) == 3
    assert got[7] == 19 and got[8] == 3 and got[9]["host_hits"] == 1
