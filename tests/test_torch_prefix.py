"""The port's prefix cache against brpc_tpu's, on the CPU, mirroring
tests/test_prefix.py: the paged suffix prefill (``prefix_resume``) against
the reference's on the same pool contents, the pool's weak references, the
index's matches and pruning, and the engine's prefix hits, copy-on-write
and eviction pressure, with streams equal to the JAX engine's and to the
uncached stream (tiny float32 config and its grouped-query variant).

Values are held within 1e-4 (summation order); block lists, refcounts,
match results, counters and token streams exactly.

    python -m pytest tests/test_torch_prefix.py -q
"""

import dataclasses
import threading
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

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(n_kv_heads):
    return (dataclasses.replace(jt.TransformerConfig.tiny(),
                                dtype=jnp.float32, n_kv_heads=n_kv_heads),
            dataclasses.replace(tt.TransformerConfig.tiny(),
                                dtype=torch.float32, n_kv_heads=n_kv_heads))


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def models(request):
    jcfg, tcfg = _configs(request.param)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


@pytest.fixture(scope="module")
def pools_cfg():
    return _configs(4)


def _pools(pools_cfg, n_blocks, page):
    jcfg, tcfg = pools_cfg
    return (jkv.PagedKvPool(jcfg, n_blocks, page),
            tkv.PagedKvPool(tcfg, n_blocks, page, device="cpu"))


# ---- model layer: the paged resume against the reference's ---------------------

PAGE = 16
# (name, cached tokens, shared tail held by another sequence); the prompt
# has 45 tokens, so 44 cached leaves one query
RESUMES = [("page_aligned", 32, False), ("page_aligned_held", 32, True),
           ("one_page", 16, False), ("first_page_mid", 5, False),
           ("first_page_mid_cow", 5, True), ("mid_page", 21, False),
           ("mid_page_cow", 21, True), ("late_mid_page", 40, False),
           ("last_token", 44, False), ("last_token_cow", 44, True)]


@pytest.mark.parametrize("name,use,held", RESUMES,
                         ids=[r[0] for r in RESUMES])
def test_prefill_resume_matches_full_prefill(models, name, use, held):
    """The port's paged ``prefix_resume`` and the reference's, on the same
    pool contents and the same cached blocks: the same block list and
    refcounts, first-token logits and the pages' rows below the prompt's
    length within 1e-4. Rows past the length are the reference's pad
    writes (its table reads the garbage block there); decode overwrites
    them before anything attends them, so they are not compared."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(7)
    n_blocks = 12
    shape = (n_blocks, jcfg.n_layers, PAGE, jcfg.n_kv_heads, jcfg.d_head)
    k0 = rng.standard_normal(shape, np.float32)
    v0 = rng.standard_normal(shape, np.float32)
    prompt = rng.integers(0, jcfg.vocab, 45).astype(np.int32)
    jpool = jkv.PagedKvPool(jcfg, n_blocks, PAGE)
    tpool = tkv.PagedKvPool(tcfg, n_blocks, PAGE, device="cpu")
    jidx = jkv.PrefixIndex(jpool, PAGE, jkv.kv_token_bytes(jcfg))
    tidx = tkv.PrefixIndex(tpool, PAGE, tkv.kv_token_bytes(tcfg))
    out = []
    for pool, kv, idx in ((jpool, jkv, jidx), (tpool, tkv, tidx)):
        everything = pool.alloc(n_blocks - 1)
        pool.write_blocks(everything, k0[1:], v0[1:])
        pool.release(everything)
        shared = pool.alloc(kv.pages_for(use, PAGE))
        if held:
            pool.retain(shared[-1:])  # another live sequence's tail
        params = jp if kv is jkv else tp
        cfg = jcfg if kv is jkv else tcfg
        logits, blocks = kv.prefix_resume(pool, params, cfg, PAGE, prompt,
                                          shared, use, index=idx)
        out.append((np.asarray(logits), blocks,
                    [pool.refcount(b) for b in range(n_blocks)],
                    np.asarray(pool.k), np.asarray(pool.v), shared,
                    idx.cow_copies))
    (jl, jb, jref, jk, jv, jshared, jcow), \
        (tl, tb, tref, tk, tv, tshared, tcow) = out
    assert tb == jb
    assert tref == jref
    assert tcow == jcow == int(held and use % PAGE != 0)
    np.testing.assert_allclose(tl, jl, **TOL)
    P = len(prompt)
    for n, blk in enumerate(tb):
        rows = min(PAGE, P - n * PAGE)
        np.testing.assert_allclose(tk[blk, :, :rows], jk[blk, :, :rows],
                                   **TOL)
        np.testing.assert_allclose(tv[blk, :, :rows], jv[blk, :, :rows],
                                   **TOL)
    if tcow:
        # the other holder's tail page is byte-unchanged
        src = tshared[-1]
        assert tb[len(tshared) - 1] != src
        np.testing.assert_array_equal(tk[src], k0[src])
        np.testing.assert_array_equal(tv[src], v0[src])


def test_prefill_resume_matches_one_shot_prefill(models):
    """Resuming from a cached prefix reproduces the one-shot prefill: the
    same last-position logits and the same KV at every real position."""
    _, _, tcfg, tp = models
    prompt = np.array([3, 17, 91, 7, 42, 9, 2, 55, 14, 60], np.int32)
    start, length, page = 6, len(prompt), 4
    ref_logits, ref_k, ref_v = tt.prefill(
        tp, torch.from_numpy(np.pad(prompt, (0, 6))), length, tcfg)
    pool = tkv.PagedKvPool(tcfg, 8, page, device="cpu")
    _, k, v = tt.prefill(tp, torch.from_numpy(np.pad(prompt[:start],
                                                     (0, 2))), start, tcfg)
    blocks = pool.alloc(tkv.pages_for(length, page))
    kp, vp = tkv.prefill_cache_pages(k, v, start, page)
    pool.write_blocks(blocks[:len(kp)], kp, vp)
    logits = tt.prefill_resume(
        tp, torch.from_numpy(prompt[start:]), start, length,
        torch.tensor(blocks, dtype=torch.int32), pool.k, pool.v, tcfg)
    np.testing.assert_allclose(logits.numpy(), ref_logits.numpy(), **TOL)
    got_k = pool.k[blocks].transpose(0, 1).reshape(tcfg.n_layers, -1,
                                                   tcfg.n_kv_heads,
                                                   tcfg.d_head)
    got_v = pool.v[blocks].transpose(0, 1).reshape(tcfg.n_layers, -1,
                                                   tcfg.n_kv_heads,
                                                   tcfg.d_head)
    np.testing.assert_allclose(got_k[:, :length].numpy(),
                               ref_k[:, :length].numpy(), **TOL)
    np.testing.assert_allclose(got_v[:, :length].numpy(),
                               ref_v[:, :length].numpy(), **TOL)


def test_paged_resume_fn_matches_jax(models):
    """``paged_resume_fn`` keeps the reference's signature and return: the
    logits and the pages it wrote, on the same pool contents."""
    jcfg, jp, tcfg, tp = models
    rng = np.random.default_rng(3)
    n_blocks = 8
    shape = (n_blocks, jcfg.n_layers, PAGE, jcfg.n_kv_heads, jcfg.d_head)
    k0 = rng.standard_normal(shape, np.float32)
    v0 = rng.standard_normal(shape, np.float32)
    start, length = 19, 40
    sb = jkv.suffix_bucket(length - start)
    sfx = np.zeros(sb, np.int32)
    sfx[:length - start] = rng.integers(0, jcfg.vocab, length - start)
    view = max(3, -(-(start + sb) // PAGE))
    table = np.zeros(view, np.int32)
    table[:3] = [5, 2, 7]
    first = start // PAGE
    jfn = jkv.paged_resume_fn(jcfg, PAGE, sb, view, first, 3 - first)
    jl, jkp, jvp = jfn(jp, jnp.asarray(sfx), jnp.int32(start),
                       jnp.int32(length), jnp.asarray(table),
                       jnp.asarray(k0), jnp.asarray(v0))
    tfn = tkv.paged_resume_fn(tcfg, PAGE, sb, 3, first, 3 - first)
    tl, tkp, tvp = tfn(tp, sfx, start, length, table[:3],
                       torch.from_numpy(k0.copy()),
                       torch.from_numpy(v0.copy()))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert tkp.shape == jkp.shape and tvp.shape == jvp.shape
    for n in range(3 - first):  # rows below the length (pad rows differ)
        rows = min(PAGE, length - (first + n) * PAGE)
        np.testing.assert_allclose(tkp[n, :, :rows].numpy(),
                                   np.asarray(jkp)[n, :, :rows], **TOL)
        np.testing.assert_allclose(tvp[n, :, :rows].numpy(),
                                   np.asarray(jvp)[n, :, :rows], **TOL)


def test_suffix_bucket_and_can_resume_match_jax(pools_cfg):
    jcfg, tcfg = pools_cfg
    for n in (1, 7, 8, 9, 64, 65, 100):
        assert tkv.suffix_bucket(n) == jkv.suffix_bucket(n)
    for use, length in ((0, 10), (5, 10), (60, 100), (100, 128), (1, 128)):
        assert tkv.can_resume(tcfg, use, length) == \
            jkv.can_resume(jcfg, use, length)


# ---- pool: weak refs, revival, eviction safety --------------------------------

def _retain_script(pool):
    evicted = []
    pool.on_evict = evicted.append
    (a,) = pool.alloc(1)
    ver = pool.version(a)
    trace = [pool.entry_alive(a, ver), pool.try_retain(a, ver),
             pool.refcount(a)]
    pool.release([a, a])
    trace += [pool.refcount(a), pool.entry_alive(a, ver),
              pool.try_retain(a, ver), pool.refcount(a)]
    pool.release([a])
    grabbed = pool.alloc(5)  # must reclaim `a` off the LRU
    trace += [a in grabbed, pool.try_retain(a, ver),
              [pair for batch in evicted for pair in batch],
              pool.entry_alive(a, ver)]
    return a, ver, trace


def test_pool_try_retain_revives_and_versions(pools_cfg):
    jpool, tpool = _pools(pools_cfg, 6, 16)
    a, ver, got = _retain_script(tpool)
    assert got == [True, True, 2, 0, True, True, 1, True, False,
                   [(a, ver)], False]
    assert got == _retain_script(jpool)[2]


def test_refcounted_shared_pages_never_evicted(pools_cfg):
    """Memory pressure may only reclaim zero-ref pages: with every block
    referenced, alloc fails instead of stealing a shared page."""
    out = []
    for pool in _pools(pools_cfg, 4, 16):
        held = pool.alloc(3)
        full = pool.alloc(1)
        ev0 = pool.evictions
        pool.release(held[:1])
        got = pool.alloc(1)
        out.append((held, full, ev0, got, pool.evictions))
    held, full, ev0, got, ev1 = out[1]
    assert full is None and ev0 == 0
    assert got == held[:1] and ev1 == 1
    assert out[0] == out[1]


# ---- index: match / admit / prune -------------------------------------------

def _match_script(pool, kv, cfg):
    idx = kv.PrefixIndex(pool, 16, token_bytes=kv.kv_token_bytes(cfg))
    prompt = np.arange(1, 37, dtype=np.int32)  # 2 full pages + 4 tail
    blocks = pool.alloc(3)
    idx.admit(prompt, blocks)
    pool.release(blocks)
    trace = [blocks]
    same = np.concatenate([prompt, [99]])
    div = np.concatenate([prompt[:20], [77, 78]])
    short = prompt[:16]
    for toks in (same, div, short):
        got, use = idx.match(toks, len(toks) - 1)
        trace.append((got, use, [pool.refcount(b) for b in got]))
        pool.release(got)
    other = pool.alloc(3)
    idx.admit(prompt, other)
    pool.release(other)
    got, use = idx.match(same, len(same) - 1)
    trace.append((got, use))
    pool.release(got)
    trace.append(idx.counters())
    return trace


def test_index_longest_match_full_and_partial(pools_cfg):
    jpool, tpool = _pools(pools_cfg, 9, 16)
    got = _match_script(tpool, tkv, pools_cfg[1])
    blocks = got[0]
    assert got[1] == (blocks, 36, [1, 1, 1])        # full + partial, len-1
    assert got[2] == (blocks[:1], 16, [1])          # diverges mid page 2
    assert got[3] == (blocks[:1], 15, [1])          # never past len-1
    assert got[4] == (blocks, 36)                   # idempotent admission
    assert got == _match_script(jpool, jkv, pools_cfg[0])


def _prune_script(pool, kv, cfg):
    idx = kv.PrefixIndex(pool, 16, token_bytes=kv.kv_token_bytes(cfg))
    prompt = np.arange(1, 33, dtype=np.int32)  # 2 full pages
    blocks = pool.alloc(2)
    idx.admit(prompt, blocks)
    pool.release(blocks)
    churn = pool.alloc(3)  # reclaims both cached pages
    got, use = idx.match(np.concatenate([prompt, [5]]), 32)
    return blocks, churn, got, use, idx.counters()


def test_index_prunes_evicted_entries(pools_cfg):
    jpool, tpool = _pools(pools_cfg, 4, 16)
    blocks, churn, got, use, counters = _prune_script(tpool, tkv,
                                                      pools_cfg[1])
    assert set(blocks) <= set(churn)
    assert counters["evictions"] >= 2
    assert use == 0 and got == [] and counters["misses"] == 1
    assert (blocks, churn, got, use, counters) == \
        _prune_script(jpool, jkv, pools_cfg[0])


def _index_fuzz(kv, pool, cfg, host_tier, seed):
    """Random admit / match / churn / release / gc steps over one index;
    every result, refcount and counter on the way. Tokens come from four
    prompt families sharing prefixes at page edges and mid-page, in a
    token range no other test uses (the host store is process-wide)."""
    rng = np.random.default_rng(seed)
    page = 8
    shape = (pool.num_blocks - 1, cfg.n_layers, page, cfg.n_kv_heads,
             cfg.d_head)
    pool.write_blocks(list(range(1, pool.num_blocks)),
                      rng.standard_normal(shape, np.float32),
                      rng.standard_normal(shape, np.float32))
    idx = kv.PrefixIndex(pool, page, token_bytes=kv.kv_token_bytes(cfg),
                         host_tier=host_tier)
    base = rng.integers(10_000, 20_000, 40).astype(np.int32)
    families = [base, base.copy(), base.copy(), base.copy()]
    families[1][12:] = rng.integers(10_000, 20_000, 28)   # mid-page split
    families[2][16:] = rng.integers(10_000, 20_000, 24)   # page-edge split
    families[3][:] = rng.integers(10_000, 20_000, 40)     # unrelated
    held, trace = [], []
    for step in range(150):
        op = rng.choice(["admit", "match", "churn", "drop", "gc"],
                        p=[0.25, 0.3, 0.12, 0.3, 0.03])
        if len(held) > 3:  # at most four live sequences
            op = "drop"
        fam = families[rng.integers(4)]
        toks = fam[:rng.integers(1, 41)]
        if op == "admit":
            blocks = pool.alloc(kv.pages_for(len(toks), page))
            if blocks is not None:
                idx.admit(toks, blocks)
                held.append(blocks)
            res = blocks
        elif op == "match":
            got, use = idx.match(toks, len(toks) - 1)
            held.append(got)
            res = (got, use)
        elif op == "churn":
            got = pool.alloc(int(rng.integers(1, 6)))
            if got is not None:
                pool.release(got)
            res = got
        elif op == "drop" and held:
            res = held.pop(int(rng.integers(len(held))))
            pool.release(res)
        elif op == "gc":
            res = idx.gc(max_age_s=-1 if rng.random() < 0.5 else 3600)
        else:
            res = None
        trace.append((step, str(op), res, idx.counters(), pool.stats(),
                      [pool.refcount(b) for b in range(pool.num_blocks)]))
    return trace


@pytest.mark.parametrize("seed", range(20))
@pytest.mark.parametrize("host_tier", [False, True],
                         ids=["hbm_only", "host_tier"])
def test_index_random_steps_match_jax(pools_cfg, host_tier, seed):
    """A random walk of admissions, matches, pool churn, releases and gc
    sweeps gives the reference's results step for step: block lists,
    matched lengths, refcounts, pool stats and every counter."""
    jpool, tpool = _pools(pools_cfg, 14, 8)
    seed = 31 + 2 * seed + host_tier
    got = _index_fuzz(tkv, tpool, pools_cfg[1], host_tier, seed)
    want = _index_fuzz(jkv, jpool, pools_cfg[0], host_tier, seed)
    for g, w in zip(got, want):
        assert g == w, f"step {g[0]}"
    assert sum(t[3]["hits"] for t in got[-1:]) > 0


# ---- engine: hits skip prefill, byte-exact, COW -----------------------------

ENGINE_KW = dict(max_batch_size=4, slots=4, max_queue_delay_us=2000,
                 max_prompt=48)
PREFIX_COUNTERS = ("kv_prefix_hits", "kv_prefix_misses",
                   "kv_prefix_bytes_shared", "kv_prefix_blocks_shared",
                   "kv_prefix_cow_copies")


def _run_engines(models, script, **kw):
    """``script(addr, generate)`` against the JAX engine, the port's
    engine and the port's uncached engine; their results and stats."""
    jcfg, jp, tcfg, tp = models
    kw = {**ENGINE_KW, **kw}
    out = {}
    for name, make, gen in (
            ("jax", lambda: jserving.ServingEngine(jp, jcfg, **kw),
             jserving.generate),
            ("port", lambda: serving.ServingEngine(tp, tcfg, device="cpu",
                                                   **kw), serving.generate),
            ("uncached", lambda: serving.ServingEngine(
                tp, tcfg, device="cpu", **{**kw, "prefix_cache": False}),
             serving.generate)):
        eng = make()
        try:
            res = script(f"127.0.0.1:{eng.port}", gen)
            out[name] = (res, _settled_stats(eng))
        finally:
            eng.close()
    return out


def _settled_stats(eng):
    """Stats once the engine has vacated every finished sequence: a
    client sees its terminal frame before the engine admits and releases
    the sequence's pages."""
    deadline = time.monotonic() + 30
    while eng.in_flight() and time.monotonic() < deadline:
        time.sleep(0.01)
    return eng.stats()


def test_prefix_hit_skips_prefill_byte_exact(models):
    prompt = list(range(1, 25))  # 24 tokens: 1 full page + 8 tail
    out = _run_engines(models, lambda addr, gen: [gen(addr, prompt, 10),
                                                  gen(addr, prompt, 10)])
    (jres, js), (tres, ts), (ures, _) = (out["jax"], out["port"],
                                          out["uncached"])
    assert tres == jres == ures
    assert ts["prefills"] == 1 and ts["resumes"] == 1
    assert ts["kv_prefix_hits"] == 1 and ts["kv_prefix_misses"] == 1
    assert ts["kv_prefix_bytes_shared"] > 0
    assert ts["kv_prefix_blocks_shared"] >= 2
    # The first run, once finished, left an entry on the prompt's tail
    # page that serves rows past the prompt (its decoded tokens); the
    # port copies that tail before the resend's decode writes those rows,
    # where the reference writes in place (ROADMAP §C 1). The other
    # counters are the reference's.
    assert ts["kv_prefix_cow_copies"] == js["kv_prefix_cow_copies"] + 1 == 1
    assert {k: ts[k] for k in PREFIX_COUNTERS
            if k != "kv_prefix_cow_copies"} == \
        {k: js[k] for k in PREFIX_COUNTERS if k != "kv_prefix_cow_copies"}


def test_cow_divergence_byte_exact(models):
    """Diverging mid-page and at a page boundary both match the uncached
    stream; the mid-page write into a page another live sequence still
    holds goes through a copy."""
    base = list(range(1, 19))            # 18 tokens: full page + 2 tail
    div_mid = base + [90, 91, 92, 93]    # shares 18 (mid-page)
    div_edge = base[:16] + [70, 71, 72]  # shares exactly one page

    def script(addr, gen):
        client = (serving.ServingClient if gen is serving.generate
                  else jserving.ServingClient)
        with client(addr, timeout_ms=60_000) as c:
            # keep `base` live so its tail page stays referenced
            it = c.generate(base, 24)
            first = next(it)
            got_mid = gen(addr, div_mid, 8)
            got_edge = gen(addr, div_edge, 8)
            rest = list(it)
        return [[first] + rest, got_mid, got_edge]

    out = _run_engines(models, script)
    (jres, js), (tres, ts), (ures, _) = (out["jax"], out["port"],
                                          out["uncached"])
    assert tres == jres == ures
    assert ts["kv_prefix_cow_copies"] >= 1
    assert ts["kv_prefix_hits"] >= 2
    assert ts["kv_prefix_cow_copies"] == js["kv_prefix_cow_copies"]


def test_decode_past_a_resumed_prompt_keeps_longer_entries():
    """A decode must not write a tail page's rows that an index entry of
    a longer prompt serves. p (ending mid-page) is cached; p + x + z
    resumes off it in place and leaves an entry on the same tail page;
    p + x resumes off p's entry (its rows agree with that longer entry)
    and then decodes past its prompt, into rows where the longer entry
    holds z. The resume copies that tail first, so a later p + x + z + w
    resuming off the longer entry streams what a cold prefill without
    the prefix cache streams. One case per head layout and seed."""
    for n_kv_heads in (4, 2):
        cfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                                  dtype=torch.float32, n_kv_heads=n_kv_heads)
        params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
        for seed in (0, 1):
            rng = np.random.default_rng(seed)
            p, x, z, w = (rng.integers(0, cfg.vocab, n).tolist()
                          for n in (20, 3, 5, 4))
            steps = ((p, 1), (p + x + z, 1), (p + x, 8), (p + x + z + w, 8))
            got = {}
            for cached in (True, False):
                eng = serving.ServingEngine(params, cfg, device="cpu",
                                            prefix_cache=cached, **ENGINE_KW)
                try:
                    addr = f"127.0.0.1:{eng.port}"
                    got[cached] = []
                    for prompt, n in steps:
                        got[cached].append(serving.generate(addr, prompt, n))
                        stats = _settled_stats(eng)
                finally:
                    eng.close()
                if cached:
                    assert stats["resumes"] == 3, (n_kv_heads, seed, stats)
                    assert stats["kv_prefix_cow_copies"] == 1, \
                        (n_kv_heads, seed, stats)
            assert got[True] == got[False], (n_kv_heads, seed)


def test_concurrent_identical_prompts_idempotent(models):
    prompt = list(range(2, 22))

    def script(addr, gen):
        results, mu = [], threading.Lock()

        def run():
            got = gen(addr, prompt, 8, timeout_ms=60_000)
            with mu:
                results.append(got)

        ts = [threading.Thread(target=run) for _ in range(3)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        return results + [gen(addr, prompt, 8)]

    out = _run_engines(models, script)
    (jres, _), (tres, ts), (ures, _) = (out["jax"], out["port"],
                                         out["uncached"])
    assert len(tres) == 4 and all(r == ures[0] for r in tres)
    assert tres == jres
    assert ts["kv_prefix_hits"] >= 1
    assert ts["kv_live_blocks"] == 0  # everything released after the swarm


@pytest.fixture
def empty_host_stores():
    """Empty both packages' host page stores (process-wide, keyed by
    tokens), so pages that other tests' engines exported in this process
    cannot reach the test's engines: shrink each store to one byte, which
    evicts every page, then give its budget back."""
    for rt in (jrt, runtime):
        budget = rt.kv_tier_stats()["kv_tier_budget_bytes"]
        rt.kv_host_configure(1)
        assert rt.kv_tier_stats()["kv_tier_host_pages"] == 0
        rt.kv_host_configure(budget)


def test_eviction_pressure_keeps_hot_prefix_correct(models,
                                                    empty_host_stores):
    """A pool far smaller than the working set churns cold pages out; the
    hot prompt stays exact whether its pages survived or not."""
    hot = list(range(1, 21))

    def script(addr, gen):
        out = []
        for i in range(6):
            out.append(gen(addr, hot, 6))
            gen(addr, [100 + i] * 20, 2)  # two pages of churn
        return out

    out = _run_engines(models, script, slots=2, kv_blocks=9)
    (jres, js), (tres, ts), (ures, _) = (out["jax"], out["port"],
                                          out["uncached"])
    assert tres == jres == ures
    assert ts["kv_prefix_evictions"] > 0 or ts.get("kv_tier_spills", 0) > 0
    assert ts["kv_alloc_failures"] == 0
    # Each of the 5 resends of the hot prompt resumes off a tail page on
    # which the previous run's finished sequence left an entry serving
    # rows past the prompt: the port copies that tail first (ROADMAP
    # §C 1), the reference writes in place. The other counters are the
    # reference's.
    assert ts["kv_prefix_hits"] == 5
    assert ts["kv_prefix_cow_copies"] == js["kv_prefix_cow_copies"] + 5
    assert {k: ts[k] for k in PREFIX_COUNTERS
            if k != "kv_prefix_cow_copies"} == \
        {k: js[k] for k in PREFIX_COUNTERS if k != "kv_prefix_cow_copies"}


def test_prefix_metrics_surface(models):
    """kv_prefix_{hits,misses,evictions,bytes_shared,blocks_shared} ride
    /vars and the metrics dump."""
    _, _, tcfg, tp = models
    eng = serving.ServingEngine(tp, tcfg, device="cpu", **ENGINE_KW)
    try:
        addr = f"127.0.0.1:{eng.port}"
        prompt = list(range(3, 23))
        serving.generate(addr, prompt, 4)
        serving.generate(addr, prompt, 4)
        m = runtime.metrics()
        via_http = jrt.http_vars(addr, "kv_prefix_")
    finally:
        eng.close()
    for name in ("kv_prefix_hits", "kv_prefix_misses",
                 "kv_prefix_evictions", "kv_prefix_bytes_shared",
                 "kv_prefix_blocks_shared"):
        assert name in m, name
        assert name in via_http, name
    assert m["kv_prefix_hits"] >= 1
    assert m["kv_prefix_bytes_shared"] > 0


def _splice_script(eng):
    """Drive ``_admit_prompt`` by hand: a splice on a miss, a cold
    admission, then a splice that skips the first token."""
    import struct

    prompt = list(range(5, 29))
    ch = runtime.Channel(f"127.0.0.1:{eng.port}", timeout_ms=30_000,
                         max_retry=0)

    def admit(**kw):
        rs = ch.open_stream_rx(serving.SERVICE, serving.METHOD_INTERACTIVE,
                               serving.encode_request(prompt, 3))
        (req_id, payload, _prio, rem), = eng.batcher.next_batch(
            max_items=1, wait_us=5_000_000)
        toks, _ = serving.decode_request(payload)
        return rs, eng._admit_prompt(req_id, toks, 3, rem, 0, **kw)

    def frames(rs):
        while eng.in_flight():  # decode the admitted sequence to its end
            eng.step(wait_us=0)
        out = []
        while True:
            msg = rs.read(timeout=30)
            if msg[:1] == b"d":
                out.append(struct.unpack("<I", msg[1:5])[0])
            elif msg[:1] == b"f":
                return out, struct.unpack("<I", msg[1:5])[0]

    try:
        trace = []
        for kw in ({"min_hit_tokens": 1}, {},
                   {"min_hit_tokens": 16, "emit_first": False}):
            rs, ok = admit(**kw)
            trace.append((ok, frames(rs), eng.prefills,
                          getattr(eng, "splice_rejects", 0)))
        return trace
    finally:
        ch.close()


def test_admit_prompt_splice_hooks(models):
    """The hooks the disaggregated decode worker uses, against the
    reference's: ``min_hit_tokens`` rejects a prompt whose cached prefix
    is shorter with EREJECT (and counts it), and ``emit_first=False``
    seats a hit without emitting the first token (the caller has sent
    it), whose stream then carries the tokens after it."""
    jcfg, jp, tcfg, tp = models
    runs = []
    for make in (lambda: serving.ServingEngine(tp, tcfg, device="cpu",
                                               autostart=False, **ENGINE_KW),
                 lambda: jserving.ServingEngine(jp, jcfg, autostart=False,
                                                **ENGINE_KW)):
        eng = make()
        try:
            runs.append(_splice_script(eng))
        finally:
            eng.close()
    (miss, cold, hit), want = runs
    assert miss == (False, ([], runtime.EREJECT), 0, 1)
    full = cold[1][0]
    assert cold[0] and cold[1][1] == 0 and len(full) == 3
    # the hit did not prefill; its stream skips the first token and the
    # first token does not count against max_new
    assert hit[0] and hit[2] == 1 and hit[1][1] == 0
    assert len(hit[1][0]) == 3 and hit[1][0][:2] == full[1:]
    assert runs[0] == want
