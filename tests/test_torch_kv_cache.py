"""The port's paged KV cache against brpc_tpu.kv_cache, on the CPU: block
accounting step for step, prefill pages and their wire bytes, and the
paged decode step (tiny float32 config and its grouped-query variant;
tolerance 1e-4 where values are computed, for summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import kv_cache as jkv
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import kv_cache as tkv
from brpc_tpu_torch.models import transformer as tt

TOL = dict(rtol=1e-4, atol=1e-4)


def _configs(n_kv_heads=4, jdtype=jnp.float32, tdtype=torch.float32):
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


# ---- block accounting ----------------------------------------------------------

def _state(pool):
    return (pool.stats(), list(pool._free), dict(pool._ref),
            list(pool._evictable), list(pool._version))


def _run(pool, script):
    """Apply (op, arg) steps; record every result and the pool state."""
    held = {}
    evicted = []
    pool.on_evict = evicted.extend
    trace = []
    for op, arg in script:
        if op == "alloc":
            name, n = arg
            res = pool.alloc(n)
            held[name] = res
        elif op == "release":
            res = pool.release(held[arg])
        elif op == "retain":
            try:
                res = pool.retain(held[arg])
            except ValueError:
                res = "ValueError"
        elif op == "try_retain":
            blk, ver = arg
            res = pool.try_retain(blk, ver)
        elif op == "probe":
            res = [(pool.refcount(b), pool.version(b),
                    pool.entry_alive(b, pool.version(b)))
                   for b in range(pool.num_blocks)]
        trace.append((op, res, _state(pool), list(evicted)))
    return trace


SCRIPTS = {
    # tests/test_kv_cache.py:32 — exhaust, fail, release, reclaim
    "exhaust_and_release": [
        ("alloc", ("a", 5)), ("alloc", ("b", 3)), ("alloc", ("c", 1)),
        ("release", "b"), ("alloc", ("d", 3)), ("probe", None)],
    # :48 — eviction takes the oldest released first
    "lru_oldest_first": [
        ("alloc", ("a", 2)), ("alloc", ("b", 2)), ("alloc", ("c", 4)),
        ("release", "a"), ("release", "b"), ("alloc", ("d", 2)),
        ("alloc", ("e", 2)), ("probe", None)],
    # :62 — a refcount pins blocks against eviction
    "refcount_pins": [
        ("alloc", ("a", 4)), ("retain", "a"), ("release", "a"),
        ("alloc", ("b", 4)), ("alloc", ("c", 1)), ("release", "a"),
        ("alloc", ("d", 1)), ("release", "d"), ("retain", "d"),
        ("probe", None)],
    # weak references: versions bump on reclaim, try_retain revives
    "versions_and_try_retain": [
        ("alloc", ("a", 3)), ("release", "a"), ("try_retain", (8, 0)),
        ("try_retain", (7, 0)), ("alloc", ("b", 6)), ("try_retain", (7, 0)),
        ("try_retain", (0, 0)), ("release", "b"), ("alloc", ("c", 8)),
        ("try_retain", (6, 0)), ("try_retain", (6, 1)), ("probe", None)],
}


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_pool_accounting_matches_jax(name):
    jcfg, tcfg = _configs()
    want = _run(jkv.PagedKvPool(jcfg, 9, 16), SCRIPTS[name])
    got = _run(tkv.PagedKvPool(tcfg, 9, 16, device="cpu"), SCRIPTS[name])
    assert got == want


def test_pool_rejects_page_not_dividing_max_seq():
    _, tcfg = _configs()
    with pytest.raises(ValueError):
        tkv.PagedKvPool(tcfg, 8, 24, device="cpu")  # 128 % 24 != 0


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.bfloat16, torch.bfloat16)])
def test_byte_sizes_match_jax(jdt, tdt):
    jcfg, tcfg = _configs(2, jdt, tdt)
    assert tkv.kv_token_bytes(tcfg) == jkv.kv_token_bytes(jcfg)
    assert tkv.host_page_bytes(tcfg, 16) == jkv.host_page_bytes(jcfg, 16)
    assert tcfg.wire_dtype == jkv.wire_dtype(jcfg)


def test_write_blocks_lands_pages_in_place():
    _, tcfg = _configs()
    pool = tkv.PagedKvPool(tcfg, 9, 16, device="cpu")
    ptr = pool.k.data_ptr()
    pages = torch.randn((2,) + tuple(pool.k.shape[1:]))
    pool.write_blocks([3, 7], pages, pages * 2)
    assert pool.k.data_ptr() == ptr
    assert torch.equal(pool.k[7], pages[1])
    assert torch.equal(pool.v[3], pages[0] * 2)
    assert not pool.k[[0, 1, 2, 4, 5, 6, 8]].any()


# ---- prefill pages and the wire codec ------------------------------------------

@pytest.mark.parametrize("length,bucket,page", [(5, 16, 16), (20, 32, 16),
                                                (5, 8, 16), (9, 16, 4)])
def test_prefill_pages_byte_identical_to_jax(models, length, bucket, page):
    """The same prefill KV cut into pages: byte-identical to the
    reference's pages, pad-token rows and zero rows included, and so are
    the encode_layer wire bytes. The port's own prefill KV agrees within
    the f32 tolerance (XLA and torch sum in other orders, so its bits need
    not match)."""
    jcfg, jp, tcfg, tp = models
    prompt = np.arange(3, 3 + length, dtype=np.int32)
    padded = np.pad(prompt, (0, bucket - length))
    _, jk, jv = jt.prefill(jp, jnp.asarray(padded), jnp.int32(length), jcfg)
    want_k, want_v = jkv.prefill_cache_pages(jk, jv, length, page)
    same_k = torch.from_numpy(np.array(jk)[:, :bucket])
    same_v = torch.from_numpy(np.array(jv)[:, :bucket])
    got_k, got_v = tkv.prefill_cache_pages(same_k, same_v, length, page)
    assert got_k.numpy().tobytes() == np.ascontiguousarray(want_k).tobytes()
    assert got_v.numpy().tobytes() == np.ascontiguousarray(want_v).tobytes()
    for layer in range(tcfg.n_layers):
        assert (tkv.encode_layer(same_k[layer], length, page, tcfg)
                == jkv.encode_layer(np.asarray(jk)[layer, :bucket], length,
                                    page, jcfg))
    _, tk, tv = tt.prefill(tp, torch.from_numpy(padded), length, tcfg)
    own_k, own_v = tkv.prefill_cache_pages(tk, tv, length, page)
    np.testing.assert_allclose(own_k.numpy(), want_k, **TOL)
    np.testing.assert_allclose(own_v.numpy(), want_v, **TOL)
    assert np.array_equal(own_k.numpy() == 0, want_k == 0)


def test_bf16_wire_bytes_identical_to_jax():
    jcfg, tcfg = _configs(2, jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(5).standard_normal((24, 2, 32), np.float32)
    want = jkv.encode_layer(jnp.asarray(x).astype(jnp.bfloat16), 20, 16,
                            jcfg)
    got = tkv.encode_layer(torch.from_numpy(x).to(torch.bfloat16), 20, 16,
                           tcfg)
    assert got == want
    back = tkv.decode_layer(np.frombuffer(want, np.uint8), 2, 16, tcfg)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.reshape(32, 2, 32)[:24],
                       torch.from_numpy(x).to(torch.bfloat16))
    with pytest.raises(ValueError):
        tkv.decode_layer(np.frombuffer(want, np.uint8), 3, 16, tcfg)


# ---- paged decode --------------------------------------------------------------

def test_paged_decode_fn_matches_jax(models):
    """Both pools hold the same pages; the port's step (in-place row write
    + attention through the tables) and the reference's jitted step
    (gather, vmapped decode_step, page scatter) give the same logits and
    write the same rows, across a page boundary (page 4)."""
    jcfg, jp, tcfg, tp = models
    page, nb = 4, tcfg.max_seq // 4
    prompts = [np.array([9, 2, 55], np.int32),
               np.array([7, 7, 1, 30, 2, 8, 40], np.int32)]
    jpool = jkv.PagedKvPool(jcfg, 2 * nb + 1, page)
    tpool = tkv.PagedKvPool(tcfg, 2 * nb + 1, page, device="cpu")
    tables = np.zeros((3, nb), np.int32)  # lane 2 stays inactive
    toks, pos, blocks = [0, 0, 0], [0, 0, 0], [[], []]
    for i, pr in enumerate(prompts):
        logits, k, v = jt.prefill(jp, jnp.asarray(np.pad(pr, (0, 8 - len(
            pr)))), jnp.int32(len(pr)), jcfg)
        kp, vp = jkv.prefill_cache_pages(k, v, len(pr), page)
        b = jpool.alloc(len(kp))
        assert tpool.alloc(len(kp)) == b
        jpool.write_blocks(b, kp, vp)
        tpool.write_blocks(b, torch.tensor(np.asarray(kp)),
                            torch.tensor(np.asarray(vp)))
        tables[i, :len(b)] = b
        blocks[i] = b
        toks[i], pos[i] = int(np.asarray(logits).argmax()), len(pr)
    jstep = jkv.paged_decode_fn(jcfg, page)
    tstep = tkv.paged_decode_fn(tcfg, page)
    for _ in range(3):
        for i in range(2):
            while len(blocks[i]) < pos[i] // page + 1:
                fresh = jpool.alloc(1)
                assert tpool.alloc(1) == fresh
                blocks[i] += fresh
                tables[i, len(blocks[i]) - 1] = fresh[0]
        want, jpool.k, jpool.v = jstep(
            jp, jnp.asarray(toks, jnp.int32), jnp.asarray(pos, jnp.int32),
            jnp.asarray(tables), jpool.k, jpool.v)
        got, tpool.k, tpool.v = tstep(
            tp, torch.tensor(toks, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), torch.from_numpy(tables),
            tpool.k, tpool.v)
        np.testing.assert_allclose(got[:2].numpy(), np.asarray(want)[:2],
                                   **TOL)
        for i in range(2):  # the row each active lane wrote
            blk, off = tables[i, pos[i] // page], pos[i] % page
            np.testing.assert_allclose(tpool.k[blk, :, off].numpy(),
                                       np.asarray(jpool.k)[blk, :, off],
                                       **TOL)
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
        pos = [pos[0] + 1, pos[1] + 1, 0]
