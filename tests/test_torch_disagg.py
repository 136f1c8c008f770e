"""The port's disaggregated serving on the CPU, against the JAX package:
the request codecs and the layer-streamed prefill against the reference's,
the KV transfer's claim, the port's router and workers against the JAX
greedy oracle (layer-wise and one-shot prefill, prefix reuse, splice,
local-skip adopt, peer pull, limiter shed, mid-stream re-dispatch), and
the mixed fleets: a JAX router over port workers, port prefill into a JAX
decode worker, and JAX prefill into a port decode worker. Tiny f32
configs, MHA and GQA, weights from the JAX package carried by
``params_from_numpy``.

Every test draws its prompts from its own seeded generator: the native
host page store is process-wide and keyed by token content, so tests of
one worker process must not share prompts."""

import dataclasses
import functools
import os
import struct
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import disagg as jdisagg
from brpc_tpu import kv_cache as jkv
from brpc_tpu import serving as jserving
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import disagg, kv_cache, runtime, serving
from brpc_tpu_torch.models import transformer as tt

# prefill_stream against the reference, f32: the port sums in another
# order than XLA, so K/V and logits agree within this, not bit for bit.
TOL = 1e-4
# Mixed-fleet legs decode from KV computed by the other implementation
# (within TOL of their own), so a greedy step whose top-2 logits sit
# closer than this could flip; the oracle's smallest top-1/top-2 margin
# along every compared stream must exceed it, so a near-tie fails loudly
# instead of flaking.
MIN_MARGIN = 1e-2
TIMEOUT_MS = 120_000


@functools.lru_cache(maxsize=None)
def _models(n_kv_heads: int):
    jcfg = dataclasses.replace(jt.TransformerConfig.tiny(), dtype=jnp.float32,
                               n_kv_heads=n_kv_heads)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                               dtype=torch.float32, n_kv_heads=n_kv_heads)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    fwd = jax.jit(functools.partial(jt.forward, cfg=jcfg))
    return jcfg, jp, tcfg, tp, fwd


def _oracle(n_kv_heads: int, prompt, n: int):
    """The JAX greedy rollout of ``n`` tokens (full forward at the tiny
    config's max_seq, which is causal, so the right padding is ignored)
    and its smallest top-1/top-2 logit margin."""
    jcfg, jp, _, _, fwd = _models(n_kv_heads)
    seq, out, margin = list(prompt), [], float("inf")
    for _ in range(n):
        toks = np.zeros((1, jcfg.max_seq), np.int32)
        toks[0, :len(seq)] = seq
        row = np.asarray(fwd(jp, jnp.asarray(toks))[0, len(seq) - 1])
        top2 = np.sort(row)[-2:]
        margin = min(margin, float(top2[1] - top2[0]))
        out.append(int(row.argmax()))
        seq.append(out[-1])
    return out, margin


def _prompts(seed: int, lengths):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n).tolist() for n in lengths]


def _concurrent(gen_fn, prompts):
    results, errors = {}, []

    def run(i, p):
        try:
            results[i] = gen_fn(p)
        except Exception as e:  # noqa: BLE001 — asserted below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(i, p))
               for i, p in enumerate(prompts)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=180)
    assert not errors, errors
    return [results[i] for i in range(len(prompts))]


def _read_stream(rs):
    """Drain a 'd'/'f' delivery stream -> (tokens, terminal status)."""
    toks = []
    while True:
        msg = rs.read(timeout=30)
        assert msg is not None, "stream died"
        if not msg:
            continue
        if msg[:1] == b"d":
            toks.append(struct.unpack("<I", msg[1:5])[0])
        elif msg[:1] == b"f":
            return toks, struct.unpack("<I", msg[1:5])[0]


def _addr(worker) -> str:
    return f"127.0.0.1:{worker.port}"


class _Fleet:
    """Port workers and router, closed together."""

    def __init__(self, n_kv_heads, n_prefill=1, n_decode=1, prefill_kw=(),
                 decode_kw=()):
        _, _, cfg, params, _ = _models(n_kv_heads)
        self.prefills = [disagg.PrefillWorker(params, cfg, device="cpu",
                                              **dict(prefill_kw))
                         for _ in range(n_prefill)]
        self.decodes = [disagg.DecodeWorker(params, cfg, slots=4,
                                            device="cpu", **dict(decode_kw))
                        for _ in range(n_decode)]
        self.router = disagg.DisaggRouter(
            [_addr(w) for w in self.prefills],
            [_addr(w) for w in self.decodes], worker_timeout_ms=TIMEOUT_MS)
        self.addr = _addr(self.router)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.router.close()
        for w in self.prefills + self.decodes:
            w.close()


# ---- wire ---------------------------------------------------------------------

def test_request_codecs_byte_identical_to_jax():
    prompt = [0, 7, 255, 2 ** 31 - 1, 42]
    cases = [
        (disagg.encode_prefill_request(0xDEADBEEF12345678, -1, prompt, 9,
                                       "127.0.0.1:4242"),
         jdisagg.encode_prefill_request(0xDEADBEEF12345678, -1, prompt, 9,
                                        "127.0.0.1:4242")),
        (disagg.encode_adopt_request(7, 123456, prompt, 99, 5),
         jdisagg.encode_adopt_request(7, 123456, prompt, 99, 5)),
        (disagg.encode_splice_request(-1, prompt, 4),
         jdisagg.encode_splice_request(-1, prompt, 4)),
        (disagg.encode_splice_request(500, prompt, 4, ["a:1", "bb:22"]),
         jdisagg.encode_splice_request(500, prompt, 4, ["a:1", "bb:22"])),
    ]
    for got, want in cases:
        assert got == want
    h, b, p, m, a = disagg.decode_prefill_request(cases[0][0])
    assert (h, b, p.tolist(), m, a) == (0xDEADBEEF12345678, -1, prompt, 9,
                                        "127.0.0.1:4242")
    h, b, p, last, left = disagg.decode_adopt_request(cases[1][0][1:])
    assert (h, b, p.tolist(), last, left) == (7, 123456, prompt, 99, 5)
    b, p, m, peers = disagg.decode_splice_request(cases[3][0][1:])
    assert (b, p.tolist(), m, peers) == (500, prompt, 4, ["a:1", "bb:22"])
    assert cases[1][0][0] == disagg.ADOPT_KIND_PAGES
    assert cases[2][0][0] == disagg.ADOPT_KIND_SPLICE
    # The reference decodes the port's bytes the same way.
    jb, jp_, jm, jpeers = jdisagg.decode_splice_request(cases[3][0][1:])
    assert (jb, jp_.tolist(), jm, jpeers) == (500, prompt, 4,
                                              ["a:1", "bb:22"])
    for bad in (b"\x00" * 3, cases[0][0][:-2]):
        with pytest.raises(ValueError):
            disagg.decode_prefill_request(bad)
    with pytest.raises(ValueError):
        disagg.decode_adopt_request(cases[1][0][1:-1])


# ---- model and KV transfer ------------------------------------------------------

@pytest.mark.parametrize("n_kv_heads", [4, 2], ids=["mha", "gqa"])
def test_prefill_stream_matches_jax(n_kv_heads):
    """Per-layer K/V and the logits of the layer-streamed prefill against
    the reference's (within TOL, f32), and its wire bytes against the page
    cut of the port's own prefill, byte for byte: a prompt shorter than
    its page span (zero rows) and one with pad rows."""
    jcfg, jp, tcfg, tp, _ = _models(n_kv_heads)
    page = 16
    for length in (5, 21):
        prompt = _prompts(length, [length])[0]
        padded = np.zeros(serving.prompt_bucket(length, 64), np.int32)
        padded[:length] = prompt
        jk, tk = [], []
        jlogits = jt.prefill_stream(
            jp, jnp.asarray(padded), length, jcfg,
            lambda l, k, v: jk.append((np.asarray(k), np.asarray(v))))
        tlogits = tt.prefill_stream(
            tp, torch.from_numpy(padded), length, tcfg,
            lambda l, k, v: tk.append((l, k, v)))
        assert [l for l, _, _ in tk] == list(range(tcfg.n_layers))
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits),
                                   atol=TOL, rtol=TOL)
        _, k_all, v_all = tt.prefill(tp, torch.from_numpy(padded), length,
                                     tcfg)
        k_pages, v_pages = kv_cache.prefill_cache_pages(k_all, v_all,
                                                        length, page)
        span = k_pages.shape[0] * page
        for (l, k, v), (jkl, jvl) in zip(tk, jk):
            np.testing.assert_allclose(k.numpy(), jkl, atol=TOL, rtol=TOL)
            np.testing.assert_allclose(v.numpy(), jvl, atol=TOL, rtol=TOL)
            for got, pages in ((k, k_pages), (v, v_pages)):
                wire = kv_cache.encode_layer(got, length, page, tcfg)
                cut = pages[:, l].reshape(span, *pages.shape[3:])
                assert wire == cut.numpy().tobytes()
                # The reference's codec gives the same bytes for this KV.
                assert wire == jkv.encode_layer(got.numpy(), length, page,
                                                jcfg)


def test_claim_into_pages_roundtrip():
    """Pages sent layer by layer through the port's KvSender come back
    from claim_into_pages block-major and equal; a transfer with another
    layer count is EREQUEST, and the claim is released either way."""
    _, _, cfg, _, _ = _models(2)
    page, length = 8, 19
    n = kv_cache.pages_for(length, page)
    gen = torch.Generator().manual_seed(5)
    shape = (n, cfg.n_layers, page, cfg.n_kv_heads, cfg.d_head)
    k_pages = torch.randn(shape, generator=gen)
    v_pages = torch.randn(shape, generator=gen)
    server = runtime.Server()
    server.start(0)
    ch = runtime.Channel(_addr(server), timeout_ms=10_000)
    try:
        def send(handle, layers):
            sender = runtime.KvSender(ch, handle, total_layers=2 * layers)
            for l in range(layers):
                for i, pages in enumerate((k_pages, v_pages)):
                    sender.send_layer(2 * l + i, pages[:, l].contiguous()
                                      .numpy().tobytes())
            sender.commit()
            return sender.bytes_sent

        handle = 0x5EED0001
        assert send(handle, cfg.n_layers) == 2 * k_pages.numel() * 4
        got_k, got_v = kv_cache.claim_into_pages(handle, length, page, cfg,
                                                 5_000)
        assert torch.equal(got_k, k_pages) and torch.equal(got_v, v_pages)
        with pytest.raises(runtime.RpcError):
            runtime.kv_recv_claim(handle, 0)  # released: gone

        handle = 0x5EED0002
        send(handle, cfg.n_layers - 1)
        with pytest.raises(runtime.RpcError) as e:
            kv_cache.claim_into_pages(handle, length, page, cfg, 5_000)
        assert e.value.code == runtime.EREQUEST
        with pytest.raises(runtime.RpcError):
            runtime.kv_recv_claim(handle, 0)
    finally:
        ch.close()
        server.stop()
        server.close()


# ---- port fleets ----------------------------------------------------------------

@pytest.mark.parametrize("layerwise,n_kv_heads",
                         [(True, 2), (False, 4)],
                         ids=["layerwise-gqa", "oneshot-mha"])
def test_port_fleet_streams_jax_oracle(layerwise, n_kv_heads):
    """Port router, one port prefill worker and two port decode workers:
    six concurrent mixed prompts stream the JAX oracle's tokens through a
    stock port client, and both decode workers adopt."""
    prompts = _prompts(10 + layerwise, [2, 5, 16, 17, 30, 9])
    with _Fleet(n_kv_heads, n_decode=2,
                prefill_kw={"layerwise": layerwise}) as f:
        got = _concurrent(
            lambda p: serving.generate(f.addr, p, 8, TIMEOUT_MS), prompts)
        pre = f.prefills[0].stats()
        adopts = [d.stats()["adopts"] for d in f.decodes]
        relayed = f.router.stats()["relayed_tokens"]
        # The receive pool's gauges ride /vars on a worker's data port.
        kv_vars = runtime.http_vars(_addr(f.decodes[0]), "kv_")
    for p, toks in zip(prompts, got):
        assert toks == _oracle(n_kv_heads, p, 8)[0]
    assert pre["prefills"] == 6 and pre["kv_sends_failed"] == 0
    assert pre["layers_streamed"] == (6 * 2 if layerwise else 0)
    assert pre["transfer_bytes"] > 0
    assert sum(adopts) == 6 and all(a > 0 for a in adopts), adopts
    assert relayed == 6 * 8
    assert kv_vars.get("kv_transfer_bytes", 0) > 0, kv_vars
    assert "kv_pages_in_use" in kv_vars and "kv_transfer_inflight" in kv_vars


def test_jax_router_over_port_workers():
    """The reference's router routes to port workers over the one wire;
    a stock JAX client gets the oracle's streams."""
    prompts = _prompts(20, [3, 18, 11])
    _, _, cfg, params, _ = _models(4)
    pw = disagg.PrefillWorker(params, cfg, device="cpu", layerwise=True)
    dw = disagg.DecodeWorker(params, cfg, slots=4, device="cpu")
    router = jdisagg.DisaggRouter([_addr(pw)], [_addr(dw)],
                                  worker_timeout_ms=TIMEOUT_MS)
    try:
        got = _concurrent(lambda p: jserving.generate(
            _addr(router), p, 6, TIMEOUT_MS), prompts)
        assert dw.stats()["adopts"] == 3
    finally:
        router.close()
        pw.close()
        dw.close()
    for p, toks in zip(prompts, got):
        assert toks == _oracle(4, p, 6)[0]


def test_port_prefill_into_jax_decode():
    """Pages a port prefill worker sends are adopted by a JAX decode
    worker (port router). The JAX worker decodes from the port's KV, so
    the oracle's margin must clear MIN_MARGIN."""
    prompts = _prompts(30, [4, 17, 25])
    jcfg, jp, tcfg, tp, _ = _models(2)
    pw = disagg.PrefillWorker(tp, tcfg, device="cpu", layerwise=True)
    jdw = jdisagg.DecodeWorker(jp, jcfg, slots=4)
    router = disagg.DisaggRouter([_addr(pw)], [_addr(jdw)],
                                 worker_timeout_ms=TIMEOUT_MS)
    try:
        got = _concurrent(lambda p: serving.generate(
            _addr(router), p, 6, TIMEOUT_MS), prompts)
        assert jdw.adopts == 3 and pw.prefills == 3
    finally:
        router.close()
        pw.close()
        jdw.close()
    for p, toks in zip(prompts, got):
        ref, margin = _oracle(2, p, 6)
        assert margin > MIN_MARGIN, f"near-tie in the oracle: {margin}"
        assert toks == ref


def test_jax_prefill_into_port_decode():
    """Pages a JAX prefill worker sends are adopted by a port decode
    worker (JAX router); the margin check as in the other mixed leg."""
    prompts = _prompts(40, [6, 16, 29])
    jcfg, jp, tcfg, tp, _ = _models(4)
    jpw = jdisagg.PrefillWorker(jp, jcfg)
    dw = disagg.DecodeWorker(tp, tcfg, slots=4, device="cpu")
    router = jdisagg.DisaggRouter([_addr(jpw)], [_addr(dw)],
                                  worker_timeout_ms=TIMEOUT_MS)
    try:
        got = _concurrent(lambda p: jserving.generate(
            _addr(router), p, 6, TIMEOUT_MS), prompts)
        assert dw.stats()["adopts"] == 3
    finally:
        router.close()
        jpw.close()
        dw.close()
    for p, toks in zip(prompts, got):
        ref, margin = _oracle(4, p, 6)
        assert margin > MIN_MARGIN, f"near-tie in the oracle: {margin}"
        assert toks == ref


# ---- prefix reuse, splice and local skips ---------------------------------------

def test_prefill_worker_prefix_reuse_byte_exact():
    """The layer-wise prefill worker caches its pages, so a repeated
    prompt and one sharing its first page prefill only their suffix (K4
    path, pages streamed out of the pool): byte-exact either way."""
    base = _prompts(50, [24])[0]  # a full page and a tail
    other = base[:16] + _prompts(51, [2])[0]
    with _Fleet(2, prefill_kw={"layerwise": True}) as f:
        a = serving.generate(f.addr, base, 6, TIMEOUT_MS)
        b = serving.generate(f.addr, base, 6, TIMEOUT_MS)
        c = serving.generate(f.addr, other, 6, TIMEOUT_MS)
        pw = f.prefills[0]
        hits, shared = pw.prefix_hits, pw.prefix.bytes_shared
    assert a == _oracle(2, base, 6)[0] and b == a
    assert c == _oracle(2, other, 6)[0]
    assert hits >= 2 and shared > 0


def test_prefill_worker_resume_keeps_other_entries_pages():
    """A prompt p, then p + x and p + y one after another: with nothing
    holding p's pages, p + x's resume writes into p's mid-page tail block
    in place, and its admitted page then lives on that block too. p + y's
    resume must copy the block rather than overwrite rows that page
    serves, or p + x sent again reads p + y's K/V (the reference writes in
    place and streams wrong tokens here)."""
    p0, x, y = _prompts(55, [40, 10, 23])
    with _Fleet(4, prefill_kw={"layerwise": True}) as f:
        got = [serving.generate(f.addr, prompt, 8, TIMEOUT_MS)
               for prompt in (p0, p0 + x, p0 + y, p0 + x + [7, 8])]
        pw = f.prefills[0]
        hits, cows = pw.prefix_hits, pw.prefix.cow_copies
    for prompt, toks in zip((p0, p0 + x, p0 + y, p0 + x + [7, 8]), got):
        assert toks == _oracle(4, prompt, 8)[0]
    assert hits == 3 and cows >= 1


def test_splice_hit_and_ereject():
    """A decode worker holding a prompt's adopted pages serves a direct
    splice of it off its cache (the whole stream, first token included);
    a prompt it does not hold gets a terminal EREJECT."""
    held, cold = _prompts(60, [21, 21])
    with _Fleet(4) as f:
        first = serving.generate(f.addr, held, 6, TIMEOUT_MS)
        dw = f.decodes[0]
        deadline = time.monotonic() + 30
        while dw.in_flight() and time.monotonic() < deadline:
            time.sleep(0.01)
        ch = runtime.Channel(_addr(dw), timeout_ms=30_000)
        try:
            rs = ch.open_stream_rx(disagg.DECODE_SERVICE,
                                   disagg.DECODE_METHOD,
                                   disagg.encode_splice_request(-1, held, 6))
            hit = _read_stream(rs)
            rs.close()
            rs = ch.open_stream_rx(disagg.DECODE_SERVICE,
                                   disagg.DECODE_METHOD,
                                   disagg.encode_splice_request(-1, cold, 6))
            miss = _read_stream(rs)
            rs.close()
        finally:
            ch.close()
        s = dw.stats()
    assert first == _oracle(4, held, 6)[0]
    assert hit == (first, 0)
    assert miss == ([], runtime.EREJECT)
    assert s["splices"] == 1 and s["splice_rejects"] == 1


def test_adopt_skips_claim_when_local_tiers_cover():
    """tests/test_tier.py:373's twin: an adopt whose prompt the decode
    worker's own cache covers resumes off it, never claims (the handle
    never transferred), and streams the oracle's continuation."""
    prompt = _prompts(70, [18])[0]
    ref = _oracle(4, prompt, 6)[0]
    _, _, cfg, params, _ = _models(4)
    page = 8
    dw = disagg.DecodeWorker(params, cfg, kv_page_tokens=page,
                             max_batch_size=2, slots=2, device="cpu")
    try:
        P = len(prompt)
        padded = np.zeros(serving.prompt_bucket(P, cfg.max_seq // 2),
                          np.int32)
        padded[:P] = prompt
        _, k, v = tt.prefill(params, torch.from_numpy(padded), P, cfg)
        blocks = dw.pool.alloc(kv_cache.pages_for(P, page))
        dw.pool.write_blocks(blocks,
                             *kv_cache.prefill_cache_pages(k, v, P, page))
        dw.prefix.admit(np.asarray(prompt, np.int32), blocks)
        dw.pool.release(blocks)
        req = disagg.encode_adopt_request(0xDEAD_BEE5, -1, prompt,
                                          last_token=ref[0],
                                          left=len(ref) - 1)
        ch = runtime.Channel(_addr(dw), timeout_ms=30_000)
        rs = ch.open_stream_rx(disagg.DECODE_SERVICE, disagg.DECODE_METHOD,
                               req)
        toks = _read_stream(rs)
        rs.close()
        ch.close()
        assert toks == (ref[1:], 0)
        assert dw.adopt_local_skips == 1 and dw.adopts == 1
        assert dw.adopt_failures == 0
    finally:
        dw.close()


_JAX_PEER_SRC = """
import dataclasses, sys
import numpy as np
import jax
import jax.numpy as jnp
from brpc_tpu import kv_cache, runtime, serving
from brpc_tpu.models import transformer

cfg = dataclasses.replace(transformer.TransformerConfig.tiny(),
                          dtype=jnp.float32)
params = transformer.init_params(cfg, jax.random.PRNGKey(0))
page = 8
prompt = np.asarray([int(t) for t in sys.argv[1].split(",")], np.int32)
pool = kv_cache.PagedKvPool(cfg, cfg.max_seq // page + 1, page)
idx = kv_cache.PrefixIndex(pool, page,
                           token_bytes=kv_cache.kv_token_bytes(cfg),
                           host_tier=True)
P = len(prompt)
padded = np.zeros(serving.prompt_bucket(P, cfg.max_seq // 2), np.int32)
padded[:P] = prompt
_l, k, v = transformer.prefill(params, jnp.asarray(padded), jnp.int32(P),
                               cfg)
blocks = pool.alloc(kv_cache.pages_for(P, page))
kp, vp = kv_cache.prefill_cache_pages(k, v, P, page)
pool.write_blocks(blocks, kp, vp)
idx.admit(prompt, blocks)   # exports every page to the host store
pool.release(blocks)
srv = runtime.Server()
port = srv.start(0)
print(f"READY {port}", flush=True)
while sys.stdin.read(1):
    pass
srv.stop(); srv.close()
"""


def test_peer_pull_from_jax_peer_then_dead_peer():
    """tests/test_tier.py:315's twin across packages: a port decode worker
    whose tiers miss a prompt pulls its pages from a JAX-package peer
    process's host store, then serves a splice off them that streams the
    JAX oracle's tokens (margin-checked: the prefix KV is JAX's). A
    killed peer degrades the next fill to 0 pages."""
    prompt = _prompts(80, [18])[0]  # 2 full pages and a tail at page 8
    ref, margin = _oracle(4, prompt, 5)
    assert margin > MIN_MARGIN, f"near-tie in the oracle: {margin}"
    _, _, cfg, params, _ = _models(4)
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    peer = subprocess.Popen(
        [sys.executable, "-c", _JAX_PEER_SRC, ",".join(map(str, prompt))],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=repo,
        env=env)
    dw = None
    try:
        line = peer.stdout.readline().strip()
        assert line.startswith("READY "), line
        peer_addr = f"127.0.0.1:{line.split()[1]}"
        dw = disagg.DecodeWorker(params, cfg, kv_page_tokens=8,
                                 max_batch_size=2, slots=2, device="cpu")
        p = np.asarray(prompt, np.int32)
        assert len(dw.prefix.plan_peer_fill(p, len(prompt) - 1)) == 2
        assert dw._peer_fill(p, [peer_addr]) == 2
        assert dw.peer_fill_pages == 2
        ch = runtime.Channel(_addr(dw), timeout_ms=30_000)
        rs = ch.open_stream_rx(disagg.DECODE_SERVICE, disagg.DECODE_METHOD,
                               disagg.encode_splice_request(-1, prompt, 5))
        toks = _read_stream(rs)
        rs.close()
        ch.close()
        assert toks == (ref, 0)
        assert dw.splices == 1

        peer.kill()
        peer.wait(timeout=10)
        dw.prefix.gc(max_age_s=-1)  # forget everything local
        for i in range(2):
            runtime.kv_host_drop(kv_cache.page_key(p[:(i + 1) * 8], 8))
        assert dw._peer_fill(p, [peer_addr]) == 0
    finally:
        if dw is not None:
            dw.close()
        peer.kill()
        peer.wait(timeout=10)


# ---- admission and faults ---------------------------------------------------------

def test_elimit_shed_bounces_to_sibling_prefill():
    """A port prefill worker under a tight limiter sheds with ELIMIT; the
    port router re-routes to its sibling, so every client completes with
    the oracle's stream."""
    _, _, cfg, params, _ = _models(2)
    limited = disagg.PrefillWorker(params, cfg, limiter="constant=1",
                                   device="cpu")
    open_ = disagg.PrefillWorker(params, cfg, limiter="", device="cpu")
    dw = disagg.DecodeWorker(params, cfg, slots=8, device="cpu")
    router = disagg.DisaggRouter([_addr(limited), _addr(open_)], [_addr(dw)],
                                 worker_timeout_ms=TIMEOUT_MS)
    prompts = _prompts(90, [2] * 6)
    try:
        got = _concurrent(lambda p: serving.generate(
            _addr(router), p, 4, TIMEOUT_MS), prompts)
        shed = limited.batcher.stats()["rejected_limit"]
        re_prefills = router.re_prefills
    finally:
        router.close()
        limited.close()
        open_.close()
        dw.close()
    for p, toks in zip(prompts, got):
        assert toks == _oracle(2, p, 4)[0]
    assert shed >= 1 and re_prefills >= 1


def test_router_admission_rejects():
    """A malformed request is EREQUEST; a tenant past its token budget is
    shed with a retriable ELIMIT before any dispatch (its first request,
    larger than the burst, admits once into debt); a router over a
    registry that does not answer raises the registry's error after its
    membership wait, with the reference's errno."""
    prompt = _prompts(95, [5])[0]
    with _Fleet(4) as f:
        ch = runtime.Channel(f.addr, timeout_ms=5000, max_retry=0)
        rs = ch.open_stream_rx(serving.SERVICE, serving.METHOD_INTERACTIVE,
                               b"\x01")
        assert _read_stream(rs) == ([], runtime.EREQUEST)
        rs.close()
        ch.close()
        f.router.tenants.set_budget("t", rate=0.01, burst=1)
        with serving.ServingClient(f.addr, timeout_ms=TIMEOUT_MS,
                                   tenant="t") as c:
            assert list(c.generate(prompt, 4)) == _oracle(4, prompt, 4)[0]
            with pytest.raises(runtime.RpcError) as e:
                list(c.generate(prompt, 4))
        assert e.value.code == runtime.ELIMIT
        assert "retry_after_ms=" in e.value.text
        assert f.router.shed_tenant == 1
    codes = []
    for pkg in (disagg, jdisagg):
        with pytest.raises(RuntimeError) as e:
            pkg.DisaggRouter(registry="127.0.0.1:1", membership_wait_s=0.2)
        codes.append(e.value.code)
    assert codes[0] == codes[1] and codes[0] in runtime.RETRIABLE_ERRNOS, \
        codes


def test_decode_worker_closed_midstream_redispatches():
    """The decode worker serving a stream is closed after the client has
    read three tokens: the router re-prefills onto the other decode
    worker, suppresses what the client already has, and the client's
    stream is the oracle's, with no duplicate."""
    prompt = _prompts(100, [10])[0]
    n = 60
    with _Fleet(2, n_decode=2) as f:
        for dw in f.decodes:  # a step every few ms: a window to close in
            def slow_step(wait_us=50_000, _step=dw.step):
                time.sleep(0.005)
                return _step(wait_us)
            dw.step = slow_step
        toks = []
        with serving.ServingClient(f.addr, timeout_ms=TIMEOUT_MS) as c:
            it = c.generate(prompt, n)
            for _ in range(3):
                toks.append(next(it))
            busy = [dw for dw in f.decodes if dw.in_flight()]
            assert len(busy) == 1
            busy[0].close()
            toks += list(it)
        s = f.router.stats()
    assert toks == _oracle(2, prompt, n)[0]
    assert s["resumed_streams"] >= 1 and s["re_prefills"] >= 1
    assert s["relayed_tokens"] == n
