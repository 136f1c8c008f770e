"""The port's serving engine on the CPU, against the JAX package: greedy
streams through stock JAX clients and the port's own client equal the JAX
greedy oracle and the JAX engine's streams (tiny float32 config and its
grouped-query variant), plus continuous batching, deadline culling,
admission limits and the wire codec, mirroring tests/test_serving.py."""

import dataclasses
import struct
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import serving as jserving
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import runtime, serving
from brpc_tpu_torch.models import transformer as tt

PROMPTS = [[5, 11, 23], [1, 2, 3, 4, 5, 6, 7, 8, 9], [200],
           [17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17, 17]]
NEW_TOKENS = 6


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def models(request):
    jcfg = dataclasses.replace(jt.TransformerConfig.tiny(), dtype=jnp.float32,
                               n_kv_heads=request.param)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                               dtype=torch.float32, n_kv_heads=request.param)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


def _jax_greedy(fwd, jp, prompt, n, width=32):
    """tests/test_serving.py:84's oracle, greedy rollout via the JAX full
    forward, jitted once at a fixed width: the forward is causal, so the
    logits at the last real position ignore the right padding."""
    seq, out = list(prompt), []
    for _ in range(n):
        toks = np.zeros((1, width), np.int32)
        toks[0, :len(seq)] = seq
        logits = fwd(jp, jnp.asarray(toks))
        out.append(int(np.asarray(logits[0, len(seq) - 1]).argmax()))
        seq.append(out[-1])
    return out


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
        t.join(timeout=120)
    assert not errors, errors
    return [results[i] for i in range(len(prompts))]


@pytest.fixture(scope="module")
def jax_streams(models):
    """The JAX oracle's and the JAX engine's streams for PROMPTS."""
    from functools import partial

    jcfg, jp, _, _ = models
    fwd = jax.jit(partial(jt.forward, cfg=jcfg))
    oracle = [_jax_greedy(fwd, jp, p, NEW_TOKENS) for p in PROMPTS]
    eng = jserving.ServingEngine(jp, jcfg, max_batch_size=4, slots=4,
                                 max_prompt=16)
    try:
        addr = f"127.0.0.1:{eng.port}"
        engine = _concurrent(
            lambda p: jserving.generate(addr, p, NEW_TOKENS, 60_000),
            PROMPTS)
    finally:
        eng.close()
    return oracle, engine


@pytest.fixture()
def engine(models):
    _, _, tcfg, tp = models
    eng = serving.ServingEngine(tp, tcfg, max_batch_size=4,
                                max_queue_delay_us=2000, slots=4,
                                max_prompt=16, device="cpu")
    yield eng
    eng.close()


@pytest.mark.parametrize("client", ["jax_client", "port_client"])
def test_streams_match_jax_oracle_and_engine(engine, jax_streams, client):
    oracle, jax_engine = jax_streams
    addr = f"127.0.0.1:{engine.port}"
    gen = jserving.generate if client == "jax_client" else serving.generate
    got = _concurrent(lambda p: gen(addr, p, NEW_TOKENS, 60_000), PROMPTS)
    assert got == oracle
    assert got == jax_engine
    s = engine.stats()
    assert s["prefills"] == len(PROMPTS)
    assert s["tokens_out"] == len(PROMPTS) * NEW_TOKENS


def test_port_oracle_matches_jax_oracle(models, jax_streams):
    _, _, tcfg, tp = models
    oracle, _ = jax_streams
    got = [tt.greedy_reference(tp, tcfg, p, NEW_TOKENS, device="cpu")
           for p in PROMPTS]
    assert got == oracle


def test_generate_streams_first_token_before_completion(engine):
    events = []
    with serving.ServingClient(f"127.0.0.1:{engine.port}",
                               timeout_ms=30_000) as client:
        toks = list(client.generate([5, 11, 23], 6, on_first_token=lambda:
                                    events.append(time.monotonic())))
        done = time.monotonic()
    assert len(toks) == 6
    assert len(events) == 1 and events[0] < done


def test_concurrent_clients_share_batches(engine):
    """Continuous batching: concurrent generations overlap in the decode
    batch, so mean occupancy exceeds 1.5 sequences per step."""
    addr = f"127.0.0.1:{engine.port}"
    out = _concurrent(lambda p: serving.generate(addr, p, 24, 60_000),
                      [[1 + i, 2 + i] for i in range(8)])
    assert all(len(t) == 24 for t in out)
    s = engine.stats()
    assert s["mean_batch_occupancy"] > 1.5, s
    assert s["model_steps"] < 8 * 24
    assert s["decode_seconds"] > 0 and s["prefill_seconds"] > 0


def test_expired_queued_request_culled_without_model_step(models):
    _, _, tcfg, tp = models
    eng = serving.ServingEngine(tp, tcfg, max_batch_size=4, slots=4,
                                max_prompt=16, autostart=False, device="cpu")
    try:
        client = serving.ServingClient(f"127.0.0.1:{eng.port}",
                                       timeout_ms=200)
        gen = client.generate([1, 2, 3], 4)
        time.sleep(0.4)  # nobody runs the engine while the budget burns
        assert eng.step(wait_us=200_000) == 0
        with pytest.raises(runtime.RpcError) as ei:
            next(gen)
        assert ei.value.code == runtime.ERPCTIMEDOUT
        s = eng.stats()
        assert s["culled_deadline"] >= 1
        assert s["model_steps"] == 0 and s["prefills"] == 0
        client.close()
    finally:
        eng.close()


def test_queue_full_rejected_with_elimit(models):
    _, _, tcfg, tp = models
    eng = serving.ServingEngine(tp, tcfg, max_batch_size=2, slots=2,
                                max_prompt=16, max_queue_len=1,
                                autostart=False, device="cpu")
    try:
        ch = runtime.Channel(f"127.0.0.1:{eng.port}", timeout_ms=5000,
                             max_retry=0)
        first = ch.open_stream_rx(serving.SERVICE,
                                  serving.METHOD_INTERACTIVE,
                                  serving.encode_request([1], 2))
        deadline = time.monotonic() + 5
        while (eng.batcher.stats()["queue_depth"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        with pytest.raises(runtime.RpcError) as ei:
            ch.open_stream_rx(serving.SERVICE, serving.METHOD_INTERACTIVE,
                              serving.encode_request([1], 2))
        assert ei.value.code == runtime.ELIMIT
        first.close()
        ch.close()
    finally:
        eng.close()


def test_bad_request_rejected(models):
    """A torn request body ends its stream with EREQUEST. The engine steps
    by hand after the stream is open: finishing a request before the
    batcher has accepted its stream fails the opening RPC instead."""
    _, _, tcfg, tp = models
    eng = serving.ServingEngine(tp, tcfg, max_batch_size=2, slots=2,
                                max_prompt=16, autostart=False, device="cpu")
    try:
        ch = runtime.Channel(f"127.0.0.1:{eng.port}", timeout_ms=5000,
                             max_retry=0)
        rs = ch.open_stream_rx(serving.SERVICE, serving.METHOD_INTERACTIVE,
                               b"\x01")  # torn header
        assert eng.step(wait_us=1_000_000) == 0
        msg = rs.read(timeout=10)
        assert msg is not None and msg[:1] == b"f"
        assert struct.unpack("<I", msg[1:5])[0] == runtime.EREQUEST
        rs.close()
        ch.close()
    finally:
        eng.close()


@pytest.mark.parametrize("option", ["prefix_cache", "kv_host_tier"])
def test_prefix_cache_options_name_the_next_slice(models, option):
    _, _, tcfg, tp = models
    with pytest.raises(NotImplementedError, match="next slice"):
        serving.ServingEngine(tp, tcfg, autostart=False, device="cpu",
                              **{option: True})


@pytest.mark.parametrize("args", [
    ([1, 2, 3], 4, "", "", ""), ([], 1, "acme", "", ""),
    ([7] * 9, 2, "", "batch", ""), ([65535, 0], 3, "t", "standard", "m8b")])
def test_wire_codec_matches_jax(args):
    body = serving.encode_request(*args)
    assert body == jserving.encode_request(*args)
    got = serving.decode_request_meta(body)
    want = jserving.decode_request_meta(body)
    assert [g.tolist() if isinstance(g, np.ndarray) else g for g in got] \
        == [w.tolist() if isinstance(w, np.ndarray) else w for w in want]
    tier = args[3]
    assert serving.tier_lane(tier) == jserving.tier_lane(tier)
    assert serving.tier_code(tier) == jserving.tier_code(tier)
    for n in (1, 8, 9, 100, 5000):
        assert serving.prompt_bucket(n, 1024) == jserving.prompt_bucket(n,
                                                                        1024)
