"""The port's worker processes and DisaggCluster on the CPU, against the JAX
package: the flat weight names and model configs, a worker process that
cold-starts over TPS1 from a JAX ParamServer, one that has no weights
source, a port cluster mirroring tests/test_disagg.py's cluster tests, a
JAX router over the port's worker processes, and the Admin RPCs of a worker
process. Tiny f32 configs; weights from the JAX package, served as numpy.

Each test draws its own prompts: the native host page store is one per
process and keyed by token content, not by model."""

import dataclasses
import functools
import os
import subprocess
import sys
import threading
import time
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import disagg as jdisagg
from brpc_tpu import param_server as jps
from brpc_tpu import serving as jserving
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import disagg, runtime, serving
from brpc_tpu_torch.models import transformer as tt

TIMEOUT_MS = 120_000
# §C 2 of ROADMAP: where a stream's margin is this thin, two correct
# implementations may pick different tokens, so such a leg fails loudly.
MIN_MARGIN = 1e-2


@functools.lru_cache(maxsize=None)
def _jax_model(cfg_name: str, seed: int):
    """(cfg, params, flat numpy weights, jitted forward) of a reference
    model: the JAX package's config of that name in f32."""
    jcfg = dataclasses.replace(
        jt.TransformerConfig.tiny() if cfg_name == "tiny"
        else jt.TransformerConfig(vocab=256, d_model=128, n_layers=2,
                                  n_heads=4, n_kv_heads=4, d_ff=256,
                                  max_seq=256),
        dtype=jnp.float32)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(seed))
    flat = jdisagg._flatten_params(jp)
    return jcfg, jp, flat, jax.jit(functools.partial(jt.forward, cfg=jcfg))


def _oracle(model, prompt, n: int, params=None):
    """The JAX greedy rollout of ``n`` tokens and its smallest top-1/top-2
    logit margin."""
    jcfg, jp, _, fwd = _jax_model(*model)
    params = jp if params is None else params
    seq, out, margin = list(prompt), [], float("inf")
    for _ in range(n):
        toks = np.zeros((1, jcfg.max_seq), np.int32)
        toks[0, :len(seq)] = seq
        row = np.asarray(fwd(params, jnp.asarray(toks))[0, len(seq) - 1])
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
    assert not any(t.is_alive() for t in threads), "hung client stream"
    assert not errors, errors
    return [results[i] for i in range(len(prompts))]


def _spawn(*argv, env=None):
    """A port worker process; returns (process, its first stdout line)."""
    p = subprocess.Popen([sys.executable, "-c", disagg._WORKER_SRC, *argv],
                         stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                         text=True, env=env)
    return p, p.stdout.readline().strip()


def _wait_status(c, addr, pred, what: str, timeout_s: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout_s
    while True:
        st = c.worker_status(addr)
        if pred(st):
            return st
        assert time.monotonic() < deadline, f"{what}: status {st}"
        time.sleep(0.05)


@pytest.fixture(scope="module")
def cluster():
    """1 prefill + 2 decode port worker processes serving the JAX tiny
    model's weights (seed 0), behind the port's router."""
    flat = _jax_model("tiny", 0)[2]
    with disagg.DisaggCluster(1, 2, f32=True, device="cpu",
                              weights={"": flat},
                              worker_timeout_ms=TIMEOUT_MS) as c:
        yield c


def test_flat_names_model_cfgs_and_load_fn_match_jax(monkeypatch):
    """_flatten_params / _unflatten_params give the reference's names on
    the port's own params; _model_cfg the reference's shapes, f32 under
    BRPC_TPU_F32; 'llama3_8b' is the port's one added name (the reference
    falls through to its default shape). series_tail and the load
    function's keys are the reference's."""
    jcfg, jp, jflat, _ = _jax_model("tiny", 0)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                               dtype=torch.float32)
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    tflat = disagg._flatten_params(tp)
    assert sorted(tflat) == sorted(jflat)
    for k, v in jflat.items():
        assert np.array_equal(tflat[k].numpy(), v), k
    assert sorted(disagg._flatten_params(disagg._unflatten_params(tflat))) \
        == sorted(jflat)
    assert disagg._flatten_params(jax.tree.map(np.asarray, jp)).keys() \
        == jflat.keys()
    fields = ("vocab", "d_model", "n_layers", "n_heads", "n_kv_heads",
              "d_ff", "max_seq", "rope_theta", "norm_eps")
    for f32 in (False, True):
        if f32:
            monkeypatch.setenv("BRPC_TPU_F32", "1")
        for name in ("tiny", "mid", "deep", "other"):
            t, j = disagg._model_cfg(name), jdisagg._model_cfg(name)
            for f in fields:
                assert getattr(t, f) == getattr(j, f), (name, f)
            assert str(t.dtype).removeprefix("torch.") \
                == jnp.dtype(j.dtype).name, (name, f32)
        llama = disagg._model_cfg("llama3_8b")
        assert (llama.d_model, llama.n_layers, llama.vocab) == (4096, 32,
                                                                128256)
        assert llama.dtype == (torch.float32 if f32 else torch.bfloat16)
        assert jdisagg._model_cfg("llama3_8b").d_model == 512
    m = {"serving_ttft_us_latency_p99": 1234.0, "kv_tier_spills": 2.0,
         "unrelated": 9.0}
    assert disagg.series_tail(m) == jdisagg.series_tail(m)
    dw = disagg.DecodeWorker(tp, tcfg, slots=2, device="cpu")
    jdw = jdisagg.DecodeWorker(jp, jcfg, slots=2)
    try:
        load = disagg._worker_load_fn(dw, "tiny")()
        assert load.keys() == jdisagg._worker_load_fn(jdw, "tiny")().keys()
        assert (load["model"], load["state"], load["queue_depth"]) \
            == ("tiny", "", 0)
    finally:
        dw.close()
        jdw.close()
    # A worker's launch tally reaches the process's app counters.
    before = runtime.app_counter_add("torch_launches_test_kernel")
    worker = types.SimpleNamespace(launches={"test_kernel": 3},
                                   _published={}, device=torch.device("cpu"))
    disagg._publish_counters(worker)
    worker.launches["test_kernel"] = 5
    disagg._publish_counters(worker)
    assert runtime.app_counter_add("torch_launches_test_kernel") \
        == before + 5


def test_worker_process_cold_starts_from_jax_param_server():
    """Port prefill and decode worker processes (--device cpu) pull their
    weights from the JAX package's ParamServer at start-up, count the
    fetch on /vars, and stream the JAX oracle's tokens through the port's
    router."""
    model = ("tiny", 0)
    flat = _jax_model(*model)[2]
    blob_bytes = len(jps.encode_arrays(flat))
    ps = jps.ParamServer(flat)
    procs, router = [], None
    try:
        params = f"m=127.0.0.1:{ps.start(0)}"
        addrs = {}
        for role in ("prefill", "decode"):
            p, line = _spawn("--role", role, "--cfg", "tiny", "--model", "m",
                             "--params", params, "--device", "cpu",
                             "--slots", "4",
                             env={**os.environ, "BRPC_TPU_F32": "1"})
            procs.append(p)
            assert line.startswith("READY "), (role, line)
            addrs[role] = f"127.0.0.1:{line.split()[1]}"
        for addr in addrs.values():
            v = runtime.http_vars(addr, "cluster_model_fetch")
            assert v["cluster_model_fetch_wire_bytes"] == blob_bytes, v
            assert v["cluster_model_fetch_effective_bytes"] == sum(
                a.nbytes for a in flat.values()), v
            assert v["cluster_model_fetch_groups"] == 1, v
        router = disagg.DisaggRouter([addrs["prefill"]], [addrs["decode"]],
                                     worker_timeout_ms=TIMEOUT_MS)
        prompts = _prompts(50, [3, 17, 30])
        got = _concurrent(lambda p: serving.generate(
            f"127.0.0.1:{router.port}", p, 6, TIMEOUT_MS), prompts)
    finally:
        if router is not None:
            router.close()
        for p in procs:
            p.kill()
            p.wait(timeout=10)
        ps.close()
    for p, toks in zip(prompts, got):
        assert toks == _oracle(model, p, 6)[0], p


def test_worker_without_weights_or_card_exits_before_ready():
    """No weights source for the model, a --registry that grants no lease,
    or no card without --device cpu: the worker prints FAILED and exits 1
    before READY, and the cluster (static or registry-fed) raises with
    that line. Nothing falls back."""
    ps = jps.ParamServer(_jax_model("tiny", 0)[2])
    cases = [
        ("no --params entry for its model",
         ("--model", "m", "--params", "other=127.0.0.1:1", "--device",
          "cpu"), "no param server for model 'm'"),
        ("a ParamServer that does not answer",
         ("--model", "m", "--params", "m=127.0.0.1:1", "--device", "cpu"),
         "RpcError"),
        ("a --registry that does not answer",
         ("--model", "m", "--params", f"m=127.0.0.1:{ps.start(0)}",
          "--registry", "127.0.0.1:1", "--device", "cpu"), "RpcError"),
        ("no card and no --device cpu", ("--model", "", "--params",
                                         "=127.0.0.1:1"), "CUDA"),
    ]
    try:
        for case, argv, want in cases:
            p, line = _spawn("--role", "decode", "--cfg", "tiny", *argv,
                             env={**os.environ, "BRPC_TPU_F32": "1"})
            rc = p.wait(timeout=60)
            assert rc == 1 and line.startswith("FAILED ") and want in line, \
                (case, rc, line)
    finally:
        ps.close()
    for use_registry in (False, True):
        with pytest.raises(RuntimeError, match="FAILED .*CUDA"):
            disagg.DisaggCluster(1, 1, weights={"": _jax_model("tiny", 0)[2]},
                                 f32=True, use_registry=use_registry)


def test_generate_unchanged_against_disagg_cluster(cluster):
    """A stock port client streams the JAX oracle's greedy tokens through
    the port's cluster (mirrors tests/test_disagg.py)."""
    prompt = [5, 11, 23]
    events = []
    with serving.ServingClient(f"127.0.0.1:{cluster.port}",
                               timeout_ms=TIMEOUT_MS) as client:
        toks = list(client.generate(
            prompt, 6, on_first_token=lambda: events.append(1)))
    assert toks == _oracle(("tiny", 0), prompt, 6)[0]
    assert events == [1]
    assert cluster.router.stats()["relayed_tokens"] >= 6


def test_concurrent_mixed_prompts_spread_across_decode(cluster):
    prompts = [[1 + i] * (2 + 3 * (i % 3)) for i in range(6)]
    got = _concurrent(lambda p: serving.generate(
        f"127.0.0.1:{cluster.port}", p, 8, timeout_ms=TIMEOUT_MS), prompts)
    for i, (p, toks) in enumerate(zip(prompts, got)):
        assert toks == _oracle(("tiny", 0), p, 8)[0], f"client {i}"
    adopted = [runtime.http_vars(a, "serving").get(
        "serving_batched_requests", 0) for a in cluster.decode_addrs]
    assert sum(adopted) >= 6
    assert all(v > 0 for v in adopted), adopted


def test_kv_gauges_on_worker_vars(cluster):
    """Sender counters on the prefill worker process, landing counters on
    the decode worker processes, off their /vars. A decode worker shows
    its kv_* gauges once a transfer has landed on it, so waves of
    concurrent requests go out until each has taken one, whatever other
    tests of this module ran in this process before."""
    for wave in range(5):
        _concurrent(lambda p: serving.generate(
            f"127.0.0.1:{cluster.port}", p, 3, timeout_ms=TIMEOUT_MS),
            _prompts(80 + wave, [3, 5, 7, 9]))
        if all(runtime.http_vars(a, "kv_").get("kv_transfer_bytes", 0) > 0
               for a in cluster.decode_addrs):
            break
    pre = runtime.http_vars(cluster.prefill_addrs[0], "kv_")
    assert pre.get("kv_send_bytes", 0) > 0, pre
    landed = sum(runtime.http_vars(a, "kv_").get("kv_transfer_bytes", 0)
                 for a in cluster.decode_addrs)
    assert landed > 0
    for a in cluster.decode_addrs:
        v = runtime.http_vars(a, "kv_")
        assert "kv_pages_in_use" in v and "kv_transfer_inflight" in v
        assert v["kv_transfer_inflight"] == 0


def test_jax_router_over_port_worker_processes(cluster):
    """The reference's router in front of the port's worker processes; a
    stock JAX client gets the oracle's streams (margin-checked)."""
    prompts = _prompts(60, [4, 19, 26])
    router = jdisagg.DisaggRouter(cluster.prefill_addrs,
                                  cluster.decode_addrs,
                                  worker_timeout_ms=TIMEOUT_MS)
    try:
        got = _concurrent(lambda p: jserving.generate(
            f"127.0.0.1:{router.port}", p, 6, TIMEOUT_MS), prompts)
    finally:
        router.close()
    for p, toks in zip(prompts, got):
        ref, margin = _oracle(("tiny", 0), p, 6)
        assert margin > MIN_MARGIN, f"near-tie in the oracle: {margin}"
        assert toks == ref, p


def test_admin_rpcs_on_worker_processes():
    """Admin status, drain/undrain, a flip on the same port (spill, then
    graft into the new role's index), a retarget and an adapter swap to
    a second model (status, fetch counters, streams of the new weights),
    and a retire after which the process exits; the status text is the
    reference's."""
    models = {"tiny": ("tiny", 0), "mid": ("mid", 1)}
    with disagg.DisaggCluster(1, 1, f32=True, device="cpu", models=models,
                              weights={m: _jax_model(*spec)[2]
                                       for m, spec in models.items()},
                              worker_timeout_ms=TIMEOUT_MS) as c:
        addr = f"127.0.0.1:{c.port}"
        pa, da = c.prefill_addrs[0], c.decode_addrs[0]
        st = c.worker_status(pa)
        assert c._admin_call(pa, "status").decode() == (
            "role=prefill state=active active=0 flips=0 sheds=0 spilled=0 "
            "grafted=0 retargets=0 model=tiny")
        prompt = _prompts(70, [40])[0]
        assert serving.generate(addr, prompt, 4, TIMEOUT_MS) \
            == _oracle(models["tiny"], prompt, 4)[0]

        c._admin_call(da, "drain")
        assert c.worker_status(da)["state"] == "draining"
        c._admin_call(da, "undrain")
        assert c.worker_status(da)["state"] == "active"

        # Flip the prefill worker to decode and back, on its own port.
        for role, flips in (("decode", 1), ("prefill", 2)):
            c.flip_worker(pa, role)
            st = _wait_status(c, pa, lambda s, r=role, n=flips: (
                s["flips"] == n and s["state"] == "active"), f"flip {role}")
            assert st["role"] == role
        # Each admission already exported its pages to the host tier, so
        # the spill finds none left; the chains graft into each successor.
        assert st["spilled"] == 0 and st["grafted"] >= 2, st
        assert c._admin_call(pa, "flip", b"prefill") == b"noop"
        with pytest.raises(runtime.RpcError) as e:
            c._admin_call(pa, "flip", b"router")
        assert e.value.code == runtime.EAPP and "unknown role" in e.value.text
        prompt = _prompts(71, [9])[0]
        assert serving.generate(addr, prompt, 4, TIMEOUT_MS) \
            == _oracle(models["tiny"], prompt, 4)[0]

        # Retarget both workers to the second model.
        fetched = runtime.http_vars(pa, "cluster_model_fetch_wire_bytes")[
            "cluster_model_fetch_wire_bytes"]
        for a in (pa, da):
            c.retarget_worker(a, "mid")
        for a in (pa, da):
            st = _wait_status(c, a, lambda s: s["model"] == "mid"
                              and s["state"] == "active", "retarget")
            assert st["retargets"] == 1
        v = runtime.http_vars(pa, "cluster_model")
        mid_flat = _jax_model(*models["mid"])[2]
        assert v["cluster_model_fetch_wire_bytes"] == fetched + len(
            jps.encode_arrays(mid_flat)), v
        assert v["cluster_model_retargets"] == 1, v
        prompt = _prompts(72, [21])[0]
        want, margin = _oracle(models["mid"], prompt, 5)
        assert want != _oracle(models["tiny"], prompt, 5)[0]
        assert serving.generate(addr, prompt, 5, TIMEOUT_MS) == want

        # An adapter: a delta published after the first workers started,
        # so a new pair (which finds it on its argv) swaps it in.
        delta = {"layers/w_down": np.full_like(mid_flat["layers/w_down"],
                                               1e-2)}
        c.add_adapter("lora", delta)
        pb = c.spawn_worker("prefill", model="mid")
        db = c.spawn_worker("decode", model="mid")
        for a in (pb, db):
            c.adapter_worker(a, "lora")
        for a in (pb, db):
            _wait_status(c, a, lambda s: s["model"] == "mid.lora"
                         and s["state"] == "active", "adapter")
        jp = _jax_model(*models["mid"])[1]
        adapted = {**jp, "layers": {**jp["layers"], "w_down":
                                    jp["layers"]["w_down"] + 1e-2}}
        prompt = _prompts(73, [13])[0]
        want, margin = _oracle(models["mid"], prompt, 5, params=adapted)
        assert margin > MIN_MARGIN, margin
        router = disagg.DisaggRouter([pb], [db], worker_timeout_ms=TIMEOUT_MS)
        try:
            assert serving.generate(f"127.0.0.1:{router.port}", prompt, 5,
                                    TIMEOUT_MS) == want
        finally:
            router.close()

        proc = c.workers[db][0]
        c.retire_worker(db)
        assert proc.wait(timeout=30) == 0
        assert db not in c.workers
        with pytest.raises(KeyError):
            c.retire_worker(db)
