"""The port's rpcz tracing against the JAX package's (after
tests/test_tracing.py): the unsampled path allocates no span, a unary
trace joins client and server, a frame dropped by fault injection ends
its span with the retry's errno, the Chrome dump is valid, and a port
engine's request tree (queue wait, prefill, one emit mark per token, the
terminal frame, the delivery stream) has the reference engine's shape for
the same weights and prompt. Also the runtime surface beside it: the
watcher's collective fence, the flight recorder's count and reset, and a
shedding router's retry hint.

One test function; each case is named in its messages.

    python -m pytest tests/test_torch_tracing.py -q
"""

import dataclasses
import json
import re
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu import cluster as jcluster
from brpc_tpu import runtime as jrt
from brpc_tpu import serving as jserving
from brpc_tpu import tracing as jtracing
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import cluster, runtime, serving, tracing
from brpc_tpu_torch.models import transformer as tt

NEW_TOKENS = 5


def _fetch(pkg, trace_id: int, service: str, deadline_s: float = 5.0):
    """Poll until the collector flushed ``service``'s spans of a trace."""
    deadline = time.monotonic() + deadline_s
    spans = []
    while time.monotonic() < deadline:
        spans = pkg.fetch(trace_id)
        if any(s["service"] == service for s in spans):
            return spans
        time.sleep(0.05)
    return spans


def _shape(spans) -> list:
    """A request tree without its times: (depth, kind, service.method,
    annotations with their numbers blanked), the stream's flow-control
    acks left out (how many there are depends on timing)."""
    by_parent, ids = {}, {s["span_id"] for s in spans}
    for s in spans:
        by_parent.setdefault(s["parent_span_id"], []).append(s)
    out = []

    def walk(s, depth):
        notes = [re.sub(r"\d+", "#", a["text"])
                 for a in s.get("annotations", [])
                 if not a["text"].startswith("ack:")]
        out.append((depth, s["kind"], f"{s['service']}.{s['method']}",
                    tuple(notes)))
        for c in sorted(by_parent.get(s["span_id"], []),
                        key=lambda c: (c["service"], c["kind"])):
            walk(c, depth + 1)

    for root in sorted((s for s in spans if s["parent_span_id"] not in ids),
                       key=lambda s: (s["service"], s["kind"])):
        walk(root, 0)
    return out


def _unary_shape(pkg_rt, pkg_tracing, service: str) -> list:
    srv = pkg_rt.Server()
    srv.add_method(service, "echo", lambda req: req)
    port = srv.start(0)
    try:
        pkg_tracing.enable(100000)
        with pkg_rt.Channel(f"127.0.0.1:{port}", timeout_ms=5000) as ch:
            assert ch.call(service, "echo", b"hi") == b"hi"
        spans = _fetch(pkg_tracing, 0, service)
        client = [s for s in spans if s["service"] == service
                  and s["kind"] == "C"]
        assert client, f"{service}: no client span"
        tid = int(client[0]["trace_id"], 16)
        tree = [s for s in spans if s["trace_id"] == client[0]["trace_id"]]
        server = [s for s in tree if s["kind"] == "S"]
        assert server and server[0]["parent_span_id"] == \
            client[0]["span_id"], f"{service}: server span not joined"
        assert pkg_tracing.format_tree(tid, tree).count(service) == 2
        return _shape(tree)
    finally:
        pkg_tracing.disable()
        srv.close()


def test_traces_match_reference(tmp_path):
    jrt.Server().close()  # the reference runtime's first call, this thread
    try:
        # The unsampled path allocates no span.
        srv = runtime.Server()
        srv.add_method("TrOff", "echo", lambda req: req)
        port = srv.start(0)
        with runtime.Channel(f"127.0.0.1:{port}", timeout_ms=5000) as ch:
            before = tracing.count()
            for _ in range(20):
                assert ch.call("TrOff", "echo", b"x") == b"x"
            assert tracing.count() == before, "unsampled: spans allocated"
        srv.close()

        # A unary trace joins client and server, as the reference's does.
        assert _unary_shape(runtime, tracing, "TrEcho") == \
            _unary_shape(jrt, jtracing, "TrEcho"), "unary trace shape"

        # A frame killed by fault injection: the span records each failed
        # attempt's errno and ends with the call's.
        srv = runtime.Server()
        srv.add_method("TrChaos", "echo", lambda req: req)
        port = srv.start(0)
        ch = runtime.Channel(f"127.0.0.1:{port}", timeout_ms=2000,
                             retry_policy=runtime.RetryPolicy(max_retry=2))
        try:
            assert ch.call("TrChaos", "echo", b"warm") == b"warm"
            tracing.enable(100000)
            runtime.fault_inject("seed=11,send_kill=1.0")
            with pytest.raises(runtime.RpcError) as ei:
                ch.call("TrChaos", "echo", b"x")
            assert runtime.fault_counters()["send_kill"] >= 1, "fault shim"
            runtime.fault_inject("")
            with pytest.raises(ValueError):
                runtime.fault_inject("send_drop=lots")
            spans = _fetch(tracing, 0, "TrChaos")
            failed = [s for s in spans if s["service"] == "TrChaos"
                      and s["kind"] == "C" and s["error_code"] != 0]
            assert failed, "fault: no failed client span"
            assert failed[0]["error_code"] == ei.value.code, "fault: errno"
            texts = [a["text"] for a in failed[0]["annotations"]]
            assert any("failed: errno" in t and "retrying" in t
                       for t in texts), f"fault: {texts}"
        finally:
            runtime.fault_inject("")
            ch.close()
            srv.close()

        # The Chrome dump round-trips as strict JSON with Perfetto's keys.
        path = tmp_path / "trace.json"
        trace = tracing.dump(str(path))
        with open(path) as f:
            assert json.load(f) == trace, "dump: file differs"
        events = trace["traceEvents"]
        assert events, "dump: no events"
        for ev in events:
            assert ev["ph"] in ("X", "i", "M") and "pid" in ev, ev
            if ev["ph"] != "M":
                assert isinstance(ev["ts"], int), ev
            if ev["ph"] == "X":
                assert ev["dur"] >= 0 and "tid" in ev, ev
        assert any(ev["ph"] == "X" and "TrChaos" in ev["name"]
                   for ev in events), "dump: the traced call is missing"
        tracing.disable()

        # A serving request's tree, the port engine against the reference
        # engine on the same weights and prompt.
        jcfg = dataclasses.replace(jt.TransformerConfig.tiny(),
                                   dtype=jnp.float32)
        tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                                   dtype=torch.float32)
        jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
        tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
        shapes = {}
        for name, srv_pkg, tr_pkg, make in (
                ("port", serving, tracing, lambda: serving.ServingEngine(
                    tp, tcfg, max_batch_size=4, slots=4, max_prompt=16,
                    device="cpu")),
                ("jax", jserving, jtracing, lambda: jserving.ServingEngine(
                    jp, jcfg, max_batch_size=4, slots=4, max_prompt=16))):
            eng = make()
            try:
                tr_pkg.enable(100000)
                with srv_pkg.ServingClient(f"127.0.0.1:{eng.port}",
                                           timeout_ms=60_000) as c:
                    toks = list(c.generate([1, 2, 3], NEW_TOKENS))
                    tid = c.last_trace_id
                assert len(toks) == NEW_TOKENS and tid, f"{name}: {toks}"
                spans = _fetch(tr_pkg, tid, "serving")
                tr_pkg.disable()
                if name == "port":
                    assert any("_queue_wait_us" in k
                               for k in runtime.metrics()), "queue-wait tvar"
            finally:
                eng.close()
            shapes[name] = (toks, _shape(spans))
            sv = [s for s in spans if s["service"] == "serving"]
            assert sv, f"{name}: no serving span"
            texts = [a["text"] for a in sv[0]["annotations"]]
            for mark in ("queue_wait_us=", "prefill_us=", "terminal frame"):
                assert any(mark in t for t in texts), f"{name}: {texts}"
            assert sum("emit" in t for t in texts) == NEW_TOKENS, \
                f"{name}: one emit mark per token: {texts}"
            assert any(s["service"] == "__stream" for s in spans), name
        assert shapes["port"] == shapes["jax"], \
            f"serving trees differ: {shapes}"

        # Tail sampling: with head sampling off, a traced request waits in
        # the pending ring until promoted.
        tracing.enable_tail()
        srv = runtime.Server()
        srv.add_method("TrTail", "echo", lambda req: req)
        port = srv.start(0)
        try:
            with runtime.Channel(f"127.0.0.1:{port}", timeout_ms=5000) as ch:
                ch.call("TrTail", "echo", b"t")
            assert tracing.pending() >= 1, "tail: nothing pending"
        finally:
            tracing.disable_tail()
            srv.close()
    finally:
        tracing.disable()
        jtracing.disable()
        runtime.fault_inject("")

    # The watcher's collective fence: a member gone from a watch bumps the
    # epoch once, as the reference's watcher does.
    fences = {}
    for name, pkg, rt in (("port", cluster, runtime), ("jax", jcluster,
                                                       jrt)):
        seen = []
        with pkg.Registry(default_ttl_ms=2000) as reg:
            leases = [pkg.WorkerLease(reg.addr, "decode", f"127.0.0.1:{p}",
                                      ttl_ms=2000) for p in (1, 2)]
            w = pkg.MembershipWatcher(reg.addr, "decode", seen.append,
                                      hold_ms=300, fence_collectives=True)
            try:
                epoch = rt.coll_epoch()
                deadline = time.monotonic() + 10
                while not (seen and len(seen[-1]) == 2):
                    assert time.monotonic() < deadline, f"{name}: 2 members"
                    time.sleep(0.05)
                leases[1].close()
                while not (seen and len(seen[-1]) == 1):
                    assert time.monotonic() < deadline, f"{name}: a leave"
                    time.sleep(0.05)
                fences[name] = (w.fences, rt.coll_epoch() - epoch)
            finally:
                w.close()
                leases[0].close()
    assert fences["port"] == fences["jax"] == (1, 1), fences
    runtime.coll_epoch_observe(runtime.coll_epoch() + 5)
    assert runtime.coll_epoch() == epoch + 6, "epoch observe"
    assert not runtime.coll_link_quarantined("127.0.0.1:1"), "quarantine"

    # The flight recorder's count (a thread adds its finished records in
    # eights) and reset, and the router's retry hint.
    before = runtime.flight_count()
    eng = serving.ServingEngine(tp, tcfg, max_batch_size=2, slots=2,
                                max_prompt=16, device="cpu")
    try:
        for i in range(8):
            serving.generate(f"127.0.0.1:{eng.port}", [4, 5 + i], 2, 60_000)
        deadline = time.monotonic() + 5
        while not runtime.flight_records():
            assert time.monotonic() < deadline, "flight: no record"
            time.sleep(0.05)
    finally:
        eng.close()
    assert runtime.flight_count() >= before, "flight: count went back"
    runtime.flight_reset()
    assert runtime.flight_records() == [], "flight: reset"
    for text, want in (("shed: pressure 3.0 retry_after_ms=250", 250),
                       ("overloaded", None)):
        e = runtime.RpcError(runtime.ELIMIT, text)
        assert e.retry_after_ms == want == jrt.RpcError(
            jrt.ELIMIT, text).retry_after_ms, text
