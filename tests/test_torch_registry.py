"""The port's lease-registry control plane and closed loop on the CPU,
against the JAX package: the text codecs and the router's tier series,
the worker pool's picks under a fake clock, the Autoscaler's and the
ModelMixAdvisor's decisions on one scripted sequence, leases of each
package in the other's registry, a registry-fed port cluster through a
worker SIGKILL, its replacement, a registry leader kill and a whole-plane
outage, registry advice flipping a port worker, a replica restarted from
its WAL, and a lease whose load function outlasts its TTL.

Each test function loops over its cases and names the case in its
messages. Tiny f32 configs; the weights are the JAX package's, served as
numpy (tests/test_torch_cluster.py's helpers), and each leg draws its own
prompts.

    python -m pytest tests/test_torch_registry.py -q
"""

import dataclasses
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch

from brpc_tpu import cluster as jcluster
from brpc_tpu import disagg as jdisagg
from brpc_tpu import runtime as jrt
from brpc_tpu import serving as jserving
from brpc_tpu_torch import cluster, disagg, runtime, serving
from brpc_tpu_torch.models import transformer as tt
from test_torch_cluster import (MIN_MARGIN, TIMEOUT_MS, _concurrent,
                                _jax_model, _oracle, _prompts)

PACKAGES = {"port": (cluster, disagg), "jax": (jcluster, jdisagg)}


class _Clock:
    """A monotonic clock the test moves by hand."""

    def __init__(self):
        self.t = 1000.0

    def __call__(self) -> float:
        return self.t


def _wait(pred, what: str, timeout_s: float):
    """Poll ``pred`` until it returns a true value; that value, or fail
    with ``what``."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = pred()
        if got:
            return got
        assert time.monotonic() < deadline, f"{what} within {timeout_s} s"
        time.sleep(0.05)


def _member(pkg, spec: dict):
    return PACKAGES[pkg][0].Member(**spec)


def test_text_codecs_and_tier_series_match_reference(monkeypatch):
    """parse_members, parse_leader_hint, series_tail, Member's properties,
    the runtime's registry constants and _TierStats (ttft_p99_us, series:
    the router lease's sr= tail, byte-identical) give the reference's
    outputs on the same strings and samples."""
    bodies = [
        "7\n",
        "12\n127.0.0.1:1 role=decode w=8 qd=3 kv=40 occ=75 ttft=1234 hb=5 "
        "pfx=a1,b2 pg=00ff,1a2b st=drain md=tiny.lora\n"
        "127.0.0.1:2 role=prefill w=4 hb=0 junk novalue= x=9\n\n"
        "127.0.0.1:3\n",
        "3 extra\n10.0.0.1:5 role=router w=64 qd=0 hb=2 md=mid\n",
    ]
    for body in bodies:
        got, want = cluster.parse_members(body), jcluster.parse_members(body)
        assert got[0] == want[0], body
        assert [dataclasses.asdict(m) for m in got[1]] \
            == [dataclasses.asdict(m) for m in want[1]], body
        for m, j in zip(got[1], want[1]):
            assert (m.ready, m.draining, m.load_per_capacity) \
                == (j.ready, j.draining, j.load_per_capacity), body
            for key in ("a1", "b2", "1a2b", "", "zz"):
                assert m.holds_prefix(key) == j.holds_prefix(key), key
                assert m.holds_page(key) == j.holds_page(key), key
    for pkg in (cluster, jcluster):
        with pytest.raises(ValueError):
            pkg.parse_members("")
    for text in ("not leader; leader=127.0.0.1:8001", "leader=?",
                 "something else", "x leader=a:1 leader=b:2", ""):
        assert cluster.parse_leader_hint(text) \
            == jcluster.parse_leader_hint(text), text
    assert (runtime.ENOLEASE, runtime.ENOTLEADER) == (jrt.ENOLEASE,
                                                      jrt.ENOTLEADER)
    assert runtime.Server.REGISTRY_COUNT_KEYS == jrt.Server.REGISTRY_COUNT_KEYS
    assert disagg.SERIES_METRICS == jdisagg.SERIES_METRICS
    rng = np.random.default_rng(3)
    for case in range(4):
        m = {k: float(rng.integers(0, 10**6)) / 7
             for k in disagg.SERIES_METRICS if rng.random() < 0.7}
        m["unrelated"] = 1.0
        assert disagg.series_tail(m) == jdisagg.series_tail(m), case

    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    stats = {"port": disagg._TierStats(), "jax": jdisagg._TierStats()}
    tiers = list(serving.TIERS)
    assert tiers == list(jserving.TIERS)
    for step in range(300):
        tier = tiers[int(rng.integers(0, len(tiers)))]
        kind = rng.random()
        ttft = float(rng.exponential(0.2)) if rng.random() < 0.9 else None
        tokens = int(rng.integers(1, 64))
        for s in stats.values():
            if kind < 0.7:
                s.note_ok(tier, ttft, tokens)
            elif kind < 0.9:
                s.note_shed(tier)
            else:
                s.note_error(tier)
        clock.t += float(rng.random())
        if step % 50 == 0 or step == 299:
            case = f"step {step}"
            assert stats["port"].series() == stats["jax"].series(), case
            assert stats["port"].snapshot() == stats["jax"].snapshot(), case
            for t in tiers:
                assert stats["port"].ttft_p99_us(t) \
                    == stats["jax"].ttft_p99_us(t), (case, t)
    assert stats["port"].series().count("|") == 4 * len(tiers) - 1


def test_worker_pool_matches_reference_under_a_fake_clock(monkeypatch):
    """One seeded script of member updates, picks (exclusions, affinity
    keys, models), finishes, failures, TTFT samples, stale flips and clock
    steps through the port's and the reference's _WorkerPool: every
    return value, fail_score, load_snapshot, holds_prefix, page_holders
    and the pick counters are equal at every step."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    rng = np.random.default_rng(11)
    addrs = [f"10.0.0.{i}:1" for i in range(6)]
    keys = ["k1", "k2", "k3", None]
    models = ["", "a", "b"]
    pools = {"port": disagg._WorkerPool(addrs[:2]),
             "jax": jdisagg._WorkerPool(addrs[:2])}
    kinds = set()
    for step in range(600):
        op = rng.choice(["members", "pick", "pick", "pick", "done", "fail",
                         "ttft", "stale", "tick", "probe"],
                        p=[.06, .2, .15, .1, .14, .1, .08, .03, .1, .04])
        case = f"step {step} {op}"
        if op == "members":
            specs = []
            for a in addrs:
                if rng.random() < 0.7:
                    specs.append(dict(
                        addr=a, capacity=int(rng.integers(1, 9)),
                        queue_depth=int(rng.integers(0, 12)),
                        p99_ttft_us=int(rng.integers(0, 3_000_000)),
                        prefix_digest=",".join(
                            k for k in keys[:3] if rng.random() < 0.4),
                        page_digest=",".join(
                            k for k in keys[:3] if rng.random() < 0.3),
                        state="drain" if rng.random() < 0.15 else "",
                        model=str(rng.choice(models)),
                        heartbeats=int(rng.choice([0, 1, 5, -1]))))
            res = {p: pools[p].update_members([_member(p, s) for s in specs])
                   for p in pools}
        elif op == "pick":
            known = pools["port"].addrs()
            exclude = {a for a in known if rng.random() < 0.2}
            key = keys[int(rng.integers(0, len(keys)))]
            model = str(rng.choice(models)) if rng.random() < 0.3 else ""
            res = {p: pools[p].pick(exclude, affinity_key=key, model=model)
                   for p in pools}
            kinds.add(res["port"] is not None)
        elif op in ("done", "fail", "ttft"):
            a = addrs[int(rng.integers(0, len(addrs)))]
            secs = float(rng.exponential(0.5))
            res = {p: (pools[p].note_done(a) if op == "done"
                       else pools[p].note_failure(a) if op == "fail"
                       else pools[p].note_ttft(a, secs)) for p in pools}
        elif op == "stale":
            on = bool(rng.random() < 0.5)
            res = {p: (pools[p].set_stale(on), pools[p].stale)
                   for p in pools}
        elif op == "tick":
            clock.t += float(rng.exponential(1.5))
            res = {}
        else:
            key = keys[int(rng.integers(0, 3))]
            model = str(rng.choice(models))
            res = {p: (pools[p].addrs(), pools[p].load_snapshot(),
                       [pools[p].fail_score(a) for a in addrs],
                       [pools[p].holds_prefix(a, key) for a in addrs],
                       pools[p].page_holders(key, model=model))
                   for p in pools}
        if res:
            assert res["port"] == res["jax"], (case, res)
        counters = {p: (pl.drained_picks, pl.warming_skips,
                        pl.affinity_picks) for p, pl in pools.items()}
        assert counters["port"] == counters["jax"], (case, counters)
    assert kinds == {True, False}
    assert all(c > 0 for c in counters["port"]), counters


def _run_autoscaler(pkg: str, script, monkeypatch, clock, **kw):
    """``script`` (steps of (dt, member specs or None for a dead plane,
    fleet doc)) through one package's Autoscaler; its poll results,
    actions and trace."""
    cl, dg = PACKAGES[pkg]
    step = {"i": 0}
    spawned = []

    def members():
        specs = script[step["i"]][1]
        if specs is None:
            raise RuntimeError("control plane down")
        return [cl.Member(**s) for s in specs]

    def spawn(role):
        spawned.append(role)
        return f"new{len(spawned)}"

    def retire(addr):
        if addr.startswith("phantom"):
            raise KeyError(addr)

    asc = dg.Autoscaler("127.0.0.1:1", spawn, retire, autostart=False, **kw)
    monkeypatch.setattr(asc, "_members", members)
    monkeypatch.setattr(dg, "fetch_fleet",
                        lambda *a, **k: script[step["i"]][2])
    out = []
    try:
        for i, (dt, _, _) in enumerate(script):
            step["i"] = i
            clock.t += dt
            out.append(asc.poll_once())
    finally:
        asc.close()
    return out, list(asc.actions), list(asc.trace), asc.stats()


def _run_advisor(pkg: str, script, monkeypatch, clock, **kw):
    cl, dg = PACKAGES[pkg]
    step = {"i": 0}
    moved = []

    def retarget(addr, model):
        if addr.startswith("phantom"):
            raise KeyError(addr)
        moved.append((addr, model))

    adv = dg.ModelMixAdvisor("127.0.0.1:1", retarget, autostart=False, **kw)
    monkeypatch.setattr(adv, "_members", lambda: [
        cl.Member(**s) for s in script[step["i"]][1]])
    out = []
    try:
        for i, (dt, _) in enumerate(script):
            step["i"] = i
            clock.t += dt
            out.append(adv.poll_once())
    finally:
        adv.close()
    return out, moved, list(adv.actions), list(adv.trace)


def test_autoscaler_and_model_advisor_decisions_match_reference(
        monkeypatch):
    """One seeded sequence of members and /fleet docs (a dead plane now
    and then, drains, a phantom that cannot be retired, qps ramps)
    through each package's Autoscaler, with and without the predictive
    lead, and one sequence of model-tagged members through each
    ModelMixAdvisor: the same decisions in the same order, the same
    actions, traces and stats."""
    clock = _Clock()
    monkeypatch.setattr(time, "monotonic", clock)
    rng = np.random.default_rng(5)
    script, qps = [], 5.0
    for i in range(240):
        if rng.random() < 0.05:
            specs = None
        else:
            n = int(rng.integers(0, 5))
            hot = (i // 30) % 2 == 0
            specs = [dict(addr=("phantom" if j == 0 and rng.random() < 0.3
                                else "w") + f"{i}.{j}",
                          capacity=4,
                          queue_depth=int(rng.integers(4 if hot else 0,
                                                       12 if hot else 2)),
                          state="drain" if rng.random() < 0.1 else "",
                          heartbeats=1)
                     for j in range(n)]
        qps = max(qps + float(rng.normal(0.3, 2.0)), 0.0)
        ttft = float(rng.choice([0.0, 50_000.0, 400_000.0]))
        fleet = ({"aggregate": {"qps": qps, "ttft_p99_us": ttft}}
                 if rng.random() < 0.9 else None)
        script.append((float(rng.uniform(0.1, 1.2)), specs, fleet))
    for lead in (0.0, 5.0):
        kw = dict(scale_up_p99_ms=250.0, scale_up_pressure=1.25,
                  scale_down_pressure=0.5, scale_down_idle_s=2.0,
                  up_cooldown_s=1.0, down_cooldown_s=2.0, min_workers=2,
                  max_workers=4, confirm=2, lead_time_s=lead)
        start = clock.t
        got = _run_autoscaler("port", script, monkeypatch, clock, **kw)
        clock.t = start
        want = _run_autoscaler("jax", script, monkeypatch, clock, **kw)
        assert got == want, f"lead {lead}"
        kinds = {a[1] for a in got[1]}
        assert kinds == {"up", "replace", "down"}, (lead, kinds)

    mscript = []
    for i in range(200):
        specs = []
        for j in range(int(rng.integers(1, 7))):
            specs.append(dict(
                addr=("phantom" if rng.random() < 0.1 else "m") + f"{i}.{j}",
                capacity=int(rng.integers(1, 5)),
                queue_depth=int(rng.integers(0, 9)),
                model=str(rng.choice(["a", "b", "c", ""], p=[.4, .4, .1, .1])),
                state="drain" if rng.random() < 0.1 else ""))
        mscript.append((float(rng.uniform(0.1, 1.0)), specs))
    kw = dict(hot_pressure=1.0, gap=0.75, confirm=2, cooldown_s=1.5,
              min_workers=1)
    start = clock.t
    got = _run_advisor("port", mscript, monkeypatch, clock, **kw)
    clock.t = start
    want = _run_advisor("jax", mscript, monkeypatch, clock, **kw)
    assert got == want
    assert len(got[1]) >= 3, got[1]


def _body(addr: str, role: str = "decode") -> str:
    with runtime.Channel(addr, timeout_ms=2000) as ch:
        return ch.call("Cluster", "watch", f"0 0 {role}".encode()).decode()


def _lease_script(reg_pkg: str, lease_pkg: str) -> list:
    """A lease of ``lease_pkg`` in a registry of ``reg_pkg``: register,
    renew with every load tag, lapse (expel), ENOLEASE re-register, renew,
    leave; the watch body and the other package's parse after each
    step, and the registry's counts at the end."""
    reg_cl = PACKAGES[reg_pkg][0]
    lease_cl = PACKAGES[lease_pkg][0]
    watch_cl = PACKAGES["jax" if lease_pkg == "port" else "port"][0]
    load = {"queue_depth": 5, "kv_pages_in_use": 7, "occupancy_x100": 42,
            "p99_ttft_us": 777, "prefix_digest": "h1,h2",
            "page_digest": "00ff", "series": "serving_queue_depth:3",
            "state": "drain", "model": "tiny"}
    out = []
    with reg_cl.Registry(default_ttl_ms=400) as reg:
        watcher = watch_cl.MembershipWatcher(reg.addr, "decode",
                                             lambda ms: None,
                                             autostart=False)
        lease = lease_cl.WorkerLease(reg.addr, "decode", "127.0.0.1:9999",
                                     capacity=3, ttl_ms=400,
                                     load_fn=lambda: load, autostart=False)
        def snap(what):
            members = watcher.poll_once(hold_ms=0)
            out.append((what, _body(reg.addr),
                        [dataclasses.asdict(m) for m in members]))

        try:
            snap("registered")
            lease.renew_once()
            snap("renewed")
            _wait(lambda: reg.counts()["members"] == 0, "lease expiry", 5)
            snap("expelled")
            lease.renew_once()
            assert lease.re_registers == 1, (reg_pkg, lease_pkg)
            snap("re-registered")
            lease.renew_once()
            snap("renewed again")
            assert lease.renews == 2, (reg_pkg, lease_pkg)
            lease.close()
            snap("left")
        finally:
            lease.close()
            watcher.close()
        c = reg.counts()
        out.append(("counts", c["members"], c["registers"], c["expels"]))
    return out


def test_mixed_package_leases_watches_and_registry_channels():
    """A port WorkerLease in a JAX Registry and a JAX one in a port
    Registry (each watched by the other package's MembershipWatcher) give
    the same watch bodies and parses as the reference alone, through a
    register, a renew with every load tag, an expiry, the ENOLEASE
    re-register, a renew and a leave. A port ``registry://`` channel
    with ``lb="la"`` reaches a server leased there by the other package;
    a port watcher on a dead address backs off and flags stale."""
    want = _lease_script("jax", "jax")
    for reg_pkg, lease_pkg in (("jax", "port"), ("port", "jax"),
                               ("port", "port")):
        got = _lease_script(reg_pkg, lease_pkg)
        assert got == want, (reg_pkg, lease_pkg, got, want)
    assert want[1][2][0]["queue_depth"] == 5 and want[2][2] == [], want
    assert want[-1] == ("counts", 0, 2, 1), want

    for reg_pkg, lease_pkg in (("port", "jax"), ("jax", "port")):
        case = f"{lease_pkg} lease in a {reg_pkg} registry"
        srv = runtime.Server()
        srv.add_method("Echo", "echo", lambda req: req[::-1])
        port = srv.start(0)
        with PACKAGES[reg_pkg][0].Registry(default_ttl_ms=2000) as reg:
            lease = PACKAGES[lease_pkg][0].WorkerLease(
                reg.addr, "decode", f"127.0.0.1:{port}", ttl_ms=2000)
            ch = runtime.Channel(f"registry://{reg.addr}/decode", lb="la",
                                 timeout_ms=2000)
            try:
                def echo():
                    try:
                        return ch.call("Echo", "echo", b"abc")
                    except runtime.RpcError:
                        return None
                assert _wait(echo, case, 10) == b"cba", case
            finally:
                ch.close()
                lease.close()
        srv.stop()
        srv.close()

    stale = []
    watcher = cluster.MembershipWatcher("127.0.0.1:9", "decode",
                                        lambda ms: None, hold_ms=300,
                                        on_stale=stale.append)
    try:
        time.sleep(2.0)
        assert 1 <= watcher.reconnects <= 12, watcher.reconnects
        assert watcher.stale and stale[:1] == [True]
    finally:
        watcher.close()


def test_registry_fed_cluster_through_kill_replace_and_failover():
    """DisaggCluster(1, 1, use_registry=True, registry_replicas=3): the
    port's router and the reference's DisaggRouter(registry=...) stream
    the JAX oracle's tokens from the port's worker processes; a SIGKILLed
    decode worker is expelled, the Autoscaler's replacement leg spawns
    one the router picks up from its watch, and streams stay exact; after
    the registry leader is killed a new one is elected, every worker's
    lease fails over and no live worker is expelled; with the whole
    control plane down the router marks registry_stale and serves on the
    frozen set. Every wave is margin-checked (ROADMAP §C 2)."""
    model = ("tiny", 0)
    ttl_ms = 1000
    flat = _jax_model(*model)[2]
    with disagg.DisaggCluster(1, 1, f32=True, device="cpu",
                              weights={"": flat}, use_registry=True,
                              registry_replicas=3, registry_ttl_ms=ttl_ms,
                              worker_timeout_ms=TIMEOUT_MS) as c:
        reg = c.registry
        router = c.router

        def wave(seed, what, gen=serving.generate, port=None):
            prompts = _prompts(seed, [3, 17, 30])
            at = f"127.0.0.1:{port or c.port}"
            got = _concurrent(lambda p: gen(at, p, 6, TIMEOUT_MS), prompts)
            for p, toks in zip(prompts, got):
                ref, margin = _oracle(model, p, 6)
                assert margin > MIN_MARGIN, (what, margin)
                assert toks == ref, (what, p)

        def leader_counts():
            return reg.counts(reg.leader_index())

        def pool_sizes():
            s = router.stats()
            return (s["prefill_workers"], s["decode_workers"])

        wave(91, "the port's router")
        counts = leader_counts()
        # Two workers and the router's own lease.
        assert counts["members"] == 3 and counts["lease_expels"] == 0, counts
        # The reference's native.lib() takes no lock: a router's two
        # watcher threads making a process's first runtime calls can load
        # a second, unconfigured CDLL and crash (ROADMAP §C 14; the port's
        # copy is fixed, test_first_runtime_calls_from_many_threads).
        # Make the first call here, on this thread.
        jrt.app_counter_add("torch_registry_test")
        jrouter = jdisagg.DisaggRouter(registry=reg.addr,
                                       worker_timeout_ms=TIMEOUT_MS)
        try:
            wave(94, "the JAX router", jserving.generate, jrouter.port)
        finally:
            jrouter.close()

        victim = c.decode_addrs[0]
        t0 = time.monotonic()
        c.kill_decode(0)
        _wait(lambda: victim not in router.decodes.addrs(),
              "the killed decode worker expelled", 10)
        assert time.monotonic() - t0 < 5.0, "expel slower than 5 TTLs"
        assert leader_counts()["lease_expels"] == 1
        asc = c.start_autoscaler(min_workers=1, max_workers=1, poll_s=0.2)
        # The replacement registers before its READY line, so the watch
        # may show it before the autoscaler's spawn returns.
        new = _wait(lambda: [a for a in router.decodes.addrs()
                             if a != victim], "a replacement picked up", 60)
        _wait(lambda: asc.actions, "the autoscaler's action", 60)
        assert [a[1:] for a in asc.actions] == [("replace", new[0])], \
            list(asc.actions)
        wave(95, "after the replacement")

        def failovers(a):
            return runtime.http_vars(a, "cluster_lease_failovers").get(
                "cluster_lease_failovers", 0)

        workers = (c.prefill_addrs[0], new[0])
        before = {a: failovers(a) for a in workers}
        dead = reg.kill_leader()
        _wait(lambda: reg.leader_index() not in (None, dead),
              "a new registry leader", 15)
        for a in workers:
            _wait(lambda a=a: failovers(a) > before[a],
                  f"{a}'s lease failed over", 15)
        wave(97, "after the leader kill")
        counts = leader_counts()
        assert counts["members"] == 3, counts
        assert pool_sizes() == (1, 1) and asc.scale_ups == 1

        reg.kill_all()
        _wait(lambda: router.stats()["registry_stale"] == 1,
              "registry_stale after a whole-plane outage", 20)
        assert pool_sizes() == (1, 1)
        wave(98, "on the frozen set")


def test_registry_advice_flips_accepting_port_worker():
    """A port WorkerRunner with accept_advice holds a decode lease; a
    drowning prefill member and a second decode member make the registry
    advise a flip, the runner drains, rebuilds a prefill worker on the
    same port and re-registers it under role prefill (one atomic change,
    hb=0 until its next renew); the flipped worker then serves the
    oracle's tokens. Closing the runner leaves its lease (no expel)."""
    model = ("tiny", 0)
    jcfg, jp, _, _ = _jax_model(*model)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                               dtype=torch.float32)
    params = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                  device="cpu")
    with cluster.Registry(default_ttl_ms=5000) as reg:
        factory = disagg._make_worker_factory({"--slots": "2"}, params, tcfg,
                                              device="cpu")
        runner = disagg.WorkerRunner("decode", factory,
                                     registry_addr=reg.addr, ttl_ms=1500,
                                     accept_advice=True)
        addr = f"127.0.0.1:{runner.worker.port}"
        # Never renewed by the test, so their TTL outlasts it.
        drowning = jcluster.WorkerLease(
            reg.addr, "prefill", "127.0.0.1:7001", ttl_ms=60_000,
            autostart=False, load_fn=lambda: {"queue_depth": 50})
        sibling = jcluster.WorkerLease(reg.addr, "decode", "127.0.0.1:7003",
                                       ttl_ms=60_000, autostart=False)
        decode = None
        try:
            drowning.renew_once()
            _wait(lambda: runner.flips == 1 and runner.state == "active",
                  "the advised flip", 20)
            assert runner.role == "prefill" and runner.lease.role_flips == 1
            assert f"127.0.0.1:{runner.worker.port}" == addr
            assert isinstance(runner.worker, disagg.PrefillWorker)
            members = _wait(lambda: [
                m for m in cluster.parse_members(_body(reg.addr, "prefill"))[1]
                if m.addr == addr and m.heartbeats > 0],
                "the flipped worker's first renew", 10)
            assert members[0].capacity == 4, members
            counts = reg.counts()
            assert counts["advices"] >= 1 and counts["expels"] == 0, counts
            decode = disagg.DecodeWorker(params, tcfg, slots=2, device="cpu")
            router = disagg.DisaggRouter([addr],
                                         [f"127.0.0.1:{decode.port}"],
                                         worker_timeout_ms=TIMEOUT_MS)
            try:
                prompt = _prompts(97, [21])[0]
                ref, margin = _oracle(model, prompt, 5)
                assert margin > MIN_MARGIN, margin
                assert serving.generate(f"127.0.0.1:{router.port}", prompt,
                                        5, TIMEOUT_MS) == ref
            finally:
                router.close()
        finally:
            runner.close()
            drowning.close()
            sibling.close()
            if decode is not None:
                decode.close()
        counts = reg.counts()
        assert counts["members"] == 0 and counts["expels"] == 0, counts


_FIRST_CALLS_SRC = """
import sys, threading
from brpc_tpu_torch import runtime
addr = sys.argv[1]
barrier = threading.Barrier(8)
errors = []

def run():
    barrier.wait()
    try:
        for _ in range(10):
            with runtime.Channel(addr, timeout_ms=5000) as ch:
                ch.call("Cluster", "list", b"")
    except Exception as e:
        errors.append(e)

threads = [threading.Thread(target=run) for _ in range(8)]
for t in threads:
    t.start()
for t in threads:
    t.join()
print("ok" if not errors else errors)
"""


def test_first_runtime_calls_from_many_threads():
    """A process whose first runtime calls come from eight threads at
    once (as a registry-fed router's watcher threads may make them) loads
    the native library once and configures it once (a second ``CDLL``
    object would miss the restypes and truncate a channel pointer): each
    of four such processes lists a registry 80 times and exits
    cleanly."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with cluster.Registry() as reg:
        for run in range(4):
            p = subprocess.run([sys.executable, "-c", _FIRST_CALLS_SRC,
                                reg.addr], cwd=repo, capture_output=True,
                               text=True, timeout=120)
            assert (p.returncode, p.stdout.strip()) == (0, "ok"), \
                (run, p.returncode, p.stdout[-500:], p.stderr[-2000:])


def _wal_restart(pkg: str) -> tuple:
    """One replica of ``pkg``'s RegistryCluster, a lease and a watcher:
    SIGKILL the replica, restart it on its port from its WAL. What the
    restarted replica counts, and whether the watcher's newest push holds
    the lease again."""
    cl = PACKAGES[pkg][0]
    addr = "127.0.0.1:9997"
    # The watcher's thread and this one must not make the process's first
    # runtime calls at once (the reference's loader, ROADMAP §C 14).
    {"jax": jrt, "port": runtime}[pkg].app_counter_add("torch_registry_test")
    with cl.RegistryCluster(1, default_ttl_ms=2000) as rc:
        pushes = []
        watcher = cl.MembershipWatcher(
            rc.addr, "decode", lambda ms: pushes.append(
                [m.addr for m in ms]), hold_ms=400)
        lease = cl.WorkerLease(rc.addr, "decode", addr, ttl_ms=2000)
        try:
            _wait(lambda: any(addr in p for p in pushes),
                  f"{pkg}: the watcher seeing the lease", 5)
            rc.kill(0)  # SIGKILL: nothing flushes, nothing deregisters
            time.sleep(0.5)
            rc.restart(0)
            _wait(lambda: lease.re_registers >= 1,
                  f"{pkg}: the ENOLEASE re-register", 10)
            c = rc.counts(0)
            _wait(lambda: addr in pushes[-1],
                  f"{pkg}: the watcher seeing the lease again", 10)
        finally:
            lease.close()
            watcher.close()
    return c["members"], c["lease_expels"], c["grace_holds"] >= 1


def test_wal_restart_reregisters_under_grace():
    """RegistryCluster.restart: SIGKILL the only replica and restart it
    from its WAL. The grace window expels nobody, the lease re-claims its
    membership through ENOLEASE and the watcher follows, in the port as in
    the reference. (Whether the watcher sees one push without the member
    while the restarted replica comes up depends on timing in both
    packages, so it is not held.)"""
    got = {pkg: _wal_restart(pkg) for pkg in ("jax", "port")}
    assert got["port"] == got["jax"] == (1, 0, True), got


def test_slow_load_fn_does_not_hold_back_renews():
    """A lease whose load_fn takes longer than its TTL (a busy worker's
    batcher, metrics and digests) still renews every period: the renew
    waits at most LOAD_WAIT of the TTL for a fresh sample, else folds in
    the newest finished one. Nobody is expelled and the samples still
    reach the watch body."""
    ttl_ms = 900
    calls = []

    def load():
        calls.append(1)
        time.sleep(1.0)  # past the TTL
        return {"queue_depth": len(calls)}

    with cluster.Registry(default_ttl_ms=ttl_ms) as reg:
        lease = cluster.WorkerLease(reg.addr, "decode", "127.0.0.1:9998",
                                    ttl_ms=ttl_ms, load_fn=load)
        try:
            time.sleep(3.0)
            counts = reg.counts()
            members = cluster.parse_members(_body(reg.addr))[1]
        finally:
            lease.close()
    worst = dict(lease.worst)
    assert counts["expels"] == 0 and lease.re_registers == 0, \
        (counts, lease.re_registers)
    assert lease.renews >= 6, lease.renews
    assert worst["renew_gap"] < ttl_ms / 1e3, worst
    assert worst["load"] >= 1.0, worst
    assert worst["load_wait"] < 0.1, worst
    assert [m.queue_depth >= 2 for m in members] == [True], members
