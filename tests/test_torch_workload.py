"""The port's workload forge against the JAX package's: compiled traces
byte-equal for the same specs (every arrival shape, multi-turn sessions, a
model mix), request lines that round-trip and parse alike, equal tenant
budgets and replay accounting, and an open-loop replay of a compiled
trace, tagged by tenant and tier, through a tiny port engine on the CPU.

One test function; each case is named in its messages.

    python -m pytest tests/test_torch_workload.py -q
"""

import dataclasses
import threading
import time

import numpy as np
import torch

from brpc_tpu import workload as jwl
from brpc_tpu_torch import runtime, serving
from brpc_tpu_torch import workload as wl
from brpc_tpu_torch.models import transformer as tt

SPECS = {
    "default": {},
    "diurnal, 3 tiers, 6 tenants": dict(
        name="forge_verdict", seed=20, sessions=64, duration_s=8.0,
        arrival="diurnal", diurnal_amplitude=0.5, diurnal_period_s=8.0,
        turns=(1, 1), think_time_s=(0.05, 0.2), prefix_families=8,
        prefix_tokens=16, turn_tokens=(2, 8), max_new=(2, 4), tenants=6,
        tier_mix=(("interactive", 0.45), ("standard", 0.35),
                  ("batch", 0.2))),
    "burst, multi-turn, capped prompts": dict(
        seed=3, sessions=40, arrival="burst", burst_factor=6.0,
        turns=(2, 4), max_prompt_tokens=40, prefix_tokens=30),
    "model mix": dict(seed=9, sessions=30, model_mix=(("tiny", 0.7),
                                                      ("mid", 0.3))),
}


def _lines(reqs) -> list:
    return [r.to_line() for r in reqs]


def test_workload_compile_and_replay_match_reference(tmp_path):
    for case, kw in SPECS.items():
        spec, jspec = wl.WorkloadSpec(**kw), jwl.WorkloadSpec(**kw)
        assert spec.canonical_json() == jspec.canonical_json(), case
        text = wl.compile_workload(spec)
        assert text == jwl.compile_workload(jspec), f"{case}: trace differs"
        assert text == wl.compile_workload(spec), f"{case}: not deterministic"
        assert wl.tenant_budgets(spec) == jwl.tenant_budgets(jspec), case
        got, want = wl.load_workload(text), jwl.load_workload(text)
        assert got[:2] == want[:2], f"{case}: header"
        assert _lines(got[2]) == _lines(want[2]), f"{case}: requests"
        for r in got[2]:
            back = wl.Request.from_line(r.to_line())
            assert back == r, f"{case}: {r.to_line()!r} does not round-trip"
            assert dataclasses.asdict(back) == dataclasses.asdict(
                jwl.Request.from_line(r.to_line())), case
        path = str(tmp_path / f"{spec.name}-{spec.seed}.trace")
        assert wl.write_workload(spec, path) == path
        assert _lines(wl.load_workload(path)[2]) == _lines(got[2]), case

    # The replay's accounting and percentile, fed the same outcomes.
    _, _, reqs = wl.load_workload(wl.compile_workload(
        wl.WorkloadSpec(**SPECS["diurnal, 3 tiers, 6 tenants"])))
    _, _, jreqs = jwl.load_workload(jwl.compile_workload(
        jwl.WorkloadSpec(**SPECS["diurnal, 3 tiers, 6 tenants"])))
    st, jst = wl.ReplayStats(), jwl.ReplayStats()
    kinds = ("ok", "shed", "errors", "hung")
    for i, (r, jr) in enumerate(zip(reqs, jreqs)):
        for stats, req in ((st, r), (jst, jr)):
            stats.note(req, kinds[i % 4], tokens=i % 5,
                       ttft_s=0.01 * i if i % 4 == 0 else None,
                       hinted=i % 3 == 0)
            stats.note_late(float(i % 7))
    assert st.snapshot() == jst.snapshot(), "replay stats"
    vals = [0.3, 0.1, 0.9, 0.5, 0.7]
    for q in (0.0, 0.5, 0.99, 1.0):
        assert wl.pct(vals, q) == jwl.pct(vals, q), q
    assert wl.pct([], 0.5) == 0.0

    # An open-loop replay through a tiny port engine, tagged by tenant and
    # tier: every request completes and none sheds.
    cfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                              dtype=torch.float32)
    params = tt.init_params(cfg, torch.Generator().manual_seed(0),
                            device="cpu")
    spec = wl.WorkloadSpec(
        name="cpu_replay", seed=5, sessions=12, duration_s=1.5,
        arrival="diurnal", diurnal_period_s=1.5, turns=(1, 2),
        think_time_s=(0.05, 0.2), prefix_families=3, prefix_tokens=6,
        turn_tokens=(2, 4), max_prompt_tokens=16, max_new=(2, 3),
        vocab=cfg.vocab, tenants=3)
    _, budgets, reqs = wl.load_workload(wl.compile_workload(spec))
    assert set(budgets) == {"t0", "t1", "t2"}
    eng = serving.ServingEngine(params, cfg, max_batch_size=4, slots=4,
                                max_prompt=16, device="cpu")
    clients, mu = [], threading.Lock()
    tls = threading.local()

    def issue(r, stats):
        cache = getattr(tls, "clients", None)
        if cache is None:
            cache = tls.clients = {}
        c = cache.get((r.tenant, r.tier))
        if c is None:
            c = cache[(r.tenant, r.tier)] = serving.ServingClient(
                f"127.0.0.1:{eng.port}", timeout_ms=60_000, tenant=r.tenant,
                tier=r.tier)
            with mu:
                clients.append(c)
        first = []
        t0 = time.monotonic()
        try:
            got = list(c.generate(list(r.prompt), r.max_new,
                                  on_first_token=lambda: first.append(
                                      time.monotonic())))
            assert len(got) == r.max_new
            stats.note(r, "ok", tokens=len(got),
                       ttft_s=first[0] - t0 if first else None)
        except runtime.RpcError as e:
            stats.note(r, "shed" if e.code == runtime.ELIMIT else "errors",
                       hinted=e.retry_after_ms is not None)

    try:
        t0 = time.monotonic()
        stats = wl.replay(reqs, issue, drivers=4)
        wall = time.monotonic() - t0
    finally:
        for c in clients:
            c.close()
        eng.close()
    snap = stats.snapshot()
    assert snap["issued"] == len(reqs), snap["issued"]
    ok = sum(c["ok"] for c in snap["by_tier"].values())
    assert ok == len(reqs), f"replay: {snap['by_tier']}"
    assert wall >= max(r.t_ms for r in reqs) / 1000.0, "replay ran early"
    assert sum(c["good_tokens"] for c in snap["by_tenant"].values()) == sum(
        r.max_new for r in reqs), "replay: tokens"
    assert all(np.isfinite(t) and t > 0 for c in snap["by_tier"].values()
               for t in c["ttfts"]), "replay: TTFTs"
