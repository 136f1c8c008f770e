"""Serve phase 5's prompt lengths through the port's worker processes at
Llama-3-8B (32 layers, bf16, seeded random weights), round by round in
the order given: a static-list DisaggCluster(1, 1) ("static") or a
registry-fed one ("registry": use_registry=True, registry_replicas=3, TTL
1500 ms), all in one process on one card, so the registry's cost to
serving shows beside the static list's. Each round starts its cluster,
sends two waves of 8 concurrent requests (chip_smoke.py's phase-5 lengths,
32 new tokens; fresh tokens in each wave) and prints one "[registry-ab]"
line: the workers' cold starts, each wave's tokens/s and TTFT p50/p99,
the workers' launches, and for a registry-fed round each lease's worst
renew gap with its parts (wake-up past the period, the wait for the load
sample, the renew RPC) and load_fn's own time, read off the workers'
/vars.

    python3 tools/torch_registry_ab.py static registry registry static

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    modes = sys.argv[1:]
    if not modes or any(m not in ("static", "registry") for m in modes):
        print(__doc__, file=sys.stderr)
        return 2
    os.environ.setdefault("TRPC_KV_HOST_ARENA", "0")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch

    import chip_smoke as c
    from brpc_tpu_torch import disagg, kv_cache, native
    from brpc_tpu_torch.models import transformer
    from brpc_tpu_torch.ops import _build

    if not torch.cuda.is_available():
        print("torch_registry_ab: no CUDA device visible", file=sys.stderr)
        return 2
    card = c.card_line()
    print(f"[registry-ab] card {card}", flush=True)
    native.build()
    _build.build()
    cfg = transformer.TransformerConfig.llama3_8b()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    flat = {k: v.cpu() for k, v in disagg._flatten_params(params).items()}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    max_new = c.MAIN_NEW_TOKENS
    blocks = 2 * len(c.MAIN_LENGTHS) * kv_cache.pages_for(
        max(c.MAIN_LENGTHS) + max_new, 16) + 1
    for i, mode in enumerate(modes):
        t0 = time.monotonic()
        cluster = disagg.DisaggCluster(
            1, 1, cfg_name="llama3_8b", weights={"": dict(flat)},
            decode_slots=8, decode_kv_blocks=blocks, max_prompt=1024,
            kv_pool=c.kv_pool_budget(cfg), use_registry=mode == "registry",
            registry_replicas=c.REGISTRY_REPLICAS if mode == "registry"
            else 0, registry_ttl_ms=c.REGISTRY_TTL_MS,
            worker_timeout_ms=600_000)
        try:
            res = {"up_s": time.monotonic() - t0,
                   "cold_starts": c.cold_starts(cluster), "waves": []}
            for seed in (5, 6):
                rng = np.random.default_rng(seed)
                prompts = [rng.integers(0, cfg.vocab, n).tolist()
                           for n in c.MAIN_LENGTHS]
                w = c.wave_metrics(c.run_swarm(cluster, prompts, max_new),
                                   cfg.vocab)
                res["waves"].append({k: w[k] for k in (
                    "tokens_per_s", "ttft_p50_ms", "ttft_p99_ms",
                    "wall_s")})
            res["launches"] = c.check_cluster_launches(cluster)
            if mode == "registry":
                res["lease_worst_ms"] = {
                    role: {p: c.lease_vars(a).get(f"{p}_max_us", 0) / 1e3
                           for p in c.LEASE_PARTS}
                    for role, a in (("prefill", cluster.prefill_addrs[0]),
                                    ("decode", cluster.decode_addrs[0]))}
                res["lease_worst_ms"]["router"] = {
                    p: 1e3 * s
                    for p, s in cluster.router._lease.worst.items()}
                res["expels"] = c.leader_counts(cluster)["lease_expels"]
        finally:
            cluster.close()
        print(f"[registry-ab] round {i} {mode}: {json.dumps(res)}",
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
