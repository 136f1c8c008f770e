"""On-card smoke of brpc_tpu_torch: builds the native runtime and the CUDA
kernels from this checkout, holds each kernel against its plain PyTorch
version at the serving path's shapes, checks that the f32 serving engine
streams exactly the plain forward's greedy tokens, and serves Llama-3-8B
at full width and depth (random seeded weights) through the native
batcher and the kernels.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # + a profiled swarm after phase 5

Needs a CUDA card and exits nonzero without one. The last line of stdout
is {"ok": true, "device": {...}}; the line before the card's name and power
limit, and before that the per-kernel JSON. A fuller report
(chip_smoke_report.json, and profile.txt with --profile) is written to
--report-dir (default build/chip_smoke).
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# Published peaks of one H100 SXM (NVIDIA data sheet, dense): device memory
# rate, bf16 tensor-core rate, f32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}

# kernel-vs-plain tolerance: |kernel - plain| <= atol + rtol * |plain|.
# bf16 keeps 8 significant bits (one rounding step is up to 0.8% of a
# value) and the kernels round probabilities before the division by the
# softmax sum where the plain version rounds after it; f32 differs only in
# summation order.
TOL = {torch.bfloat16: (2e-2, 1e-2), torch.float32: (1e-4, 1e-4)}

REPLACES = {
    "paged_decode_attention": "brpc_tpu/kv_cache.py:312",
    "prefill_attention": "brpc_tpu/models/transformer.py:242",
    "rms_norm": "brpc_tpu/models/transformer.py:102",
}
SOURCES = {
    "paged_decode_attention":
        "brpc_tpu_torch/csrc/paged_decode_attention.cu",
    "prefill_attention": "brpc_tpu_torch/csrc/prefill_attention.cu",
    "rms_norm": "brpc_tpu_torch/csrc/rms_norm.cu",
}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype) -> float:
    atol, rtol = TOL[dtype]
    g, w = got.float(), want.float()
    if not torch.isfinite(g).all():
        raise AssertionError(f"{name}: kernel output not finite")
    err = (g - w).abs()
    bad = err > atol + rtol * w.abs()
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside atol {atol} rtol "
            f"{rtol}; max abs err {float(err.max()):.3e}")
    return float(err.max())


# ---- phase 3: each kernel against its plain version -------------------------

# Phase 5's prompt lengths; its last decode step attends length + 31 keys.
MAIN_LENGTHS = [16, 1024, 100, 517, 64, 300, 800, 33]
MAIN_NEW_TOKENS = 32


def check_paged_decode(dtype, gen, pos_list) -> dict:
    from brpc_tpu_torch.ops import attention

    dev = torch.device("cuda")
    S, H, KV, Dh, page, L, max_pages = 8, 32, 8, 128, 16, 32, 512
    layer = L - 1  # the last layer: exercises the pool's layer stride
    need = [p // page + 1 for p in pos_list]
    nb = sum(need) + 1
    k_pool = torch.randn((nb, L, page, KV, Dh), generator=gen, device=dev
                         ).to(dtype)
    v_pool = torch.randn_like(k_pool)
    perm = torch.randperm(nb - 1, generator=gen, device=dev).int() + 1
    tables = torch.zeros((S, max_pages), dtype=torch.int32, device=dev)
    used = 0
    for s, n in enumerate(need):
        tables[s, :n] = perm[used:used + n]
        used += n
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)
    q = torch.randn((S, H, Dh), generator=gen, device=dev).to(dtype)

    def kern():
        return attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                                pos, layer)

    def plain():
        return attention.paged_decode_attention_plain(q, k_pool, v_pool,
                                                      tables, pos, layer)

    err = compare("paged_decode_attention", kern(), plain(), dtype)
    # Library yardstick: SDPA with an explicit mask over the already
    # gathered dense K/V (the gather itself is not timed).
    T = max(need) * page
    idx = tables[:, :max(need)].long()
    kd = k_pool[:, layer][idx].reshape(S, T, KV, Dh).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
    vd = v_pool[:, layer][idx].reshape(S, T, KV, Dh).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] <= pos.long()[:, None]
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    F = torch.nn.functional
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, kd, vd, attn_mask=mask))
    itemsize = torch.empty((), dtype=dtype).element_size()
    keys = sum(p + 1 for p in pos_list)
    nbytes = (2 * keys * KV * Dh + 2 * S * H * Dh) * itemsize \
        + tables.numel() * 4 + S * 4
    flops = 4.0 * keys * H * Dh
    b, by = bound_ms(nbytes, flops, dtype)
    return {"shape": f"q[{S},{H},{Dh}] pool[{nb},{L},{page},{KV},{Dh}] "
                     f"pos={pos_list}",
            "max_abs_err": err, "ms": time_ms(kern), "plain_ms":
            time_ms(plain), "bound_ms": b, "bound_by": by,
            "library_ms": lib_ms}


def check_prefill(dtype, gen, P: int, length: int) -> dict:
    from brpc_tpu_torch.ops import attention

    dev = torch.device("cuda")
    H, KV, Dh = 32, 8, 128
    q = torch.randn((P, H, Dh), generator=gen, device=dev).to(dtype)
    k = torch.randn((P, KV, Dh), generator=gen, device=dev).to(dtype)
    v = torch.randn((P, KV, Dh), generator=gen, device=dev).to(dtype)

    def kern():
        return attention.prefill_attention(q, k, v, length)

    def plain():
        return attention.prefill_attention_plain(q, k, v, length)

    err = compare(f"prefill_attention P={P}", kern(), plain(), dtype)
    span = torch.arange(P, device=dev)
    mask = ((span[:, None] >= span[None, :])
            & (span[None, :] < length))[None, None]
    q4 = q.transpose(0, 1)[None]
    k4 = k.repeat_interleave(H // KV, dim=1).transpose(0, 1)[None]
    v4 = v.repeat_interleave(H // KV, dim=1).transpose(0, 1)[None]
    F = torch.nn.functional
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        q4, k4, v4, attn_mask=mask), iters=5)
    itemsize = torch.empty((), dtype=dtype).element_size()
    pairs = sum(min(i + 1, length) for i in range(P))
    nbytes = (2 * P * H * Dh + 2 * P * KV * Dh) * itemsize
    flops = 4.0 * pairs * H * Dh
    b, by = bound_ms(nbytes, flops, dtype)
    return {"shape": f"q[{P},{H},{Dh}] kv[{P},{KV},{Dh}] length={length}",
            "max_abs_err": err, "ms": time_ms(kern, iters=5),
            "plain_ms": time_ms(plain, iters=5), "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms}


def check_rms_norm(dtype, gen, rows: int) -> dict:
    from brpc_tpu_torch.ops import norm

    dev = torch.device("cuda")
    D, eps = 4096, 1e-5
    x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    g = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)

    def kern():
        return norm.rms_norm(x, g, eps)

    def plain():
        return norm.rms_norm_plain(x, g, eps)

    err = compare(f"rms_norm rows={rows}", kern(), plain(), dtype)
    F = torch.nn.functional
    lib_ms = None
    if hasattr(F, "rms_norm"):
        g_dt = g.to(dtype)
        lib_ms = time_ms(lambda: F.rms_norm(x, (D,), weight=g_dt, eps=eps))
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * rows * D * itemsize + D * 4
    b, by = bound_ms(nbytes, 4.0 * rows * D, dtype)
    return {"shape": f"x[{rows},{D}]", "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by, "library_ms": lib_ms}


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {"paged_decode_attention": [], "prefill_attention": [],
             "rms_norm": []}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        runs = [("paged_decode_attention", check_paged_decode(
            dtype, gen, [0, 15, 16, 300, 2047, 1000, 517, 64]))]
        if dtype == torch.bfloat16:  # phase 5's last decode step
            runs.append(("paged_decode_attention", check_paged_decode(
                dtype, gen, [n + MAIN_NEW_TOKENS - 1 for n in MAIN_LENGTHS])))
        for P, length in ((8, 5), (512, 300), (1024, 1024), (4096, 3000)):
            runs.append(("prefill_attention",
                         check_prefill(dtype, gen, P, length)))
        for rows in (8, 1000):
            runs.append(("rms_norm", check_rms_norm(dtype, gen, rows)))
        for name, r in runs:
            r["dtype"] = tag
            cases[name].append(r)
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            log(f"[kernel] {name} {tag} {r['shape']}: max_abs_err "
                f"{r['max_abs_err']:.3e} ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
                f"({r['bound_by']}) library_ms {lib}")
    return cases


# ---- phases 4 and 5: the serving path -----------------------------------------

def run_swarm(engine, prompts, max_new: int) -> dict:
    """Concurrent streaming clients against the engine; every stream must
    end cleanly with ``max_new`` tokens."""
    from brpc_tpu_torch import serving

    results, ttft, errors = {}, {}, []

    def one(i, prompt):
        t0 = time.monotonic()
        try:
            with serving.ServingClient(f"127.0.0.1:{engine.port}",
                                       timeout_ms=600_000) as c:
                toks = list(c.generate(
                    prompt, max_new, on_first_token=lambda: ttft.__setitem__(
                        i, time.monotonic() - t0)))
            results[i] = toks
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=one, args=(i, p))
               for i, p in enumerate(prompts)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.monotonic() - t0
    if errors:
        raise errors[0]
    for i in range(len(prompts)):
        if len(results.get(i, [])) != max_new:
            raise AssertionError(f"request {i}: {len(results.get(i, []))} "
                                 f"tokens, want {max_new}")
    return {"tokens": results, "ttft_s": ttft, "wall_s": wall}


def phase_exactness() -> dict:
    from brpc_tpu_torch import serving
    from brpc_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = dataclasses.replace(transformer.TransformerConfig.llama3_8b(),
                              n_layers=2, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = transformer.init_params(cfg, gen, device="cuda")
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in (5, 16, 17, 100)]
    log("[exact] weights ready; starting the engine")
    eng = serving.ServingEngine(params, cfg, max_batch_size=4, slots=4,
                                max_prompt=128, kv_blocks=64)
    try:
        out = run_swarm(eng, prompts, 8)
    finally:
        eng.close()
    log("[exact] streams done; rolling out the plain forward")
    for i, p in enumerate(prompts):
        ref = transformer.greedy_reference(params, cfg, p, 8)
        if out["tokens"][i] != ref:
            raise AssertionError(f"f32 stream {i} (prompt {len(p)}): "
                                 f"{out['tokens'][i]} != plain {ref}")
    log(f"[exact] f32 Llama-3-8B width, 2 layers: 4 concurrent streams "
        f"(prompts 5/16/17/100, 8 tokens) identical to the plain forward's "
        f"greedy rollout")
    del params
    torch.cuda.empty_cache()
    return {"streams": [out["tokens"][i] for i in range(len(prompts))]}


def profile_swarm(engine, prompts, max_new: int, report_dir: str) -> dict:
    """A second, shorter swarm under torch.profiler: device time by kernel
    group over the wall time (the measured swarm runs unprofiled)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_swarm(engine, prompts, max_new)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups = {"K1 paged_decode_attention": 0.0, "K2 prefill_attention": 0.0,
              "K3 rms_norm": 0.0, "matmul (cuBLAS)": 0.0, "other": 0.0}
    table = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        table.append((us, e.count, e.key))
        name = e.key.lower()
        if "paged_decode" in name:
            g = "K1 paged_decode_attention"
        elif "prefill_attention" in name:
            g = "K2 prefill_attention"
        elif "rms_norm" in name:
            g = "K3 rms_norm"
        elif any(t in name for t in ("gemm", "gemv", "cutlass", "xmma",
                                     "cublas", "nvjet", "sm90")):
            g = "matmul (cuBLAS)"
        else:
            g = "other"
        groups[g] += us / 1e3
    table.sort(reverse=True)
    with open(os.path.join(report_dir, "profile.txt"), "w") as f:
        for us, n, key in table:
            f.write(f"{us / 1e3:10.3f} ms {n:7d}x {key}\n")
    busy = sum(groups.values())
    if busy == 0:  # the profiler saw no device activity: not measured
        return {"wall_ms": 1e3 * wall, "device_busy_ms": None,
                "idle_share": None, "by_group_ms": None}
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (1e3 * wall), "by_group_ms": groups}


def phase_main(card: str, profile_it: bool, report_dir: str) -> dict:
    from brpc_tpu_torch import kv_cache, ops, serving
    from brpc_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.llama3_8b()
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.monotonic()
    params = transformer.init_params(cfg, gen, device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    rng = np.random.default_rng(0)
    lengths = MAIN_LENGTHS
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
    max_new = MAIN_NEW_TOKENS
    blocks = len(prompts) * kv_cache.pages_for(max(lengths) + max_new, 16) + 1
    log(f"[main] weights ready in {init_s:.1f} s; starting the engine")
    eng = serving.ServingEngine(params, cfg, max_batch_size=8, slots=8,
                                max_prompt=1024, kv_blocks=blocks)
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = run_swarm(eng, prompts, max_new)
        launches = ops.launch_counts()
        stats = eng.stats()
        prof = (profile_swarm(eng, prompts, 8, report_dir) if profile_it
                else None)
    finally:
        eng.close()
    steps, prefills = stats["model_steps"], stats["prefills"]
    L = cfg.n_layers
    if launches["paged_decode_attention"] != L * steps:
        raise AssertionError(f"K1 launched {launches['paged_decode_attention']}"
                             f" times, want {L} x {steps} decode steps")
    if launches["prefill_attention"] != L * prefills or prefills == 0:
        raise AssertionError(f"K2 launched {launches['prefill_attention']} "
                             f"times over {prefills} prefills")
    if launches["rms_norm"] != (2 * L + 1) * (steps + prefills):
        raise AssertionError(f"K3 launched {launches['rms_norm']} times")
    for toks in out["tokens"].values():
        if not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError("token id out of vocabulary")
    ttft = sorted(out["ttft_s"].values())
    n_tok = sum(len(t) for t in out["tokens"].values())
    res = {
        "card": card,
        "requests": len(prompts), "prompt_lengths": lengths,
        "new_tokens": max_new, "model_steps": steps, "prefills": prefills,
        "tokens_per_s": n_tok / out["wall_s"],
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                      int(0.99 * len(ttft)))],
        "decode_step_ms": 1e3 * stats["decode_seconds"] / steps,
        "prefill_ms_mean": 1e3 * stats["prefill_seconds"] / prefills,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "weights_init_s": init_s,
        "mean_batch_occupancy": stats["mean_batch_occupancy"],
        "launches": launches,
        "profile": prof,
    }
    log(f"[main] Llama-3-8B bf16 32 layers, {card}: {len(prompts)} "
        f"concurrent requests, {n_tok} tokens in {out['wall_s']:.3f} s = "
        f"{res['tokens_per_s']:.2f} tok/s; TTFT p50 "
        f"{res['ttft_p50_ms']:.1f} ms p99 {res['ttft_p99_ms']:.1f} ms; "
        f"decode step {res['decode_step_ms']:.2f} ms mean over {steps} "
        f"steps; prefill {res['prefill_ms_mean']:.2f} ms mean over "
        f"{prefills}; peak memory {res['peak_mem_gib']:.2f} GiB; launches "
        f"{launches}")
    if prof is not None:
        log(f"[profile] 8 more requests x 8 tokens, {card}: wall "
            f"{prof['wall_ms']:.1f} ms, device busy ms "
            f"{prof['device_busy_ms']}, idle share {prof['idle_share']}; "
            f"by group ms {json.dumps(prof['by_group_ms'])}")
    del params
    torch.cuda.empty_cache()
    return res


def main() -> int:
    faulthandler.enable()
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="after phase 5, profile a second, shorter swarm")
    ap.add_argument("--report-dir",
                    default=os.path.join(HERE, "build", "chip_smoke"),
                    help="where the JSON report and the profile table go")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    from brpc_tpu_torch import native
    from brpc_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[card] {card} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} | {kind} x {torch.cuda.device_count()}")
    report = {"card": card, "torch": torch.__version__}
    t0 = time.monotonic()
    native.build()
    t_native = time.monotonic() - t0
    t0 = time.monotonic()
    _build.build()
    t_kernels = time.monotonic() - t0
    log(f"[build] native runtime {t_native:.1f} s, CUDA kernels "
        f"{t_kernels:.1f} s")
    with open(_build.PTXAS_LOG) as f:
        for line in f:
            if "registers" in line or "spill" in line or "==" in line:
                log("[ptxas] " + line.rstrip())
    report["build_s"] = {"native": t_native, "kernels": t_kernels}
    cases = phase_kernels()
    report["exact"] = phase_exactness()
    os.makedirs(args.report_dir, exist_ok=True)
    main_res = phase_main(card, args.profile, args.report_dir)
    report["main"] = main_res
    report["kernel_cases"] = cases
    with open(os.path.join(args.report_dir, "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    # One row per kernel: the bf16 case at a shape the main path gives it
    # (its 8 lanes at their last decode step; a 1024-token bucket; 8 decode
    # rows), with the launches of the main path's run.
    pick = {"paged_decode_attention": 1, "prefill_attention": 2,
            "rms_norm": 0}
    rows = []
    for name, i in pick.items():
        r = cases[name][i]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": main_res["launches"][name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
