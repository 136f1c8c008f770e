"""On-card smoke of brpc_tpu_torch: builds the native runtime and the CUDA
kernels from this checkout, holds each kernel against its plain PyTorch
version at the serving path's shapes, checks that the f32 serving engine
streams exactly the plain forward's greedy tokens (cold prompts, then
prefix-cache resumes over two chat turns), and serves Llama-3-8B at full
width and depth (random seeded weights) through the native batcher and the
kernels: first a prefix-cache phase (shared system prompt, two chat turns,
a wave that pushes the cached pages out to the host tier, and re-sent
conversations that fill back from it), then the main path's cold swarm.

    python3 chip_smoke.py            # all phases, one card
    python3 chip_smoke.py --profile  # + two short profiled swarms

Needs a CUDA card and exits nonzero without one. The last line of stdout
is {"ok": true, "device": {...}}; the line before the card's name and power
limit, and before that the per-kernel JSON. A fuller report
(chip_smoke_report.json, and with --profile the per-kernel tables
profile_prefix.txt and profile.txt) is written to
--report-dir (default build/chip_smoke).
"""

from __future__ import annotations

import argparse
import dataclasses
import faulthandler
import json
import os
import re
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
# Attention kernels also hold every output row (one (query, head) vector)
# to |kernel - plain| <= ROW_TOL |plain| in the 2-norm. Over a few thousand
# keys the outputs are about as small as TOL's atol, so TOL alone would let
# a kernel drop a whole 64-key tile, which ROW_TOL catches
# (tests/test_torch_attention_split.py). bf16 rounding of the probabilities
# and the output keeps each row of K1, K2 and K4 within 5.4e-3 (this
# script's row_rel_err, NVIDIA H100 80GB HBM3, 700 W).
ROW_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}

REPLACES = {
    "paged_decode_attention": "brpc_tpu/kv_cache.py:312",
    "prefill_attention": "brpc_tpu/models/transformer.py:242",
    "paged_prefill_attention": "brpc_tpu/kv_cache.py:1151",
    "rms_norm": "brpc_tpu/models/transformer.py:102",
}
SOURCES = {
    "paged_decode_attention":
        "brpc_tpu_torch/csrc/paged_decode_attention.cu",
    "prefill_attention": "brpc_tpu_torch/csrc/prefill_attention.cu",
    "paged_prefill_attention":
        "brpc_tpu_torch/csrc/paged_prefill_attention.cu",
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
    """Time per call between CUDA events around ``iters`` back-to-back
    calls: the device time, or the host's launch time where a call is
    shorter than its launch."""
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


def device_ms(fn, iters: int = 20):
    """Device time of fn() per call: the CUDA kernels it launched, summed
    by torch.profiler over ``iters`` calls, without the host's launch time
    (which ``time_ms`` includes once a call is shorter than its launch).
    None when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if getattr(e, "device_type", None)
             == torch.autograd.DeviceType.CUDA)
    return us / 1e3 / iters if us else None


def bound_ms(nbytes: float, flops: float, dtype) -> tuple:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def compare(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
            rows: bool = False) -> tuple:
    """-> (max abs err, max row relative err or None). Raises outside TOL
    and, with ``rows`` (an attention output), outside ROW_TOL."""
    from brpc_tpu_torch.ops import attention

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
    row_err = attention.max_row_rel_err(g, w) if rows else None
    if rows and not row_err <= ROW_TOL[dtype]:
        raise AssertionError(
            f"{name}: a row's relative error {row_err:.3e} is above "
            f"{ROW_TOL[dtype]}")
    return float(err.max()), row_err


def ptxas_summary(path: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v log: its
    template instance, registers, and stack and spill bytes."""
    out, name, spill = [], None, ""
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                m = re.search(r"\d([a-z_]+_kernel)I(13__nv_bfloat16|f)"
                              r"(?:Li(\d+)E)?", line)
                name = (f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'f32'}"
                        f"{', ' + m.group(3) if m.group(3) else ''}>"
                        if m else line.split("'")[1])
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                out.append(f"{name}: {line.split(':', 1)[1].strip()}; "
                           f"{spill}")
                name = None
    return out


def sass_mma_counts(build) -> dict:
    """Tensor-core instructions (HMMA/HGMMA) per compiled attention kernel
    of the built library, from cuobjdump -sass; fails if a bf16 K2 or K4
    kernel has none."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.LIB_PATH],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = 0
        elif name is not None and ("HMMA" in line or "HGMMA" in line):
            counts[name] += 1
    for name, n in counts.items():
        if "prefill" in name and "bfloat16" in name:
            log(f"[sass] {name}: {n} HMMA/HGMMA")
            if "merge" not in name and n == 0:
                raise AssertionError(f"{name} has no tensor-core instruction")
    if not any("prefill" in k and "bfloat16" in k for k in counts):
        raise AssertionError("no bf16 prefill kernel in the SASS")
    return counts


# ---- phase 3: each kernel against its plain version -------------------------

# Phase 3's K4 cases: (start, queries). The last one's split plan leaves
# its first rows no key in the later splits (fully masked (row, split)
# pairs, which the merge must weigh 0).
K4_CASES = ((1008, 40), (517, 300), (4000, 1), (100, 200))
# Phase 3's K2 cases: (bucket P, length); the last is the prefix phase's
# 1060-token prompt in its 2048 bucket.
K2_CASES = ((8, 5), (512, 300), (1024, 1024), (4096, 3000), (2048, 1060))

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

    err, row_err = compare("paged_decode_attention", kern(), plain(), dtype,
                           rows=True)
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
            "max_abs_err": err, "row_rel_err": row_err,
            "ms": time_ms(kern), "plain_ms":
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

    err, row_err = compare(f"prefill_attention P={P}", kern(), plain(),
                           dtype, rows=True)
    span = torch.arange(P, device=dev)
    mask = ((span[:, None] >= span[None, :])
            & (span[None, :] < length))[None, None]
    q4 = q.transpose(0, 1)[None]
    k4 = k.repeat_interleave(H // KV, dim=1).transpose(0, 1)[None]
    v4 = v.repeat_interleave(H // KV, dim=1).transpose(0, 1)[None]
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(q4, k4, v4, attn_mask=mask)

    lib_ms = time_ms(lib)
    itemsize = torch.empty((), dtype=dtype).element_size()
    pairs = sum(min(i + 1, length) for i in range(P))
    nbytes = (2 * P * H * Dh + 2 * P * KV * Dh) * itemsize
    flops = 4.0 * pairs * H * Dh
    b, by = bound_ms(nbytes, flops, dtype)
    return {"shape": f"q[{P},{H},{Dh}] kv[{P},{KV},{Dh}] length={length}",
            "max_abs_err": err, "row_rel_err": row_err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
            "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms,
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)}


def check_paged_prefill(dtype, gen, start: int, n: int) -> dict:
    from brpc_tpu_torch.ops import attention

    dev = torch.device("cuda")
    H, KV, Dh, page, L = 32, 8, 128, 16, 32
    layer = L - 1  # the last layer: exercises the pool's layer stride
    pages = -(-(start + n) // page)
    nb = pages + 5
    k_pool = torch.randn((nb, L, page, KV, Dh), generator=gen, device=dev
                         ).to(dtype)
    v_pool = torch.randn_like(k_pool)
    table = (torch.randperm(nb - 1, generator=gen, device=dev)[:pages]
             + 1).int()
    q = torch.randn((n, H, Dh), generator=gen, device=dev).to(dtype)

    def kern():
        return attention.paged_prefill_attention(q, k_pool, v_pool, table,
                                                 start, layer)

    def plain():
        return attention.paged_prefill_attention_plain(q, k_pool, v_pool,
                                                       table, start, layer)

    err, row_err = compare(f"paged_prefill_attention start={start} n={n}",
                           kern(), plain(), dtype, rows=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per, splits = attention.plan_splits(n, H, KV, start, sms)
    q_tiles = -(-(n * H // KV) // attention.TILE_ROWS)
    # rows (query, head) that see no key of some split, which the merge
    # must weigh 0
    masked_pairs = H * sum(
        min(n, max(0, lo - start))
        for lo, _ in attention.split_ranges(start, n, per, splits))
    # Library yardstick: SDPA with an explicit mask over the already
    # gathered dense K/V (the gather itself is not timed).
    T = pages * page
    idx = table.long()
    kd = k_pool[:, layer][idx].reshape(T, KV, Dh).repeat_interleave(
        H // KV, dim=1).transpose(0, 1)[None].contiguous()
    vd = v_pool[:, layer][idx].reshape(T, KV, Dh).repeat_interleave(
        H // KV, dim=1).transpose(0, 1)[None].contiguous()
    qpos = start + torch.arange(n, device=dev)
    mask = (torch.arange(T, device=dev)[None, :] <= qpos[:, None]
            )[None, None]
    q4 = q.transpose(0, 1)[None]
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)

    lib_ms = time_ms(lib)
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (2 * (start + n) * KV * Dh + 2 * n * H * Dh) * itemsize \
        + pages * 4
    flops = 4.0 * H * Dh * (n * start + n * (n + 1) / 2)
    b, by = bound_ms(nbytes, flops, dtype)
    return {"shape": f"q[{n},{H},{Dh}] start={start} pool[{nb},{L},{page},"
                     f"{KV},{Dh}]",
            "splits": splits, "tiles_per_split": per,
            "grid_blocks": q_tiles * KV * splits,
            "masked_row_splits": masked_pairs,
            "max_abs_err": err, "row_rel_err": row_err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
            "bound_ms": b,
            "bound_by": by, "library_ms": lib_ms,
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)}


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

    err, _ = compare(f"rms_norm rows={rows}", kern(), plain(), dtype)
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


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {"paged_decode_attention": [], "prefill_attention": [],
             "paged_prefill_attention": [], "rms_norm": []}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        runs = [("paged_decode_attention", check_paged_decode(
            dtype, gen, [0, 15, 16, 300, 2047, 1000, 517, 64]))]
        if dtype == torch.bfloat16:  # phase 5's last decode step
            runs.append(("paged_decode_attention", check_paged_decode(
                dtype, gen, [n + MAIN_NEW_TOKENS - 1 for n in MAIN_LENGTHS])))
        for P, length in K2_CASES:
            runs.append(("prefill_attention",
                         check_prefill(dtype, gen, P, length)))
        # page-aligned start (a turn-2 resume's shape), mid-page start with
        # a long suffix, one query deep in the cache
        for start, n in K4_CASES:
            runs.append(("paged_prefill_attention",
                         check_paged_prefill(dtype, gen, start, n)))
        for rows in (8, 1000):
            runs.append(("rms_norm", check_rms_norm(dtype, gen, rows)))
        for name, r in runs:
            r["dtype"] = tag
            cases[name].append(r)
            lib = ("n/a" if r["library_ms"] is None
                   else f"{r['library_ms']:.4f}")
            plan = (f" splits {r['splits']} x {r['tiles_per_split']} tiles, "
                    f"{r['grid_blocks']} blocks, {r['masked_row_splits']} "
                    f"fully masked (row, split) pairs;" if "splits" in r
                    else "")
            dev = ("" if "device_ms" not in r else
                   f" device_ms {fmt_ms(r['device_ms'])} library_device_ms "
                   f"{fmt_ms(r['library_device_ms'])}")
            row = ("" if r.get("row_rel_err") is None else
                   f" row_rel_err {r['row_rel_err']:.3e}")
            log(f"[kernel] {name} {tag} {r['shape']}:{plan} max_abs_err "
                f"{r['max_abs_err']:.3e}{row} ms {r['ms']:.4f} plain_ms "
                f"{r['plain_ms']:.4f} bound_ms {r['bound_ms']:.5f} "
                f"({r['bound_by']}) library_ms {lib}{dev}")
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


def phase_exactness(cfg) -> dict:
    from brpc_tpu_torch import ops, serving
    from brpc_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
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
        # Two chat turns over a shared 40-token prefix (a mid-page start):
        # p0 is the prefix itself and keeps decoding while a and b extend
        # it, so their resumes copy p0's shared tail page; then each
        # conversation's follow-up resumes off its finished first turn.
        p0 = rng.integers(0, cfg.vocab, 40).tolist()
        a = p0 + rng.integers(0, cfg.vocab, 10).tolist()
        b = p0 + rng.integers(0, cfg.vocab, 23).tolist()
        ops.reset_launch_counts()
        s0 = eng.stats()
        with serving.ServingClient(f"127.0.0.1:{eng.port}",
                                   timeout_ms=600_000) as c:
            it = c.generate(p0, 40)
            first = next(it)
            ab = run_swarm(eng, [a, b], 8)["tokens"]
            r0 = [first] + list(it)
        turn1 = [(p0, r0), (a, ab[0]), (b, ab[1])]
        turn2 = [p + r + rng.integers(0, cfg.vocab, 3 + i).tolist()
                 for i, (p, r) in enumerate(turn1)]
        t2 = run_swarm(eng, turn2, 8)["tokens"]
        launches = ops.launch_counts()
        s1 = eng.stats()
    finally:
        eng.close()
    log("[exact] streams done; rolling out the plain forward")
    for i, p in enumerate(prompts):
        ref = transformer.greedy_reference(params, cfg, p, 8)
        if out["tokens"][i] != ref:
            raise AssertionError(f"f32 stream {i} (prompt {len(p)}): "
                                 f"{out['tokens'][i]} != plain {ref}")
    chats = turn1 + [(p, t2[i]) for i, p in enumerate(turn2)]
    for i, (p, toks) in enumerate(chats):
        ref = transformer.greedy_reference(params, cfg, p, len(toks))
        if toks != ref:
            raise AssertionError(f"f32 chat stream {i} (prompt {len(p)}): "
                                 f"{toks} != plain {ref}")
    resumes = s1["resumes"] - s0["resumes"]
    cows = s1["kv_prefix_cow_copies"] - s0["kv_prefix_cow_copies"]
    if resumes < 5 or cows < 1:
        raise AssertionError(f"chat script resumed {resumes} times with "
                             f"{cows} copy-on-writes; want >= 5 and >= 1")
    if launches["paged_prefill_attention"] != cfg.n_layers * resumes:
        raise AssertionError(f"K4 launched "
                             f"{launches['paged_prefill_attention']} times "
                             f"over {resumes} resumes")
    log(f"[exact] f32 Llama-3-8B width, {cfg.n_layers} layers: 4 "
        f"concurrent streams "
        f"(prompts 5/16/17/100, 8 tokens) identical to the plain forward's "
        f"greedy rollout; two chat turns over a 40-token shared prefix: "
        f"{resumes} resumes ({cows} copy-on-write), all 6 streams identical "
        f"to the plain rollout of the full prompt")
    del params
    torch.cuda.empty_cache()
    return {"streams": [out["tokens"][i] for i in range(len(prompts))],
            "chat_streams": [t for _, t in chats], "resumes": resumes,
            "cow_copies": cows}


def flight_ttfts(n: int) -> tuple:
    """TTFT (ms) of the newest ``n`` finished requests, split into prefix
    hits (routed HBM_HIT or HOST_FILL) and misses, and how many carry
    HOST_FILL."""
    from brpc_tpu_torch import runtime

    hit_bits = runtime.ROUTE_HBM_HIT | runtime.ROUTE_HOST_FILL
    hits, misses, host = [], [], 0
    for r in runtime.flight_records(max_items=n, oldest_first=False):
        route = int(r.get("route", 0))
        (hits if route & hit_bits else misses).append(
            int(r.get("ttft_us", 0)) / 1e3)
        host += bool(route & runtime.ROUTE_HOST_FILL)
    return sorted(hits), sorted(misses), host


def p50(xs):
    return xs[len(xs) // 2] if xs else None


# TTFT segments from the flight records' phase stamps: queued in the
# batcher, waiting behind the earlier admissions of the same engine step,
# the prefill or resume itself, and the rest up to the first token (the
# prefix index's admission with its host-tier export, then the emit).
TTFT_SEGMENTS = (("queue", "admit_us", "batch_formed_us"),
                 ("wait", "batch_formed_us", "prefill_start_us"),
                 ("prefill", "prefill_start_us", "prefill_done_us"),
                 ("admit_emit", "prefill_done_us", "first_emit_us"))


def ttft_breakdown(n: int) -> dict:
    """Mean ms of each TTFT segment over the newest ``n`` finished
    requests."""
    from brpc_tpu_torch import runtime

    recs = runtime.flight_records(max_items=n, oldest_first=False)
    out = {}
    for name, a, b in TTFT_SEGMENTS:
        spans = [(r[b] - r[a]) / 1e3 for r in recs if a in r and b in r]
        out[name] = sum(spans) / len(spans) if spans else None
    return out


# Prefix phase: a 1000-token system prompt (62 full pages + 8 tokens) and
# eight user suffixes; the second conversation extends the first's
# mid-page prompt (1060 tokens) while that one is still decoding.
SYSTEM_TOKENS = 1000
USER_TOKENS = (60, 100, 24, 300, 150, 77, 211, 33)
PREFIX_NEW = 32
TURN2_TOKENS = 40
WAVE3 = (8, 800, 8)  # prompts, tokens each, new tokens
# The host tier's budget: 2 GiB at Llama-3-8B width. The store evicts in
# export order and the phase exports about 610 pages (both chat turns, then
# the third wave), so at 512 pages the system prompt's pages, exported
# first, would be gone before the re-send.
HOST_PAGES = 1024


def phase_prefix(params, cfg, card: str, profile_it: bool,
                 report_dir: str) -> dict:
    """The prefix-cache serving path at full width: turn 1 of eight
    conversations over one system prompt, turn 2 off the finished turn 1,
    a third wave of unrelated prompts that evicts the cached pages into
    the host tier, and two turn-1 conversations re-sent, which fill back
    from it. With ``profile_it``, two more turn-1 conversations re-sent
    under the profiler afterwards (prefix hits: resumes)."""
    from brpc_tpu_torch import kv_cache, ops, runtime, serving

    rng = np.random.default_rng(2)
    vocab = cfg.vocab
    system = rng.integers(0, vocab, SYSTEM_TOKENS).tolist()
    users = [rng.integers(0, vocab, USER_TOKENS[0]).tolist()]
    users.append(users[0] + rng.integers(
        0, vocab, USER_TOKENS[1] - USER_TOKENS[0]).tolist())
    users += [rng.integers(0, vocab, n).tolist() for n in USER_TOKENS[2:]]
    turn1 = [system + u for u in users]
    n3, len3, new3 = WAVE3
    wave3 = [rng.integers(0, vocab, len3).tolist() for _ in range(n3)]
    # The pool holds the whole third wave live and little else, so the
    # wave pushes the two chat turns' pages off the LRU.
    blocks = n3 * kv_cache.pages_for(len3 + new3, 16) + 16
    eng = serving.ServingEngine(params, cfg, max_batch_size=8, slots=8,
                                max_prompt=2048, kv_blocks=blocks,
                                kv_host_budget_bytes=HOST_PAGES *
                                kv_cache.host_page_bytes(cfg, 16))
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        t0 = time.monotonic()
        # The first conversation goes first and keeps decoding while the
        # other seven arrive: the second extends its mid-page prompt.
        with serving.ServingClient(f"127.0.0.1:{eng.port}",
                                   timeout_ms=600_000) as c:
            it = c.generate(turn1[0], PREFIX_NEW)
            first = next(it)
            rest = run_swarm(eng, turn1[1:], PREFIX_NEW)["tokens"]
            r1 = {0: [first] + list(it)}
        r1.update({i + 1: t for i, t in rest.items()})
        turn2 = [p + r1[i] + rng.integers(0, vocab, TURN2_TOKENS).tolist()
                 for i, p in enumerate(turn1)]
        r2 = run_swarm(eng, turn2, PREFIX_NEW)["tokens"]
        s_chat = eng.stats()
        r3 = run_swarm(eng, wave3, new3)["tokens"]
        s_wave = eng.stats()
        again = [turn1[2], turn1[3]]
        r4 = run_swarm(eng, again, 8)["tokens"]
        wall = time.monotonic() - t0
        launches = ops.launch_counts()
        stats = eng.stats()
        n_req = len(turn1) + len(turn2) + len(wave3) + len(again)
        hits, misses, host_routed = flight_ttfts(n_req)
        segments = ttft_breakdown(n_req)
        prof = (profile_swarm(eng, [turn1[4], turn1[5]], 8, report_dir,
                              "profile_prefix.txt") if profile_it else None)
    finally:
        eng.close()
    L = cfg.n_layers
    if launches["paged_prefill_attention"] != L * stats["resumes"] \
            or stats["resumes"] == 0:
        raise AssertionError(f"K4 launched "
                             f"{launches['paged_prefill_attention']} times "
                             f"over {stats['resumes']} resumes")
    if launches["prefill_attention"] != L * stats["prefills"]:
        raise AssertionError(f"K2 launched {launches['prefill_attention']} "
                             f"times over {stats['prefills']} prefills")
    steps = stats["model_steps"]
    if launches["paged_decode_attention"] != L * steps or steps == 0:
        raise AssertionError(f"K1 launched "
                             f"{launches['paged_decode_attention']} times "
                             f"over {steps} decode steps")
    if launches["rms_norm"] != (2 * L + 1) * (
            steps + stats["prefills"] + stats["resumes"]):
        raise AssertionError(f"K3 launched {launches['rms_norm']} times")
    if stats["kv_prefix_hits"] < 15:
        raise AssertionError(f"{stats['kv_prefix_hits']} prefix hits, "
                             f"want >= 15")
    if stats["kv_prefix_cow_copies"] < 1:
        raise AssertionError("no copy-on-write of a shared tail page")
    host_fills = stats["kv_prefix_host_hits"] - s_wave["kv_prefix_host_hits"]
    if host_fills < 1 or host_routed < 1 or stats["kv_tier_spills"] < 1:
        raise AssertionError(
            f"re-sent conversations did not fill from the host tier: "
            f"host hits {host_fills}, HOST_FILL routes {host_routed}, "
            f"spills {stats['kv_tier_spills']}")
    for toks in (*r1.values(), *r2.values(), *r3.values(), *r4.values()):
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError("token id out of vocabulary")
    res = {
        "card": card, "requests": n_req, "wall_s": wall,
        "system_tokens": SYSTEM_TOKENS, "user_tokens": list(USER_TOKENS),
        "prefills": stats["prefills"], "resumes": stats["resumes"],
        "prefill_ms_mean": 1e3 * stats["prefill_seconds"]
        / max(1, stats["prefills"]),
        "resume_ms_mean": 1e3 * stats["resume_seconds"]
        / max(1, stats["resumes"]),
        "ttft_p50_hit_ms": p50(hits), "ttft_p50_miss_ms": p50(misses),
        "hit_requests": len(hits), "miss_requests": len(misses),
        "host_fill_requests": host_routed,
        "kv_prefix_hits": stats["kv_prefix_hits"],
        "kv_prefix_misses": stats["kv_prefix_misses"],
        "kv_prefix_cow_copies": stats["kv_prefix_cow_copies"],
        "kv_prefix_host_hits": stats["kv_prefix_host_hits"],
        "kv_prefix_evictions": stats["kv_prefix_evictions"],
        "kv_tier_spills": stats["kv_tier_spills"],
        "kv_tier_fills": stats["kv_tier_fills"],
        "kv_tier_evictions": stats["kv_tier_evictions"],
        "kv_evictions_wave3": s_wave["kv_evictions"] - s_chat["kv_evictions"],
        "kv_blocks": blocks, "ttft_segments_ms": segments,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "launches": launches, "profile": prof,
    }
    log(f"[prefix] Llama-3-8B bf16 {L} layers, {card}: {n_req} requests "
        f"in {wall:.3f} s; {res['prefills']} cold prefills "
        f"{res['prefill_ms_mean']:.2f} ms mean, {res['resumes']} resumes "
        f"{res['resume_ms_mean']:.2f} ms mean; TTFT p50 hits "
        f"{res['ttft_p50_hit_ms']} ms ({len(hits)}) misses "
        f"{res['ttft_p50_miss_ms']} ms ({len(misses)}); prefix hits "
        f"{res['kv_prefix_hits']}, copy-on-write "
        f"{res['kv_prefix_cow_copies']}, host fills {host_fills} "
        f"({host_routed} HOST_FILL routes), tier spills "
        f"{res['kv_tier_spills']} evictions {res['kv_tier_evictions']}; "
        f"peak memory {res['peak_mem_gib']:.2f} GiB; TTFT segments mean ms "
        f"{fmt_segments(segments)}; launches {launches}")
    if prof is not None:
        log(f"[profile] prefix hits, 2 requests x 8 tokens, {card}: wall "
            f"{prof['wall_ms']:.1f} ms, device busy ms "
            f"{prof['device_busy_ms']}, idle share {prof['idle_share']}; "
            f"by group ms {json.dumps(prof['by_group_ms'])}")
    return res


def fmt_segments(segments: dict) -> str:
    return " ".join(f"{k} {v:.2f}" if v is not None else f"{k} n/a"
                    for k, v in segments.items())


def profile_swarm(engine, prompts, max_new: int, report_dir: str,
                  table_name: str = "profile.txt") -> dict:
    """A second, shorter swarm under torch.profiler: device time by kernel
    group over the wall time (the measured swarm runs unprofiled); the
    per-kernel table goes to ``table_name`` in ``report_dir``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        run_swarm(engine, prompts, max_new)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
    groups = {"K1 paged_decode_attention": 0.0, "K2 prefill_attention": 0.0,
              "K3 rms_norm": 0.0, "K4 paged_prefill_attention": 0.0,
              "matmul (cuBLAS)": 0.0, "other": 0.0}
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
        elif "paged_prefill" in name:  # K4's split pass and its merge
            g = "K4 paged_prefill_attention"
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
    with open(os.path.join(report_dir, table_name), "w") as f:
        for us, n, key in table:
            f.write(f"{us / 1e3:10.3f} ms {n:7d}x {key}\n")
    busy = sum(groups.values())
    if busy == 0:  # the profiler saw no device activity: not measured
        return {"wall_ms": 1e3 * wall, "device_busy_ms": None,
                "idle_share": None, "by_group_ms": None}
    return {"wall_ms": 1e3 * wall, "device_busy_ms": busy,
            "idle_share": 1.0 - busy / (1e3 * wall), "by_group_ms": groups}


def phase_main(params, cfg, init_s: float, card: str, profile_it: bool,
               report_dir: str) -> dict:
    from brpc_tpu_torch import kv_cache, ops, serving

    rng = np.random.default_rng(0)
    lengths = MAIN_LENGTHS
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in lengths]
    max_new = MAIN_NEW_TOKENS
    blocks = len(prompts) * kv_cache.pages_for(max(lengths) + max_new, 16) + 1
    log("[main] starting the engine")
    eng = serving.ServingEngine(params, cfg, max_batch_size=8, slots=8,
                                max_prompt=1024, kv_blocks=blocks)
    try:
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        out = run_swarm(eng, prompts, max_new)
        launches = ops.launch_counts()
        stats = eng.stats()
        segments = ttft_breakdown(len(prompts))
        prof = (profile_swarm(eng, prompts, 8, report_dir) if profile_it
                else None)
    finally:
        eng.close()
    steps, prefills = stats["model_steps"], stats["prefills"]
    resumes = stats["resumes"]  # random prompts: no shared prefix, none
    L = cfg.n_layers
    if launches["paged_decode_attention"] != L * steps:
        raise AssertionError(f"K1 launched {launches['paged_decode_attention']}"
                             f" times, want {L} x {steps} decode steps")
    if launches["prefill_attention"] != L * prefills or prefills == 0:
        raise AssertionError(f"K2 launched {launches['prefill_attention']} "
                             f"times over {prefills} prefills")
    if launches["paged_prefill_attention"] != L * resumes:
        raise AssertionError(f"K4 launched "
                             f"{launches['paged_prefill_attention']} times "
                             f"over {resumes} resumes")
    if launches["rms_norm"] != (2 * L + 1) * (steps + prefills + resumes):
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
        "resumes": resumes,
        "tokens_per_s": n_tok / out["wall_s"],
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                      int(0.99 * len(ttft)))],
        "decode_step_ms": 1e3 * stats["decode_seconds"] / steps,
        "prefill_ms_mean": 1e3 * stats["prefill_seconds"] / prefills,
        "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
        "weights_init_s": init_s, "ttft_segments_ms": segments,
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
        f"{prefills}; peak memory {res['peak_mem_gib']:.2f} GiB; TTFT "
        f"segments mean ms {fmt_segments(segments)}; launches {launches}")
    if prof is not None:
        log(f"[profile] 8 more requests x 8 tokens, {card}: wall "
            f"{prof['wall_ms']:.1f} ms, device busy ms "
            f"{prof['device_busy_ms']}, idle share {prof['idle_share']}; "
            f"by group ms {json.dumps(prof['by_group_ms'])}")
    return res


def main() -> int:
    faulthandler.enable()
    # The host tier keeps its pages on the heap: in the registered send
    # arena (256 MiB unless TRPC_DEVICE_ARENA_MB says otherwise) its budget
    # would be capped at half the arena, 64 pages at Llama-3-8B width.
    os.environ.setdefault("TRPC_KV_HOST_ARENA", "0")
    ap = argparse.ArgumentParser()
    ap.add_argument("--profile", action="store_true",
                    help="profile a short swarm after the prefix phase "
                    "and after phase 5 (both re-send prompts the cache "
                    "holds: resumes and decode)")
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
    for line in ptxas_summary(_build.PTXAS_LOG):
        log("[ptxas] " + line)
        if ("prefill" in line and "<bf16, 128>" in line
                and " 0 bytes spill stores" not in line):
            raise AssertionError(f"the Llama-width tile spills: {line}")
    report["build_s"] = {"native": t_native, "kernels": t_kernels}
    report["sass_mma"] = sass_mma_counts(_build)
    cases = phase_kernels()
    from brpc_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.llama3_8b()
    report["exact"] = phase_exactness(
        dataclasses.replace(cfg, n_layers=2, dtype=torch.float32))
    os.makedirs(args.report_dir, exist_ok=True)
    t0 = time.monotonic()
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    torch.cuda.synchronize()
    init_s = time.monotonic() - t0
    log(f"[weights] Llama-3-8B bf16 random weights in {init_s:.1f} s")
    report["prefix"] = phase_prefix(params, cfg, card, args.profile,
                                    args.report_dir)
    main_res = phase_main(params, cfg, init_s, card, args.profile,
                          args.report_dir)
    report["main"] = main_res
    report["kernel_cases"] = cases
    with open(os.path.join(args.report_dir, "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    # One row per kernel: the bf16 case at a shape its path gives it (the
    # main path's 8 lanes at their last decode step; a 1024-token bucket;
    # a turn-2 resume's 40 rows after 1008 cached tokens; 8 decode rows),
    # with the launches of its path's run: K4's from the prefix phase, the
    # others from the main path's.
    pick = {"paged_decode_attention": 1, "prefill_attention": 2,
            "paged_prefill_attention": 0, "rms_norm": 0}
    runs = {name: main_res for name in pick}
    runs["paged_prefill_attention"] = report["prefix"]
    rows = []
    for name, i in pick.items():
        r = cases[name][i]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name],
            "launches": runs[name]["launches"][name],
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
