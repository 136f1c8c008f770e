"""On-card smoke of brpc_tpu_torch: builds the native runtime and the CUDA
kernels from this checkout, holds each kernel against its plain PyTorch
version at the serving path's shapes, checks that the f32 serving engine
streams exactly the plain forward's greedy tokens (cold prompts, then
prefix-cache resumes over two chat turns), and serves Llama-3-8B at full
width and depth (random seeded weights) through the native batcher and the
kernels: first a prefix-cache phase (shared system prompt, two chat turns,
a wave that pushes the cached pages out to the host tier, and re-sent
conversations that fill back from it), then the main path's cold swarm,
then the same lengths through the disaggregated path (the port's router,
a layer-wise prefill worker and a decode worker, each on its own CUDA
stream), whose f32 exactness phase 4 also checks. Before the serving
phases, the parallelism path: K5 (the ring-attention block fold) at
Llama-3-8B's attention width over S 32768 as 8 in-process ranks, held
against its plain fold step by step and against dense attention at S
8192, then the collectives, ring attention, the GPipe pipeline and the
expert-parallel MoE through an NCCL world of one rank.

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
import struct
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
    "add_rms_norm": "brpc_tpu/models/transformer.py:102",
    "ring_attention_fold": "brpc_tpu/ops/ring_attention.py:65",
}
SOURCES = {
    "paged_decode_attention":
        "brpc_tpu_torch/csrc/paged_decode_attention.cu",
    "prefill_attention": "brpc_tpu_torch/csrc/prefill_attention.cu",
    "paged_prefill_attention":
        "brpc_tpu_torch/csrc/paged_prefill_attention.cu",
    "rms_norm": "brpc_tpu_torch/csrc/rms_norm.cu",
    "add_rms_norm": "brpc_tpu_torch/csrc/rms_norm.cu",
    "ring_attention_fold": "brpc_tpu_torch/csrc/ring_attention.cu",
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


# Kernels on the shared attention tile core (K1, K2, K4, K5, and the
# merges).
TILE_KERNEL = re.compile(r"prefill|paged_decode|ring_attention")


def sass_mma_counts(build) -> dict:
    """Tensor-core instructions (HMMA/HGMMA) per compiled attention kernel
    of the built library, from cuobjdump -sass; fails if a bf16 K1, K2 or
    K4 kernel has none, or if the decode kernel K1 is missing."""
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
        if TILE_KERNEL.search(name) and "bfloat16" in name:
            log(f"[sass] {name}: {n} HMMA/HGMMA")
            if "merge" not in name and n == 0:
                raise AssertionError(f"{name} has no tensor-core instruction")
    for kind in ("prefill", "paged_decode_kernel", "ring_attention_fold"):
        if not any(kind in k and "bfloat16" in k for k in counts):
            raise AssertionError(f"no bf16 {kind} kernel in the SASS")
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
# Phase 3's K1 cases: (positions of 8 lanes, table columns (None: the pages
# in play, as the engine sends them), idle lanes). Short and long lanes over
# the full 512-column table (max_seq / page); phase 5's last decode step;
# a lane at max_seq - 1 beside short ones; every lane idle but one.
K1_CASES = (([0, 15, 16, 300, 2047, 1000, 517, 64], 512, ()),
            ([n + MAIN_NEW_TOKENS - 1 for n in MAIN_LENGTHS], None, ()),
            ([8191, 0, 15, 16, 100, 64, 33, 7], 512, ()),
            ([0] * 7 + [1055], None, tuple(range(7))))


def check_paged_decode(dtype, gen, pos_list, width=None, idle=()) -> dict:
    """K1 over 8 lanes at ``pos_list`` on the last layer of a 32-layer
    pool, its table ``width`` columns wide (None: the pages in play, as
    the engine sends it); lanes in ``idle`` decode at pos 0 through
    garbage block 0, as free slots do."""
    from brpc_tpu_torch.ops import attention

    dev = torch.device("cuda")
    S, H, KV, Dh, page, L = len(pos_list), 32, 8, 128, 16, 32
    layer = L - 1  # the last layer: exercises the pool's layer stride
    need = [0 if s in idle else p // page + 1 for s, p in enumerate(pos_list)]
    width = width or max(need)
    nb = sum(need) + 1
    k_pool = torch.randn((nb, L, page, KV, Dh), generator=gen, device=dev
                         ).to(dtype)
    v_pool = torch.randn_like(k_pool)
    perm = torch.randperm(nb - 1, generator=gen, device=dev).int() + 1
    tables = torch.zeros((S, width), dtype=torch.int32, device=dev)
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

    err, row_err = compare(f"paged_decode_attention pos={pos_list}", kern(),
                           plain(), dtype, rows=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per, splits = attention.plan_decode_splits(S, KV, width * page, sms)
    # (row, split) pairs wholly past their lane's pos: empty blocks whose
    # rows the merge must weigh 0
    masked_pairs = H * sum(lo > p for p in pos_list for lo, _ in
                           attention.split_ranges(0, width * page, per,
                                                  splits))
    # Library yardstick: SDPA with an explicit mask over the already
    # gathered dense K/V (the gather itself is not timed).
    T = max(max(need), 1) * page
    idx = tables[:, :T // page].long()
    kd = k_pool[:, layer][idx].reshape(S, T, KV, Dh).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
    vd = v_pool[:, layer][idx].reshape(S, T, KV, Dh).repeat_interleave(
        H // KV, dim=2).transpose(1, 2).contiguous()
    mask = (torch.arange(T, device=dev)[None, :] <= pos.long()[:, None]
            )[:, None, None, :]
    q4 = q[:, :, None, :]
    F = torch.nn.functional

    def lib():
        return F.scaled_dot_product_attention(q4, kd, vd, attn_mask=mask)

    itemsize = torch.empty((), dtype=dtype).element_size()
    keys = sum(p + 1 for p in pos_list)
    nbytes = (2 * keys * KV * Dh + 2 * S * H * Dh) * itemsize \
        + tables.numel() * 4 + S * 4
    flops = 4.0 * keys * H * Dh
    b, by = bound_ms(nbytes, flops, dtype)
    return {"shape": f"q[{S},{H},{Dh}] pool[{nb},{L},{page},{KV},{Dh}] "
                     f"table[{S},{width}] pos={pos_list}"
                     + (f" idle={list(idle)}" if idle else ""),
            "splits": splits, "tiles_per_split": per,
            "grid_blocks": S * KV * splits,
            "masked_row_splits": masked_pairs,
            "max_abs_err": err, "row_rel_err": row_err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain, iters=5),
            "bound_ms": b, "bound_by": by, "library_ms": time_ms(lib),
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)}


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
    g_dt = g.to(dtype)

    def lib():
        return F.rms_norm(x, (D,), weight=g_dt, eps=eps)

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * rows * D * itemsize + D * 4
    b, by = bound_ms(nbytes, 4.0 * rows * D, dtype)
    return {"shape": f"x[{rows},{D}]", "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by, "library_ms": time_ms(lib),
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)}


def check_add_rms_norm(dtype, gen, rows: int) -> dict:
    """K3's fused entry: the residual add and the norm after it, against
    its plain version (the sum must be bit-equal to torch's x + delta) and
    against the two library calls it replaces, x + delta then
    F.rms_norm."""
    from brpc_tpu_torch.ops import norm

    dev = torch.device("cuda")
    D, eps = 4096, 1e-5
    x = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    delta = torch.randn((rows, D), generator=gen, device=dev).to(dtype)
    g = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)

    def kern():
        return norm.add_rms_norm(x, delta, g, eps)

    def plain():
        return norm.add_rms_norm_plain(x, delta, g, eps)

    (s_got, h_got), (s_want, h_want) = kern(), plain()
    if not torch.equal(s_got, s_want):
        raise AssertionError(f"add_rms_norm rows={rows}: the sum differs "
                             f"from x + delta")
    err, _ = compare(f"add_rms_norm rows={rows}", h_got, h_want, dtype)
    F = torch.nn.functional
    g_dt = g.to(dtype)

    def lib():
        s = x + delta
        return s, F.rms_norm(s, (D,), weight=g_dt, eps=eps)

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * rows * D * itemsize + D * 4
    b, by = bound_ms(nbytes, 5.0 * rows * D, dtype)
    return {"shape": f"x[{rows},{D}] + delta", "max_abs_err": err,
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by, "library_ms": time_ms(lib),
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)}


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {name: [] for name in SOURCES}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype).replace("torch.", "")
        runs = [("paged_decode_attention", check_paged_decode(
            dtype, gen, pos, width, idle)) for pos, width, idle in K1_CASES]
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
            runs.append(("add_rms_norm", check_add_rms_norm(dtype, gen,
                                                             rows)))
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


# ---- the parallel phase: K5, the collectives, the pipeline, MoE -------------

# K5 at Llama-3-8B's attention width (TransformerConfig.llama3_8b: H 32, Dh
# 128), B 1: S 32768 as 8 in-process ranks of 4096, and S 8192 (8 x 1024)
# against dense attention (dense at 32768 would need 137 GB of f32 scores).
RING_RANKS = 8
RING_S = 32768
RING_DENSE_S = 8192
RING_H, RING_DH = 32, 128


def ring_launches(n: int, causal: bool) -> int:
    """K5 launches of one in-process ring of n ranks: every fold, except
    that a causal block above the diagonal launches only as a rank's last
    step (to write its output)."""
    if not causal:
        return n * n
    return n * (n + 1) // 2 + n - 1


def ring_blocks(gen, dtype, S: int) -> tuple:
    """q, k, v of one sequence [1, S, H, Dh], each cut into RING_RANKS
    blocks on dim 1 (rank order)."""
    shape = (1, S, RING_H, RING_DH)
    full = [torch.randn(shape, generator=gen, device="cuda").to(dtype)
            for _ in range(3)]
    return full, [list(t.split(S // RING_RANKS, dim=1)) for t in full]


def check_ring_fold(dtype, gen, causal: bool) -> dict:
    """K5 step by step against the plain fold (the reference's ``step``)
    through an in-process ring at S 32768: after every step each rank's
    state, normalised, is held to TOL and ROW_TOL; then each rank's output
    (the kernel's last-step epilogue) against the plain fold's. Returns the
    worst errors, the inputs and the ring's outputs."""
    from brpc_tpu_torch.ops import ring_attention as ra

    n, s = RING_RANKS, RING_S // RING_RANKS
    _, (qs, ks, vs) = ring_blocks(gen, dtype, RING_S)
    tag = f"ring_attention_fold {str(dtype)[6:]} causal={causal}"
    worst, worst_row, finals = 0.0, 0.0, []
    for my in range(n):
        state, plain = ra.fold_state(qs[my]), ra.fold_state(qs[my])
        for t in range(n):
            src = (my - t) % n
            state = ra.ring_attention_fold(qs[my], ks[src], vs[src], state,
                                           my * s, src * s, causal)
            plain = ra.ring_attention_fold_plain(qs[my], ks[src], vs[src],
                                                 plain, my * s, src * s,
                                                 causal)
            err, row = compare(f"{tag} rank {my} step {t}",
                               ra.fold_output(state, torch.float32),
                               ra.fold_output(plain, torch.float32), dtype,
                               rows=True)
            worst, worst_row = max(worst, err), max(worst_row, row)
        finals.append(ra.fold_output(plain, dtype))
        del state, plain
    outs = ra.ring_attention_local(qs, ks, vs, causal)
    for my in range(n):
        err, row = compare(f"{tag} rank {my} output", outs[my], finals[my],
                           dtype, rows=True)
        worst, worst_row = max(worst, err), max(worst_row, row)
    return {"max_abs_err": worst, "row_rel_err": worst_row,
            "inputs": (qs, ks, vs), "outputs": outs}


def check_ring_dense(dtype, gen, causal: bool) -> tuple:
    """The in-process ring at S 8192 against dense attention."""
    from brpc_tpu_torch.ops import ring_attention as ra

    (q, k, v), (qs, ks, vs) = ring_blocks(gen, dtype, RING_DENSE_S)
    got = torch.cat(ra.ring_attention_local(qs, ks, vs, causal), dim=1)
    want = ra.attention_reference(q, k, v, causal)
    return compare(f"ring_attention S={RING_DENSE_S} {str(dtype)[6:]} "
                   f"causal={causal} vs dense", got, want, dtype, rows=True)


def time_ring_fold(dtype, gen) -> dict:
    """One fold of a block with every key visible (rank 1 folding rank 0's
    block) and one diagonal block, s 4096; the plain fold; SDPA over the
    same block as the library yardstick."""
    from brpc_tpu_torch.ops import ring_attention as ra

    s, H, D = RING_S // RING_RANKS, RING_H, RING_DH
    q, k, v = (torch.randn((1, s, H, D), generator=gen, device="cuda")
               .to(dtype) for _ in range(3))
    state = ra.fold_state(q)

    def kern():
        return ra.ring_attention_fold(q, k, v, state, s, 0, True)

    def diag():
        return ra.ring_attention_fold(q, k, v, state, s, s, True)

    def plain():
        return ra.ring_attention_fold_plain(q, k, v, state, s, 0, True)

    F = torch.nn.functional
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))

    def lib():
        return F.scaled_dot_product_attention(q4, k4, v4)

    itemsize = torch.empty((), dtype=dtype).element_size()
    # q, k, v read; the state (o and (m, l), f32) read and written.
    nbytes = 3 * s * H * D * itemsize + 2 * s * H * (D + 2) * 4
    b, by = bound_ms(nbytes, 4.0 * H * s * s * D, dtype)
    b_diag, _ = bound_ms(nbytes, 4.0 * H * D * s * (s + 1) / 2, dtype)
    return {"shape": f"q,k,v[1,{s},{H},{D}] one block, every key visible",
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "diag_ms": time_ms(diag), "diag_bound_ms": b_diag,
            "plain_ms": time_ms(plain, iters=5), "bound_ms": b,
            "bound_by": by, "library_ms": time_ms(lib),
            "library_device_ms": device_ms(lib)}


def phase_world(gen) -> dict:
    """The collectives, ring attention, the pipeline and MoE through an
    NCCL process group of world size 1 on the card (one card cannot hold
    two NCCL ranks: the CPU tests run them in gloo worlds of 4). f32 with
    TF32 off for the pipeline and MoE."""
    import socket

    import torch.distributed as dist
    from brpc_tpu_torch import parallel as par
    from brpc_tpu_torch.models import moe
    from brpc_tpu_torch.ops import ring_attention as ra
    from brpc_tpu_torch.parallel.pipeline import pipeline_forward

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    t0 = time.monotonic()
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    res = {"init_s": time.monotonic() - t0}
    try:
        x = torch.randn((4, 1024), generator=gen, device=dev)
        for name, got in (
                ("all_gather", par.all_gather(x)),
                ("all_reduce", par.all_reduce(x)),
                ("reduce_scatter", par.reduce_scatter(x[None])[0]),
                ("all_to_all", par.all_to_all(x[:1])),
                ("ring_shift", par.ring_shift(x, 1)),
                ("fanout_concat", par.fanout_call(
                    lambda r, a: a * (r + 1), x, "concat")),
                ("fanout_sum", par.fanout_call(
                    lambda r, a: a * (r + 1), x, "sum"))):
            want = x[:1] if name == "all_to_all" else x
            if not torch.equal(got, want):
                raise AssertionError(f"{name} in a world of one changed "
                                     f"its input")
        (q, k, v), _ = ring_blocks(gen, torch.bfloat16, 4096)
        res["ring_err"] = compare("ring_attention, world of one, S 4096",
                                  ra.ring_attention(q, k, v, True),
                                  ra.attention_reference(q, k, v, True),
                                  torch.bfloat16, rows=True)
        # GPipe: 4 stages of tanh(a @ w) at width 4096 (the one rank holds
        # all 4), 8 microbatches of 512 rows.
        w = torch.randn((4, 4096, 4096), generator=gen, device=dev) \
            * 4096 ** -0.5
        xs = torch.randn((8, 512, 4096), generator=gen, device=dev)

        def stage(p, a):
            return torch.tanh(a @ p)

        t0 = time.monotonic()
        ys = pipeline_forward(stage, w, xs)
        torch.cuda.synchronize()
        res["pipeline_ms"] = (time.monotonic() - t0) * 1e3
        want = xs
        for i in range(4):
            want = stage(w[i], want)
        res["pipeline_err"] = compare("pipeline_forward", ys, want,
                                      torch.float32)[0]
        del w, xs, ys, want
        # MoE at Llama-3-8B's MLP width, 8 experts, f32: ample capacity
        # (512 tokens, no drop) and capacity 16 (drops).
        p = moe.moe_init(torch.Generator(device=dev).manual_seed(7), 4096,
                         14336, 8, device=dev)
        xm = torch.randn((4, 128, 4096), generator=gen, device=dev)
        for cap in (512, 16):
            t0 = time.monotonic()
            got = moe.moe_forward(p, xm, cap)
            torch.cuda.synchronize()
            ms = (time.monotonic() - t0) * 1e3
            want = moe.moe_reference(p, xm, cap)
            kept = int(moe._route(xm.reshape(-1, 4096), p["router"], cap,
                                  8)[0].sum())
            res[f"moe_cap{cap}"] = {
                "max_abs_err": compare(f"moe_forward capacity {cap}", got,
                                       want, torch.float32)[0],
                "tokens_kept": kept, "ms": ms}
        if res["moe_cap512"]["tokens_kept"] != 512 or \
                res["moe_cap16"]["tokens_kept"] >= 512:
            raise AssertionError(f"MoE capacities did not keep all tokens "
                                 f"and then drop some: {res}")
        del p, xm
    finally:
        dist.destroy_process_group()
    return res


def phase_parallel() -> dict:
    """K5 against its plain fold and dense attention, its timings, then the
    main run of this path: counts zeroed, the in-process causal bf16 ring
    at S 32768 and the NCCL world, counts read."""
    from brpc_tpu_torch import ops
    from brpc_tpu_torch.ops import ring_attention as ra

    gen = torch.Generator(device="cuda").manual_seed(11)
    res = {"fold": {}, "dense": {}, "timing": {}}
    t_phase = time.monotonic()
    main_in = main_out = None
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for causal in (True, False):
            r = check_ring_fold(dtype, gen, causal)
            if dtype == torch.bfloat16 and causal:
                main_in, main_out = r["inputs"], r["outputs"]
            res["fold"][f"{tag} causal={causal}"] = {
                "max_abs_err": r["max_abs_err"],
                "row_rel_err": r["row_rel_err"]}
            del r
            err, row = check_ring_dense(dtype, gen, causal)
            res["dense"][f"{tag} causal={causal}"] = {"max_abs_err": err,
                                                      "row_rel_err": row}
            log(f"[parallel] K5 {tag} causal={causal}: S {RING_S} as "
                f"{RING_RANKS} x {RING_S // RING_RANKS} vs plain fold, "
                f"every step: max_abs_err "
                f"{res['fold'][f'{tag} causal={causal}']['max_abs_err']:.3e}"
                f" row_rel_err "
                f"{res['fold'][f'{tag} causal={causal}']['row_rel_err']:.3e}"
                f"; S {RING_DENSE_S} vs dense: max_abs_err {err:.3e} "
                f"row_rel_err {row:.3e}")
            torch.cuda.empty_cache()
        t = time_ring_fold(dtype, gen)
        res["timing"][tag] = t
        log(f"[kernel] ring_attention_fold {tag} {t['shape']}: ms "
            f"{t['ms']:.4f} device_ms {fmt_ms(t['device_ms'])} plain_ms "
            f"{t['plain_ms']:.4f} bound_ms {t['bound_ms']:.5f} "
            f"({t['bound_by']}) library_ms {t['library_ms']:.4f} "
            f"library_device_ms {fmt_ms(t['library_device_ms'])}; diagonal "
            f"block ms {t['diag_ms']:.4f} bound_ms {t['diag_bound_ms']:.5f}")
    # The whole causal ring against one causal SDPA over S 32768 (bf16).
    qs, ks, vs = main_in
    F = torch.nn.functional
    Q, K, V = (torch.cat(b, dim=1).transpose(1, 2) for b in (qs, ks, vs))
    ring_ms = time_ms(lambda: ra.ring_attention_local(qs, ks, vs, True),
                      iters=3, warmup=1)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        Q, K, V, is_causal=True), iters=3, warmup=1)
    ring_bound, _ = bound_ms(
        4 * RING_S * RING_H * RING_DH * 2,
        4.0 * RING_H * RING_DH * RING_S * (RING_S + 1) / 2, torch.bfloat16)
    res["ring_bf16_causal"] = {"ring_ms": ring_ms, "sdpa_causal_ms": sdpa_ms,
                               "bound_ms": ring_bound}
    log(f"[parallel] causal ring, S {RING_S} bf16, {RING_RANKS} in-process "
        f"ranks: {ring_ms:.3f} ms ({ring_launches(RING_RANKS, True)} K5 "
        f"launches); one causal SDPA over S {RING_S}: {sdpa_ms:.3f} ms; "
        f"bound {ring_bound:.3f} ms (operations)")
    del Q, K, V
    # The path's main run: counts zeroed just before, read just after.
    ops.reset_launch_counts()
    outs = ra.ring_attention_local(qs, ks, vs, True)
    res["world"] = phase_world(gen)
    launches = ops.launch_counts()
    want = ring_launches(RING_RANKS, True) + 1  # + the world of one's fold
    if launches["ring_attention_fold"] != want:
        raise AssertionError(f"K5 launched {launches['ring_attention_fold']}"
                             f" times on the parallel path, not {want}")
    for my in range(RING_RANKS):
        if not torch.equal(outs[my], main_out[my]):
            raise AssertionError(f"the ring's output on rank {my} changed "
                                 f"between two runs")
    res["launches"] = launches
    w = res["world"]
    log(f"[parallel] NCCL world of one (init {w['init_s']:.1f} s): "
        f"collectives exact; ring_attention S 4096 vs dense max_abs_err "
        f"{w['ring_err'][0]:.3e} row_rel_err {w['ring_err'][1]:.3e}; "
        f"pipeline (4 stages x 4096, 8 x 512 rows) {w['pipeline_ms']:.1f} ms"
        f" max_abs_err {w['pipeline_err']:.3e}; MoE (4096 x 14336, 8 "
        f"experts, 512 tokens, f32) capacity 512 kept "
        f"{w['moe_cap512']['tokens_kept']} in "
        f"{w['moe_cap512']['ms']:.1f} ms max_abs_err "
        f"{w['moe_cap512']['max_abs_err']:.3e}, capacity 16 kept "
        f"{w['moe_cap16']['tokens_kept']} max_abs_err "
        f"{w['moe_cap16']['max_abs_err']:.3e}; K5 launches {launches}; "
        f"phase {time.monotonic() - t_phase:.1f} s")
    del main_in, main_out, outs, qs, ks, vs
    torch.cuda.empty_cache()
    return res


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
    # The same requests through the disaggregated path; the colocated
    # streams above equal the plain rollout, so these must equal them.
    script = [[(p, 8, out["tokens"][i]) for i, p in enumerate(prompts)],
              [(p0, 40, r0)], [(a, 8, ab[0]), (b, 8, ab[1])],
              [(p, 8, t2[i]) for i, p in enumerate(turn2)]]
    disagg_res = exact_disagg(params, cfg, script)
    del params
    torch.cuda.empty_cache()
    return {"streams": [out["tokens"][i] for i in range(len(prompts))],
            "chat_streams": [t for _, t in chats], "resumes": resumes,
            "cow_copies": cows, "disagg": disagg_res}


def disagg_fleet(params, cfg, **kw):
    """The port's disaggregated path in this process: a prefill worker
    (layer-wise, the default on a card) and a decode worker, each on its
    own loop thread and CUDA stream, behind the port's router. ``kw``
    holds each worker's options: ``prefill`` and ``decode``."""
    from brpc_tpu_torch import disagg

    pw = disagg.PrefillWorker(params, cfg, **kw.get("prefill", {}))
    dw = disagg.DecodeWorker(params, cfg, **kw.get("decode", {}))
    router = disagg.DisaggRouter([f"127.0.0.1:{pw.port}"],
                                 [f"127.0.0.1:{dw.port}"],
                                 worker_timeout_ms=600_000)
    return pw, dw, router


def close_fleet(pw, dw, router) -> None:
    router.close()
    pw.close()
    dw.close()


def wait_idle(dw, timeout_s: float = 60.0) -> None:
    """Until the decode worker has vacated every finished sequence (a
    client sees its terminal before the engine releases the pages)."""
    deadline = time.monotonic() + timeout_s
    while dw.in_flight() and time.monotonic() < deadline:
        time.sleep(0.01)


def check_worker_launches(pw, dw, L: int) -> None:
    """Each worker's own launch tally against its counters: K2 once per
    layer of a cold prefill and K4 of a prefix hit on the prefill worker;
    K1 per layer of each decode step and K4 per layer of each resume (a
    local-skip adopt or a splice) on the decode worker; the norms of
    every pass (check_norm_launches); no kernel of the other role."""
    ps, ds = pw.stats(), dw.stats()
    cold, hits = ps["prefills"] - ps["prefix_hits"], ps["prefix_hits"]
    steps, resumes = ds["model_steps"], ds["resumes"]
    want_p = {"prefill_attention": L * cold,
              "paged_prefill_attention": L * hits,
              "paged_decode_attention": 0}
    want_d = {"prefill_attention": L * ds["prefills"],
              "paged_prefill_attention": L * resumes,
              "paged_decode_attention": L * steps}
    for who, got, want in (("prefill", pw.launches, want_p),
                           ("decode", dw.launches, want_d)):
        for name, n in want.items():
            if got.get(name, 0) != n:
                raise AssertionError(f"{who} worker launched {name} "
                                     f"{got.get(name, 0)} times, want {n}")
    full = {name: 0 for name in ("rms_norm", "add_rms_norm")}
    check_norm_launches({**full, **pw.launches}, L, 0, ps["prefills"])
    check_norm_launches({**full, **dw.launches}, L, steps,
                        ds["prefills"] + resumes)


def exact_disagg(params, cfg, script) -> dict:
    """``script``: waves of (prompt, new tokens, expected stream); each
    wave goes concurrently through the port's router, prefill worker
    (layer-wise) and decode worker, and every stream must equal its
    expected one."""
    pw, dw, router = disagg_fleet(
        params, cfg,
        prefill={"max_prompt": 128, "kv_blocks": 64},
        decode={"max_batch_size": 4, "slots": 4, "max_prompt": 128,
                "kv_blocks": 64})
    try:
        if not pw.layerwise:
            raise AssertionError("the prefill worker is not layer-wise")
        for wave in script:
            for n in sorted({n for _, n, _ in wave}):
                part = [(p, want) for p, m, want in wave if m == n]
                got = run_swarm(router, [p for p, _ in part], n)["tokens"]
                for i, (p, want) in enumerate(part):
                    if got[i] != want:
                        raise AssertionError(
                            f"f32 disagg stream (prompt {len(p)}): "
                            f"{got[i]} != plain {want}")
        wait_idle(dw)
        check_worker_launches(pw, dw, cfg.n_layers)
        res = {"prefill": pw.stats(), "decode": dw.stats(),
               "prefill_launches": dict(pw.launches),
               "decode_launches": dict(dw.launches)}
    finally:
        close_fleet(pw, dw, router)
    if not (res["prefill_launches"].get("prefill_attention")
            and res["decode_launches"].get("paged_decode_attention")
            and res["decode_launches"].get("rms_norm")):
        raise AssertionError("the disagg path did not launch K2 on the "
                             "prefill worker and K1/K3 on the decode worker")
    n = sum(len(w) for w in script)
    log(f"[exact] disagg: the same {n} requests through the port's router, "
        f"layer-wise prefill worker and decode worker identical to the "
        f"plain rollout; prefill worker {res['prefill']['prefills']} "
        f"prefills ({res['prefill']['prefix_hits']} prefix hits), decode "
        f"worker {res['decode']['adopts']} adopts "
        f"({res['decode']['adopt_local_skips']} local skips); launches "
        f"prefill {res['prefill_launches']} decode "
        f"{res['decode_launches']}")
    return {k: res[k] for k in ("prefill_launches", "decode_launches")}


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
    check_norm_launches(launches, L, steps,
                        stats["prefills"] + stats["resumes"])
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


def check_norm_launches(launches: dict, L: int, steps: int,
                        passes: int) -> None:
    """K3 per forward: the first ln_attn alone, every other norm fused with
    the residual add before it (2L of them in a decode step, whose ln_out
    is fused too; 2L - 1 in a prefill or resume, whose one-row ln_out is
    not)."""
    want = {"rms_norm": steps + 2 * passes,
            "add_rms_norm": 2 * L * steps + (2 * L - 1) * passes}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"K3 {name} launched {launches[name]} times,"
                                 f" want {n} ({steps} decode steps, {passes}"
                                 f" prefills and resumes)")


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
              "K3 rms_norm": 0.0, "K3 add_rms_norm": 0.0,
              "K4 paged_prefill_attention": 0.0, "matmul (cuBLAS)": 0.0,
              "other": 0.0}
    table = []
    for e in prof.key_averages():
        if getattr(e, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
        table.append((us, e.count, e.key))
        name = e.key.lower()
        if "paged_decode" in name:  # K1's split pass and its merge
            g = "K1 paged_decode_attention"
        elif "paged_prefill" in name:  # K4's split pass and its merge
            g = "K4 paged_prefill_attention"
        elif "prefill_attention" in name:
            g = "K2 prefill_attention"
        elif "add_rms_norm" in name:
            g = "K3 add_rms_norm"
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


def decode_step_split(params, cfg) -> dict:
    """One bare ``decode_step`` at the main path's last-step positions (8
    lanes, table cut to the pages in play), outside the engine: host_ms is
    the time until the call returns, which is the host's enqueue of its
    launches, step_ms the time until the device has finished (medians of
    10), device_ms the busy time of its kernels (torch.profiler). When
    host_ms is close to step_ms and device_ms well below it, the step is
    bound by the host's launches."""
    from brpc_tpu_torch.models import transformer

    dev = torch.device("cuda")
    page = 16
    pos_list = [n + MAIN_NEW_TOKENS - 1 for n in MAIN_LENGTHS]
    need = [p // page + 1 for p in pos_list]
    k_pool = torch.zeros((sum(need) + 1, cfg.n_layers, page, cfg.n_kv_heads,
                          cfg.d_head), dtype=cfg.dtype, device=dev)
    v_pool = torch.zeros_like(k_pool)
    tables = torch.zeros((len(need), max(need)), dtype=torch.int32,
                         device=dev)
    used = 1
    for s, n in enumerate(need):
        tables[s, :n] = torch.arange(used, used + n, dtype=torch.int32)
        used += n
    tokens = torch.arange(len(need), dtype=torch.int32, device=dev)
    pos = torch.tensor(pos_list, dtype=torch.int32, device=dev)

    def step():
        return transformer.decode_step(params, tokens, pos, tables, k_pool,
                                       v_pool, cfg)

    for _ in range(3):
        step()
    host, total = [], []
    for _ in range(10):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        host.append(t1 - t0)
        total.append(time.perf_counter() - t0)
    res = {"host_ms": 1e3 * sorted(host)[5], "step_ms": 1e3 * sorted(total)[5],
           "device_ms": device_ms(step, iters=5)}
    del k_pool, v_pool
    torch.cuda.empty_cache()
    return res


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
    bare = decode_step_split(params, cfg)
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
    check_norm_launches(launches, L, steps, prefills + resumes)
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
        "launches": launches, "bare_decode_step": bare,
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
    log(f"[decode] bare decode_step, 8 lanes at the last step's positions: "
        f"host enqueue {bare['host_ms']:.2f} ms, step {bare['step_ms']:.2f} "
        f"ms, device busy {fmt_ms(bare['device_ms'])} ms")
    if prof is not None:
        log(f"[profile] 8 more requests x 8 tokens, {card}: wall "
            f"{prof['wall_ms']:.1f} ms, device busy ms "
            f"{prof['device_busy_ms']}, idle share {prof['idle_share']}; "
            f"by group ms {json.dumps(prof['by_group_ms'])}")
    return res


# The disagg phase: phase 5's prompt lengths with fresh tokens (phase 5's
# own prompts are in the host tier by now, which would make every prefill
# a host-fill hit), then two of them again, then one direct splice.
DISAGG_WAVE2 = (0, 3)
DISAGG_SPLICE = 5
DISAGG_SOLO_TOKENS = 1024


def kv_pool_budget(cfg, page_tokens: int = 16) -> tuple:
    """The native receive pool's geometry for this script: one pool page
    per page of one wire layer (K or V of one layer, ``page_tokens``
    tokens), so a transfer takes 2L pages per KV page with no rounding,
    and room for twice the disagg phase's first wave and its solo prompt
    in flight at once (the default, 512 pages of 1 MiB, holds a
    1024-token bf16 transfer in 128 pages but not the wave)."""
    from brpc_tpu_torch import kv_cache

    page_bytes = (page_tokens * cfg.n_kv_heads * cfg.d_head
                  * cfg.dtype.itemsize)
    pages = sum(kv_cache.pages_for(n, page_tokens)
                for n in (*MAIN_LENGTHS, DISAGG_SOLO_TOKENS))
    return page_bytes, 2 * pages * 2 * cfg.n_layers


def classify_flights(recs) -> dict:
    """Newest flight records of one disagg wave, by who wrote them: the
    prefill worker's carry its transfer note, the router's stamp its
    prefill RPC, and the decode worker's claim stamps the transfer alone."""
    out = {"router": [], "prefill": [], "decode": []}
    for r in recs:
        if str(r.get("note", "")).startswith("kv w="):
            out["prefill"].append(r)
        elif "prefill_start_us" in r:
            out["router"].append(r)
        elif "kv_transfer_us" in r:
            out["decode"].append(r)
    return out


def mean_span_ms(recs, a: str, b: str):
    spans = [(r[b] - r[a]) / 1e3 for r in recs if a in r and b in r]
    return sum(spans) / len(spans) if spans else None


# (name, who, from stamp, to stamp): the router's queue, its prefill RPC
# (the prefill worker's queue, compute, cache admission and the transfer's
# commit) and the relay of the first token; inside it the prefill worker's
# compute with its cache admission, and the commit; then on the decode
# worker, after the first token, the claim and the adopt up to its first
# decoded token (landing the pages, the prefix admission with its
# host-tier export, one decode step).
DISAGG_SEGMENTS = (
    ("queue", "router", "admit_us", "batch_formed_us"),
    ("prefill_rpc", "router", "prefill_start_us", "prefill_done_us"),
    ("first_emit", "router", "prefill_done_us", "first_emit_us"),
    ("prefill", "prefill", "prefill_start_us", "prefill_done_us"),
    ("kv_commit", "prefill", "prefill_done_us", "kv_transfer_us"),
    ("claim", "decode", "batch_formed_us", "kv_transfer_us"),
    ("adopt_to_token", "decode", "kv_transfer_us", "first_emit_us"),
)


def pool_write_timing(cfg, tokens: int = 1024) -> dict:
    """An adopt's landing at ``tokens`` tokens (64 pages at Llama-3-8B
    width, 2 MiB each, K and V): the pageable host-to-device copy of the
    claimed pages and the pool's ``index_copy_`` of them, each by CUDA
    events (5 calls), the latter also by torch.profiler. Byte bounds: the
    copy's bytes over PCIe Gen5 x16 (64 GB/s a direction), the
    index_copy_'s read plus write over HBM."""
    from brpc_tpu_torch import kv_cache

    page = 16
    n = kv_cache.pages_for(tokens, page)
    shape = (n, cfg.n_layers, page, cfg.n_kv_heads, cfg.d_head)
    host = [torch.ones(shape, dtype=cfg.dtype) for _ in range(2)]
    pool = kv_cache.PagedKvPool(cfg, n + 1, page, device="cuda")
    blocks = list(range(1, n + 1))
    dev = [h.to("cuda") for h in host]
    nbytes = sum(h.numel() * h.element_size() for h in host)
    idx = torch.tensor(blocks, dtype=torch.long, device="cuda")

    def h2d():
        for h in host:
            h.to("cuda")

    def land():
        pool.k.index_copy_(0, idx, dev[0])
        pool.v.index_copy_(0, idx, dev[1])

    res = {"tokens": tokens, "pages": n, "bytes": nbytes,
           "h2d_ms": time_ms(h2d, iters=5, warmup=1),
           "h2d_bound_ms": nbytes / 64e9 * 1e3,
           "index_copy_ms": time_ms(land, iters=5, warmup=1),
           "index_copy_device_ms": device_ms(land, iters=5),
           "index_copy_bound_ms": 2 * nbytes / HBM_BYTES_PER_S * 1e3,
           "write_blocks_ms": time_ms(
               lambda: pool.write_blocks(blocks, *host), iters=5,
               warmup=1)}
    del pool, dev
    torch.cuda.empty_cache()
    log(f"[pool-write] {tokens}-token adopt, {n} pages, {nbytes} bytes: "
        f"pageable H2D {res['h2d_ms']:.3f} ms (PCIe bound "
        f"{res['h2d_bound_ms']:.3f}), index_copy_ {res['index_copy_ms']:.4f}"
        f" ms device {fmt_ms(res['index_copy_device_ms'])} (byte bound "
        f"{res['index_copy_bound_ms']:.4f}), write_blocks "
        f"{res['write_blocks_ms']:.3f} ms")
    return res


def phase_disagg(params, cfg, card: str, main_res: dict) -> dict:
    """Disaggregated serving at full width and depth: the port's router
    in front of one layer-wise prefill worker and one decode worker (8
    slots), each on its own stream; a stock client swarm of phase 5's
    lengths, then two prompts again (prefix hits on the prefill worker,
    local-skip adopts on the decode worker), then one splice sent to the
    decode worker directly."""
    from brpc_tpu_torch import disagg, kv_cache, runtime, serving

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in MAIN_LENGTHS]
    max_new = MAIN_NEW_TOKENS
    blocks = len(prompts) * kv_cache.pages_for(max(MAIN_LENGTHS) + max_new,
                                               16) + 1
    kv0 = runtime.kv_stats()
    torch.cuda.reset_peak_memory_stats()
    pw, dw, router = disagg_fleet(
        params, cfg,
        prefill={"max_prompt": 1024,
                 "kv_blocks": sum(kv_cache.pages_for(n, 16)
                                  for n in MAIN_LENGTHS) + 16},
        decode={"max_batch_size": 8, "slots": 8, "max_prompt": 1024,
                "kv_blocks": blocks})
    # Host-clock intervals of each prefill and of each decode step that
    # decoded, to count the steps that ran while a prefill ran.
    spans = {"prefill": [], "step": []}

    def timed(fn, key, keep=lambda out: True):
        def wrapper(*a, **kw):
            t0 = time.monotonic()
            out = fn(*a, **kw)
            if keep(out):
                spans[key].append((t0, time.monotonic()))
            return out
        return wrapper

    pw._handle = timed(pw._handle, "prefill")
    dw.step = timed(dw.step, "step", keep=lambda active: active > 0)
    try:
        wave1 = run_swarm(router, prompts, max_new)
        wait_idle(dw)
        flights = classify_flights(runtime.flight_records(
            max_items=3 * len(prompts), oldest_first=False))
        s1p, s1d = pw.stats(), dw.stats()
        kv1 = runtime.kv_stats()
        wave2 = run_swarm(router, [prompts[i] for i in DISAGG_WAVE2],
                          max_new)
        wait_idle(dw)
        ch = runtime.Channel(f"127.0.0.1:{dw.port}", timeout_ms=600_000)
        try:
            rs = ch.open_stream_rx(
                disagg.DECODE_SERVICE, disagg.DECODE_METHOD,
                disagg.encode_splice_request(-1, prompts[DISAGG_SPLICE],
                                             max_new))
            splice_toks, status = [], None
            while status is None:
                msg = rs.read(timeout=600)
                if msg is None:
                    raise AssertionError("splice stream closed early")
                if msg[:1] == b"d":
                    splice_toks.append(struct.unpack("<I", msg[1:5])[0])
                elif msg[:1] == b"f":
                    status = struct.unpack("<I", msg[1:5])[0]
            rs.close()
        finally:
            ch.close()
        wait_idle(dw)
        # One cold prompt alone: the prefill worker's time with no decode
        # step and no other prefill beside it.
        s3 = pw.stats()
        run_swarm(router, [rng.integers(0, cfg.vocab,
                                       DISAGG_SOLO_TOKENS).tolist()], 2)
        wait_idle(dw)
        s4 = pw.stats()
        solo = {k: 1e3 * (s4[k] - s3[k])
                for k in ("prefill_seconds", "layer_stall_seconds",
                          "send_seconds", "cache_seconds",
                          "transfer_seconds", "commit_seconds")}
        ps, ds = pw.stats(), dw.stats()
        launches = {"prefill": dict(pw.launches),
                    "decode": dict(dw.launches)}
        check_worker_launches(pw, dw, cfg.n_layers)
        peak = torch.cuda.max_memory_allocated() / 2**30
    finally:
        close_fleet(pw, dw, router)
    pool_write = pool_write_timing(cfg)
    kv = runtime.kv_stats()
    if kv["kv_transfers_failed"] or kv["kv_pages_evicted"]:
        raise AssertionError(f"kv transfers failed or evicted: {kv}")
    if status != 0 or len(splice_toks) != max_new:
        raise AssertionError(f"splice ended {status} after "
                             f"{len(splice_toks)} tokens")
    for name, n in (("prefill worker prefix hits", ps["prefix_hits"]),
                    ("local-skip adopts", ds["adopt_local_skips"]),
                    ("splices", ds["splices"])):
        if n < 1:
            raise AssertionError(f"{name}: {n}, want >= 1")
    for toks in (*wave1["tokens"].values(), *wave2["tokens"].values(),
                 splice_toks):
        if not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError("token id out of vocabulary")
    overlap = sum(any(a < e and s < b for a, b in spans["prefill"])
                  for s, e in spans["step"])
    ttft = sorted(wave1["ttft_s"].values())
    n_tok = sum(len(t) for t in wave1["tokens"].values())
    cold = s1p["prefills"]
    segments = {name: mean_span_ms(flights[who], a, b)
                for name, who, a, b in DISAGG_SEGMENTS}
    res = {
        "card": card, "requests": len(prompts),
        "prompt_lengths": MAIN_LENGTHS, "new_tokens": max_new,
        "tokens_per_s": n_tok / wave1["wall_s"],
        "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
        "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                      int(0.99 * len(ttft)))],
        "decode_step_ms": 1e3 * s1d["decode_seconds"]
        / max(1, s1d["model_steps"]),
        "model_steps": s1d["model_steps"],
        "prefill_ms_mean": 1e3 * s1p["prefill_seconds"] / cold,
        "layer_stall_ms_mean": 1e3 * s1p["layer_stall_seconds"]
        / max(1, s1p["layers_streamed"]),
        "layer_stall_ms_per_prefill": 1e3 * s1p["layer_stall_seconds"]
        / cold,
        "send_ms_per_prefill": 1e3 * s1p["send_seconds"] / cold,
        "solo_1024_ms": solo,
        "cache_admit_ms_mean": 1e3 * s1p["cache_seconds"] / cold,
        "transfer_ms_mean": 1e3 * s1p["transfer_seconds"] / cold,
        "commit_ms_mean": 1e3 * s1p["commit_seconds"] / cold,
        "transfer_bytes_wave1": s1p["transfer_bytes"],
        "kv_transfer_bytes_wave1": kv1["kv_transfer_bytes"]
        - kv0["kv_transfer_bytes"],
        "kv_transfers_completed": kv["kv_transfers_completed"]
        - kv0["kv_transfers_completed"],
        "kv_stats": kv, "ttft_segments_ms": segments,
        "decode_steps_during_prefill": overlap,
        "decode_steps_timed": len(spans["step"]),
        "prefill_stats": ps, "decode_stats": ds,
        "prefix_hits": ps["prefix_hits"],
        "adopt_local_skips": ds["adopt_local_skips"],
        "splices": ds["splices"],
        "splice_matches_wave1": splice_toks
        == wave1["tokens"][DISAGG_SPLICE],
        "launches": launches, "peak_mem_gib": peak,
        "pool_write": pool_write,
    }
    log(f"[disagg] Llama-3-8B bf16 {cfg.n_layers} layers, {card}: "
        f"{len(prompts)} concurrent requests through router -> layer-wise "
        f"prefill worker -> decode worker (own streams), {n_tok} tokens in "
        f"{wave1['wall_s']:.3f} s = {res['tokens_per_s']:.2f} tok/s; TTFT "
        f"p50 {res['ttft_p50_ms']:.1f} ms p99 {res['ttft_p99_ms']:.1f} ms; "
        f"decode step {res['decode_step_ms']:.2f} ms mean over "
        f"{res['model_steps']} steps; peak memory {peak:.2f} GiB")
    log(f"[disagg] TTFT segments mean ms {fmt_segments(segments)}")
    log(f"[disagg] prefill worker, {cold} cold prefills: prefill "
        f"{res['prefill_ms_mean']:.2f} ms mean, of it host stall per layer "
        f"{res['layer_stall_ms_mean']:.3f} ms ({res['layer_stall_ms_per_prefill']:.2f} "
        f"ms per prefill), handing layers to the sender "
        f"{res['send_ms_per_prefill']:.2f} ms per prefill; local cache "
        f"admission "
        f"{res['cache_admit_ms_mean']:.2f} ms; transfer (first layer sent "
        f"to commit) {res['transfer_ms_mean']:.2f} ms mean, commit wait "
        f"{res['commit_ms_mean']:.2f} ms; {res['transfer_bytes_wave1']} "
        f"wire bytes; decode steps that ran while a prefill ran: "
        f"{overlap} of {len(spans['step'])}")
    log(f"[disagg] one cold {DISAGG_SOLO_TOKENS}-token prompt alone, "
        f"prefill worker ms: "
        + " ".join(f"{k.replace('_seconds', '')} {v:.2f}"
                   for k, v in solo.items()))
    log(f"[disagg] kv_stats {json.dumps(kv)}")
    log(f"[disagg] prefix_hits {ps['prefix_hits']} adopt_local_skips "
        f"{ds['adopt_local_skips']} splices {ds['splices']} (splice stream "
        f"equal to wave 1's: {res['splice_matches_wave1']}); launches "
        f"prefill worker {launches['prefill']} decode worker "
        f"{launches['decode']}")
    log(f"[disagg] against phase 5 (colocated, same lengths) in this run: "
        f"tok/s {res['tokens_per_s']:.2f} vs {main_res['tokens_per_s']:.2f}"
        f", TTFT p50 {res['ttft_p50_ms']:.1f} vs "
        f"{main_res['ttft_p50_ms']:.1f} ms, p99 {res['ttft_p99_ms']:.1f} vs "
        f"{main_res['ttft_p99_ms']:.1f} ms, decode step "
        f"{res['decode_step_ms']:.2f} vs {main_res['decode_step_ms']:.2f} "
        f"ms, peak memory {peak:.2f} vs {main_res['peak_mem_gib']:.2f} GiB")
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
        if (TILE_KERNEL.search(line) and "<bf16, 128>" in line
                and " 0 bytes spill stores" not in line):
            raise AssertionError(f"a Llama-width tile spills: {line}")
    report["build_s"] = {"native": t_native, "kernels": t_kernels}
    report["sass_mma"] = sass_mma_counts(_build)
    cases = phase_kernels()
    report["parallel"] = parallel = phase_parallel()
    from brpc_tpu_torch import runtime
    from brpc_tpu_torch.models import transformer

    cfg = transformer.TransformerConfig.llama3_8b()
    # Before the first transfer: the pool's page size changes only while
    # the pool is empty.
    pool_page, pool_pages = kv_pool_budget(cfg)
    runtime.kv_pool_configure(pool_page, pool_pages)
    log(f"[kv] receive pool {pool_pages} pages of {pool_page} bytes")
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
    report["disagg"] = phase_disagg(params, cfg, card, main_res)
    report["kernel_cases"] = cases
    with open(os.path.join(args.report_dir, "chip_smoke_report.json"),
              "w") as f:
        json.dump(report, f, indent=1)
    # One row per kernel: the bf16 case at a shape its path gives it (the
    # main path's 8 lanes at their last decode step; a 1024-token bucket;
    # a turn-2 resume's 40 rows after 1008 cached tokens; 8 decode rows,
    # alone and with the residual add), with the launches of its path's
    # run: K4's from the prefix phase, the others from the main path's.
    pick = {"paged_decode_attention": 1, "prefill_attention": 2,
            "paged_prefill_attention": 0, "rms_norm": 0, "add_rms_norm": 0}
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
    t = parallel["timing"]["bfloat16"]
    rows.append({
        "name": "ring_attention_fold", "route": "cuda",
        "source": SOURCES["ring_attention_fold"],
        "replaces": REPLACES["ring_attention_fold"],
        "launches": parallel["launches"]["ring_attention_fold"],
        "max_abs_err": parallel["fold"]["bfloat16 causal=True"][
            "max_abs_err"],
        "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
    })
    print(json.dumps({"kernels": rows}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
