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
stream), whose f32 exactness phase 4 also checks, and then once more
through worker processes: a DisaggCluster whose prefill and decode
workers pull the weights over TPS1 at start-up from ParamServers in this
process and run on the card beside it (phase 4 runs its f32 script
through such a cluster too). Before the serving
phases, the parallelism path: K5 (the ring-attention block fold) at
Llama-3-8B's attention width over S 32768 as 8 in-process ranks, held
against its plain fold step by step and against dense attention at S
8192, then the collectives, ring attention, the GPipe pipeline and the
expert-parallel MoE through an NCCL world of one rank. Then the training
path: the backward kernels K2b, K3b (and its fused form) and K5b against
their plain backwards, the ring's backward against dense autograd at S
8192 and timed at S 32768, one f32 train_step at Llama-3-8B width (2
layers) against the plain autograd step, the bf16 step at width (4
layers, tokens [2, 2049]) beside the plain one, and the dp x tp dry-run
twin in an NCCL world of one. Then checkpoint and resume: a 1-layer
Llama-3-8B in bf16 takes two train steps, is saved to a CheckpointStore
process on disk, the store is killed with SIGKILL and restarted, and the
loaded weights must be torch.equal on the card and give step 3's loss
bit for bit; a ParamServer round-trips through the same store. Phase 5's
engine also serves four traced requests, whose span trees must be
complete, and an open-loop replay of a compiled workload, which must
complete every request. Then device landing: four rank processes
on the device fabric each hold a tensor-parallel quarter of one
Llama-3-8B layer; the mesh bridge gathers them over a star and a ring
pchan onto the card, bit-equal to the source, and a 1-layer Llama-3-8B
built from the landed bytes streams tokens bit-equal to the same model
loaded with .to("cuda"); then the pipelined lane, the H2D sources and a
scatter round trip. Last, resharding: four rank processes hold row
shards of one Llama-3-8B w_gate, redistributed into column shards over
TCP and then over the device fabric, each landed torch.equal on the
card.

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
import gc
import json
import os
import re
import select
import shutil
import signal
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
    "attention_backward": "brpc_tpu/models/transformer.py:123",
    "rms_norm_backward": "brpc_tpu/models/transformer.py:102",
    "add_rms_norm_backward": "brpc_tpu/models/transformer.py:102",
    "ring_attention_fold_backward": "brpc_tpu/ops/ring_attention.py:65",
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
    "attention_backward": "brpc_tpu_torch/csrc/attention_backward.cu",
    "rms_norm_backward": "brpc_tpu_torch/csrc/rms_norm_backward.cu",
    "add_rms_norm_backward": "brpc_tpu_torch/csrc/rms_norm_backward.cu",
    "ring_attention_fold_backward":
        "brpc_tpu_torch/csrc/ring_attention_backward.cu",
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
            rows: bool = False, floor: float = 0.0,
            row_tol: float = None) -> tuple:
    """-> (max abs err, max row relative err or None). Raises outside TOL
    and, with ``rows`` (an attention output or gradient), outside
    ``row_tol`` (default ROW_TOL), each row held relative to at least
    ``floor`` times the largest."""
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
    row_err = attention.max_row_rel_err(g, w, floor) if rows else None
    row_tol = ROW_TOL[dtype] if row_tol is None else row_tol
    if rows and not row_err <= row_tol:
        raise AssertionError(
            f"{name}: a row's relative error {row_err:.3e} is above "
            f"{row_tol}")
    return float(err.max()), row_err


def ptxas_summary(path: str) -> list:
    """One line per compiled kernel from nvcc's -Xptxas -v log: its
    template instance, registers, and stack and spill bytes."""
    out, name, spill = [], None, ""
    with open(path) as f:
        for line in f:
            if "Compiling entry function" in line:
                m = re.search(r"\d([a-z_]+_kernel)I(13__nv_bfloat16|f)"
                              r"(?:Lb([01])E)?(?:Li(\d+)E)?(?:Lb([01])E)?",
                              line)
                flag = ("" if not m or m.group(3) is None else
                        ", fused" if m.group(3) == "1" else ", alone")
                form = ("" if not m or m.group(1) != "norm_kernel"
                        or m.group(5) is None else
                        ", gain first" if m.group(5) == "1" else ", late")
                name = (f"{m.group(1)}<{'bf16' if m.group(2) != 'f' else 'f32'}"
                        f"{flag}{', ' + m.group(4) if m.group(4) else ''}"
                        f"{form}>" if m else line.split("'")[1])
            elif name and "spill" in line:
                spill = line.strip()
            elif name and "Used" in line:
                out.append(f"{name}: {line.split(':', 1)[1].strip()}; "
                           f"{spill}")
                name = None
    return out


# The forward attention kernels (K1, K2, K4, their merges, K5): their SASS
# counts are logged, and their bf16 Dh-128 instances must not spill. Those
# of K1, K2 and K4 run the shared tile core: mma.sync (HMMA) in bf16.
TILE_KERNEL = re.compile(r"prefill|paged_decode|ring_attention")
TILE_BF16_KERNELS = ("prefill_attention_kernel", "paged_decode_kernel",
                     "paged_prefill_kernel")
# The Hopper cores: wgmma (HGMMA) and no mma.sync in bf16. K5's forward
# core, and the passes of the backward core (K2b, K5b).
WGMMA_KERNELS = ("ring_attention_fold_wgmma_kernel",)
BACKWARD_KERNELS = ("attention_backward_kv_kernel",
                    "attention_backward_q_kernel",
                    "ring_fold_backward_kv_kernel",
                    "ring_fold_backward_q_kernel")
# The f32 routes of K5, K2, K4, K1, K2b and K5b run the SIMT cores of
# csrc/attention_f32.cuh: plain FFMA, no tensor cores (no TF32), no spill.
F32_SIMT_KERNELS = ("ring_attention_fold_kernel",
                    "prefill_attention_simt_kernel",
                    "paged_prefill_simt_kernel",
                    "paged_decode_simt_kernel") + BACKWARD_KERNELS
# K2's, K4's and K1's kernels on the tile core: bf16 only (their f32
# routes are the SIMT kernels above).
TILE_BF16_ONLY = re.compile(
    r"\d(prefill_attention|paged_prefill|paged_decode)_kernelIf")


def f32_simt_kernel(name: str) -> bool:
    """Is ``name`` (mangled, or ptxas_summary's "kernel<f32, D>") an f32
    instance of a kernel on the f32 SIMT core?"""
    m = re.search(r"\d([a-z_]+_kernel)If", name) or re.search(
        r"([a-z_]+_kernel)<f32", name)
    return bool(m) and m.group(1) in F32_SIMT_KERNELS


def sass_mma_counts(build) -> dict:
    """Tensor-core instructions per compiled attention kernel of the built
    library, from cuobjdump -sass: {kernel: {"HMMA": n, "HGMMA": m}}
    (mma.sync and wgmma). Fails unless each bf16 K1, K2 and K4 kernel has
    HMMA, each bf16 K5 kernel HGMMA and no HMMA, each bf16 pass of K2b
    and K5b HGMMA, each f32 K5, K2, K4, K1, K2b and K5b kernel neither,
    and no f32 instance of K2's, K4's or K1's tile-core kernel is
    built."""
    tool = os.path.join(os.path.dirname(build._nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", build.LIB_PATH],
                          capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = {"HMMA": 0, "HGMMA": 0}
        elif name is not None:
            for op in ("HMMA", "HGMMA"):
                if op in line:
                    counts[name][op] += 1

    def fmt(c):
        return f"{c['HMMA']} HMMA, {c['HGMMA']} HGMMA"

    def bf16(kind):
        return [k for k in counts if kind in k and "bfloat16" in k]

    for name, c in counts.items():
        # The kernel's own name: the mangled one also holds its source
        # file's (csrc/ring_attention_backward.cu's kernels are not K5).
        own = re.search(r"\d([a-z_]+_kernel)I", name)
        if (TILE_KERNEL.search(own.group(1) if own else name)
                and "bfloat16" in name):
            log(f"[sass] {name}: {fmt(c)}")
    for kind in TILE_BF16_KERNELS:
        found = bf16(kind)
        if not found or any(counts[k]["HMMA"] == 0 for k in found):
            raise AssertionError(f"no bf16 {kind} with mma.sync (HMMA) in "
                                 f"the SASS")
    if any("ring_attention_fold_kernel" in k for k in bf16("")):
        raise AssertionError("a bf16 instance of the mma.sync ring fold "
                             "is still built")
    old_f32 = [k for k in counts if TILE_BF16_ONLY.search(k)]
    if old_f32:
        raise AssertionError(f"an f32 instance of K2's, K4's or K1's "
                             f"tile-core kernel is still built: {old_f32}")
    for kind in WGMMA_KERNELS + BACKWARD_KERNELS:
        found = bf16(kind)
        if not found or any(counts[k]["HGMMA"] == 0 for k in found):
            raise AssertionError(f"no bf16 {kind} with wgmma (HGMMA) in "
                                 f"the SASS")
        if kind in WGMMA_KERNELS and any(counts[k]["HMMA"]
                                         for k in found):
            raise AssertionError(f"a bf16 {kind} has mma.sync (HMMA)")
        for k in found:
            if kind in BACKWARD_KERNELS:
                log(f"[sass] {k}: {fmt(counts[k])}")
    simt = [k for k in counts if f32_simt_kernel(k)]
    if len(simt) != len(F32_SIMT_KERNELS) * 3:  # Dh 32, 64 and 128
        raise AssertionError(f"f32 SIMT kernels in the SASS: {simt}")
    for k in simt:
        log(f"[sass] {k}: {fmt(counts[k])}")
        if counts[k]["HMMA"] or counts[k]["HGMMA"]:
            raise AssertionError(f"the f32 kernel {k} uses the tensor "
                                 f"cores: {fmt(counts[k])}")
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


def decode_inputs(dtype, gen, pos_list, width=None, idle=()) -> tuple:
    """K1's inputs at Llama-3-8B heads: 8 lanes at ``pos_list`` on the
    last layer of a 32-layer pool, the table ``width`` columns wide (None:
    the pages in play, as the engine sends it); lanes in ``idle`` decode
    at pos 0 through garbage block 0, as free slots do. -> (q, k_pool,
    v_pool, tables, pos, layer, pages each lane holds)."""
    dev = torch.device("cuda")
    S, H, KV, Dh, page, L = len(pos_list), 32, 8, 128, 16, 32
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
    return q, k_pool, v_pool, tables, pos, L - 1, need


def check_paged_decode(dtype, gen, pos_list, width=None, idle=()) -> dict:
    """K1 on ``decode_inputs``: against its plain version, timed, with its
    dtype's split plan, grid and empty (row, split) pairs."""
    from brpc_tpu_torch.ops import attention

    q, k_pool, v_pool, tables, pos, layer, need = decode_inputs(
        dtype, gen, pos_list, width, idle)
    dev = q.device
    (S, H, Dh), (nb, L, page, KV, _) = q.shape, k_pool.shape
    width = tables.shape[1]

    def kern():
        return attention.paged_decode_attention(q, k_pool, v_pool, tables,
                                                pos, layer)

    def plain():
        return attention.paged_decode_attention_plain(q, k_pool, v_pool,
                                                      tables, pos, layer)

    err, row_err = compare(f"paged_decode_attention pos={pos_list}", kern(),
                           plain(), dtype, rows=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    per, splits = attention.plan_decode_splits(S, KV, width * page, sms,
                                               dtype)
    blocks = (attention.decode_grid(S, H, KV, splits, sms)
              if dtype == torch.float32 else S * KV * splits)
    # (row, split) pairs wholly past their lane's pos: in bf16 empty blocks
    # whose rows the merge must weigh 0, in f32 items no block runs and
    # the merge must skip
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
            "grid_blocks": blocks,
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
    # the plan and grid of the dtype's core: the tile core's 64-row blocks
    # in bf16, the SIMT core's 128-row blocks in f32
    per, splits = attention.plan_splits(n, H, KV, start, sms, dtype)
    rows = (attention.F32_FWD_ROWS if dtype == torch.float32
            else attention.TILE_ROWS)
    q_tiles = -(-(n * H // KV) // rows)
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

    out = kern()
    err, _ = compare(f"rms_norm rows={rows}", out, plain(), dtype)
    if not torch.equal(out, kern()):
        raise AssertionError(f"rms_norm rows={rows}: a rerun differs")
    F = torch.nn.functional
    g_dt = g.to(dtype)

    def lib():
        return F.rms_norm(x, (D,), weight=g_dt, eps=eps)

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 2 * rows * D * itemsize + D * 4
    b, by = bound_ms(nbytes, 4.0 * rows * D, dtype)
    return {"shape": f"x[{rows},{D}]", "max_abs_err": err,
            "host_us": host_us(kern), "ms": time_ms(kern),
            "plain_ms": time_ms(plain),
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
    s_again, h_again = kern()
    if not (torch.equal(s_again, s_got) and torch.equal(h_again, h_got)):
        raise AssertionError(f"add_rms_norm rows={rows}: a rerun differs")
    F = torch.nn.functional
    g_dt = g.to(dtype)

    def lib():
        s = x + delta
        return s, F.rms_norm(s, (D,), weight=g_dt, eps=eps)

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * rows * D * itemsize + D * 4
    b, by = bound_ms(nbytes, 5.0 * rows * D, dtype)
    return {"shape": f"x[{rows},{D}] + delta", "max_abs_err": err,
            "host_us": host_us(kern), "add_host_us": host_us(lambda: x + delta),
            "ms": time_ms(kern), "plain_ms": time_ms(plain),
            "bound_ms": b, "bound_by": by, "library_ms": time_ms(lib),
            "device_ms": device_ms(kern), "library_device_ms": device_ms(lib)}


def host_us(fn, calls: int = 1000) -> float:
    """Host microseconds per call of fn() over ``calls`` calls with no
    synchronisation between them: what the caller's thread pays to
    enqueue the work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def fmt_ms(x) -> str:
    return "not measured" if x is None else f"{x:.4f}"


def phase_kernels() -> dict:
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases = {name: [] for name in REPLACES if "backward" not in name}
    # The smallest launch torch makes, for the device times below: a
    # one-element fill.
    z = torch.zeros(1, device="cuda")
    floor = device_ms(z.zero_, iters=50)
    log(f"[kernel] launch_floor torch.zeros(1).zero_(): device_ms "
        f"{'not measured' if floor is None else f'{floor:.5f}'} ms "
        f"{time_ms(z.zero_):.4f}")
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
                    else f" host_us {r['host_us']:.2f}"
                    + (f" (x + delta alone {r['add_host_us']:.2f})"
                       if "add_host_us" in r else "") + ";"
                    if "host_us" in r else "")
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
    worst errors, the inputs, the ring's outputs and its K5 launches."""
    from brpc_tpu_torch import ops
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
    ops.reset_launch_counts()
    outs = ra.ring_attention_local(qs, ks, vs, causal)
    ring_launches_run = ops.launch_counts()["ring_attention_fold"]
    for my in range(n):
        err, row = compare(f"{tag} rank {my} output", outs[my], finals[my],
                           dtype, rows=True)
        worst, worst_row = max(worst, err), max(worst_row, row)
    return {"max_abs_err": worst, "row_rel_err": worst_row,
            "inputs": (qs, ks, vs), "outputs": outs,
            "launches": ring_launches_run}


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

    def lib_diag():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=True)

    itemsize = torch.empty((), dtype=dtype).element_size()
    # q, k, v read; the state (o and (m, l), f32) read and written.
    nbytes = 3 * s * H * D * itemsize + 2 * s * H * (D + 2) * 4
    b, by = bound_ms(nbytes, 4.0 * H * s * s * D, dtype)
    b_diag, _ = bound_ms(nbytes, 4.0 * H * D * s * (s + 1) / 2, dtype)
    return {"shape": f"q,k,v[1,{s},{H},{D}] one block, every key visible",
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "diag_ms": time_ms(diag), "diag_device_ms": device_ms(diag),
            "diag_library_ms": time_ms(lib_diag),
            "diag_library_device_ms": device_ms(lib_diag),
            "diag_bound_ms": b_diag,
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
        # 4 stages x 8 microbatches of a [512, 4096] x [4096, 4096] product.
        res["pipeline_bound_ms"] = bound_ms(
            (4 * 4096 * 4096 + 2 * 8 * 512 * 4096) * 4,
            4 * 8 * 2.0 * 512 * 4096 * 4096, torch.float32)[0]
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
            # Each kept token through its one expert's two products; the
            # experts' weights read once.
            res[f"moe_cap{cap}"] = {
                "max_abs_err": compare(f"moe_forward capacity {cap}", got,
                                       want, torch.float32)[0],
                "tokens_kept": kept, "ms": ms,
                "bound_ms": bound_ms(8 * 2 * 4096 * 14336 * 4,
                                     kept * 2 * 2.0 * 4096 * 14336,
                                     torch.float32)[0]}
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
                "row_rel_err": r["row_rel_err"], "launches": r["launches"]}
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
                f", the ring's K5 launches "
                f"{res['fold'][f'{tag} causal={causal}']['launches']}"
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
            f"block ms {t['diag_ms']:.4f} device_ms "
            f"{fmt_ms(t['diag_device_ms'])} bound_ms "
            f"{t['diag_bound_ms']:.5f} causal SDPA over the block ms "
            f"{t['diag_library_ms']:.4f} device_ms "
            f"{fmt_ms(t['diag_library_device_ms'])}")
    # The whole causal ring against one causal SDPA over S 32768 (bf16).
    qs, ks, vs = main_in
    F = torch.nn.functional
    Q, K, V = (torch.cat(b, dim=1).transpose(1, 2) for b in (qs, ks, vs))
    ring_ms = time_ms(lambda: ra.ring_attention_local(qs, ks, vs, True),
                      iters=3, warmup=1)
    ring_dev = device_ms(lambda: ra.ring_attention_local(qs, ks, vs, True),
                         iters=3)
    sdpa_ms = time_ms(lambda: F.scaled_dot_product_attention(
        Q, K, V, is_causal=True), iters=3, warmup=1)
    ring_bound, _ = bound_ms(
        4 * RING_S * RING_H * RING_DH * 2,
        4.0 * RING_H * RING_DH * RING_S * (RING_S + 1) / 2, torch.bfloat16)
    res["ring_bf16_causal"] = {"ring_ms": ring_ms, "sdpa_causal_ms": sdpa_ms,
                               "bound_ms": ring_bound,
                               "ring_device_ms": ring_dev}
    log(f"[parallel] causal ring, S {RING_S} bf16, {RING_RANKS} in-process "
        f"ranks: {ring_ms:.3f} ms, device {fmt_ms(ring_dev)} ms "
        f"({ring_launches(RING_RANKS, True)} K5 "
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
        f" (bound {w['pipeline_bound_ms']:.3f} ms, f32 operations) "
        f"max_abs_err {w['pipeline_err']:.3e}; MoE (4096 x 14336, 8 "
        f"experts, 512 tokens, f32) capacity 512 kept "
        f"{w['moe_cap512']['tokens_kept']} in "
        f"{w['moe_cap512']['ms']:.1f} ms (bound "
        f"{w['moe_cap512']['bound_ms']:.3f} ms) max_abs_err "
        f"{w['moe_cap512']['max_abs_err']:.3e}, capacity 16 kept "
        f"{w['moe_cap16']['tokens_kept']} max_abs_err "
        f"{w['moe_cap16']['max_abs_err']:.3e}; K5 launches {launches}; "
        f"phase {time.monotonic() - t_phase:.1f} s")
    del main_in, main_out, outs, qs, ks, vs
    torch.cuda.empty_cache()
    return res


# ---- the training phase: K2b, K3b, K5b, the ring's backward, the step -------

# The f32 exactness step: Llama-3-8B width, 2 layers, one sequence of 513
# tokens (512 predicted). Its tolerances: the loss within 1e-5 relative
# (f32 on both sides, sums in another order), every gradient and every
# updated parameter within 1e-4 in the relative 2-norm over the tensor
# (the kernels' f32 cores sum in another order than cuBLAS and torch's
# reductions; 1e-4 leaves room for 2 layers of that).
TRAIN_EXACT_LAYERS, TRAIN_EXACT_TOKENS = 2, (1, 513)
TRAIN_EXACT_TOL = {"loss": 1e-5, "tensor": 1e-4}
# The bf16 step at width: 4 layers, tokens [2, max_seq // 4 + 1] as the dry
# run takes them. The kernel path and the plain path round to bf16 at
# different points (the kernels round P and dS to bf16 as tensor-core
# operands, the plain softmax rounds after the division), and each layer's
# difference feeds the next: every gradient tensor is held to 5e-2 in the
# relative 2-norm.
TRAIN_STEP_LAYERS, TRAIN_STEP_TOKENS = 4, (2, 2049)
TRAIN_BF16_TOL = 5e-2
# Phase 3's backward cases: K2b at (B, S) with Llama-3-8B's heads, K3b and
# its fused form at these rows x 4096, K5b on one 4096-row block.
K2B_CASES = [(2, 2048), (1, 4096)]
K3B_ROWS = (8, 4096)
# The ring's backward: S 8192 as 4 in-process ranks against dense
# attention's autograd, and S 32768 as 8 ranks, timed.
RING_BWD_DENSE_S, RING_BWD_DENSE_RANKS = 8192, 4


def fmt_errs(errs: dict) -> str:
    """{name: error} as compact JSON, 3 significant digits."""
    return json.dumps({k: float(f"{v:.2e}") for k, v in errs.items()})


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """|got - want| / |want| in the 2-norm over the whole tensor, in f32."""
    g, w = got.float(), want.float()
    return float((g - w).norm() / w.norm().clamp_min(1e-30))


def check_attention_backward(dtype, gen, B: int, S: int) -> dict:
    """K2's training forward (o and its LSE) against causal_attention_plain,
    timed beside its bound and causal SDPA's forward, and K2b against its
    plain backward on K2's own o and LSE, at Llama-3-8B's heads; SDPA's
    causal GQA backward as the library yardstick."""
    from brpc_tpu_torch.ops import attention

    dev = torch.device("cuda")
    H, KV, Dh = 32, 8, 128
    q = torch.randn((B, S, H, Dh), generator=gen, device=dev).to(dtype)
    k, v = (torch.randn((B, S, KV, Dh), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    do = torch.randn((B, S, H, Dh), generator=gen, device=dev).to(dtype)
    o, lse = attention.causal_attention_forward(q, k, v)
    tag = f"attention_backward B={B} S={S} {str(dtype)[6:]}"
    o_p, lse_p = attention.causal_attention_plain(q, k, v)
    fwd_err = compare(f"{tag} forward o", o, o_p, dtype, rows=True)
    lse_err = compare(f"{tag} forward lse", lse, lse_p, torch.float32)[0]
    del o_p, lse_p

    def kern():
        return attention.attention_backward(q, k, v, o, lse, do)

    def plain():
        return attention.prefill_attention_backward_plain(q, k, v, o, lse,
                                                          do)

    got = kern()
    errs = [compare(f"{tag} d{n}", g, w, dtype, rows=True,
                    floor=attention.GRAD_ROW_FLOOR)
            for n, g, w in zip("qkv", got, plain())]
    if not all(torch.equal(a, b) for a, b in zip(got, kern())):
        raise AssertionError(f"{tag}: two runs on the same inputs differ")
    del got
    F = torch.nn.functional
    q4, k4, v4 = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, k, v))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                         enable_gqa=True)
    do4 = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    itemsize = torch.empty((), dtype=dtype).element_size()
    pairs = B * S * (S + 1) / 2
    # q, o, dO read and dq written; k, v read and dk, dv written; the LSE.
    nbytes = (4 * B * S * H * Dh + 4 * B * S * KV * Dh) * itemsize \
        + B * S * H * 4
    b, by = bound_ms(nbytes, 10.0 * pairs * H * Dh, dtype)

    def fwd():
        return attention.causal_attention_forward(q, k, v)

    def lib_fwd():
        return F.scaled_dot_product_attention(
            q4.detach(), k4.detach(), v4.detach(), is_causal=True,
            enable_gqa=True)

    # q read and o written, k and v read, the LSE written
    fb, fby = bound_ms((2 * B * S * H * Dh + 2 * B * S * KV * Dh) * itemsize
                       + B * S * H * 4, 4.0 * pairs * H * Dh, dtype)
    timing = {"ms": time_ms(fwd), "device_ms": device_ms(fwd),
              "bound_ms": fb, "bound_by": fby, "library_ms": time_ms(lib_fwd),
              "library_device_ms": device_ms(lib_fwd)}
    return {"shape": f"q,o,dO[{B},{S},{H},{Dh}] k,v[{B},{S},{KV},{Dh}]",
            "max_abs_err": max(e[0] for e in errs),
            "row_rel_err": max(e[1] for e in errs),
            "tiles": backward_tiles(dtype),
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, iters=3), "bound_ms": b,
            "bound_by": by, "library_ms": time_ms(lib),
            "library_device_ms": device_ms(lib),
            "forward": {"max_abs_err": fwd_err[0], "row_rel_err": fwd_err[1],
                        "lse_max_abs_err": lse_err, **timing}}


def check_norm_backward(dtype, gen, rows: int, fused: bool) -> dict:
    """K3b (with ``fused``, its form with the stream's gradient) against
    its plain backward; the autograd backward of F.rms_norm (after x +
    delta when fused) as the library yardstick."""
    from brpc_tpu_torch.ops import norm

    dev = torch.device("cuda")
    D, eps = 4096, 1e-5
    x, dy, ds_out = (torch.randn((rows, D), generator=gen, device=dev)
                     .to(dtype) for _ in range(3))
    g = 1.0 + 0.1 * torch.randn((D,), generator=gen, device=dev)
    if fused:
        def kern():
            return norm.add_rms_norm_backward(x, g, dy, ds_out, eps)

        def plain():
            return norm.add_rms_norm_backward_plain(x, g, dy, ds_out, eps)
    else:
        def kern():
            return norm.rms_norm_backward(x, g, dy, eps)

        def plain():
            return norm.rms_norm_backward_plain(x, g, dy, eps)

    name = "add_rms_norm_backward" if fused else "rms_norm_backward"
    (dx, dg), (dx_p, dg_p) = kern(), plain()
    err = compare(f"{name} rows={rows} {str(dtype)[6:]} dx", dx, dx_p,
                  dtype)[0]
    err_g = compare(f"{name} rows={rows} {str(dtype)[6:]} dgain", dg, dg_p,
                    torch.float32)[0]
    F = torch.nn.functional
    xr = x.detach().requires_grad_(True)
    dr = torch.zeros_like(x).requires_grad_(True)
    w = g.to(dtype).requires_grad_(True)
    s = xr + dr
    out = F.rms_norm(s, (D,), weight=w, eps=eps)

    def lib():
        if fused:
            return torch.autograd.grad((out, s), (xr, dr, w), (dy, ds_out),
                                       retain_graph=True)
        return torch.autograd.grad(out, (xr, w), dy, retain_graph=True)

    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes = (4 if fused else 3) * rows * D * itemsize + 2 * D * 4
    b, by = bound_ms(nbytes, 10.0 * rows * D, dtype)
    return {"shape": f"x,dy[{rows},{D}]" + (" + ds_out" if fused else ""),
            "max_abs_err": err, "dgain_max_abs_err": err_g,
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, iters=5), "bound_ms": b,
            "bound_by": by, "library_ms": time_ms(lib),
            "library_device_ms": device_ms(lib)}


def check_ring_fold_backward(dtype, gen, diagonal: bool) -> dict:
    """K5b on one block at s 4096, H 32, Dh 128 (rank 1 of a causal ring:
    its o and LSE from K5 over rank 0's block and its own), for rank 0's
    block (every key visible) or, with ``diagonal``, its own; against the
    plain block backward, and SDPA's backward over the same block (causal
    on the diagonal) as the library yardstick."""
    from brpc_tpu_torch.ops import attention
    from brpc_tpu_torch.ops import ring_attention as ra

    s, H, D = RING_S // RING_RANKS, RING_H, RING_DH
    q, k0, v0, k1, v1, do = (torch.randn((1, s, H, D), generator=gen,
                                         device="cuda").to(dtype)
                             for _ in range(6))
    lse = torch.empty((1, s, H), dtype=torch.float32, device="cuda")
    st = ra.ring_attention_fold(q, k0, v0, ra.fold_state(q), s, 0, True)
    o = ra.ring_attention_fold(q, k1, v1, st, s, s, True, final=True,
                               lse=lse)
    kb, vb, k_start = (k1, v1, s) if diagonal else (k0, v0, 0)
    grads = ra.grad_buffers(q, kb)

    def kern():
        return ra.ring_attention_fold_backward(q, kb, vb, o, lse, do, grads,
                                               s, k_start, True, True)

    def plain():
        return ra.ring_attention_fold_backward_plain(q, kb, vb, o, lse, do,
                                                     s, k_start, True)

    kern()
    tag = (f"ring_attention_fold_backward {'diagonal' if diagonal else 'full'}"
           f" block {str(dtype)[6:]}")
    errs = [compare(f"{tag} d{n}", g, w, dtype, rows=True,
                    floor=attention.GRAD_ROW_FLOOR)
            for n, g, w in zip("qkv", grads[:3], plain())]
    again = ra.grad_buffers(q, kb)
    ra.ring_attention_fold_backward(q, kb, vb, o, lse, do, again, s, k_start,
                                    True, True)
    if not all(torch.equal(a, b) for a, b in zip(grads[:3], again[:3])):
        raise AssertionError(f"{tag}: two runs on the same inputs differ")
    del again
    F = torch.nn.functional
    q4, k4, v4 = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (q, kb, vb))
    out = F.scaled_dot_product_attention(q4, k4, v4, is_causal=diagonal)
    do4 = do.transpose(1, 2)

    def lib():
        return torch.autograd.grad(out, (q4, k4, v4), do4, retain_graph=True)

    itemsize = torch.empty((), dtype=dtype).element_size()
    pairs = s * (s + 1) / 2 if diagonal else s * s
    # q, o, dO, k, v read; the LSE read; dq, dk, dv read and written (f32).
    nbytes = 5 * s * H * D * itemsize + s * H * 4 + 6 * s * H * D * 4
    b, by = bound_ms(nbytes, 10.0 * pairs * H * D, dtype)
    return {"shape": f"q,k,v,o,dO[1,{s},{H},{D}] "
                     f"{'diagonal block' if diagonal else 'every key visible'}",
            "max_abs_err": max(e[0] for e in errs),
            "row_rel_err": max(e[1] for e in errs),
            "tiles": backward_tiles(dtype),
            "ms": time_ms(kern), "device_ms": device_ms(kern),
            "plain_ms": time_ms(plain, iters=3), "bound_ms": b,
            "bound_by": by, "library_ms": time_ms(lib),
            "library_device_ms": device_ms(lib)}


def backward_tiles(dtype) -> str:
    """The backward core's tiles and pipeline in ``dtype``, as
    csrc/attention_backward.cuh (bf16) and csrc/attention_f32.cuh (f32)
    set them."""
    from brpc_tpu_torch.ops import attention

    if dtype == torch.bfloat16:
        own, cols = attention.BWD_OWN_ROWS, attention.BWD_COLS
        return (f"dK/dV pass {own} keys x {cols}-query tiles, dQ pass {own} "
                f"queries x {cols}-key tiles, {own // attention.BWD_WG_ROWS}"
                f" consumer warpgroups, {attention.BWD_STAGES} TMA stages")
    return (f"both passes {attention.F32_BWD_OWN_ROWS} own rows x "
            f"{attention.F32_BWD_COLS}-column tiles, SIMT FFMA (256 "
            f"threads, 4 x 4 S/dP and 8 x 8 output micro-tiles), 2 "
            f"cp.async stages")


def log_case(name: str, tag: str, r: dict) -> None:
    row = ("" if r.get("row_rel_err") is None else
           f" row_rel_err {r['row_rel_err']:.3e}")
    log(f"[kernel] {name} {tag} {r['shape']}: max_abs_err "
        f"{r['max_abs_err']:.3e}{row} ms {r['ms']:.4f} device_ms "
        f"{fmt_ms(r['device_ms'])} plain_ms {r['plain_ms']:.4f} bound_ms "
        f"{r['bound_ms']:.5f} ({r['bound_by']}) library_ms "
        f"{r['library_ms']:.4f} library_device_ms "
        f"{fmt_ms(r['library_device_ms'])}")
    if "tiles" in r:
        log(f"[kernel] {name} {tag}: {r['tiles']}; two runs bit-identical")
    if "forward" in r:
        f = r["forward"]
        log(f"[kernel] {name} {tag}: K2's training forward against "
            f"causal_attention_plain: o max_abs_err {f['max_abs_err']:.3e} "
            f"row_rel_err {f['row_rel_err']:.3e}; lse max_abs_err "
            f"{f['lse_max_abs_err']:.3e}; ms {f['ms']:.4f} device_ms "
            f"{fmt_ms(f['device_ms'])} bound_ms {f['bound_ms']:.5f} "
            f"({f['bound_by']}) causal SDPA library_ms "
            f"{f['library_ms']:.4f} library_device_ms "
            f"{fmt_ms(f['library_device_ms'])}")


def phase_backward_kernels() -> dict:
    """Phase 3's backward cases: K2b, K3b (alone and fused) and K5b (a
    full block and the diagonal block), bf16 and f32, each against its
    plain backward, timed beside its bound and library call."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    cases = {name: [] for name in ("attention_backward", "rms_norm_backward",
                                   "add_rms_norm_backward",
                                   "ring_attention_fold_backward")}
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        runs = [("attention_backward", check_attention_backward(
            dtype, gen, B, S)) for B, S in K2B_CASES]
        for rows in K3B_ROWS:
            runs.append(("rms_norm_backward",
                         check_norm_backward(dtype, gen, rows, False)))
            runs.append(("add_rms_norm_backward",
                         check_norm_backward(dtype, gen, rows, True)))
        for diagonal in (False, True):
            runs.append(("ring_attention_fold_backward",
                         check_ring_fold_backward(dtype, gen, diagonal)))
        for name, r in runs:
            r["dtype"] = tag
            cases[name].append(r)
            log_case(name, tag, r)
            torch.cuda.empty_cache()
    return cases


def ring_grads(qs, ks, vs, do_blocks, causal: bool) -> tuple:
    """The in-process ring's output blocks and, for the output gradient
    ``do_blocks``, its gradient in every block -> (outputs, [dq blocks,
    dk blocks, dv blocks])."""
    from brpc_tpu_torch.ops import ring_attention as ra

    leaves = [[b.detach().requires_grad_(True) for b in t]
              for t in (qs, ks, vs)]
    outs = ra.ring_attention_local(*leaves, causal)
    torch.autograd.backward(outs, do_blocks)
    return [o.detach() for o in outs], [[b.grad for b in t] for t in leaves]


def check_ring_backward_dense(dtype, gen) -> dict:
    """The in-process causal ring's gradient at S 8192 as 4 ranks against
    dense attention, 8 heads at a time: in f32 row by row against dense
    autograd; in bf16 row by row against the same backward over one dense
    block (ring_attention_fold_backward_plain on the ring's own output),
    and each gradient tensor against dense autograd in the relative
    2-norm (attention.RING_BF16_GRAD_TOL)."""
    from brpc_tpu_torch import ops
    from brpc_tpu_torch.ops import attention
    from brpc_tpu_torch.ops import ring_attention as ra

    S, n = RING_BWD_DENSE_S, RING_BWD_DENSE_RANKS
    full = [torch.randn((1, S, RING_H, RING_DH), generator=gen,
                        device="cuda").to(dtype) for _ in range(4)]
    ops.reset_launch_counts()
    outs, got = ring_grads(*(list(t.split(S // n, dim=1)) for t in full[:3]),
                           list(full[3].split(S // n, dim=1)), True)
    counts = ops.launch_counts()
    launches = {k: counts[k] for k in ("ring_attention_fold",
                                       "ring_attention_fold_backward")}
    out = torch.cat(outs, dim=1)
    got = [torch.cat(blocks, dim=1) for blocks in got]
    tag = f"ring backward S={S} {str(dtype)[6:]}"
    res = {"max_abs_err": 0.0, "row_rel_err": 0.0}
    sq_diff = [0.0] * 3
    sq_ref = [0.0] * 3
    autograd_row = 0.0
    for h0 in range(0, RING_H, 8):
        hs = slice(h0, h0 + 8)
        q, k, v, do = (t[:, :, hs] for t in full)
        leaves = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
        ra.attention_reference(*leaves, True).backward(do.float())
        dense = [leaf.grad for leaf in leaves]
        del leaves
        if dtype == torch.float32:
            want = dense
        else:
            lse = ra.fold_lse(ra.ring_attention_fold_plain(
                q, k, v, ra.fold_state(q), 0, 0, True))
            want = ra.ring_attention_fold_backward_plain(
                q, k, v, out[:, :, hs], lse, do, 0, 0, True)
            del lse
        for i, name in enumerate("qkv"):
            g = got[i][:, :, hs]
            e = compare(f"{tag} d{name} heads {h0}..", g, want[i], dtype,
                        rows=True, floor=attention.GRAD_ROW_FLOOR)
            res["max_abs_err"] = max(res["max_abs_err"], e[0])
            res["row_rel_err"] = max(res["row_rel_err"], e[1])
            sq_diff[i] += float((g.float() - dense[i]).norm()) ** 2
            sq_ref[i] += float(dense[i].norm()) ** 2
            autograd_row = max(autograd_row, attention.max_row_rel_err(
                g, dense[i], attention.GRAD_ROW_FLOOR))
        del want, dense
    res["autograd_rel_err"] = {name: (d / r) ** 0.5 for name, d, r in
                               zip("qkv", sq_diff, sq_ref)}
    res["autograd_row_rel_err"] = autograd_row
    res["launches"] = launches
    worst = max(res["autograd_rel_err"].values())
    if dtype == torch.bfloat16 and not worst <= attention.RING_BF16_GRAD_TOL:
        raise AssertionError(f"{tag}: a gradient's relative 2-norm error "
                             f"against dense autograd is {worst:.3e}")
    return res


def train_params(cfg, seed: int) -> dict:
    """f32 master parameters of the reference's shapes and scales
    (``init_params`` in f32) from a seeded generator on the card."""
    from brpc_tpu_torch.models import transformer

    return transformer.init_params(
        dataclasses.replace(cfg, dtype=torch.float32),
        torch.Generator(device="cuda").manual_seed(seed), device="cuda")


def leaf_names(params: dict) -> list:
    return (["embed"] + sorted(params["layers"]) + ["ln_out", "w_out"])


def step_exactness(cfg) -> dict:
    """One f32 train_step on the kernels against one step through
    loss_fn_plain's autograd, TF32 off: the loss, every gradient and every
    updated parameter, held to TRAIN_EXACT_TOL."""
    from brpc_tpu_torch import ops, train
    from brpc_tpu_torch.models import transformer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = train_params(cfg, 21)
    tokens = torch.randint(0, cfg.vocab, TRAIN_EXACT_TOKENS, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(22))
    ops.reset_launch_counts()
    loss, grads = train.value_and_grad(transformer.loss_fn, params, tokens,
                                       cfg, device="cuda")
    launches = ops.launch_counts()
    loss_p, grads_p = train.value_and_grad(transformer.loss_fn_plain, params,
                                           tokens, cfg, device="cuda")
    loss_err = abs(float(loss) - float(loss_p)) / abs(float(loss_p))
    if not loss_err <= TRAIN_EXACT_TOL["loss"]:
        raise AssertionError(f"f32 step: loss {float(loss)} vs plain "
                             f"{float(loss_p)}")
    worst = {}
    names = leaf_names(params)
    for name, g, gp in zip(names, grads, grads_p):
        worst[name] = rel_err(g, gp)
        if not (torch.isfinite(g).all()
                and worst[name] <= TRAIN_EXACT_TOL["tensor"]):
            raise AssertionError(f"f32 step: d/d{name} relative error "
                                 f"{worst[name]:.3e}")
    new = train.sgd_update(params, grads, 1e-3)
    new_p = train.sgd_update(params, grads_p, 1e-3)
    upd = max(rel_err(a, b) for a, b in zip(train.flatten(new),
                                            train.flatten(new_p)))
    if not upd <= TRAIN_EXACT_TOL["tensor"]:
        raise AssertionError(f"f32 step: updated parameters differ by "
                             f"{upd:.3e}")
    return {"loss": float(loss), "loss_plain": float(loss_p),
            "loss_rel_err": loss_err, "grad_rel_err": worst,
            "update_rel_err": upd,
            "launches": {k: n for k, n in launches.items() if n}}


def timed(fn) -> tuple:
    """fn() between synchronisations -> (result, ms on the host clock)."""
    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.monotonic() - t0) * 1e3


def step_at_width(cfg) -> dict:
    """The bf16 train_step at Llama-3-8B width and TRAIN_STEP_LAYERS layers
    on tokens TRAIN_STEP_TOKENS: the main run of the training path (counts
    zeroed just before, read just after), timed, beside the plain autograd
    step; every gradient held to TRAIN_BF16_TOL of the plain step's."""
    from brpc_tpu_torch import ops, train
    from brpc_tpu_torch.models import transformer

    params = train_params(cfg, 31)
    tokens = torch.randint(0, cfg.vocab, TRAIN_STEP_TOKENS, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(32))
    n_tok = TRAIN_STEP_TOKENS[0] * (TRAIN_STEP_TOKENS[1] - 1)
    train.train_step(params, tokens, cfg)  # warm-up
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    (new, loss), step_ms = timed(lambda: train.train_step(params, tokens,
                                                          cfg))
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del new
    L = cfg.n_layers
    want = {"prefill_attention": L, "attention_backward": L, "rms_norm": 1,
            "add_rms_norm": 2 * L, "rms_norm_backward": 1,
            "add_rms_norm_backward": 2 * L}
    for name, n in want.items():
        if launches[name] != n:
            raise AssertionError(f"the training step launched {name} "
                                 f"{launches[name]} times, want {n}")
    torch.cuda.empty_cache()

    def plain_step():
        lp, gp = train.value_and_grad(transformer.loss_fn_plain, params,
                                      tokens, cfg)
        return train.sgd_update(params, gp, 1e-3), lp

    plain_step()  # warm-up
    torch.cuda.reset_peak_memory_stats()
    (new_p, loss_p), plain_ms = timed(plain_step)
    plain_peak = torch.cuda.max_memory_allocated() / 2**30
    del new_p
    torch.cuda.empty_cache()
    if not (torch.isfinite(loss) and torch.isfinite(loss_p)):
        raise AssertionError(f"bf16 step: losses {float(loss)}, plain "
                             f"{float(loss_p)}")
    loss_k, grads = train.value_and_grad(transformer.loss_fn, params, tokens,
                                         cfg)
    _, grads_p = train.value_and_grad(transformer.loss_fn_plain, params,
                                      tokens, cfg)
    errs = {}
    for name, g, gp in zip(leaf_names(params), grads, grads_p):
        errs[name] = rel_err(g, gp)
        if not (torch.isfinite(g).all() and errs[name] <= TRAIN_BF16_TOL):
            raise AssertionError(f"bf16 step: d/d{name} relative error "
                                 f"{errs[name]:.3e} vs the plain step")
    del grads, grads_p, params
    torch.cuda.empty_cache()
    # The step's least time: 6 flops per matmul parameter and token
    # (forward, and the two backward products), and causal attention's
    # forward (4 Dh flops per visible pair and head) and backward (10 Dh),
    # at the bf16 peak; the embedding, norms, RoPE and update are far below
    # the matmuls.
    D, Dh = cfg.d_model, cfg.d_head
    per_layer = D * Dh * (2 * cfg.n_heads + 2 * cfg.n_kv_heads) \
        + 3 * D * cfg.d_ff
    n_matmul = L * per_layer + D * cfg.vocab
    B, T = TRAIN_STEP_TOKENS[0], TRAIN_STEP_TOKENS[1] - 1
    flops = 6.0 * n_matmul * n_tok \
        + 14.0 * L * B * T * (T + 1) / 2 * cfg.n_heads * Dh
    bound, _ = bound_ms(0.0, flops, torch.bfloat16)
    return {"tokens": list(TRAIN_STEP_TOKENS), "layers": L,
            "flops": flops, "bound_ms": bound,
            "loss": float(loss), "loss_plain": float(loss_p),
            "step_ms": step_ms, "tokens_per_s": n_tok / step_ms * 1e3,
            "peak_mem_gib": peak, "plain_step_ms": plain_ms,
            "plain_tokens_per_s": n_tok / plain_ms * 1e3,
            "plain_peak_mem_gib": plain_peak, "grad_rel_err": errs,
            "launches": launches}


def ring_backward_at_length(gen) -> dict:
    """The causal bf16 in-process ring at S 32768 as 8 ranks, forward and
    backward: the main run of the ring's backward (counts zeroed just
    before, read just after), timed, beside one causal SDPA forward and
    backward over the whole sequence."""
    from brpc_tpu_torch import ops

    S, n = RING_S, RING_RANKS
    full = [torch.randn((1, S, RING_H, RING_DH), generator=gen,
                        device="cuda").to(torch.bfloat16) for _ in range(4)]
    blocks = [list(t.split(S // n, dim=1)) for t in full]

    def run():
        return ring_grads(*blocks[:3], blocks[3], True)[1]

    run()  # warm-up
    ops.reset_launch_counts()
    grads, ms = timed(run)
    launches = ops.launch_counts()
    skipped_above = n * (n - 1) // 2
    if launches["ring_attention_fold_backward"] != n * n - skipped_above or \
            launches["ring_attention_fold"] != ring_launches(n, True):
        raise AssertionError(f"the ring's backward launched {launches}")
    for t in grads:
        for g in t:
            if not torch.isfinite(g).all():
                raise AssertionError("the ring's gradient is not finite")
    F = torch.nn.functional
    Q, K, V = (torch.cat(b, dim=1).transpose(1, 2).detach()
               .requires_grad_(True) for b in blocks[:3])
    dO = full[3].transpose(1, 2)

    def lib():
        out = F.scaled_dot_product_attention(Q, K, V, is_causal=True)
        return torch.autograd.grad(out, (Q, K, V), dO)

    lib()
    _, lib_ms = timed(lib)
    # Forward (4 D flops per visible pair) and backward (10 D).
    b, _ = bound_ms(9 * S * RING_H * RING_DH * 2,
                    14.0 * RING_H * RING_DH * S * (S + 1) / 2,
                    torch.bfloat16)
    return {"ms": ms, "device_ms": device_ms(run, iters=2),
            "sdpa_ms": lib_ms, "bound_ms": b, "launches": launches}


def phase_train() -> dict:
    """The training path: phase 3's backward cases, the ring's backward
    against dense and at S 32768, the f32 exactness step, the bf16 step at
    width, and the dry-run twin in an NCCL world of one."""
    import socket

    import torch.distributed as dist
    from brpc_tpu_torch import dryrun
    from brpc_tpu_torch.models import transformer

    t_phase = time.monotonic()
    res = {"kernels": phase_backward_kernels()}
    gen = torch.Generator(device="cuda").manual_seed(41)
    for dtype in (torch.bfloat16, torch.float32):
        res[f"ring_dense_{str(dtype)[6:]}"] = d = check_ring_backward_dense(
            dtype, gen)
        log(f"[train] ring backward, causal S {RING_BWD_DENSE_S} as "
            f"{RING_BWD_DENSE_RANKS} in-process ranks, {str(dtype)[6:]}: vs "
            f"{'dense autograd' if dtype == torch.float32 else 'one block'}"
            f" max_abs_err {d['max_abs_err']:.3e} row_rel_err "
            f"{d['row_rel_err']:.3e}; vs dense autograd relative 2-norm "
            f"error {fmt_errs(d['autograd_rel_err'])}, worst row "
            f"{d['autograd_row_rel_err']:.3e}; launches {d['launches']}")
        torch.cuda.empty_cache()
    res["ring"] = r = ring_backward_at_length(gen)
    log(f"[train] causal ring forward + backward, S {RING_S} bf16 as "
        f"{RING_RANKS} in-process ranks: {r['ms']:.3f} ms (device "
        f"{fmt_ms(r['device_ms'])} ms; K5 "
        f"{r['launches']['ring_attention_fold']} launches, K5b "
        f"{r['launches']['ring_attention_fold_backward']}); one causal SDPA "
        f"forward + backward over S {RING_S}: {r['sdpa_ms']:.3f} ms; bound "
        f"{r['bound_ms']:.3f} ms (operations)")
    torch.cuda.empty_cache()
    base = transformer.TransformerConfig.llama3_8b()
    res["exact"] = e = step_exactness(dataclasses.replace(
        base, n_layers=TRAIN_EXACT_LAYERS, dtype=torch.float32))
    log(f"[train] f32 step, Llama-3-8B width, {TRAIN_EXACT_LAYERS} layers, "
        f"tokens {list(TRAIN_EXACT_TOKENS)}, TF32 off: loss {e['loss']:.6f} "
        f"vs plain {e['loss_plain']:.6f} (rel {e['loss_rel_err']:.2e}); "
        f"gradients' relative 2-norm error max "
        f"{max(e['grad_rel_err'].values()):.2e} "
        f"({fmt_errs(e['grad_rel_err'])}); "
        f"updated parameters {e['update_rel_err']:.2e}; launches "
        f"{e['launches']}")
    torch.cuda.empty_cache()
    res["step"] = s = step_at_width(dataclasses.replace(
        base, n_layers=TRAIN_STEP_LAYERS))
    log(f"[train] bf16 train_step, Llama-3-8B width, {TRAIN_STEP_LAYERS} "
        f"layers, tokens {list(TRAIN_STEP_TOKENS)}: {s['step_ms']:.1f} ms = "
        f"{s['tokens_per_s']:.0f} tokens/s, peak {s['peak_mem_gib']:.2f} GiB,"
        f" loss {s['loss']:.5f}; bound {s['bound_ms']:.2f} ms "
        f"({s['flops'] / 1e12:.2f} TFLOP at the bf16 peak); the plain "
        f"autograd step "
        f"{s['plain_step_ms']:.1f} ms = {s['plain_tokens_per_s']:.0f} "
        f"tokens/s, peak {s['plain_peak_mem_gib']:.2f} GiB, loss "
        f"{s['loss_plain']:.5f}; gradients' relative 2-norm error vs plain "
        f"max {max(s['grad_rel_err'].values()):.2e} "
        f"({fmt_errs(s['grad_rel_err'])}); "
        f"launches {s['launches']}")
    with socket.socket() as so:
        so.bind(("localhost", 0))
        port = so.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        twin = dryrun.dryrun_rank(0, 1, device="cuda")
    finally:
        dist.destroy_process_group()
    res["dryrun"] = {k: v for k, v in twin.items() if k != "params"}
    log(f"[train] dry-run twin, NCCL world of one (dp 1 x tp 1), tiny bf16:"
        f" loss {twin['loss']:.5f}; sp {twin['sp']['max_abs_err']:.2e}, ep "
        f"{twin['ep']['max_abs_err']:.2e}, pp {twin['pp']['max_abs_err']:.2e};"
        f" phase {time.monotonic() - t_phase:.1f} s")
    torch.cuda.empty_cache()
    return res


# ---- checkpoint and resume ----------------------------------------------------

# A 1-layer Llama-3-8B in bf16 is 1,268,789,248 parameters, 2.54 GB of TCK1:
# one blob under param_server.MAX_BLOB_BYTES (f32 masters, 5.08 GB, are not).
CKPT_PARAMS = 1_268_789_248
CKPT_TOKENS = (1, 513)
CKPT_STEPS = 2
CKPT_LR = 1e-3
CKPT_KEEP = 2


def spawn_store(directory: str) -> tuple:
    """A CheckpointStore process on ``directory``: (process, address,
    its recovery's seconds, steps it recovered)."""
    proc = subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.checkpoint", "--dir",
         directory, "--keep", str(CKPT_KEEP)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=HERE)
    ready, _, _ = select.select([proc.stdout], [], [], 300)
    line = proc.stdout.readline().split() if ready else []
    if not line or line[0] != "READY":
        proc.kill()
        proc.wait()
        raise AssertionError(f"the store process did not start: {line!r}")
    return proc, f"127.0.0.1:{int(line[1])}", float(line[2]), int(line[3])


def kill_store(proc) -> None:
    if proc.poll() is None:
        proc.send_signal(signal.SIGKILL)
    proc.wait()


def ckpt_vars(addr: str) -> dict:
    from brpc_tpu_torch import runtime

    return runtime.http_vars(addr, "ckpt_")


def phase_checkpoint(card: str, report_dir: str) -> dict:
    """Checkpoint and resume at Llama-3-8B width: a 1-layer bf16 model on
    the card takes CKPT_STEPS train_steps (K2, K2b, K3, K3b), is saved to
    a CheckpointStore process with a directory (keep 2), the store is
    killed with SIGKILL and restarted on its directory, and the loaded
    parameters, moved onto the card, must be torch.equal to those saved;
    step 3 from them must give the originals' loss bit for bit (or, if
    two step-3 runs from the originals differ, stay within their spread).
    Then a ParamServer of the same weights round-trips through
    snapshot_to / restore byte-identical. The snapshot files are removed
    at the end."""
    from brpc_tpu_torch import checkpoint, disagg, ops, param_server, train
    from brpc_tpu_torch.models import transformer

    t_phase = time.monotonic()
    cfg = dataclasses.replace(transformer.TransformerConfig.llama3_8b(),
                              n_layers=1)
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(51), device="cuda")
    tokens = torch.randint(0, cfg.vocab, CKPT_TOKENS, device="cuda",
                           generator=torch.Generator(device="cuda")
                           .manual_seed(52))
    ops.reset_launch_counts()
    losses = []
    for _ in range(CKPT_STEPS):
        params, loss = train.train_step(params, tokens, cfg, lr=CKPT_LR)
        losses.append(float(loss))
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    L = cfg.n_layers
    want = {"prefill_attention": L, "attention_backward": L, "rms_norm": 1,
            "add_rms_norm": 2 * L, "rms_norm_backward": 1,
            "add_rms_norm_backward": 2 * L}
    for name, n in want.items():
        if launches[name] != CKPT_STEPS * n:
            raise AssertionError(f"{CKPT_STEPS} train steps launched {name} "
                                 f"{launches[name]} times, want "
                                 f"{CKPT_STEPS * n}")
    flat = disagg._flatten_params(params)
    n_params = sum(t.numel() for t in flat.values())
    nbytes = checkpoint.checkpoint_bytes(flat)
    if n_params != CKPT_PARAMS or nbytes > param_server.MAX_BLOB_BYTES:
        raise AssertionError(f"{n_params} parameters, {nbytes} bytes")
    directory = os.path.join(report_dir, "ckpt")
    shutil.rmtree(directory, ignore_errors=True)
    os.makedirs(directory)
    free = shutil.disk_usage(directory).free
    if free < CKPT_KEEP * nbytes + (1 << 30):
        raise AssertionError(f"{directory} has {free} bytes free, less than "
                             f"{CKPT_KEEP} snapshots of {nbytes} and 1 GiB")
    res = {"card": card, "params": n_params, "bytes": nbytes,
           "train_losses": losses, "launches": launches}
    proc, addr, _, n0 = spawn_store(directory)
    try:
        if n0:
            raise AssertionError(f"a fresh store recovered {n0} steps")
        v0 = ckpt_vars(addr)
        t0 = time.monotonic()
        checkpoint.save_checkpoint(addr, CKPT_STEPS, CKPT_LR, flat,
                                   timeout_s=600)
        res["save_s"] = time.monotonic() - t0
        v1 = ckpt_vars(addr)
        for key in ("write", "fsync"):
            res[f"commit_{key}_s"] = (v1.get(f"ckpt_{key}_us", 0)
                                      - v0.get(f"ckpt_{key}_us", 0)) / 1e6
        kill_store(proc)
        t0 = time.monotonic()
        proc, addr, res["recover_s"], n1 = spawn_store(directory)
        res["restart_s"] = time.monotonic() - t0
        if n1 != 1:
            raise AssertionError(f"the restarted store recovered {n1} steps")
        t0 = time.monotonic()
        step, lr, host = checkpoint.load_checkpoint(addr)
        res["load_s"] = time.monotonic() - t0
        t0 = time.monotonic()
        loaded = {k: torch.as_tensor(v).to("cuda") for k, v in host.items()}
        torch.cuda.synchronize()
        res["h2d_s"] = time.monotonic() - t0
        if (step, lr) != (CKPT_STEPS, CKPT_LR):
            raise AssertionError(f"restored step {step} lr {lr}")
        if set(loaded) != set(flat):
            raise AssertionError("restored names differ")
        for k, t in flat.items():
            if loaded[k].dtype != t.dtype or not torch.equal(loaded[k], t):
                raise AssertionError(f"restored {k} differs")
        restored = disagg._unflatten_params(loaded)
        del loaded
        # Step 3 from the originals twice and from the restored parameters.
        runs = [train.train_step(p, tokens, cfg, lr=CKPT_LR)
                for p in (params, params, restored)]
        (new_a, loss_a), (new_b, loss_b), (new_r, loss_r) = runs
        fa, fb, fr = (disagg._flatten_params(n) for n in (new_a, new_b, new_r))
        spread = abs(float(loss_a) - float(loss_b))
        res["step3"] = {
            "loss": float(loss_a), "loss_rerun": float(loss_b),
            "loss_restored": float(loss_r),
            "rerun_bit_equal": bool(torch.equal(loss_a, loss_b)),
            "restored_bit_equal": bool(torch.equal(loss_r, loss_a)),
            # Parameters whose update differs between two runs from the
            # same weights (an op of the backward that is not
            # deterministic), and between the restored and original runs.
            "update_differs_rerun": [k for k in sorted(fa)
                                     if not torch.equal(fa[k], fb[k])],
            "update_differs_restored": [k for k in sorted(fa)
                                        if not torch.equal(fa[k], fr[k])],
        }
        if res["step3"]["rerun_bit_equal"]:
            if not res["step3"]["restored_bit_equal"]:
                raise AssertionError(f"step 3: restored loss {float(loss_r)!r}"
                                     f" vs {float(loss_a)!r}")
        elif abs(float(loss_r) - float(loss_a)) > spread:
            raise AssertionError(f"step 3: restored loss {float(loss_r)!r} "
                                 f"outside the reruns' spread {spread!r}")
        del runs, new_a, new_b, new_r, fa, fb, fr, restored
        # The ParamServer's round trip: its blob wrapped as it is.
        srv = param_server.ParamServer(host, lr=CKPT_LR,
                                       version=CKPT_STEPS + 1)
        del host
        try:
            t0 = time.monotonic()
            if srv.snapshot_to(addr) != CKPT_STEPS + 1:
                raise AssertionError("snapshot_to: wrong step")
            res["ps_snapshot_s"] = time.monotonic() - t0
            t0 = time.monotonic()
            back = param_server.ParamServer.restore(addr)
            res["ps_restore_s"] = time.monotonic() - t0
            try:
                if back.version() != CKPT_STEPS + 1 or back._blob != srv._blob:
                    raise AssertionError("ParamServer.restore: the blob or "
                                         "the version differs")
            finally:
                back.close()
        finally:
            srv.close()
        res["steps_kept"] = checkpoint.list_checkpoints(addr)
        if res["steps_kept"] != [CKPT_STEPS, CKPT_STEPS + 1]:
            raise AssertionError(f"the store keeps {res['steps_kept']}")
        res["files"] = sorted(os.listdir(directory))
    finally:
        kill_store(proc)
        shutil.rmtree(directory, ignore_errors=True)
    del params, flat
    torch.cuda.empty_cache()
    gb = nbytes / 1e9
    res["phase_s"] = time.monotonic() - t_phase
    s3 = res["step3"]
    log(f"[ckpt] {card}: 1-layer Llama-3-8B bf16, {n_params} parameters, "
        f"{nbytes} bytes of TCK1 after {CKPT_STEPS} train_steps on tokens "
        f"{list(CKPT_TOKENS)} (losses {losses}; launches {launches}); "
        f"save_checkpoint {res['save_s']:.3f} s = {gb / res['save_s']:.3f} "
        f"GB/s (the commit's write {res['commit_write_s']:.3f} s, fsync "
        f"{res['commit_fsync_s']:.3f} s); SIGKILL, restart "
        f"{res['restart_s']:.3f} s (recovery {res['recover_s']:.3f} s); "
        f"load_checkpoint {res['load_s']:.3f} s = {gb / res['load_s']:.3f} GB/s, to the card "
        f"{res['h2d_s']:.3f} s; every tensor torch.equal")
    log(f"[ckpt] step 3: loss {s3['loss']!r}, rerun {s3['loss_rerun']!r} "
        f"(bit-equal {s3['rerun_bit_equal']}), restored "
        f"{s3['loss_restored']!r} (bit-equal {s3['restored_bit_equal']}); "
        f"updates that differ between reruns {s3['update_differs_rerun']}, "
        f"restored vs original {s3['update_differs_restored']}; ParamServer "
        f"snapshot_to (its blob as it is, no encode) "
        f"{res['ps_snapshot_s']:.3f} s = {gb / res['ps_snapshot_s']:.3f} "
        f"GB/s, restore {res['ps_restore_s']:.3f} s = "
        f"{gb / res['ps_restore_s']:.3f} GB/s, blob byte-identical; kept "
        f"{res['steps_kept']}; phase {res['phase_s']:.1f} s")
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
        ops.reset_launch_counts()
        out = run_swarm(eng, prompts, 8)
        cold = ops.launch_counts()
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
    total_launches = {k: cold[k] + launches[k] for k in launches
                      if cold[k] + launches[k]}
    log(f"[exact] f32 Llama-3-8B width, {cfg.n_layers} layers: 4 "
        f"concurrent streams "
        f"(prompts 5/16/17/100, 8 tokens) identical to the plain forward's "
        f"greedy rollout; two chat turns over a 40-token shared prefix: "
        f"{resumes} resumes ({cows} copy-on-write), all 6 streams identical "
        f"to the plain rollout of the full prompt; launches "
        f"{total_launches}")
    # The same requests through the disaggregated path; the colocated
    # streams above equal the plain rollout, so these must equal them.
    script = [[(p, 8, out["tokens"][i]) for i, p in enumerate(prompts)],
              [(p0, 40, r0)], [(a, 8, ab[0]), (b, 8, ab[1])],
              [(p, 8, t2[i]) for i, p in enumerate(turn2)]]
    disagg_res = exact_disagg(params, cfg, script)
    cluster_res = exact_cluster(params, cfg, script)
    registry_res = exact_registry(params, cfg, script)
    del params
    torch.cuda.empty_cache()
    return {"streams": [out["tokens"][i] for i in range(len(prompts))],
            "chat_streams": [t for _, t in chats], "resumes": resumes,
            "cow_copies": cows, "disagg": disagg_res,
            "cluster": cluster_res, "registry": registry_res,
            "launches": total_launches}


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
        run_waves(router, script, "disagg")
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


def run_waves(server, script, what: str) -> None:
    """``script``'s waves through ``server`` (anything with a ``port``),
    each wave's prompts concurrently by their number of new tokens; every
    stream must equal its expected one."""
    for wave in script:
        for n in sorted({n for _, n, _ in wave}):
            part = [(p, want) for p, m, want in wave if m == n]
            got = run_swarm(server, [p for p, _ in part], n)["tokens"]
            for i, (p, want) in enumerate(part):
                if got[i] != want:
                    raise AssertionError(
                        f"f32 {what} stream (prompt {len(p)}): "
                        f"{got[i]} != plain {want}")


def cluster_launches(cluster, addr: str, timeout_s: float = 60.0) -> dict:
    """A worker process's kernel launches, off its /vars, once it holds no
    sequence and two reads 0.2 s apart agree (a worker adds a batch's
    launches to its counters after the batch)."""
    from brpc_tpu_torch import disagg, runtime

    prefix = disagg.LAUNCH_COUNTER_PREFIX
    deadline = time.monotonic() + timeout_s
    prev = None
    while True:
        cur = {k[len(prefix):]: int(v)
               for k, v in runtime.http_vars(addr, prefix).items()}
        if cur == prev and cluster.worker_status(addr)["active"] == 0:
            return cur
        if time.monotonic() > deadline:
            raise AssertionError(f"worker {addr} did not settle: "
                                 f"{cluster.worker_status(addr)}")
        prev = cur
        time.sleep(0.2)


# Kernels each worker process must have launched: K2 (under
# prefill_stream) on a prefill worker, K1 and K3 fused on a decode worker.
CLUSTER_KERNELS = {"prefill": ("prefill_attention",),
                   "decode": ("paged_decode_attention", "add_rms_norm")}


def cluster_addrs(cluster) -> dict:
    """role -> the addresses of the worker processes the cluster started
    with."""
    return {"prefill": cluster.prefill_addrs, "decode": cluster.decode_addrs}


def check_cluster_launches(cluster, addrs=None) -> dict:
    """Each worker process's launches (``addrs``: role -> addresses,
    default the ones the cluster started with); fails unless each
    launched its role's kernels."""
    addrs = addrs or cluster_addrs(cluster)
    out = {role: [cluster_launches(cluster, a) for a in addrs[role]]
           for role in ("prefill", "decode")}
    for role, names in CLUSTER_KERNELS.items():
        for i, got in enumerate(out[role]):
            for name in names:
                if got.get(name, 0) <= 0:
                    raise AssertionError(f"{role} worker process {i} "
                                         f"launched {name} "
                                         f"{got.get(name, 0)} times: {got}")
    return out


def cold_start(cluster, addr: str) -> dict:
    """One worker process's cold start: seconds from spawn to READY, and
    its weight pull's seconds, wire and effective bytes and groups (the
    worker's own counters, off its /vars)."""
    from brpc_tpu_torch import runtime

    v = runtime.http_vars(addr, "cluster_model_fetch")
    return {"ready_s": cluster.spawn_seconds[addr],
            "fetch_s": v["cluster_model_fetch_us"] / 1e6,
            "wire_bytes": int(v["cluster_model_fetch_wire_bytes"]),
            "effective_bytes": int(v["cluster_model_fetch_effective_bytes"]),
            "groups": int(v["cluster_model_fetch_groups"])}


def cold_starts(cluster) -> dict:
    """``cold_start`` of each worker process the cluster started with."""
    return {f"{role}{i}": cold_start(cluster, addr)
            for role, addrs in cluster_addrs(cluster).items()
            for i, addr in enumerate(addrs)}


def fmt_cold_starts(starts: dict) -> str:
    return "; ".join(
        f"{who}: ready {s['ready_s']:.1f} s, pull {s['fetch_s']:.2f} s of "
        f"{s['wire_bytes']} wire bytes ({s['effective_bytes']} effective, "
        f"{s['groups']} groups, {s['wire_bytes'] / s['fetch_s'] / 1e9:.2f} "
        f"GB/s)" for who, s in starts.items())


def worker_memory(cluster, addrs=None) -> dict:
    """Device memory: the rows of ``nvidia-smi
    --query-compute-apps=pid,used_memory`` (pid and MiB of every process
    on the card; in a container the pids may be another namespace's),
    this process's and the worker processes' pids, and each worker
    process's own allocator reservation (``torch_cuda_reserved_bytes``,
    off its /vars)."""
    from brpc_tpu_torch import disagg, runtime

    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=30).stdout
    res = {"nvidia_smi": [ln.strip() for ln in out.splitlines()
                          if ln.strip()],
           "pids": {"this process": os.getpid()}, "reserved_gib": {}}
    for role, role_addrs in (addrs or cluster_addrs(cluster)).items():
        for i, addr in enumerate(role_addrs):
            res["pids"][f"{role}{i}"] = cluster.workers[addr][0].pid
            v = runtime.http_vars(addr, disagg.DEVICE_MEMORY_COUNTER)
            res["reserved_gib"][f"{role}{i}"] = round(
                v.get(disagg.DEVICE_MEMORY_COUNTER, 0) / 2**30, 3)
    return res


def exact_cluster(params, cfg, script) -> dict:
    """``script`` through worker processes: DisaggCluster(1, 1, f32=True)
    serving the phase's weights from host memory; the prefill and decode
    worker processes pull them over TPS1 and run on this card. Every
    stream must equal its expected one; each worker process must have
    launched its kernels (CLUSTER_KERNELS)."""
    from brpc_tpu_torch import disagg

    # The cluster takes the host copy out of the dict: it is freed once
    # the cluster's servers hold the weights' blobs.
    cluster = disagg.DisaggCluster(
        1, 1, cfg_name="llama3_8b", n_layers=cfg.n_layers, f32=True,
        weights={"": {k: v.cpu() for k, v in
                      disagg._flatten_params(params).items()}},
        decode_slots=4, decode_kv_blocks=64, max_prompt=128,
        worker_timeout_ms=600_000)
    try:
        starts = cold_starts(cluster)
        run_waves(cluster, script, "worker-process")
        launches = check_cluster_launches(cluster)
    finally:
        cluster.close()
    n = sum(len(w) for w in script)
    log(f"[exact] worker processes: the same {n} requests through "
        f"DisaggCluster(1, 1, f32) identical to the plain rollout; cold "
        f"starts {fmt_cold_starts(starts)}; launches {launches}")
    return {"cold_starts": starts, "launches": launches}


# ---- registry mode: the lease registry and the closed loop ------------------

REGISTRY_REPLICAS = 3
REGISTRY_TTL_MS = 1500


def wait_for(pred, what: str, timeout_s: float):
    """Poll ``pred`` every 20 ms until it returns a true value; that value
    and the seconds it took. Fails with ``what`` past ``timeout_s``."""
    t0 = time.monotonic()
    while True:
        got = pred()
        if got:
            return got, time.monotonic() - t0
        if time.monotonic() - t0 > timeout_s:
            raise AssertionError(f"{what}: not within {timeout_s} s")
        time.sleep(0.02)


def leader_counts(cluster) -> dict:
    """The registry leader's counters (off its /vars)."""
    reg = cluster.registry
    li = reg.leader_index()
    if li is None:
        raise AssertionError("the registry has no leader")
    return reg.counts(li)


LEASE_PARTS = ("renew_gap", "wake_late", "load_wait", "rpc", "load")


def lease_vars(addr: str) -> dict:
    """A process's lease counters (renews, re_registers, failovers, and
    the worst of each of LEASE_PARTS in us: ``<part>_max_us``), off its
    /vars."""
    from brpc_tpu_torch import runtime

    pre = "cluster_lease_"
    return {k[len(pre):]: int(v)
            for k, v in runtime.http_vars(addr, pre).items()}


def live_addrs(cluster) -> dict:
    """role -> the worker addresses in the router's pools."""
    return {"prefill": cluster.router.prefills.addrs(),
            "decode": cluster.router.decodes.addrs()}


def registry_members(cluster, role: str) -> list:
    """The registry's members of ``role``, listed by a live replica."""
    from brpc_tpu_torch import cluster as cp
    from brpc_tpu_torch import runtime

    with runtime.Channel(cluster.registry.addrs[cluster.registry.live()[0]],
                         timeout_ms=5000) as ch:
        return cp.parse_members(
            ch.call("Cluster", "list", role.encode()).decode())[1]


def elasticity(cluster, wave, probe, tag: str) -> dict:
    """The closed loop on a registry-fed DisaggCluster(1, 1): ``wave()``,
    across which the registry must expel nobody; SIGKILL the decode
    worker, which the registry must expel within two TTLs; an Autoscaler
    (min 1, max 1 decode worker) spawns the replacement, which the
    router's watch picks up; ``probe()`` (one request, the run_swarm
    result) is its first pick, timed from READY to its first token;
    the registry's leader is SIGKILLed: a new leader, and every worker's
    lease fails over to it; ``wave()`` again, across which nobody is
    expelled. Times on the host clock; any leg that fails raises."""
    from brpc_tpu_torch import disagg

    reg, router = cluster.registry, cluster.router
    ttl_s = REGISTRY_TTL_MS / 1e3
    res = {"ttl_ms": REGISTRY_TTL_MS, "replicas": reg.n}
    if leader_counts(cluster)["lease_expels"]:
        raise AssertionError(f"[{tag}] an expel before the first wave")
    res["wave1"] = wave()
    if leader_counts(cluster)["lease_expels"]:
        raise AssertionError(f"[{tag}] a live worker was expelled during "
                             f"the first wave")
    victim = cluster.decode_addrs[0]
    killed = lease_vars(victim)
    t_kill = time.monotonic()
    cluster.workers[victim][0].kill()
    _, res["kill_to_expel_s"] = wait_for(
        lambda: leader_counts(cluster)["lease_expels"] >= 1,
        f"[{tag}] the killed decode worker's expel", 10 * ttl_s)
    _, drop_s = wait_for(lambda: victim not in router.decodes.addrs(),
                         f"[{tag}] the router dropping it", 10 * ttl_s)
    res["kill_to_router_drop_s"] = res["kill_to_expel_s"] + drop_s
    if res["kill_to_expel_s"] > 2 * ttl_s:
        raise AssertionError(f"[{tag}] expel {res['kill_to_expel_s']:.3f} s "
                             f"after the SIGKILL, past two TTLs")
    asc = cluster.start_autoscaler(min_workers=1, max_workers=1, poll_s=0.2)
    try:
        (_, kind, new), _ = wait_for(
            lambda: asc.actions and asc.actions[0],
            f"[{tag}] the autoscaler's replacement",
            disagg.READY_TIMEOUT_S + 60)
        t_ready = time.monotonic()
        if kind != "replace":
            raise AssertionError(f"[{tag}] autoscaler action {kind}")
        res["kill_to_spawn_s"] = asc.actions[0][0] - t_kill
        res["spawn_to_ready_s"] = cluster.spawn_seconds[new]
        res["replacement_cold_start"] = cold_start(cluster, new)
        _, res["ready_to_router_pool_s"] = wait_for(
            lambda: new in router.decodes.addrs(),
            f"[{tag}] the router's watch picking up {new}", 30)
        _, res["ready_to_heartbeat_s"] = wait_for(
            lambda: any(m.addr == new and m.ready
                        for m in registry_members(cluster, "decode")),
            f"[{tag}] the replacement's first heartbeat", 30)
        t_probe = time.monotonic()
        got = probe()
        res["probe"] = got["tokens"][0]
        res["ready_to_first_token_s"] = (t_probe - t_ready
                                         + got["ttft_s"][0])
        workers = {"prefill": cluster.prefill_addrs[0],
                   "replacement decode": new}
        # Before the leader kill: a gap here is the renew thread's own
        # (GIL or host stalls); after it, the failover's window adds in.
        leases = {who: lease_vars(a) for who, a in workers.items()}
        leases["killed decode"] = killed
        before = {a: leases[who].get("failovers", 0)
                  for who, a in workers.items()}
        watch0 = router.stats()["watch_reconnects"]
        t0 = time.monotonic()
        res["killed_leader"] = dead = reg.kill_leader()

        def new_leader():
            li = reg.leader_index(timeout_s=1.0)
            return None if li in (None, dead) else (li,)

        (res["new_leader"],), res["leader_kill_to_new_leader_s"] = wait_for(
            new_leader, f"[{tag}] a new registry leader", 30)
        wait_for(lambda: all(lease_vars(a).get("failovers", 0) > before[a]
                             for a in before),
                 f"[{tag}] every worker lease's failover", 30)
        res["leader_kill_to_lease_failover_s"] = time.monotonic() - t0
        res["lease_failovers"] = {
            who: lease_vars(a).get("failovers", 0) - before[a]
            for who, a in workers.items()}
        expels = leader_counts(cluster)["lease_expels"]
        res["wave2"] = wave()
        counts = leader_counts(cluster)
        if counts["lease_expels"] != expels:
            raise AssertionError(f"[{tag}] a live worker was expelled "
                                 f"during the second wave: {counts}")
        if counts["members"] != 3:  # two workers and the router's lease
            raise AssertionError(f"[{tag}] {counts['members']} members "
                                 f"after the failover, want 3")
        if asc.scale_ups != 1:
            raise AssertionError(f"[{tag}] {asc.scale_ups} scale-ups")
        res["autoscaler"] = asc.stats()
    finally:
        cluster.stop_autoscaler()
    res["watch_reconnects"] = router.stats()["watch_reconnects"] - watch0
    res["registry_counts"] = {i: reg.counts(i) for i in reg.live()}
    res["leases_before_leader_kill"] = leases
    res["leases"] = {who: lease_vars(a) for who, a in workers.items()}
    def worst_ms(v: dict) -> dict:
        return {p: v.get(f"{p}_max_us", 0) / 1e3 for p in LEASE_PARTS}

    res["lease_worst_ms"] = {
        "before the leader kill": {who: worst_ms(v)
                                   for who, v in leases.items()},
        "through the failover": {who: worst_ms(v)
                                 for who, v in res["leases"].items()}}
    res["lease_worst_ms"]["through the failover"]["router"] = {
        p: 1e3 * sec for p, sec in router._lease.worst.items()}
    res["router"] = {k: router.stats()[k] for k in (
        "re_prefills", "resumed_streams", "registry_stale",
        "prefill_workers", "decode_workers", "warming_skips")}
    log(f"[{tag}] registry-fed control plane ({reg.n} replica processes, "
        f"TTL {REGISTRY_TTL_MS} ms): SIGKILL -> expel "
        f"{res['kill_to_expel_s']:.3f} s (router drop "
        f"{res['kill_to_router_drop_s']:.3f} s); autoscaler spawn "
        f"{res['kill_to_spawn_s']:.3f} s after the kill, spawn -> READY "
        f"{res['spawn_to_ready_s']:.2f} s, READY -> router pool "
        f"{res['ready_to_router_pool_s']:.3f} s, -> first heartbeat "
        f"{res['ready_to_heartbeat_s']:.3f} s, -> the first token of its "
        f"first pick {res['ready_to_first_token_s']:.3f} s; kill_leader -> "
        f"new leader "
        f"{res['leader_kill_to_new_leader_s']:.3f} s, -> every lease failed "
        f"over {res['leader_kill_to_lease_failover_s']:.3f} s "
        f"({res['lease_failovers']}); watch reconnects "
        f"{res['watch_reconnects']}; each lease's worst renew gap, its "
        f"parts (wake-up past the period, the wait for the load sample, "
        f"the renew RPC) and load_fn's own time on its sampler thread, ms: "
        f"{json.dumps(res['lease_worst_ms'])}")
    log(f"[{tag}] registry counts by live replica "
        f"{json.dumps(res['registry_counts'])}; router {res['router']}")
    return res


def exact_registry(params, cfg, script) -> dict:
    """``script`` through registry-fed worker processes,
    DisaggCluster(1, 1, f32=True, use_registry=True, registry_replicas=3),
    before and after the closed-loop script (``elasticity``); every
    stream of both waves must equal its expected one, and the live
    worker processes must have launched their kernels."""
    from brpc_tpu_torch import disagg

    cluster = disagg.DisaggCluster(
        1, 1, cfg_name="llama3_8b", n_layers=cfg.n_layers, f32=True,
        weights={"": {k: v.cpu() for k, v in
                      disagg._flatten_params(params).items()}},
        decode_slots=4, decode_kv_blocks=64, max_prompt=128,
        use_registry=True, registry_replicas=REGISTRY_REPLICAS,
        registry_ttl_ms=REGISTRY_TTL_MS, worker_timeout_ms=600_000)
    prompt, n, want = script[0][0]

    def probe():
        got = run_swarm(cluster, [prompt], n)
        if got["tokens"][0] != want:
            raise AssertionError(f"f32 registry probe: {got['tokens'][0]} "
                                 f"!= plain {want}")
        return got

    try:
        starts = cold_starts(cluster)
        loop = elasticity(
            cluster, lambda: run_waves(cluster, script, "registry-fed"),
            probe, "exact")
        launches = check_cluster_launches(cluster, live_addrs(cluster))
    finally:
        cluster.close()
    n_req = sum(len(w) for w in script)
    log(f"[exact] registry-fed worker processes: the same {n_req} requests "
        f"through DisaggCluster(1, 1, f32, use_registry, registry_replicas="
        f"{REGISTRY_REPLICAS}) identical to the plain rollout before and "
        f"after SIGKILL, replacement and leader kill; cold starts "
        f"{fmt_cold_starts(starts)}; launches of the live workers "
        f"{launches}")
    return {"cold_starts": starts, "elasticity": loop, "launches": launches}


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


# Traced requests on phase 5's engine: two cold prompts and two that extend
# a phase-5 prompt (prefix hits: resumes on K4), TRACE_NEW tokens each.
TRACE_COLD = (64, 300)
TRACE_RESUMES = ((3, 23), (6, 40))  # (phase-5 prompt, fresh tokens)
TRACE_NEW = 8
TRACE_SPAN_MARKS = ("queue_wait_us=", "prefill_us=", "terminal frame")


def note_value(texts, key: str):
    """The integer after ``key=`` in the first annotation that has it."""
    for t in texts:
        m = re.search(re.escape(key) + r"=(\d+)", t)
        if m:
            return int(m.group(1))
    return None


def traced_requests(eng, cfg, prompts, report_dir: str) -> dict:
    """TRACE_COLD and TRACE_RESUMES sent at once through ServingClients
    with tracing on: each request's span tree must hold the serving span
    with its queue wait and prefill, one emit mark per token, the terminal
    frame, and the ``__stream`` span. The Chrome dump goes to the report
    directory; tracing is off again on return."""
    from brpc_tpu_torch import ops, serving, tracing

    rng = np.random.default_rng(7)
    reqs = [rng.integers(0, cfg.vocab, n).tolist() for n in TRACE_COLD]
    reqs += [prompts[i] + rng.integers(0, cfg.vocab, n).tolist()
             for i, n in TRACE_RESUMES]
    out, errors = {}, []

    def one(i, prompt):
        try:
            first = []
            t0 = time.monotonic()
            with serving.ServingClient(f"127.0.0.1:{eng.port}",
                                       timeout_ms=600_000) as c:
                toks = list(c.generate(
                    prompt, TRACE_NEW,
                    on_first_token=lambda: first.append(time.monotonic())))
                out[i] = (toks, c.last_trace_id, 1e3 * (first[0] - t0))
        except Exception as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    resumes0 = eng.stats()["resumes"]
    tracing.enable(100000)
    try:
        ops.reset_launch_counts()
        threads = [threading.Thread(target=one, args=(i, p))
                   for i, p in enumerate(reqs)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        launches = ops.launch_counts()
        if errors:
            raise errors[0]
        rows = []
        for i, prompt in enumerate(reqs):
            toks, tid, ttft_ms = out[i]
            if len(toks) != TRACE_NEW or not tid:
                raise AssertionError(f"traced request {i}: {len(toks)} "
                                     f"tokens, trace id {tid}")
            deadline = time.monotonic() + 10
            while True:
                spans = tracing.fetch(tid)
                sv = [s for s in spans if s["service"] == "serving"]
                texts = [a["text"] for a in sv[0]["annotations"]] if sv \
                    else []
                if (any("terminal frame" in t for t in texts) and any(
                        s["service"] == "__stream" for s in spans)) or \
                        time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            missing = [m for m in TRACE_SPAN_MARKS
                       if not any(m in t for t in texts)]
            emits = sum("emit" in t for t in texts)
            if missing or emits != TRACE_NEW or not any(
                    s["service"] == "__stream" for s in spans):
                raise AssertionError(
                    f"traced request {i}: tree lacks {missing}, {emits} "
                    f"emit marks (want {TRACE_NEW}), services "
                    f"{sorted({s['service'] for s in spans})}")
            rows.append({"prompt": len(prompt), "trace_id": f"{tid:x}",
                         "spans": len(spans), "client_ttft_ms": ttft_ms,
                         "queue_wait_ms": note_value(texts,
                                                     "queue_wait_us") / 1e3,
                         "prefill_ms": note_value(texts, "prefill_us") / 1e3,
                         "server_ttft_ms": note_value(texts, "ttft_us") / 1e3})
        path = os.path.join(report_dir, "trace.json")
        dump = tracing.dump(path)
        spans_total = tracing.count()
    finally:
        tracing.disable()
    resumes = eng.stats()["resumes"] - resumes0
    L = cfg.n_layers
    for name in ("paged_decode_attention", "prefill_attention", "rms_norm",
                 "add_rms_norm", "paged_prefill_attention"):
        if not launches[name]:
            raise AssertionError(f"the traced requests never launched {name}"
                                 f": {launches}")
    if launches["paged_prefill_attention"] != L * resumes or not resumes:
        raise AssertionError(f"K4 launched "
                             f"{launches['paged_prefill_attention']} times "
                             f"over {resumes} resumes")
    for r in rows:
        log(f"[trace] prompt {r['prompt']} tokens, trace {r['trace_id']} "
            f"({r['spans']} spans): client TTFT {r['client_ttft_ms']:.1f} ms"
            f" = queue wait {r['queue_wait_ms']:.1f} + prefill "
            f"{r['prefill_ms']:.1f} ms (server TTFT "
            f"{r['server_ttft_ms']:.1f} ms)")
    log(f"[trace] {len(rows)} requests x {TRACE_NEW} tokens traced, {resumes}"
        f" resumes; {len(dump['traceEvents'])} Chrome events in {path}; "
        f"{spans_total} spans collected in the process; launches {launches}")
    return {"requests": rows, "resumes": resumes, "launches": launches,
            "chrome_events": len(dump["traceEvents"])}


# The replayed workload: bench.py's forge leg's diurnal shape (3 tiers, 6
# tenants) with prompts of a 128-token shared prefix and 8-64 fresh tokens.
REPLAY_SPEC = dict(
    name="chip_replay", seed=20, sessions=64, duration_s=8.0,
    arrival="diurnal", diurnal_amplitude=0.5, diurnal_period_s=8.0,
    turns=(1, 1), think_time_s=(0.05, 0.2), prefix_families=8,
    prefix_tokens=128, turn_tokens=(8, 64), max_new=(4, 16), tenants=6,
    tier_mix=(("interactive", 0.45), ("standard", 0.35), ("batch", 0.2)))


def replayed_workload(eng, cfg) -> dict:
    """REPLAY_SPEC compiled twice (byte-equal), then replayed open-loop
    through ServingClients tagged by tenant and tier: every request must
    complete and none may shed."""
    from brpc_tpu_torch import ops, runtime, serving, workload

    spec = workload.WorkloadSpec(vocab=cfg.vocab, max_prompt_tokens=1024,
                                 **REPLAY_SPEC)
    text = workload.compile_workload(spec)
    if text != workload.compile_workload(spec):
        raise AssertionError("the workload did not compile byte-equal")
    _, budgets, reqs = workload.load_workload(text)
    tls = threading.local()
    clients, mu = [], threading.Lock()

    def issue(r, st):
        cache = getattr(tls, "clients", None)
        if cache is None:
            cache = tls.clients = {}
        c = cache.get((r.tenant, r.tier))
        if c is None:
            c = cache[(r.tenant, r.tier)] = serving.ServingClient(
                f"127.0.0.1:{eng.port}", timeout_ms=120_000,
                tenant=r.tenant, tier=r.tier)
            with mu:
                clients.append(c)
        first = []
        t0 = time.monotonic()
        try:
            got = list(c.generate(list(r.prompt), r.max_new,
                                  on_first_token=lambda: first.append(
                                      time.monotonic())))
            st.note(r, "ok" if len(got) == r.max_new else "errors",
                    tokens=len(got), ttft_s=first[0] - t0 if first else None)
        except runtime.RpcError as e:
            st.note(r, "shed" if e.code == runtime.ELIMIT else "errors",
                    hinted=e.retry_after_ms is not None)

    ops.reset_launch_counts()
    t0 = time.monotonic()
    try:
        stats = workload.replay(reqs, issue, drivers=16)
    finally:
        for c in clients:
            c.close()
    wall = time.monotonic() - t0
    launches = ops.launch_counts()
    for name in ("paged_decode_attention", "prefill_attention",
                 "paged_prefill_attention", "rms_norm", "add_rms_norm"):
        if not launches[name]:
            raise AssertionError(f"the replay never launched {name}: "
                                 f"{launches}")
    snap = stats.snapshot()
    tiers = {}
    for tier, c in sorted(snap["by_tier"].items()):
        tiers[tier] = {k: c[k] for k in ("n", "ok", "shed", "errors", "hung",
                                         "good_tokens")}
        tiers[tier]["ttft_p50_ms"] = 1e3 * workload.pct(c["ttfts"], 0.5)
        tiers[tier]["ttft_p99_ms"] = 1e3 * workload.pct(c["ttfts"], 0.99)
    ok = sum(t["ok"] for t in tiers.values())
    tokens = sum(t["good_tokens"] for t in tiers.values())
    res = {"requests": len(reqs), "sessions": spec.sessions,
           "prompt_tokens": [min(len(r.prompt) for r in reqs),
                             max(len(r.prompt) for r in reqs)],
           "wall_s": wall, "late_ms_max": snap["late_ms_max"],
           "tokens_per_s": tokens / wall, "tiers": tiers,
           "tenants": {k: c["ok"] for k, c in sorted(
               snap["by_tenant"].items())},
           "budgets": budgets, "launches": launches}
    log(f"[replay] {len(reqs)} requests of {spec.sessions} sessions over "
        f"{spec.duration_s} s ({spec.arrival}, prompts "
        f"{res['prompt_tokens'][0]}-{res['prompt_tokens'][1]} tokens): "
        f"{ok} ok in {wall:.2f} s, {tokens} tokens = "
        f"{res['tokens_per_s']:.2f} tok/s, issue late by at most "
        f"{snap['late_ms_max']:.1f} ms; by tier {json.dumps(tiers)}; ok by "
        f"tenant {res['tenants']}; launches {launches}")
    if ok != len(reqs):
        raise AssertionError(f"replay: {ok} of {len(reqs)} completed: "
                             f"{json.dumps(tiers)}")
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
        traced = traced_requests(eng, cfg, prompts, report_dir)
        replayed = replayed_workload(eng, cfg)
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
        "profile": prof, "traced": traced, "replay": replayed,
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
        "wave1_streams": [wave1["tokens"][i] for i in range(len(prompts))],
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


def wave_metrics(wave: dict, vocab: int) -> dict:
    """tokens/s and TTFT p50/p99 of one ``run_swarm`` wave; fails on a
    token out of the vocabulary."""
    streams = [wave["tokens"][i] for i in range(len(wave["tokens"]))]
    for toks in streams:
        if not all(0 <= t < vocab for t in toks):
            raise AssertionError("token id out of vocabulary")
    ttft = sorted(wave["ttft_s"].values())
    n_tok = sum(len(t) for t in streams)
    return {"streams": streams, "tokens": n_tok, "wall_s": wave["wall_s"],
            "tokens_per_s": n_tok / wave["wall_s"],
            "ttft_p50_ms": 1e3 * ttft[len(ttft) // 2],
            "ttft_p99_ms": 1e3 * ttft[min(len(ttft) - 1,
                                          int(0.99 * len(ttft)))]}


def kv_failed(addrs) -> dict:
    """``kv_transfers_failed`` of each worker process, off its /vars."""
    from brpc_tpu_torch import runtime

    return {a: int(runtime.http_vars(a, "kv_transfers_failed")
                   ["kv_transfers_failed"]) for a in addrs}


def phase_disagg_procs(weights: dict, cfg, card: str, main_res: dict,
                       inproc: dict) -> dict:
    """The disagg phase's first wave (the same prompts) through
    registry-fed worker processes at full width and depth:
    DisaggCluster(1, 1, use_registry=True, registry_replicas=3) serving
    ``weights`` ({"": flat dict in host memory}, which the cluster takes
    out of the dict), a prefill and a decode worker process on this card
    beside this one and three registry replica processes off it. The
    wave, the closed-loop script (``elasticity``: SIGKILL, expel,
    replacement, leader kill), the wave again."""
    from brpc_tpu_torch import disagg, kv_cache

    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, cfg.vocab, n).tolist() for n in MAIN_LENGTHS]
    max_new = MAIN_NEW_TOKENS
    blocks = len(prompts) * kv_cache.pages_for(max(MAIN_LENGTHS) + max_new,
                                               16) + 1
    t0 = time.monotonic()
    cluster = disagg.DisaggCluster(
        1, 1, cfg_name="llama3_8b", weights=weights, decode_slots=8,
        decode_kv_blocks=blocks, max_prompt=1024,
        kv_pool=kv_pool_budget(cfg), use_registry=True,
        registry_replicas=REGISTRY_REPLICAS,
        registry_ttl_ms=REGISTRY_TTL_MS, worker_timeout_ms=600_000)

    def probe():
        got = run_swarm(cluster, [prompts[0]], 4)
        toks = got["tokens"][0]
        if len(toks) != 4 or not all(0 <= t < cfg.vocab for t in toks):
            raise AssertionError(f"probe stream {toks}")
        return got

    try:
        up_s = time.monotonic() - t0
        starts = cold_starts(cluster)
        mem_idle = worker_memory(cluster)
        loop = elasticity(cluster,
                          lambda: run_swarm(cluster, prompts, max_new),
                          probe, "disagg-procs")
        live = live_addrs(cluster)
        launches = check_cluster_launches(cluster, live)
        mem = worker_memory(cluster, live)
        kv = kv_failed(live["prefill"] + live["decode"])
        groups = len(cluster.param_servers[""])
    finally:
        cluster.close()
    if any(kv.values()):
        raise AssertionError(f"failed KV transfers {kv}")
    waves = [wave_metrics(loop.pop(w), cfg.vocab) for w in ("wave1",
                                                            "wave2")]
    streams = waves[0]["streams"]
    res = {
        "card": card, "requests": len(prompts),
        "prompt_lengths": MAIN_LENGTHS, "new_tokens": max_new,
        "cluster_up_s": up_s, "param_server_groups": groups,
        "cold_starts": starts, "device_memory": mem,
        "device_memory_idle": mem_idle,
        "tokens_per_s": waves[0]["tokens_per_s"],
        "ttft_p50_ms": waves[0]["ttft_p50_ms"],
        "ttft_p99_ms": waves[0]["ttft_p99_ms"],
        "waves": [{k: w[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                     "ttft_p99_ms", "wall_s")}
                  for w in waves],
        "launches": launches, "kv_transfers_failed": kv,
        "elasticity": loop,
        "streams_equal_in_process": sum(
            a == b for a, b in zip(streams, inproc["wave1_streams"])),
        "wave2_streams_equal_wave1": sum(
            a == b for a, b in zip(waves[1]["streams"], streams)),
    }
    log(f"[disagg-procs] Llama-3-8B bf16 {cfg.n_layers} layers, {card}: "
        f"registry-fed cluster ({REGISTRY_REPLICAS} replica processes) up "
        f"in {up_s:.1f} s ({groups} ParamServer groups); cold starts "
        f"{fmt_cold_starts(starts)}; the replacement: "
        f"{fmt_cold_starts({'decode': loop['replacement_cold_start']})}")
    log(f"[disagg-procs] device memory by process (nvidia-smi), idle "
        f"{json.dumps(mem_idle)}, after both waves {json.dumps(mem)}")
    for i, w in enumerate(waves):
        log(f"[disagg-procs] wave {i + 1} ({'before' if i == 0 else 'after'}"
            f" the closed-loop script): {len(prompts)} concurrent requests "
            f"through router -> prefill worker process -> decode worker "
            f"process, {w['tokens']} tokens in {w['wall_s']:.3f} s = "
            f"{w['tokens_per_s']:.2f} tok/s; TTFT p50 {w['ttft_p50_ms']:.1f} "
            f"ms p99 {w['ttft_p99_ms']:.1f} ms")
    log(f"[disagg-procs] against the in-process disagg run "
        f"{inproc['tokens_per_s']:.2f} tok/s, p50 "
        f"{inproc['ttft_p50_ms']:.1f}, p99 {inproc['ttft_p99_ms']:.1f}, and "
        f"phase 5 (colocated) {main_res['tokens_per_s']:.2f} tok/s, p50 "
        f"{main_res['ttft_p50_ms']:.1f}, p99 {main_res['ttft_p99_ms']:.1f}; "
        f"{res['streams_equal_in_process']} of {len(prompts)} wave-1 streams "
        f"equal to the in-process run's, {res['wave2_streams_equal_wave1']} "
        f"of wave 2's to wave 1's (bf16: batch shapes and prefix hits may "
        f"differ); kv_transfers_failed {kv}")
    log(f"[disagg-procs] launches of the live prefill worker "
        f"{launches['prefill']} and replacement decode worker "
        f"{launches['decode']}")
    return res


# ---- the landing phase: rank shards gathered over RPC onto the card ---------

LANDING_RANKS = 4
LANDING_SLICE = 7             # the phase's device-fabric coordinates
LANDING_STREAM_ITERS = 8
LANDING_PROMPTS = (16, 100, 300, 1000)
LANDING_NEW = 16
# Host-to-device rate of the card's link: PCIe Gen5 x16, one direction.
PCIE_BYTES_PER_S = 64e9
# A rank process's send arena (MB) and retain budget (MB). Handed-off
# blocks may pin only half of the arena (cpp/trpc/device_transport.h:86),
# and the default 256 MB (TRPC_DEVICE_ARENA_MB, :94) would let a rank
# keep one 104 MiB frame in flight; a depth-2 stream needs two.
LANDING_ARENA_MB = 1024
LANDING_RETAIN_MB = 512
# trpc_max_body_size of the phase's processes. A ring hop carries the
# concat so far, cut into chunk frames, and a chunked message is capped
# as a whole (cpp/trpc/policy/trpc_protocol.cc:1732, :1875): the hop into
# rank 3 carries 312 MiB and the root's pickup 416 MiB, over the default
# 256 MiB. (The star root receives one 104 MiB frame a rank.)
LANDING_BODY_CAP = 1 << 30
# The phase's processes arm the wire-integrity rail (crc32c over each
# collective frame, checked end to end; a mismatch is dropped and
# resent). Without it the first ring gather over fresh fabric links can
# deliver a rank's payload tail corrupted (shared native code, both
# packages; ROADMAP §C 13); the phase logs the mismatches the rail caught.

# A rank process: an empty ShardServer on the device fabric (and on TCP
# for its /vars); the parent puts its shard in, and closes stdin to stop
# it.
_RANK_SRC = r"""
import sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch import mesh_bridge, runtime
runtime.set_max_body_size(int(sys.argv[4]))
mesh_bridge.enable_wire_integrity()
srv = mesh_bridge.ShardServer({})
port = srv.start(0)
srv.start_device(int(sys.argv[2]), int(sys.argv[3]))
print("READY", port, flush=True)
sys.stdin.read()
srv.close()
"""


def start_rank_servers(k: int, slice_: int) -> tuple:
    """k rank processes on ``ici://slice_/r``: (processes, their TCP
    addresses)."""
    env = dict(os.environ, TRPC_DEVICE_ARENA_MB=str(LANDING_ARENA_MB),
               TRPC_FABRIC_RETAIN_MB=str(LANDING_RETAIN_MB))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RANK_SRC, HERE, str(slice_), str(r),
         str(LANDING_BODY_CAP)],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env, text=True)
        for r in range(k)]
    addrs = []
    try:
        for r, p in enumerate(procs):
            ready, _, _ = select.select([p.stdout], [], [], 120)
            line = p.stdout.readline() if ready else ""
            if not line.startswith("READY "):
                raise AssertionError(f"rank process {r} did not start "
                                     f"(exit {p.poll()}, said {line!r})")
            addrs.append(f"127.0.0.1:{int(line.split()[1])}")
    except BaseException:
        stop_rank_servers(procs)
        raise
    return procs, addrs


def stop_rank_servers(procs: list) -> None:
    for p in procs:
        try:
            p.stdin.close()
        except OSError:
            pass
    for p in procs:
        try:
            p.wait(timeout=30)
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()


def land_from_buffer(buf, register: bool) -> dict:
    """Host seconds of landing one gathered buffer on the card: its rows
    copied from the runtime's pageable buffer, or (``register``) with the
    buffer page-locked by ``cudaHostRegister`` first and unregistered
    after the copies."""
    from brpc_tpu_torch import mesh_bridge

    cudart = torch.cuda.cudart()
    flat = np.frombuffer(buf.view, np.uint8)
    ptr, n = flat.ctypes.data, flat.nbytes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if register:
        rc = cudart.cudaHostRegister(ptr, n, 0)
        if int(rc) != 0:
            raise AssertionError(f"cudaHostRegister failed: {rc}")
    t1 = time.perf_counter()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    # The bridge's own landing of a gathered buffer (gather_to_mesh's core;
    # its copy stream waits for the current stream, which waits for it).
    landing = mesh_bridge._assemble_on_devices(buf, "w", [torch.device(
        "cuda", torch.cuda.current_device())])
    end.record()
    landing.synchronize()
    t2 = time.perf_counter()
    if register:
        rc = cudart.cudaHostUnregister(ptr)
        if int(rc) != 0:
            raise AssertionError(f"cudaHostUnregister failed: {rc}")
    t3 = time.perf_counter()
    del flat
    torch.cuda.synchronize()
    return {"register_ms": 1e3 * (t1 - t0), "copy_ms": 1e3 * (t2 - t1),
            "copy_events_ms": start.elapsed_time(end),
            "unregister_ms": 1e3 * (t3 - t2), "total_ms": 1e3 * (t3 - t0)}


def phase_landing(card: str) -> dict:
    """Device landing at full width: four rank processes on the device
    fabric each hold a tensor-parallel quarter of one Llama-3-8B layer's
    matrices, packed into one bf16 array ``w`` (109 MB a rank); the
    port's mesh bridge gathers them over a star and a ring pchan and lands
    them on the card, and a 1-layer Llama-3-8B built from the landed
    bytes streams greedy tokens through the ServingEngine (K2, K3, K3
    fused, K1) bit-equal to the same model loaded with ``.to("cuda")``.
    Then the pipelined lane (star, and ring through the prefix lane), the
    two H2D sources, the pinned and pageable yardsticks, and a scatter
    round trip."""
    from brpc_tpu_torch import mesh_bridge, runtime
    from brpc_tpu_torch.models import transformer

    k = LANDING_RANKS
    cfg = dataclasses.replace(transformer.TransformerConfig.llama3_8b(),
                              n_layers=1)
    params = transformer.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(3), device="cuda")
    host = {n: params["layers"][n].cpu() for n in mesh_bridge.TP_AXIS}
    shapes = {n: tuple(t.shape) for n, t in host.items()}
    packed = mesh_bridge.pack_tp_shards(host, k)
    per_rank = packed[0].numel()
    nbytes = k * per_rank * 2
    if per_rank != 54_525_952:
        raise AssertionError(f"{per_rank} elements a rank, want 54525952")
    bound = nbytes / PCIE_BYTES_PER_S * 1e3
    t_phase = time.monotonic()
    os.environ["TRPC_FABRIC_NS"] = f"chip-landing-{os.getpid()}"
    runtime.set_max_body_size(LANDING_BODY_CAP)
    mesh_bridge.enable_wire_integrity()
    crc0 = crc_errors()
    t0 = time.monotonic()
    procs, addrs = start_rank_servers(k, LANDING_SLICE)
    res = {"card": card, "ranks": k, "bytes_per_rank": per_rank * 2,
           "bytes": nbytes, "bound_ms": bound,
           "ranks_up_s": time.monotonic() - t0}
    chans = [runtime.Channel(f"ici://{LANDING_SLICE}/{r}", timeout_ms=120_000)
             for r in range(k)]
    pchans = {}
    try:
        for r in range(k):
            if chans[r].call(mesh_bridge.SERVICE, "put",
                             mesh_bridge.encode_arrays({"w": packed[r]})
                             ) != b"ok":
                raise AssertionError(f"rank {r} refused its shard")
        pchans = {s: runtime.ParallelChannel(chans, timeout_ms=120_000,
                                             schedule=s)
                  for s in ("star", "ring")}
        src = torch.stack(packed).to("cuda")
        landed = {}
        for s, pc in pchans.items():
            mesh_bridge.reset_stats()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mesh_bridge.gather_to_mesh(pc, "w")
            torch.cuda.synchronize()
            ms = 1e3 * (time.perf_counter() - t0)
            st = mesh_bridge.stats()
            if len(out) != 1 or not torch.equal(out[0], src):
                raise AssertionError(f"{s} landing differs from the source")
            if st["staging_copy_bytes"] or st["zero_copy_bytes"] != nbytes:
                raise AssertionError(f"{s} landing counters {st}")
            landed[s] = out
            res[f"gather_{s}_ms"] = ms
            log(f"[landing] {s} gather_to_mesh of {k} x {per_rank * 2} "
                f"bytes onto the card: {ms:.2f} ms host clock "
                f"({nbytes / ms / 1e6:.3f} GB/s), torch.equal to the "
                f"source, {st}")
        res["serving"] = landing_serving(params, cfg, host, shapes,
                                         landed["star"][0])
        res["stream"] = {}
        for s, pc in pchans.items():
            res["stream"][s] = landing_stream(pc, src, nbytes, s, addrs)
        res["sources"] = landing_sources(pchans["star"], nbytes)
        res["yardsticks"] = landing_yardsticks(packed, nbytes)
        res["device_ms"] = landing_device_ms(pchans["star"])
        # Scatter round trip: put the landed rows back negated (exact in
        # bf16), then read the servers' arrays over RPC.
        flipped = [-landed["star"][0]]
        t0 = time.perf_counter()
        mesh_bridge.scatter_from_mesh(flipped, chans, "w")
        res["scatter_ms"] = 1e3 * (time.perf_counter() - t0)
        back = mesh_bridge.rpc_all_gather(pchans["star"], "w")
        for r in range(k):
            if not torch.equal(back[r], flipped[0][r].cpu()):
                raise AssertionError(f"rank {r} holds other bytes after the "
                                     f"scatter")
        res["crc_errors"] = {"root": crc_errors() - crc0}
        for r, addr in enumerate(addrs):
            res["crc_errors"][f"rank{r}"] = crc_errors(addr)
    finally:
        for pc in pchans.values():
            pc.close()
        for ch in chans:
            ch.close()
        stop_rank_servers(procs)
    res["phase_s"] = time.monotonic() - t_phase
    y, sources = res["yardsticks"], res["sources"]
    log(f"[landing] {card}: one landing of {nbytes} bytes, star "
        f"{res['gather_star_ms']:.2f} ms, ring {res['gather_ring_ms']:.2f} "
        f"ms (host clock, RPC included), device {res['device_ms']} ms; "
        f"bound {bound:.2f} ms at {PCIE_BYTES_PER_S / 1e9:.0f} GB/s; pinned "
        f"copy_ {y['pinned_ms']:.2f} ms, pageable .to {y['pageable_ms']:.2f} "
        f"ms; sources {json.dumps(sources)}; scatter round trip "
        f"{res['scatter_ms']:.1f} ms; frames the crc32c rail dropped and "
        f"had resent: {res['crc_errors']}; phase {res['phase_s']:.1f} s")
    return res


def crc_errors(addr: str = "") -> int:
    """Frames the wire-integrity rail rejected (``coll_link_crc_errors``),
    in this process or, with ``addr``, in the server there."""
    from brpc_tpu_torch import runtime

    name = "coll_link_crc_errors"
    v = runtime.http_vars(addr, name) if addr else runtime.metrics()
    return int(v.get(name, 0))


def landing_serving(params, cfg, host, shapes, rows) -> dict:
    """The landed rows unpacked on the card into a 1-layer Llama-3-8B
    (embedding, head and norms loaded directly), against the same model
    whose layer matrices were moved with ``.to("cuda")``: equal weights,
    bit-equal token streams through the ServingEngine (each prompt alone,
    so both engines run the same batch shapes) and bit-equal last
    logits."""
    from brpc_tpu_torch import mesh_bridge, ops, serving
    from brpc_tpu_torch.models import transformer

    def model(layers):
        return {**params, "layers": {**params["layers"], **layers}}

    landed = model(mesh_bridge.unpack_tp_shards(rows, shapes))
    direct = model({n: t.to("cuda") for n, t in host.items()})
    for n in mesh_bridge.TP_AXIS:
        if not torch.equal(landed["layers"][n], direct["layers"][n]):
            raise AssertionError(f"landed {n} differs from .to('cuda')")
    rng = np.random.default_rng(11)
    prompts = [rng.integers(0, cfg.vocab, n).tolist()
               for n in LANDING_PROMPTS]
    streams, logits, launches = {}, {}, {}
    blocks = len(prompts) * ((max(LANDING_PROMPTS) + LANDING_NEW) // 16
                             + 1) + 1
    for name, p in (("landed", landed), ("direct", direct)):
        eng = serving.ServingEngine(
            p, cfg, max_batch_size=4, slots=4, max_prompt=1024,
            kv_blocks=blocks, prefix_cache=False, kv_host_tier=False)
        try:
            ops.reset_launch_counts()
            streams[name] = [run_swarm(eng, [q], LANDING_NEW)["tokens"][0]
                             for q in prompts]
            launches[name] = ops.launch_counts()
        finally:
            eng.close()
        seq = torch.tensor([prompts[-1] + streams[name][-1][:-1]],
                           device="cuda")
        logits[name] = transformer.forward(p, seq, cfg)[0, -1]
    if streams["landed"] != streams["direct"]:
        raise AssertionError(f"landed model's streams {streams['landed']} "
                             f"!= direct {streams['direct']}")
    if not torch.equal(logits["landed"], logits["direct"]):
        raise AssertionError("landed model's last logits differ")
    if not torch.isfinite(logits["landed"]).all():
        raise AssertionError("last logits not finite")
    used = launches["landed"]
    for kname in ("prefill_attention", "rms_norm", "add_rms_norm",
                  "paged_decode_attention"):
        if not used.get(kname):
            raise AssertionError(f"{kname} never launched on the landed "
                                 f"model: {used}")
    log(f"[landing] 1-layer Llama-3-8B from the landed bytes: "
        f"{len(prompts)} prompts ({'/'.join(map(str, LANDING_PROMPTS))} "
        f"tokens, {LANDING_NEW} new each) stream bit-equal to the "
        f".to('cuda') model's, last logits torch.equal; launches "
        f"{ {k: v for k, v in used.items() if v} }")
    return {"streams_equal": True, "logits_equal": True,
            "launches": {k: v for k, v in used.items() if v}}


class _Timed:
    """Accumulates the host seconds spent in some methods while active:
    the stream's split between waiting for the RPC (``GatherHandle``'s
    waits) and the host-to-device copies (``_Landing.put``, the host wait
    on a landing's event)."""

    def __init__(self, targets):
        self.targets = targets  # [(owner, method name, bucket)]
        self.s = {bucket: 0.0 for _o, _m, bucket in targets}
        self._orig = []

    def __enter__(self):
        for owner, name, bucket in self.targets:
            fn = getattr(owner, name)
            self._orig.append((owner, name, fn))

            def timed(*a, _fn=fn, _b=bucket, **kw):
                t0 = time.perf_counter()
                try:
                    return _fn(*a, **kw)
                finally:
                    self.s[_b] += time.perf_counter() - t0
            setattr(owner, name, timed)
        return self

    def __exit__(self, *exc):
        for owner, name, fn in self._orig:
            setattr(owner, name, fn)


def fabric_links(addr: str = "") -> list:
    """The per-link table of this process (``runtime.coll_link_stats``)
    or, with ``addr``, of the server there (its /fabric page)."""
    import urllib.request

    from brpc_tpu_torch import runtime

    if not addr:
        return runtime.coll_link_stats()
    with urllib.request.urlopen(f"http://{addr}/fabric", timeout=10) as r:
        return json.loads(r.read().decode()).get("links", [])


LINK_KEYS = ("rx_bytes", "tx_bytes", "rx_frames", "tx_frames",
             "staged_copies", "retain_grants", "retain_fallbacks",
             "credit_stalls", "crc_errors")


def link_growth(after: list, before: list) -> dict:
    """Device-fabric peer -> how much each of LINK_KEYS grew between two
    link tables (links that did not move, and the TCP links the /fabric
    reads themselves ride, left out)."""
    prev = {link["peer"]: link for link in before}
    out = {}
    for link in after:
        if not link["peer"].startswith("ici://"):
            continue
        old = prev.get(link["peer"], {})
        d = {k: link.get(k, 0) - old.get(k, 0) for k in LINK_KEYS}
        if any(d.values()):
            out[link["peer"]] = d
    return out


def observatory_summary(doc: dict) -> dict:
    """The root's collective records of one stream: how many, their
    schedules, mean wall ms, how often each hop was the critical one,
    straggler verdicts; a ring's mean per-hop transit, span, self, in and
    out ms (keyed by rank); a star's mean ms until each rank's response
    was in."""
    recs = doc.get("records", [])
    mean = lambda xs: sum(xs) / len(xs) / 1e3  # noqa: E731 (us -> ms)
    out = {"records": len(recs), "scheds": sorted({r["sched"] for r in recs}),
           "wall_ms": mean([r["wall_us"] for r in recs]) if recs else None,
           "critical_hop": {}, "stragglers": sum(r["straggler"]
                                                 for r in recs)}
    hops, done = {}, {}
    for r in recs:
        out["critical_hop"][r["critical_hop"]] = \
            out["critical_hop"].get(r["critical_hop"], 0) + 1
        for h in r.get("hops", []):
            hops.setdefault(h["rank"], []).append(h)
        for rank, us in r.get("rank_done_us", []):
            done.setdefault(rank, []).append(us)
    if hops:
        out["hops_ms"] = {
            rank: {k: round(mean([h[f"{k}_us"] for h in hs]), 3)
                   for k in ("transit", "span", "self", "in_dur", "out_dur")}
            for rank, hs in sorted(hops.items())}
    if done:
        out["rank_done_ms"] = {rank: round(mean(v), 3)
                               for rank, v in sorted(done.items())}
    return out


def landing_stream(pc, src, nbytes: int, schedule: str, addrs) -> dict:
    """``gather_to_mesh_stream`` over ``LANDING_STREAM_ITERS`` gathers at
    depth 2, every landing checked against the source, with the host's
    time split between waiting for ranks to arrive and the H2D copies;
    beside it the collective observatory's records of the stream (per-hop
    transit and span, the critical hop) and how each link's counters
    (staged copies, retain grants against fallback copies, credit stalls)
    grew at the root and at the rank processes ``addrs``."""
    from brpc_tpu_torch import mesh_bridge, runtime

    h = pc.gather_begin(mesh_bridge.SERVICE, "get")
    mode = h.mode
    h.end()
    want = "prefix" if schedule == "ring" else "rank"
    if mode != want:
        raise AssertionError(f"{schedule} handle mode {mode}, want {want}")
    mesh_bridge.reset_stats()
    runtime.coll_observe_reset()
    links0 = {a: fabric_links(a) for a in ("", *addrs)}
    n = LANDING_STREAM_ITERS
    got, check_s = 0, 0.0
    with _Timed([(runtime.GatherHandle, "wait_rank", "receive"),
                 (runtime.GatherHandle, "wait_prefix", "receive"),
                 (mesh_bridge._Landing, "put", "h2d"),
                 (mesh_bridge._Landing, "synchronize", "h2d")]) as timed:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for out in mesh_bridge.gather_to_mesh_stream(pc, "w", iters=n,
                                                     depth=2):
            t1 = time.perf_counter()
            if not torch.equal(out[0], src):
                raise AssertionError(f"{schedule} stream landing {got} "
                                     f"differs")
            got += 1
            check_s += time.perf_counter() - t1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - check_s
    st = mesh_bridge.stats()
    if got != n or st["staging_copy_bytes"] != 0 \
            or st["zero_copy_bytes"] != n * nbytes:
        raise AssertionError(f"{schedule} stream: {got} landings, {st}")
    obs = observatory_summary(runtime.coll_records())
    if obs["records"] != n:
        raise AssertionError(f"{schedule} stream: {obs['records']} "
                             f"observatory records for {n} gathers")
    links = {a or "root": link_growth(fabric_links(a), links0[a])
             for a in links0}
    res = {"mode": mode, "iters": n, "ms_per_landing": 1e3 * wall / n,
           "gbps": n * nbytes / wall / 1e9,
           "receive_wait_ms": 1e3 * timed.s["receive"] / n,
           "h2d_ms": 1e3 * timed.s["h2d"] / n, "stats": st,
           "observatory": obs, "links": links}
    log(f"[landing] stream {schedule} ({mode} lane), {n} gathers at depth "
        f"2: {res['ms_per_landing']:.2f} ms a landing = "
        f"{res['gbps']:.3f} GB/s (the checks excluded); of a landing's "
        f"host time {res['receive_wait_ms']:.2f} ms waiting for ranks to "
        f"arrive, {res['h2d_ms']:.2f} ms in the H2D copies; "
        f"staging_copy_bytes {st['staging_copy_bytes']}, zero_copy_bytes "
        f"{st['zero_copy_bytes']}")
    log(f"[landing] stream {schedule}, the observatory's records at the "
        f"root: {json.dumps(obs)}")
    log(f"[landing] stream {schedule}, link counters grown over the "
        f"{n} gathers (root, then each rank process): {json.dumps(links)}")
    return res


def landing_device_ms(pc):
    """Device time of one star landing (its copies), by torch.profiler;
    None when the profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    from brpc_tpu_torch import mesh_bridge

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        mesh_bridge.gather_to_mesh(pc, "w")
        torch.cuda.synchronize()
    us = sum(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0))
             for e in prof.key_averages()
             if getattr(e, "device_type", None)
             == torch.autograd.DeviceType.CUDA)
    return us / 1e3 if us else None


def landing_sources(pc, nbytes: int) -> dict:
    """The two H2D sources, each on a fresh gathered buffer: the
    runtime's pageable buffer as it is, and the same registered."""
    from brpc_tpu_torch import mesh_bridge

    out = {"pageable": [], "registered": []}
    for register in (False, True):
        buf = pc.call_view(mesh_bridge.SERVICE, "get")
        try:
            out["registered" if register else "pageable"].append(
                land_from_buffer(buf, register))
        finally:
            buf.release()
    for name, runs in out.items():
        log(f"[landing] H2D from the gathered buffer, {name}: " + "; ".join(
            f"total {r['total_ms']:.2f} ms (register {r['register_ms']:.2f}"
            f", copies {r['copy_ms']:.2f}, CUDA events around the copies "
            f"{r['copy_events_ms']:.2f}, unregister "
            f"{r['unregister_ms']:.2f}) = {nbytes / r['total_ms'] / 1e6:.2f}"
            f" GB/s" for r in runs))
    return out


def landing_yardsticks(packed, nbytes: int) -> dict:
    """The same bytes moved by plain torch: a pinned ``copy_`` (the
    link's ceiling) and a pageable ``.to`` (the plain way)."""
    flat = torch.cat(packed)
    pinned = torch.empty_like(flat).pin_memory()
    pinned.copy_(flat)
    dst = torch.empty_like(flat, device="cuda")
    res = {"pinned_ms": time_ms(lambda: dst.copy_(pinned, non_blocking=True),
                                iters=5, warmup=1),
           "pageable_ms": time_ms(lambda: flat.to("cuda"), iters=5,
                                  warmup=1)}
    log(f"[landing] yardsticks for {nbytes} bytes: pinned copy_ "
        f"{res['pinned_ms']:.3f} ms ({nbytes / res['pinned_ms'] / 1e6:.2f} "
        f"GB/s), pageable .to {res['pageable_ms']:.3f} ms "
        f"({nbytes / res['pageable_ms'] / 1e6:.2f} GB/s)")
    return res


# ---- resharding ---------------------------------------------------------------

RESHARD_RANKS = 4
RESHARD_SLICE = 8             # the phase's device-fabric coordinates
RESHARD_SHAPE = (4096, 14336)  # one Llama-3-8B w_gate, bf16

_RESHARD_RANK_SRC = r"""
import struct, sys
sys.path.insert(0, sys.argv[1])
from brpc_tpu_torch import runtime
runtime.rd_put("w_gate", sys.stdin.buffer.read(int(sys.argv[4])))
srv = runtime.Server()
srv.enable_redistribute()

def put(req):
    (n,) = struct.unpack_from("<H", req)
    runtime.rd_put(req[2:2 + n].decode(), req[2 + n:])
    return b"ok"

def stats(_req):
    st = runtime.rd_stats()
    return struct.pack("<3q", st["entries"], st["pulls"], st["pull_bytes"])

def crc(req):
    runtime.coll_crc_enable(req == b"1")
    return b"ok"

srv.add_method("R", "put", put)
srv.add_method("R", "get", lambda req: runtime.rd_get(req.decode()))
srv.add_method("R", "stats", stats)
srv.add_method("R", "crc", crc)
port = srv.start(0)
srv.start_device(int(sys.argv[2]), int(sys.argv[3]))
print("READY", port, flush=True)
sys.stdin.read()
"""


def reshard_pass(chans, peers, src, dst, name: str, rank_addrs) -> dict:
    """One redistribute of ``name`` from ``src`` to ``dst`` with ``peers``
    as the addresses ranks pull from: host seconds, what moved, and each
    rank's pulls and fabric links."""
    from brpc_tpu_torch import redistribute

    before = [fabric_links(a) for a in rank_addrs]
    stats0 = [struct.unpack("<3q", ch.call("R", "stats")) for ch in chans]
    t0 = time.perf_counter()
    moved = redistribute.redistribute(chans, peers, src, dst, name)
    s = time.perf_counter() - t0
    pulls, links = [], {}
    for r, (ch, a) in enumerate(zip(chans, rank_addrs)):
        entries, n, nb = struct.unpack("<3q", ch.call("R", "stats"))
        if entries != 1:
            raise AssertionError(f"rank {r} holds {entries} entries")
        pulls.append({"pulls": n - stats0[r][1],
                      "pull_bytes": nb - stats0[r][2]})
        for peer, d in link_growth(fabric_links(a), before[r]).items():
            links[f"rank{r}<-{peer}"] = d
    return {"s": s, "gb_per_s": moved["total_bytes"] / s / 1e9,
            "moved": moved, "pulls": pulls, "links": links}


def phase_reshard(card: str) -> dict:
    """Resharding at full width: four port rank processes, each with the
    ``__rd`` service, hold a row shard of one Llama-3-8B ``w_gate`` (bf16,
    made on the card); the port's planner turns it into column shards,
    over TCP first, then over the device fabric with the crc32c rail
    armed. Each pass lands every rank's new shard on the card, where it
    must be torch.equal to the source's column slice."""
    from brpc_tpu_torch import redistribute, runtime

    k = RESHARD_RANKS
    t_phase = time.monotonic()
    w = torch.randn(RESHARD_SHAPE, generator=torch.Generator(device="cuda")
                    .manual_seed(61), device="cuda").to(torch.bfloat16)
    flat = w.cpu().view(torch.int16).numpy().tobytes()
    mesh = redistribute.Mesh((k,), ("x",))
    rows = mesh.sharding(RESHARD_SHAPE, 2, ("x", None))
    cols = mesh.sharding(RESHARD_SHAPE, 2, (None, "x"))
    shards = [b"".join(flat[o:o + n] for o, n in rows.ranges[r])
              for r in range(k)]
    plan = redistribute.plan_redistribute(rows, cols)
    steps = [len(p) for p in plan]
    env = dict(os.environ, TRPC_FABRIC_NS=f"chip-reshard-{os.getpid()}",
               TRPC_DEVICE_ARENA_MB=str(LANDING_ARENA_MB),
               TRPC_FABRIC_RETAIN_MB=str(LANDING_RETAIN_MB))
    t0 = time.monotonic()
    procs = [subprocess.Popen(
        [sys.executable, "-c", _RESHARD_RANK_SRC, HERE, str(RESHARD_SLICE),
         str(r), str(len(shards[r]))],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env)
        for r in range(k)]
    res = {"card": card, "ranks": k, "shape": list(RESHARD_SHAPE),
           "bytes": len(flat), "plan_steps": steps}
    chans = []
    try:
        addrs = []
        for r, p in enumerate(procs):
            p.stdin.write(shards[r])
            p.stdin.flush()
            ready, _, _ = select.select([p.stdout], [], [], 120)
            line = p.stdout.readline().decode() if ready else ""
            if not line.startswith("READY "):
                raise AssertionError(f"reshard rank {r} did not start "
                                     f"(exit {p.poll()}, said {line!r})")
            addrs.append(f"127.0.0.1:{int(line.split()[1])}")
        res["ranks_up_s"] = time.monotonic() - t0
        chans = [runtime.Channel(a, timeout_ms=300_000) for a in addrs]
        width = RESHARD_SHAPE[1] // k
        fabric = [f"ici://{RESHARD_SLICE}/{r}" for r in range(k)]
        for how, peers in (("tcp", addrs), ("fabric", fabric)):
            if how == "fabric":
                for r, ch in enumerate(chans):
                    nb = b"w_gate"
                    if ch.call("R", "put", struct.pack("<H", len(nb)) + nb
                               + shards[r]) != b"ok" or \
                            ch.call("R", "crc", b"1") != b"ok":
                        raise AssertionError(f"rank {r}: reset failed")
            crc0 = [crc_errors(a) for a in addrs]
            res[how] = rp = reshard_pass(chans, peers, rows, cols, "w_gate",
                                        addrs)
            t1 = time.perf_counter()
            for r, ch in enumerate(chans):
                got = torch.frombuffer(bytearray(ch.call("R", "get",
                                                         b"w_gate")),
                                       dtype=torch.int16)
                got = got.view(torch.bfloat16).reshape(
                    RESHARD_SHAPE[0], width).to("cuda")
                if not torch.equal(got, w[:, r * width:(r + 1) * width]):
                    raise AssertionError(f"{how}: rank {r}'s column shard "
                                         f"differs from the source")
            torch.cuda.synchronize()
            rp["land_s"] = time.perf_counter() - t1
            rp["crc_errors"] = [crc_errors(a) - c for a, c in zip(addrs, crc0)]
            staged = sum(d.get("staged_copies", 0)
                         for d in rp["links"].values())
            grants = sum(d.get("retain_grants", 0)
                         for d in rp["links"].values())
            fallbacks = sum(d.get("retain_fallbacks", 0)
                            for d in rp["links"].values())
            rp["link_totals"] = {"staged_copies": staged,
                                "retain_grants": grants,
                                "retain_fallbacks": fallbacks}
            log(f"[reshard] {how}: {card}: w_gate {RESHARD_SHAPE} bf16 "
                f"({len(flat)} bytes) rows -> columns over {k} rank "
                f"processes: {rp['s']:.3f} s = {rp['gb_per_s']:.3f} GB/s "
                f"(host clock; {rp['moved']['pull_bytes']} bytes pulled, "
                f"{rp['moved']['local_bytes']} local; plan steps a rank "
                f"{steps}); rd_stats a rank {rp['pulls']}; fabric links "
                f"{rp['link_totals']}; crc32c drops {rp['crc_errors']}; every "
                f"column shard torch.equal on the card (landed in "
                f"{rp['land_s']:.3f} s)")
    finally:
        for ch in chans:
            ch.close()
        for p in procs:
            try:
                p.stdin.close()
            except OSError:
                pass
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
    res["phase_s"] = time.monotonic() - t_phase
    log(f"[reshard] ranks up in {res['ranks_up_s']:.1f} s; phase "
        f"{res['phase_s']:.1f} s")
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
        if ((TILE_KERNEL.search(line) or any(
                k in line for k in BACKWARD_KERNELS))
                and "<bf16, 128>" in line
                and " 0 bytes spill stores" not in line):
            raise AssertionError(f"a Llama-width tile spills: {line}")
        if f32_simt_kernel(line) and not (" 0 bytes spill stores" in line
                                          and " 0 bytes spill loads" in line):
            raise AssertionError(f"an f32 SIMT kernel spills: {line}")
        if line.startswith("norm_kernel<") and " 0 bytes spill stores" \
                not in line:
            raise AssertionError(f"a K3 kernel spills: {line}")
    report["build_s"] = {"native": t_native, "kernels": t_kernels}
    report["sass_mma"] = sass_mma_counts(_build)
    cases = phase_kernels()
    report["parallel"] = parallel = phase_parallel()
    report["train"] = trained = phase_train()
    report["checkpoint"] = phase_checkpoint(card, args.report_dir)
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
    # The worker processes load the weights themselves: this process keeps
    # a host copy to serve them from and releases its device copy.
    from brpc_tpu_torch import disagg

    weights = {"": {k: v.cpu()
                    for k, v in disagg._flatten_params(params).items()}}
    del params
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[disagg-procs] this process's device copy of the weights "
        f"released: {torch.cuda.memory_allocated() / 2**30:.2f} GiB still "
        f"allocated here")
    report["disagg_procs"] = phase_disagg_procs(weights, cfg, card,
                                                main_res, report["disagg"])
    del weights
    gc.collect()
    report["landing"] = phase_landing(card)
    report["reshard"] = phase_reshard(card)
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
    # The backward kernels: the bf16 case at the training step's shapes
    # (K2b at (2, 2048), K3b at 4096 rows, K5b on a full block), launches
    # from the bf16 step (K5b: from the ring's backward at S 32768).
    pick = {"attention_backward": 0, "rms_norm_backward": 1,
            "add_rms_norm_backward": 1, "ring_attention_fold_backward": 0}
    for name, i in pick.items():
        r = trained["kernels"][name][i]
        run = trained["ring" if name.startswith("ring") else "step"]
        rows.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": run["launches"][name],
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
