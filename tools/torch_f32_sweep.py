"""Time the f32 attention cores (csrc/attention_f32.cuh: K5's f32 fold,
K2's, K4's and K1's f32 forward on the same core, K5b's and K2b's f32
backward passes) at chip_smoke.py's shapes for copies of this checkout
with other block shapes, in turns, one process each, so that they compare
on one card in one call. K2 runs at P 1024 and P 4096 (length 3000), K4 at
(start 100, 200 queries) and (start 4000, 1 query), each with the split
plan that copy's rows give, and K1 at chip_smoke.py's first two K1 cases
(8 lanes at 0-2047 over a 512-column table, and phase 5's last decode
step), each with the plan and grid that copy's decode constants give.
Each case is also held to its plain version (the worst row error), and
each copy's ptxas registers and spills of its f32 Dh-128 kernels are
printed.

    python3 tools/torch_f32_sweep.py . F128x32x512 B64x32x512 .
    python3 tools/torch_f32_sweep.py --decode . D1x16x2 D2x128x1 .
    python3 tools/torch_f32_sweep.py --decode . Xproducts Xloads \
        Xproducts-Xloads

Each argument is "." (this checkout) or a spec of the forward core's
block (F<rows>x<keys>x<threads>), the backward core's (B<own rows>x<column
rows>x<threads>), the inner loops' unroll depths (U<dots>x<accumulations>),
K1's f32 decode route (D<key tiles a split>x<rows of its layout>x<blocks
an SM holds>: D2x16x2 is the shipped one, D2x128x1 the other routes'
layout), or several joined by "-":
a copy under build/f32_sweep/ with those constants. A part "Xproducts"
or "Xloads" ablates the forward core's tile loop in the copy: it skips
the products (S = Q.K^T and O += P.V) or every K/V load after a
problem's first tile, so that the time left shows what the rest costs;
such a copy's outputs are wrong, and are not held to the plain version.
With ``--decode`` only the K1 cases run. Prints the card's name and power limit, then one
"[f32]" line per argument and case. Needs a CUDA card; each copy builds
its kernels into its own build/ directory.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
S, H, DH = 4096, 32, 128
K2B = (2, 2048, 8)  # B, S, KV heads
ABLATED = "ABLATED"  # marks a copy whose tile loop is ablated
# The ablations: (old, new) edits of csrc/attention_f32.cuh's tile loop.
ABLATIONS = {
    "products": (
        ("    dots<DH, kRm, kKn, kGy, kGrid, kLive>(s, qs, kt, ty, tx);", ""),
        ("      accumulate<DH, kRm, kGy, kLive>(r.o, ps,",
         "      if (false) accumulate<DH, kRm, kGy, kLive>(r.o, ps,")),
    "loads": (
        ("    if (more) {\n      const int nx",
         "    if (false) {\n      const int nx"),
        ("    if (L::kVStages == 1 && more) {",
         "    if (false) {")),
}


def one(root: str, decode_only: bool = False) -> None:
    """The cases in the checkout at ``root``, as RESULT lines (with
    ``decode_only``, K1's alone)."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from brpc_tpu_torch.ops import _build, attention
    from brpc_tpu_torch.ops import ring_attention as ra

    _build.build()
    for line in chip_smoke.ptxas_summary(_build.PTXAS_LOG):
        if chip_smoke.f32_simt_kernel(line) and "f32, 128>" in line:
            print("RESULT " + json.dumps({"ptxas": line}), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    ablated = os.path.exists(os.path.join(root, ABLATED))

    def emit(case, fn, got, want, flops):
        err = None if ablated else max(
            chip_smoke.compare(case, g, w, f32, rows=True,
                               floor=attention.GRAD_ROW_FLOOR)[1]
            for g, w in zip(got, want))
        ms = chip_smoke.device_ms(fn, iters=10)
        print("RESULT " + json.dumps({"case": case, "device_ms": ms,
                                      "tflops": flops / ms / 1e9,
                                      "row_rel_err": err}), flush=True)

    decode_cases(chip_smoke, gen, emit)
    if decode_only:
        return
    q, k0, v0, k1, v1, do = (rnd(1, S, H, DH) for _ in range(6))
    for name, k_start, pairs in (("K5 full", 0, S * S),
                                 ("K5 diagonal", S, S * (S + 1) / 2)):
        state = ra.fold_state(q)
        got = ra.ring_attention_fold(q, k0, v0, ra.fold_state(q), S,
                                     k_start, True)
        want = ra.ring_attention_fold_plain(q, k0, v0, ra.fold_state(q), S,
                                            k_start, True)
        emit(name, lambda: ra.ring_attention_fold(q, k0, v0, state, S,
                                                  k_start, True),
             [ra.fold_output(got, f32)], [ra.fold_output(want, f32)],
             4.0 * pairs * H * DH)
        del got, want, state
    lse = torch.empty((1, S, H), dtype=f32, device="cuda")
    st = ra.ring_attention_fold(q, k0, v0, ra.fold_state(q), S, 0, True)
    o = ra.ring_attention_fold(q, k1, v1, st, S, S, True, final=True,
                               lse=lse)
    del st
    for name, kb, vb, k_start, pairs in (
            ("K5b full", k0, v0, 0, S * S),
            ("K5b diagonal", k1, v1, S, S * (S + 1) / 2)):
        grads = ra.grad_buffers(q, kb)
        ra.ring_attention_fold_backward(q, kb, vb, o, lse, do, grads, S,
                                        k_start, True, True)
        want = ra.ring_attention_fold_backward_plain(q, kb, vb, o, lse, do,
                                                     S, k_start, True)
        emit(name, lambda: ra.ring_attention_fold_backward(
            q, kb, vb, o, lse, do, grads, S, k_start, True, True),
             grads[:3], want, 10.0 * pairs * H * DH)
        del grads, want
    del q, k0, v0, k1, v1, do, o, lse
    torch.cuda.empty_cache()
    forward_cases(rnd, emit)
    B, T, KV = K2B
    q, do = rnd(B, T, H, DH), rnd(B, T, H, DH)
    k, v = rnd(B, T, KV, DH), rnd(B, T, KV, DH)
    o, lse = attention.causal_attention_forward(q, k, v)
    got = attention.attention_backward(q, k, v, o, lse, do)
    want = attention.prefill_attention_backward_plain(q, k, v, o, lse, do)
    emit(f"K2b B={B} S={T}",
         lambda: attention.attention_backward(q, k, v, o, lse, do), got,
         want, 10.0 * B * T * (T + 1) / 2 * H * DH)


def forward_cases(rnd, emit) -> None:
    """K2 and K4 in f32 at Llama-3-8B heads (KV 8): K2 at P 1024 and P 4096
    (length 3000); K4 on the last layer of a 2-layer pool of 16-token
    pages at (start 100, 200 queries) and (start 4000, 1 query)."""
    import torch

    from brpc_tpu_torch.ops import attention

    kv, page = K2B[2], 16
    for P, length in ((1024, 1024), (4096, 3000)):
        q, k, v = rnd(P, H, DH), rnd(P, kv, DH), rnd(P, kv, DH)
        pairs = sum(min(i + 1, length) for i in range(P))
        emit(f"K2 P={P} length={length}",
             lambda: attention.prefill_attention(q, k, v, length),
             [attention.prefill_attention(q, k, v, length)],
             [attention.prefill_attention_plain(q, k, v, length)],
             4.0 * pairs * H * DH)
    for start, n in ((100, 200), (4000, 1)):
        pages = -(-(start + n) // page)
        k_pool, v_pool = (rnd(pages + 1, 2, page, kv, DH) for _ in range(2))
        table = torch.randperm(pages, device="cuda").int() + 1
        q = rnd(n, H, DH)

        def kern():
            return attention.paged_prefill_attention(q, k_pool, v_pool,
                                                     table, start, 1)

        plan = attention.plan_splits(n, H, kv, start, 132, torch.float32)
        emit(f"K4 start={start} n={n} plan(132 SMs)={plan}", kern, [kern()],
             [attention.paged_prefill_attention_plain(q, k_pool, v_pool,
                                                      table, start, 1)],
             4.0 * H * DH * (n * start + n * (n + 1) / 2))


def decode_cases(chip_smoke, gen, emit) -> None:
    """K1 in f32 at chip_smoke.py's first two K1 cases (Llama-3-8B heads,
    8 lanes, the last layer of a 32-layer pool of 16-token pages), each
    named with its plan and grid at 132 SMs."""
    import torch

    from brpc_tpu_torch.ops import attention

    for pos, width, idle in chip_smoke.K1_CASES[:2]:
        q, k_pool, v_pool, tables, pos_t, layer, _ = chip_smoke.decode_inputs(
            torch.float32, gen, pos, width, idle)
        S, H, Dh = q.shape
        KV, page = k_pool.shape[3], k_pool.shape[2]
        plan = attention.plan_decode_splits(S, KV, tables.shape[1] * page,
                                            132, torch.float32)
        grid = attention.decode_grid(S, H, KV, plan[1], 132)

        def kern():
            return attention.paged_decode_attention(q, k_pool, v_pool,
                                                    tables, pos_t, layer)

        emit(f"K1 table={tables.shape[1]} pos={pos} plan(132 SMs)={plan} "
             f"grid={grid}", kern, [kern()],
             [attention.paged_decode_attention_plain(q, k_pool, v_pool,
                                                     tables, pos_t, layer)],
             4.0 * sum(p + 1 for p in pos) * H * Dh)
        del q, k_pool, v_pool
        torch.cuda.empty_cache()


def checkout(spec: str) -> str:
    """The checkout for an argument: this one, or a copy with the block
    shapes of ``spec``."""
    if spec == ".":
        return REPO
    root = os.path.join(REPO, "build", "f32_sweep", spec)
    if not os.path.exists(os.path.join(root, "chip_smoke.py")):
        os.makedirs(root, exist_ok=True)
        shutil.copytree(os.path.join(REPO, "brpc_tpu_torch"),
                        os.path.join(root, "brpc_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"),
                        dirs_exist_ok=True)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
        header = os.path.join(root, "brpc_tpu_torch", "csrc",
                              "attention_f32.cuh")
        with open(header) as f:
            text = f.read()
        names = {"F": ("kF32FwdRows", "kF32FwdKeys", "kF32FwdThreads"),
                 "B": ("kF32BwdOwnRows", "kF32BwdCols", "kF32BwdThreads"),
                 "U": ("kF32DotUnroll", "kF32AccUnroll"),
                 "D": ("kF32DecodeSplitTiles", "kF32DecodeRows",
                       "kF32DecodeBlocks")}
        for part in spec.split("-"):
            if part[0] == "X":
                for old, new in ABLATIONS[part[1:]]:
                    if old not in text:
                        raise ValueError(f"{spec}: the tile loop changed")
                    text = text.replace(old, new)
                open(os.path.join(root, ABLATED), "w").close()
                continue
            for name, value in zip(names[part[0]], part[1:].split("x")):
                text = re.sub(rf"constexpr int {name} = \d+;",
                              f"constexpr int {name} = {int(value)};", text)
        with open(header, "w") as f:
            f.write(text)
    return root


def main() -> int:
    args = sys.argv[1:]
    if args[:1] == ["--one"]:
        one(os.path.abspath(args[1]), args[2:3] == ["--decode"])
        return 0
    decode_only = args[:1] == ["--decode"]
    specs = args[1:] if decode_only else args
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[f32] card {card}", flush=True)
    for i, spec in enumerate(specs or ["."]):
        root = checkout(spec)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root]
            + (["--decode"] if decode_only else []),
            cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            print(f"[f32] round {i} {spec}: failed\n{out.stdout[-1500:]}"
                  f"\n{out.stderr[-3000:]}", flush=True)
            continue
        for line in out.stdout.splitlines():
            if not line.startswith("RESULT "):
                continue
            r = json.loads(line[len("RESULT "):])
            if "ptxas" in r:
                print(f"[f32] round {i} {spec}: ptxas {r['ptxas']}",
                      flush=True)
                continue
            err = ("n/a (ablated)" if r["row_rel_err"] is None
                   else f"{r['row_rel_err']:.3e}")
            print(f"[f32] round {i} {spec}: {r['case']} device_ms "
                  f"{r['device_ms']:.4f} ({r['tflops']:.1f} TFLOP/s by the "
                  f"4- or 10-flop count) row_rel_err {err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
