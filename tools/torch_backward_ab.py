"""Time the port's attention backward kernels (K2b at chip_smoke.py's two
training shapes, K5b on a full and on the diagonal block of s 4096) in bf16
for one or more checkouts of this repository, in turns, in one process per
checkout and round: each checkout's own chip_smoke.py checks its kernels
against their plain versions and times them (CUDA events and
torch.profiler), so two versions compare on one card in one call. Each
case's device time is also split by kernel (the delta pre-pass, the dK/dV
pass, the dQ pass) from torch.profiler.

    python3 tools/torch_backward_ab.py PARENT_DIR . . PARENT_DIR

Prints the card's name and power limit, then one "[ab]" line per round
and case. Needs a CUDA card; builds each checkout's kernels into its own
build/ directory.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

K2B_SHAPES = ((2, 2048), (1, 4096))


def by_kernel(fn, iters: int = 20) -> dict:
    """Device ms per call of fn's delta pre-pass, dK/dV pass and dQ pass,
    from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for k in ("delta_kernel", "kv_kernel", "q_kernel"):
            if k in e.key:
                out[k] = out.get(k, 0.0) + getattr(
                    e, "self_device_time_total", 0.0) / 1e3 / iters
    return out


def one(root: str) -> None:
    """The cases in the checkout at ``root``, as RESULT lines."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from brpc_tpu_torch.ops import _build, attention
    from brpc_tpu_torch.ops import ring_attention as ra

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(5)
    runs = [(f"K2b B={B} S={S}", chip_smoke.check_attention_backward(
        torch.bfloat16, gen, B, S)) for B, S in K2B_SHAPES]
    runs += [("K5b " + ("diagonal" if d else "full"),
              chip_smoke.check_ring_fold_backward(torch.bfloat16, gen, d))
             for d in (False, True)]

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    split = {}
    for B, S in K2B_SHAPES:
        q, k, v, do = (rnd(B, S, 32, 128), rnd(B, S, 8, 128),
                       rnd(B, S, 8, 128), rnd(B, S, 32, 128))
        o, lse = attention.causal_attention_forward(q, k, v)
        split[f"K2b B={B} S={S}"] = by_kernel(
            lambda: attention.attention_backward(q, k, v, o, lse, do))
    s = 4096
    q, k0, v0, k1, v1, do = (rnd(1, s, 32, 128) for _ in range(6))
    lse = torch.empty((1, s, 32), dtype=torch.float32, device="cuda")
    st = ra.ring_attention_fold(q, k0, v0, ra.fold_state(q), s, 0, True)
    o = ra.ring_attention_fold(q, k1, v1, st, s, s, True, final=True,
                               lse=lse)
    for diagonal in (False, True):
        kb, vb, k_start = (k1, v1, s) if diagonal else (k0, v0, 0)
        grads = ra.grad_buffers(q, kb)
        split["K5b " + ("diagonal" if diagonal else "full")] = by_kernel(
            lambda: ra.ring_attention_fold_backward(
                q, kb, vb, o, lse, do, grads, s, k_start, True, True))
    for name, r in runs:
        print("RESULT " + json.dumps({
            "case": name, "ms": r["ms"], "device_ms": r["device_ms"],
            "row_rel_err": r["row_rel_err"],
            "library_device_ms": r["library_device_ms"],
            "by_kernel": split[name]}), flush=True)


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(os.path.abspath(sys.argv[2]))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[ab] card {card}", flush=True)
    for i, root in enumerate(sys.argv[1:] or ["."]):
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if not line.startswith("RESULT "):
                continue
            r = json.loads(line[len("RESULT "):])
            split = ", ".join(f"{k} {v:.4f}"
                              for k, v in r["by_kernel"].items())
            print(f"[ab] round {i} {root}: {r['case']} device_ms "
                  f"{r['device_ms']:.4f} ms {r['ms']:.4f} row_rel_err "
                  f"{r['row_rel_err']:.3e} (SDPA backward device_ms "
                  f"{r['library_device_ms']:.4f}); by kernel: {split}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
