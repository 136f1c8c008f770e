"""Time the port's Hopper attention kernels in bf16 for one or more
checkouts of this repository, in turns, in one process per checkout and
round: K2b at chip_smoke.py's two training shapes, K5b and K5 on a full and
on the diagonal block of s 4096, and the ring's forward (8 in-process
ranks of K5 folds) at S 32768. Each checkout's own chip_smoke.py checks
its kernels against their plain versions and times them (CUDA events and
torch.profiler), so two versions compare on one card in one call. Each
case's device time is also split by kernel from torch.profiler (K2b and
K5b: the delta pre-pass, the dK/dV pass, the dQ pass).

    python3 tools/torch_backward_ab.py PARENT_DIR . . PARENT_DIR

Prints the card's name and power limit, then one "[ab]" line per round
and case. Needs a CUDA card; builds each checkout's kernels into its own
build/ directory.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

K2B_SHAPES = ((2, 2048), (1, 4096))


def by_kernel(fn, iters: int = 20) -> dict:
    """Device ms per call of each kernel fn launches, by the kernel's
    name (the rest of PyTorch's own kernels as "other"), from
    torch.profiler."""
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
        m = re.search(r"((?:ring|attention)\w*_kernel)", e.key)
        k = m.group(1) if m else "other"
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
    runs = [(name, r, "SDPA backward") for name, r in runs]
    runs += k5_runs(chip_smoke, ra, gen, split)
    for name, r, lib in runs:
        print("RESULT " + json.dumps({
            "case": name, "ms": r["ms"], "device_ms": r["device_ms"],
            "row_rel_err": r["row_rel_err"], "library": lib,
            "library_device_ms": r["library_device_ms"],
            "by_kernel": split[name]}), flush=True)


def k5_runs(chip_smoke, ra, gen, split: dict) -> list:
    """K5 on a full and on the diagonal block of s 4096 (one fold each,
    checked against the plain fold, then chip_smoke.time_ring_fold), and
    the causal ring's forward at S 32768 as 8 in-process ranks (its
    outputs are checked by chip_smoke.py's parallel phase), each split by
    kernel into ``split``: [(case, result, library call)]."""
    import torch

    bf16 = torch.bfloat16
    s = chip_smoke.RING_S // chip_smoke.RING_RANKS
    q, k, v = (torch.randn((1, s, chip_smoke.RING_H, chip_smoke.RING_DH),
                           generator=gen, device="cuda").to(bf16)
               for _ in range(3))
    errs = {}
    for name, k_start in (("K5 full", 0), ("K5 diagonal", s)):
        got = ra.ring_attention_fold(q, k, v, ra.fold_state(q), s, k_start,
                                     True)
        want = ra.ring_attention_fold_plain(q, k, v, ra.fold_state(q), s,
                                            k_start, True)
        errs[name] = chip_smoke.compare(
            name, ra.fold_output(got, torch.float32),
            ra.fold_output(want, torch.float32), bf16, rows=True)[1]
        state = ra.fold_state(q)
        split[name] = by_kernel(lambda: ra.ring_attention_fold(
            q, k, v, state, s, k_start, True))
        del got, want
    torch.cuda.empty_cache()
    t = chip_smoke.time_ring_fold(bf16, gen)
    out = [("K5 full", {"ms": t["ms"], "device_ms": t["device_ms"],
                        "row_rel_err": errs["K5 full"],
                        "library_device_ms": t["library_device_ms"]},
            "SDPA"),
           ("K5 diagonal", {"ms": t["diag_ms"],
                            "device_ms": t["diag_device_ms"],
                            "row_rel_err": errs["K5 diagonal"],
                            "library_device_ms": t["diag_library_device_ms"]},
            "causal SDPA")]
    _, (qs, ks, vs) = chip_smoke.ring_blocks(gen, bf16, chip_smoke.RING_S)
    name = f"ring forward S={chip_smoke.RING_S}"

    def ring():
        return ra.ring_attention_local(qs, ks, vs, True)

    split[name] = by_kernel(ring, iters=3)
    Q, K, V = (torch.cat(b, dim=1).transpose(1, 2) for b in (qs, ks, vs))
    out.append((name, {
        "ms": chip_smoke.time_ms(ring, iters=3, warmup=1),
        "device_ms": sum(split[name].values()), "row_rel_err": None,
        "library_device_ms": chip_smoke.device_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                Q, K, V, is_causal=True), iters=3)},
        "causal SDPA over S"))
    return out


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
            err = ("n/a" if r["row_rel_err"] is None
                   else f"{r['row_rel_err']:.3e}")
            print(f"[ab] round {i} {root}: {r['case']} device_ms "
                  f"{r['device_ms']:.4f} ms {r['ms']:.4f} row_rel_err "
                  f"{err} ({r['library']} device_ms "
                  f"{r['library_device_ms']:.4f}); by kernel: {split}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
