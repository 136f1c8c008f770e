"""Time the port's attention kernels for one or more checkouts of this
repository, in turns, in one process per checkout and round. Per dtype
(bf16, then f32): K2b at chip_smoke.py's two training shapes, K5b and K5
on a full and on the diagonal block of s 4096, and the ring's forward (8
in-process ranks of K5 folds) at S 32768. With ``--all`` also every other
case of chip_smoke.py's phase 3 (K1, K2, K4, K3 and its fused form) and
of its backward cases (K3b alone and fused), whose code a change to the
attention cores should leave alone. Each checkout's own chip_smoke.py
checks its kernels against their plain versions and times them (CUDA
events and torch.profiler), so two versions compare on one card in one
call. Each K2b, K5b and K5 case's device time is also split by kernel
from torch.profiler (K2b and K5b: the delta pre-pass, the dK/dV pass, the
dQ pass), and the library call's kernels are named by the profiler. K2's
batched training forward (o and the LSE) is timed at K2b's shapes beside
causal SDPA's forward; with ``--all`` the kernels of phase 3's K2 and K4
library call (SDPA with an explicit mask) are named too, and those of
its K1 library call at phase 5's last decode step.

    python3 tools/torch_backward_ab.py [--all] PARENT_DIR . . PARENT_DIR
    python3 tools/torch_backward_ab.py --k3 8,529,1000 PARENT_DIR . . PARENT_DIR

With ``--k3 ROWS`` only K3 and its fused form run, at D 4096 and each of
the comma-separated row counts, in bf16 and f32 (chip_smoke.py's own
checks: the plain version, the fused sum ``torch.equal`` to x + delta,
a bit-identical rerun), beside the device time of the smallest launch
torch makes (a one-element ``zero_``) and the registers and spills ptxas
gave each K3 instance.

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


def by_kernel(fn, iters: int = 20, raw: bool = False) -> dict:
    """Device ms per call of each kernel fn launches, by the kernel's
    name (with ``raw``, the profiler's own name, cut to 60 characters;
    else the port's kernels by name and the rest of PyTorch's own kernels
    as "other"), from torch.profiler."""
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
        k = e.key[:60] if raw else (m.group(1) if m else "other")
        out[k] = out.get(k, 0.0) + getattr(
            e, "self_device_time_total", 0.0) / 1e3 / iters
    return out


def result(case: str, r: dict, library: str, split: dict) -> None:
    print("RESULT " + json.dumps({
        "case": case, "ms": r["ms"], "device_ms": r["device_ms"],
        "row_rel_err": r.get("row_rel_err"), "library": library,
        "library_device_ms": r.get("library_device_ms"),
        "by_kernel": split}), flush=True)


def k3(chip_smoke, _build, rows_list: list) -> None:
    """K3 alone and fused at D 4096 and each row count, as RESULT lines,
    after the launch floor's, then one PTXAS line per K3 instance."""
    import torch

    z = torch.zeros(1, device="cuda")
    result("launch_floor zero_ [1]", {
        "ms": chip_smoke.time_ms(z.zero_),
        "device_ms": chip_smoke.device_ms(z.zero_, iters=50)}, "n/a", {})
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        for rows in rows_list:
            for name, check in (("rms_norm", chip_smoke.check_rms_norm),
                                ("add_rms_norm",
                                 chip_smoke.check_add_rms_norm)):
                r = check(dtype, gen, rows)
                result(f"{name} {tag} {r['shape']}", r, "library", {})
    for line in chip_smoke.ptxas_summary(_build.PTXAS_LOG):
        if "norm" in line and "backward" not in line:
            print("PTXAS " + line, flush=True)


def one(root: str, everything: bool, k3_rows: list) -> None:
    """The cases in the checkout at ``root``, as RESULT lines."""
    sys.path.insert(0, root)
    import torch

    import chip_smoke
    from brpc_tpu_torch.ops import _build, attention
    from brpc_tpu_torch.ops import ring_attention as ra

    _build.build()
    if k3_rows:
        k3(chip_smoke, _build, k3_rows)
        return
    if everything:
        for name, rs in chip_smoke.phase_kernels().items():
            for r in rs:
                if r.get("device_ms") is not None:
                    result(f"{name} {r['dtype']} {r['shape']}", r,
                           "library", {})
    for dtype in (torch.bfloat16, torch.float32):
        tag = str(dtype)[6:]
        gen = torch.Generator(device="cuda").manual_seed(5)
        runs = [(f"K2b {tag} B={B} S={S}",
                 chip_smoke.check_attention_backward(dtype, gen, B, S))
                for B, S in K2B_SHAPES]
        runs += [(f"K5b {tag} " + ("diagonal" if d else "full"),
                  chip_smoke.check_ring_fold_backward(dtype, gen, d))
                 for d in (False, True)]
        if everything:
            for rows in chip_smoke.K3B_ROWS:
                for fused in (False, True):
                    runs.append((f"K3b{' fused' if fused else ''} {tag} "
                                 f"rows={rows}",
                                 chip_smoke.check_norm_backward(
                                     dtype, gen, rows, fused)))

        def rnd(*shape):
            return torch.randn(shape, generator=gen, device="cuda").to(dtype)

        split, forward = {}, []
        for B, S in K2B_SHAPES:
            q, k, v, do = (rnd(B, S, 32, 128), rnd(B, S, 8, 128),
                           rnd(B, S, 8, 128), rnd(B, S, 32, 128))
            o, lse = attention.causal_attention_forward(q, k, v)
            split[f"K2b {tag} B={B} S={S}"] = by_kernel(
                lambda: attention.attention_backward(q, k, v, o, lse, do))
            forward.append(training_forward(chip_smoke, attention, q, k, v,
                                            f"K2 forward {tag} B={B} S={S}",
                                            split))
            del q, k, v, do, o, lse
        if everything:
            q, k, v = rnd(1, 32, 1024, 128), rnd(1, 32, 1024, 128), \
                rnd(1, 32, 1024, 128)
            mask = torch.ones((1024, 1024), dtype=torch.bool,
                              device="cuda").tril()[None, None]

            def masked():
                return torch.nn.functional.scaled_dot_product_attention(
                    q, k, v, attn_mask=mask)

            name = f"SDPA masked {tag} [1, 32, 1024, 128]"
            split[name] = by_kernel(masked, raw=True)
            result(name, {"ms": chip_smoke.time_ms(masked),
                          "device_ms": sum(split[name].values())},
                   "phase 3's K2 and K4 library call", split[name])
            del q, k, v, mask
            # Phase 3's K1 library call at phase 5's last step: one query
            # per (lane, head) over the gathered keys, each lane's own mask.
            q, k, v = rnd(8, 32, 1, 128), rnd(8, 32, 1056, 128), \
                rnd(8, 32, 1056, 128)
            mask = (torch.arange(1056, device="cuda")[None, :] <= torch.tensor(
                [n + 31 for n in (16, 1024, 100, 517, 64, 300, 800, 33)],
                device="cuda")[:, None])[:, None, None, :]
            name = f"SDPA masked decode {tag} [8, 32, 1, 128] x 1056 keys"
            split[name] = by_kernel(masked, raw=True)
            result(name, {"ms": chip_smoke.time_ms(masked),
                          "device_ms": sum(split[name].values())},
                   "phase 3's K1 library call", split[name])
            del q, k, v, mask
        s = 4096
        q, k0, v0, k1, v1, do = (rnd(1, s, 32, 128) for _ in range(6))
        lse = torch.empty((1, s, 32), dtype=torch.float32, device="cuda")
        st = ra.ring_attention_fold(q, k0, v0, ra.fold_state(q), s, 0, True)
        o = ra.ring_attention_fold(q, k1, v1, st, s, s, True, final=True,
                                   lse=lse)
        for diagonal in (False, True):
            kb, vb, k_start = (k1, v1, s) if diagonal else (k0, v0, 0)
            grads = ra.grad_buffers(q, kb)
            split[f"K5b {tag} " + ("diagonal" if diagonal else "full")] = \
                by_kernel(lambda: ra.ring_attention_fold_backward(
                    q, kb, vb, o, lse, do, grads, s, k_start, True, True))
        del q, k0, v0, k1, v1, do, st, o, lse, grads
        torch.cuda.empty_cache()
        for name, r in runs:
            result(name, r, "SDPA backward" if "K3b" not in name
                   else "F.rms_norm backward", split.get(name, {}))
        for name, r in forward:
            result(name, r, "causal SDPA", split[name])
        for name, r, lib in k5_runs(chip_smoke, ra, gen, dtype, split):
            result(name, r, lib, split[name])
        torch.cuda.empty_cache()


def training_forward(chip_smoke, attention, q, k, v, name: str,
                     split: dict) -> tuple:
    """K2's batched training forward (o and the LSE) on q [B, S, H, Dh],
    k, v [B, S, KV, Dh], timed beside causal SDPA's forward over the same
    GQA inputs; ``split[name]`` gets both split by kernel (SDPA's under
    the profiler's names, marked "SDPA"): (name, result)."""
    import torch

    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))

    def kern():
        return attention.causal_attention_forward(q, k, v)

    def lib():
        return torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True)

    own, library = by_kernel(kern), by_kernel(lib, raw=True)
    split[name] = {**own, **{"SDPA " + k: ms for k, ms in library.items()}}
    return name, {"ms": chip_smoke.time_ms(kern),
                  "device_ms": sum(own.values()), "row_rel_err": None,
                  "library_device_ms": sum(library.values())}


def k5_runs(chip_smoke, ra, gen, dtype, split: dict) -> list:
    """K5 on a full and on the diagonal block of s 4096 (one fold each,
    checked against the plain fold, then chip_smoke.time_ring_fold), and
    the causal ring's forward at S 32768 as 8 in-process ranks (its
    outputs are checked by chip_smoke.py's parallel phase), each split by
    kernel into ``split``, and the kernels of the library call over the
    full block: [(case, result, library call)]."""
    import torch

    tag = str(dtype)[6:]
    F = torch.nn.functional
    s = chip_smoke.RING_S // chip_smoke.RING_RANKS
    q, k, v = (torch.randn((1, s, chip_smoke.RING_H, chip_smoke.RING_DH),
                           generator=gen, device="cuda").to(dtype)
               for _ in range(3))
    errs = {}
    for name, k_start in ((f"K5 {tag} full", 0), (f"K5 {tag} diagonal", s)):
        got = ra.ring_attention_fold(q, k, v, ra.fold_state(q), s, k_start,
                                     True)
        want = ra.ring_attention_fold_plain(q, k, v, ra.fold_state(q), s,
                                            k_start, True)
        errs[name] = chip_smoke.compare(
            name, ra.fold_output(got, torch.float32),
            ra.fold_output(want, torch.float32), dtype, rows=True)[1]
        state = ra.fold_state(q)
        split[name] = by_kernel(lambda: ra.ring_attention_fold(
            q, k, v, state, s, k_start, True))
        del got, want
    q4, k4, v4 = (t.transpose(1, 2) for t in (q, k, v))
    split[f"SDPA {tag} full"] = by_kernel(
        lambda: F.scaled_dot_product_attention(q4, k4, v4), raw=True)
    split[f"SDPA {tag} full"].update({
        "backward " + k: ms for k, ms in by_kernel(
            lambda: sdpa_backward(q4, k4, v4), raw=True).items()})
    del q, k, v, q4, k4, v4
    torch.cuda.empty_cache()
    t = chip_smoke.time_ring_fold(dtype, gen)
    out = [(f"K5 {tag} full", {
        "ms": t["ms"], "device_ms": t["device_ms"],
        "row_rel_err": errs[f"K5 {tag} full"],
        "library_device_ms": t["library_device_ms"]}, "SDPA"),
           (f"K5 {tag} diagonal", {
               "ms": t["diag_ms"], "device_ms": t["diag_device_ms"],
               "row_rel_err": errs[f"K5 {tag} diagonal"],
               "library_device_ms": t["diag_library_device_ms"]},
            "causal SDPA"),
           (f"SDPA {tag} full", {
               "ms": t["library_ms"], "device_ms": t["library_device_ms"]},
            "the library call's kernels")]
    _, (qs, ks, vs) = chip_smoke.ring_blocks(gen, dtype, chip_smoke.RING_S)
    name = f"ring forward {tag} S={chip_smoke.RING_S}"

    def ring():
        return ra.ring_attention_local(qs, ks, vs, True)

    split[name] = by_kernel(ring, iters=3)
    out.append((name, {
        "ms": chip_smoke.time_ms(ring, iters=3, warmup=1),
        "device_ms": sum(split[name].values()), "row_rel_err": None,
        "library_device_ms": None}, "n/a"))
    del qs, ks, vs
    torch.cuda.empty_cache()
    return out


def sdpa_backward(q, k, v):
    """One SDPA forward and backward over the block (the backward's
    kernels, with the forward's, for the profiler)."""
    import torch

    leaves = [t.detach().requires_grad_(True) for t in (q, k, v)]
    out = torch.nn.functional.scaled_dot_product_attention(*leaves)
    return torch.autograd.grad(out, leaves, torch.ones_like(out))


def main() -> int:
    args = sys.argv[1:]
    one_root = None
    if args[:1] == ["--one"]:
        one_root, args = os.path.abspath(args[1]), args[2:]
    everything = args[:1] == ["--all"]
    if everything:
        args = args[1:]
    k3_rows = []
    if args[:1] == ["--k3"]:
        k3_rows, args = [int(r) for r in args[1].split(",")], args[2:]
    if one_root:
        one(one_root, everything, k3_rows)
        return 0
    flags = (["--all"] if everything else []) + (
        ["--k3", ",".join(map(str, k3_rows))] if k3_rows else [])
    roots = args
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[ab] card {card}", flush=True)
    for i, root in enumerate(roots or ["."]):
        root = os.path.abspath(root)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root]
            + flags,
            cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("PTXAS "):
                print(f"[ab] round {i} {root}: ptxas {line[6:]}", flush=True)
            if not line.startswith("RESULT "):
                continue
            r = json.loads(line[len("RESULT "):])
            split = ", ".join(f"{k} {v:.4f}"
                              for k, v in r["by_kernel"].items())
            err = ("n/a" if r["row_rel_err"] is None
                   else f"{r['row_rel_err']:.3e}")
            lib = ("" if r["library_device_ms"] is None else
                   f" ({r['library']} device_ms "
                   f"{r['library_device_ms']:.4f})")
            dev = ("n/a" if r["device_ms"] is None
                   else f"{r['device_ms']:.4f}")
            print(f"[ab] round {i} {root}: {r['case']} device_ms {dev} ms "
                  f"{r['ms']:.4f} row_rel_err {err}{lib}; by kernel: "
                  f"{split}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
