"""Time K5's bf16 fold (ring_attention_fold, one block of sq 4096 queries at
Llama-3-8B's attention width) against the number of keys, beside SDPA over
the same block, and split each time into a fixed cost per launch and a cost
per 1024 keys (a least-squares line through the key counts). Optionally the
same for copies of this checkout whose csrc/attention_forward.cuh has other
tile sizes (kFwdKeys x kFwdStages), in turns, one process each, so that
they compare on one card in one call.

    python3 tools/torch_fold_sweep.py . 64x3 . 64x3

Each argument is "." (this checkout) or KEYSxSTAGES (a copy under
build/fold_sweep/ with those constants). Prints the card's name and power
limit, then per argument one "[sweep]" line per key count, the diagonal
(causal) block, and one "[fit]" line. Needs a CUDA card; each copy builds
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
SQ, H, DH = 4096, 32, 128
KEY_COUNTS = (512, 1024, 2048, 4096, 8192)


def one(root: str) -> None:
    """The sweep in the checkout at ``root``, as one RESULT line."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    import chip_smoke
    from brpc_tpu_torch.ops import _build
    from brpc_tpu_torch.ops import ring_attention as ra

    _build.build()
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(n):
        return torch.randn((1, n, H, DH), generator=gen,
                           device="cuda").to(torch.bfloat16)

    q = rnd(SQ)
    q4 = q.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fold, lib = [], []
    for sk in KEY_COUNTS:
        k, v = rnd(sk), rnd(sk)
        state = ra.fold_state(q)
        fold.append(chip_smoke.device_ms(lambda: ra.ring_attention_fold(
            q, k, v, state, 0, 0, False)))
        k4, v4 = k.transpose(1, 2), v.transpose(1, 2)
        lib.append(chip_smoke.device_ms(lambda: sdpa(q4, k4, v4)))
    k, v = rnd(SQ), rnd(SQ)
    state = ra.fold_state(q)
    diag = chip_smoke.device_ms(lambda: ra.ring_attention_fold(
        q, k, v, state, SQ, SQ, True))
    keys = np.array(KEY_COUNTS) / 1024.0
    fits = [np.polyfit(keys, np.array(t), 1).tolist() for t in (fold, lib)]
    print("RESULT " + json.dumps({"fold": fold, "sdpa": lib, "diag": diag,
                                  "fit": fits}), flush=True)


def checkout(spec: str) -> str:
    """The checkout for an argument: this one, or a copy with the tile
    sizes KEYSxSTAGES."""
    if spec == ".":
        return REPO
    keys, stages = (int(x) for x in spec.split("x"))
    root = os.path.join(REPO, "build", "fold_sweep", spec)
    if not os.path.exists(os.path.join(root, "chip_smoke.py")):
        os.makedirs(root, exist_ok=True)
        shutil.copytree(os.path.join(REPO, "brpc_tpu_torch"),
                        os.path.join(root, "brpc_tpu_torch"),
                        ignore=shutil.ignore_patterns("__pycache__"),
                        dirs_exist_ok=True)
        shutil.copy(os.path.join(REPO, "chip_smoke.py"), root)
        header = os.path.join(root, "brpc_tpu_torch", "csrc",
                              "attention_forward.cuh")
        with open(header) as f:
            text = f.read()
        text = re.sub(r"constexpr int kFwdKeys = \d+;",
                      f"constexpr int kFwdKeys = {keys};", text)
        text = re.sub(r"constexpr int kFwdStages = \d+;",
                      f"constexpr int kFwdStages = {stages};", text)
        with open(header, "w") as f:
            f.write(text)
    return root


def main() -> int:
    if sys.argv[1:2] == ["--one"]:
        one(os.path.abspath(sys.argv[2]))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[sweep] card {card}", flush=True)
    for i, spec in enumerate(sys.argv[1:] or ["."]):
        root = checkout(spec)
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--one", root],
            cwd=root, capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-2000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        line = next(x for x in out.stdout.splitlines()
                    if x.startswith("RESULT "))
        r = json.loads(line[len("RESULT "):])
        for sk, t, lib in zip(KEY_COUNTS, r["fold"], r["sdpa"]):
            flops = 4.0 * H * SQ * sk * DH
            print(f"[sweep] round {i} {spec}: sq {SQ} sk {sk}: K5 {t:.4f} "
                  f"ms ({flops / t / 1e9:.1f} TFLOP/s), SDPA {lib:.4f} ms "
                  f"({flops / lib / 1e9:.1f} TFLOP/s)", flush=True)
        print(f"[sweep] round {i} {spec}: diagonal block sq = sk {SQ}: K5 "
              f"{r['diag']:.4f} ms", flush=True)
        (a, b), (c, d) = r["fit"]
        print(f"[fit] round {i} {spec}: K5 {b:.4f} ms fixed + {a:.4f} ms "
              f"per 1024 keys; SDPA {d:.4f} ms fixed + {c:.4f} ms per 1024 "
              f"keys", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
