"""Run chip_smoke.py's prefix phase and main path (phase 5) of the port's
serving engine for one or more checkouts of this repository, in turns,
one process per checkout and round, so two versions compare on one card
in one call. Each round builds (once per checkout) and loads that
checkout's native runtime and kernels, initialises Llama-3-8B (32 layers,
bf16, seeded random weights) and prints one "[ab]" line: the prefix
phase's wall time, resumes, copy-on-writes, prefix hits and TTFT p50 of
hits and misses, and phase 5's tokens/s, TTFT p50/p99 and mean decode
step.

    python3 tools/torch_serving_ab.py PARENT_DIR . . PARENT_DIR

Prints the card's name and power limit first. Needs a CUDA card.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROUND = r"""
import json, os, sys, time
sys.path.insert(0, os.getcwd())
os.environ.setdefault("TRPC_KV_HOST_ARENA", "0")
import torch
import chip_smoke as c
from brpc_tpu_torch import native, runtime
from brpc_tpu_torch.ops import _build
from brpc_tpu_torch.models import transformer
native.build()
_build.build()
card = c.card_line()
cfg = transformer.TransformerConfig.llama3_8b()
runtime.kv_pool_configure(*c.kv_pool_budget(cfg))
t0 = time.monotonic()
params = transformer.init_params(
    cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
torch.cuda.synchronize()
init_s = time.monotonic() - t0
out = os.path.join("build", "serving_ab")
os.makedirs(out, exist_ok=True)
pre = c.phase_prefix(params, cfg, card, False, out)
main = c.phase_main(params, cfg, init_s, card, False, out)
keep = ("wall_s", "resumes", "kv_prefix_cow_copies", "kv_prefix_hits",
        "ttft_p50_hit_ms", "ttft_p50_miss_ms")
print("RESULT " + json.dumps({
    "prefix": {k: pre[k] for k in keep},
    "main": {k: main[k] for k in ("tokens_per_s", "ttft_p50_ms",
                                  "ttft_p99_ms", "decode_step_ms")}}))
"""


def main() -> int:
    dirs = sys.argv[1:]
    if not dirs:
        print(__doc__, file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"[ab] card {card}", flush=True)
    for i, d in enumerate(dirs):
        proc = subprocess.run([sys.executable, "-c", ROUND],
                              cwd=os.path.abspath(d), capture_output=True,
                              text=True)
        lines = [ln for ln in proc.stdout.splitlines()
                 if ln.startswith("RESULT ")]
        if proc.returncode != 0 or not lines:
            sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
            print(f"[ab] round {i} {d}: failed (exit {proc.returncode})",
                  flush=True)
            return 1
        res = json.loads(lines[-1][len("RESULT "):])
        print(f"[ab] round {i} {d}: {json.dumps(res)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
