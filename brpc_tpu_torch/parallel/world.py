"""A world of ranks on one host, for tests and CPU rehearsals: n spawned
processes, one rank each, joined by ``torch.distributed`` over gloo. It
stands where the reference's virtual CPU mesh stands
(``brpc_tpu/utils/env.py``): one card cannot hold two NCCL ranks, so
multi-rank code is checked on the CPU in such a world.

Each rank runs ``fn(rank, n, *args)``. ``fn`` is pickled by its import
path and runs in a fresh interpreter (the ``spawn`` start method: the
caller may hold threads), so it lives in a module that imports only
torch, numpy and this package. The arguments reach the ranks through a
pickle file of the world's own (a pipe to each rank would hold up each
start until that rank has imported its modules), the results through a
queue: pass and return numpy arrays.
"""

from __future__ import annotations

import datetime
import multiprocessing
import os
import pickle
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

__all__ = ["run"]


def _rank_main(init: str, rank: int, n: int, timeout_s: float,
               call_path: str, results) -> None:
    # n ranks share the host's cores: one compute thread each.
    torch.set_num_threads(1)
    try:
        with open(call_path, "rb") as f:
            fn, args = pickle.load(f)  # written by run() below
        dist.init_process_group(
            "gloo", init_method=init, world_size=n, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def run(n: int, fn, *args, timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, n, *args)`` on each rank of a new n-rank gloo world
    (a ``file://`` rendezvous in a temporary directory of its own) and
    return the ranks' results in rank order. Raises ``RuntimeError`` with
    each failed rank's traceback, or naming the ranks that exited without
    a result or had not finished after ``timeout_s`` (also the process
    group's own timeout). Every process has ended when it returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got, failed = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        call_path = os.path.join(tmp, "call.pkl")
        with open(call_path, "wb") as f:
            pickle.dump((fn, args), f)
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(init, r, n, timeout_s, call_path, results))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while len(got) + len(failed) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    rank, ok, value = results.get(timeout=min(left, 0.5))
                except queue.Empty:
                    # A rank that exited put its result first: once its
                    # exit code is set, a missing result is lost for good.
                    for r, p in enumerate(procs):
                        if (p.exitcode is not None and r not in got
                                and r not in failed and results.empty()):
                            failed[r] = f"exited with code {p.exitcode} " \
                                        f"and no result"
                    continue
                (got if ok else failed)[rank] = value
        finally:
            for p in procs:
                p.join(timeout=5 if len(got) == n else 0)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
    late = [r for r in range(n) if r not in got and r not in failed]
    if failed or late:
        msg = [f"rank {r}: {failed[r]}" for r in sorted(failed)]
        if late:
            msg.append(f"ranks {late} had not finished after {timeout_s} s")
        raise RuntimeError("world of %d ranks failed:\n%s" % (n,
                                                              "\n".join(msg)))
    return [got[r] for r in range(n)]
