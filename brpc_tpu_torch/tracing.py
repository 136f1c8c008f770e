"""Distributed tracing over the native rpcz span store: the port's own
copy of the reference's ``tracing`` module, over this package's runtime.

One ``trace_id`` follows a request across every path the runtime offers:
unary RPCs (client span -> server span -> nested client calls via the
fiber-local parent), lowered collectives (root span -> every relay hop of a
ring schedule, with chunk/fold/overlap annotations -> the pickup landing),
streams (per-stream spans with write/ack marks), and the serving gateway
(admission -> lane wait -> batch formation -> per-token emits -> terminal
frame, with the TTFT split into queue-wait vs prefill).

Typical session::

    from brpc_tpu_torch import serving, tracing

    tracing.enable()                      # sampling on (default budget)
    client = serving.ServingClient(addr)
    tokens = list(client.generate([1, 2, 3], 16))
    spans = tracing.fetch(client.last_trace_id)   # the whole span tree
    tracing.dump("trace.json")            # load in Perfetto / chrome://tracing
    tracing.disable()

Sampling is off by default and the unsampled path allocates zero spans, so
leaving this module unimported costs nothing.
"""

from __future__ import annotations

import json
from typing import List, Optional

from brpc_tpu_torch import runtime


def enable(max_per_sec: int = 1000) -> None:
    """Turn span collection on (``max_per_sec`` budgets locally-originated
    traces; upstream-sampled requests are always continued)."""
    runtime.trace_set_sampling(True, max_per_sec)


def disable() -> None:
    """Turn span collection off (the default; zero-span fast path)."""
    runtime.trace_set_sampling(False)


def enable_tail() -> None:
    """Tail-based sampling: spans exist for EVERY request but buffer in a
    bounded pending ring; only requests whose flight record ends
    pathological (slow vs the p99-of-window, errored, or route-degraded)
    get their trace promoted into the store — the p99 request always has a
    full cross-worker trace while steady state stays near head-sampling-off
    cost. Composes with ``enable()`` (head samples still store directly);
    used alone, the store holds ONLY promoted traces."""
    runtime.trace_set_tail(True)


def disable_tail() -> None:
    """Turn tail-based sampling off (pending spans age out unpromoted)."""
    runtime.trace_set_tail(False)


def promote(trace_id: int) -> int:
    """Manually promote a pending trace into the store; returns the number
    of spans moved (the flight recorder does this automatically for
    pathological requests)."""
    return runtime.trace_promote(trace_id)


def pending() -> int:
    """Spans waiting in the tail-sampling pending ring."""
    return runtime.trace_pending()


def fetch(trace_id: int = 0) -> List[dict]:
    """Spans of one finished trace (``0``: the whole hot ring). See
    ``runtime.trace_fetch`` for the span dict shape."""
    return runtime.trace_fetch(trace_id)


def count() -> int:
    """Spans collected since process start."""
    return runtime.trace_count()


def dump(path: Optional[str] = None) -> dict:
    """The span ring in Chrome trace-event format. With ``path``, also
    write it to that file, ready for https://ui.perfetto.dev."""
    trace = runtime.trace_dump()
    if path is not None:
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace


def format_tree(trace_id: int, spans: Optional[List[dict]] = None) -> str:
    """Render one trace's spans as an indented parent/child tree (a quick
    terminal view of what /rpcz?trace_id= or Perfetto shows graphically)."""
    spans = spans if spans is not None else fetch(trace_id)
    by_parent: dict = {}
    by_id = {}
    for s in spans:
        by_parent.setdefault(s["parent_span_id"], []).append(s)
        by_id[s["span_id"]] = s
    roots = [s for s in spans
             if s["parent_span_id"] not in by_id]
    lines: List[str] = []

    def walk(span: dict, depth: int) -> None:
        pad = "  " * depth
        lines.append(
            f"{pad}{span['kind']} {span['service']}.{span['method']} "
            f"{span['latency_us']}us"
            + (f" err={span['error_code']}" if span["error_code"] else ""))
        for a in span.get("annotations", []):
            lines.append(f"{pad}  +{a['rel_us']}us {a['text']}")
        for child in sorted(by_parent.get(span["span_id"], []),
                            key=lambda s: s["start_us"]):
            walk(child, depth + 1)

    for root in sorted(roots, key=lambda s: s["start_us"]):
        walk(root, 0)
    return "\n".join(lines)
