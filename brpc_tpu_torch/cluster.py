"""The part of the control plane a static-list ``DisaggRouter`` needs: the
counterpart of brpc_tpu/cluster.py's ``Member`` and per-tenant token
budgets (``TenantGovernor``).

A ``Member`` is one worker as the router's pick sees it. With static
worker lists every field but the address keeps its default: capacity 1, no
reported load, no prefix digests, never draining, always ready. The lease
registry that fills the rest in (``MembershipWatcher``, ``WorkerLease``)
is not ported yet.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple


@dataclass
class Member:
    """One live worker, with the fields the router's pick reads."""
    addr: str
    capacity: int = 1
    queue_depth: int = 0
    p99_ttft_us: int = 0
    # Top-K prefix-cache hashes ("h1,h2,..."): the router's cache affinity.
    prefix_digest: str = ""
    # Top-K host-tier page content keys ("k1,k2,..." hex) the worker serves
    # to peers over the page-pull wire.
    page_digest: str = ""
    # "" = serving, "drain" = shedding admissions.
    state: str = ""
    # Model id ("" = single-model fleet); a mismatch is a hard filter.
    model: str = ""
    # Heartbeats under the current lease; 0 = no load sample yet, -1 =
    # unknown (static lists), treated as ready.
    heartbeats: int = -1

    @property
    def ready(self) -> bool:
        return self.heartbeats != 0

    @property
    def draining(self) -> bool:
        return self.state == "drain"

    def holds_prefix(self, key: str) -> bool:
        return bool(key) and key in self.prefix_digest.split(",")

    def holds_page(self, key: str) -> bool:
        return bool(key) and key in self.page_digest.split(",")


# ---- per-tenant token budgets ----------------------------------------------

@dataclass
class _Bucket:
    rate: float       # tokens refilled per second
    burst: float      # bucket capacity
    level: float = field(default=0.0)
    last: float = field(default=0.0)


class TenantGovernor:
    """Token-bucket budgets per tenant, charged at admission.

    ``charge(tenant, tokens)`` debits the tenant's bucket; over budget it
    returns ``(False, retry_after_ms)`` and the router sheds with a
    retriable ELIMIT carrying that hint. Tenants default to
    ``default_rate`` tokens/s with a ``default_burst`` cap (2 x rate when
    None); ``set_budget`` overrides one tenant. A rate <= 0 is unlimited."""

    def __init__(self, default_rate: float = 0.0,
                 default_burst: Optional[float] = None):
        self.default_rate = default_rate
        self.default_burst = default_burst
        self._buckets: Dict[str, _Bucket] = {}
        self._mu = threading.Lock()
        self.shed = 0

    def set_budget(self, tenant: str, rate: float,
                   burst: Optional[float] = None) -> None:
        with self._mu:
            self._buckets[tenant] = _Bucket(
                rate=rate, burst=burst if burst is not None else 2 * rate,
                level=burst if burst is not None else 2 * rate,
                last=time.monotonic())

    def charge(self, tenant: str, tokens: float) -> Tuple[bool, int]:
        now = time.monotonic()
        with self._mu:
            b = self._buckets.get(tenant)
            if b is None:
                if self.default_rate <= 0:
                    return True, 0
                burst = (self.default_burst if self.default_burst is not None
                         else 2 * self.default_rate)
                b = _Bucket(rate=self.default_rate, burst=burst, level=burst,
                            last=now)
                self._buckets[tenant] = b
            if b.rate <= 0:
                return True, 0
            b.level = min(b.burst, b.level + (now - b.last) * b.rate)
            b.last = now
            if b.level >= min(tokens, b.burst):
                # A cost above the burst cap admits once the bucket is full
                # and goes into debt, so the long-run rate holds and the
                # request stays admittable at all.
                b.level -= tokens
                return True, 0
            self.shed += 1
            # Until the bucket covers the request (full, for an oversized
            # one: the hint must be reachable).
            wait_s = (min(tokens, b.burst) - b.level) / b.rate
            return False, max(1, int(wait_s * 1000))
