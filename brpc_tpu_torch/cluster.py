"""The fleet's control plane, the counterpart of brpc_tpu/cluster.py: the
lease registry's Python face and per-tenant token budgets.

The native registry (``cpp/trpc/cluster.{h,cc}``, attached to a server by
``runtime.Server.add_registry``) is the fleet's source of truth. Workers
register with a role, capacity and TTL lease and renew it with heartbeats
that carry their live load; a lease that is not renewed expires, so a
SIGKILLed worker leaves every subscriber's view within one TTL. The
registry may be replicated and persistent: clients take every replica's
address ("a:p,b:p,c:p"); reads (list, watch) go to any replica, writes
(register, renew, leave) to the leader, and a follower answers ENOTLEADER
naming it. While the whole control plane is unreachable the data plane is
statically stable: a watcher keeps the last member set, flagged stale.

  Registry           one registry server (runtime.Server + registry),
                     optionally persistent (wal_path) or replicated (peers)
  RegistryCluster    N replicas as subprocesses (each with its own WAL)
                     sharing one endpoint list; kill and restart them
  WorkerLease        a worker's register + heartbeat loop: jittered
                     renews, leader failover, re-registers on ENOLEASE,
                     surfaces role advice; tracks the worst renew gap
  MembershipWatcher  longpoll Cluster.watch loop feeding a callback with
                     fresh members and loads; rotates replicas, flags the
                     set stale during a full outage
  Member             one worker as the registry publishes it (and as the
                     router's pick reads it; static lists fill only addr)
  TenantGovernor     per-tenant token budgets with retry-after hints

A replica subprocess (``_REGISTRY_SRC``) imports only this module and
``runtime``: no torch, no device.

Wire (text, space-separated; ``AttachRegistryService`` in cluster.cc):
  Cluster.register  "role addr capacity ttl_ms"       -> "lease_id index"
  Cluster.renew     "lease_id qd kv occ_x100 ttft_us [pfx=...] [pg=...]
                     [sr=n:v|n:v] [st=state] [md=model] [ts=wall_ms]"
                                                      -> "ok [advice_role]"
  Cluster.leave     "lease_id"                        -> "ok"
  Cluster.list      "[role]"                          -> member body
  Cluster.watch     "last_index hold_ms [role]"       -> member body (held)
Member body: "index\naddr role=R w=C qd=N kv=N occ=N ttft=N hb=N [pfx=...]
             [pg=...] [st=...] [md=...]\n..." (hb= counts heartbeats under
the current lease: 0 = no live load sample yet, which the router's
readiness gate holds back.)
"""

from __future__ import annotations

import os
import random
import re
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from brpc_tpu_torch import runtime

SERVICE = "Cluster"

_LEADER_HINT_RE = re.compile(r"leader=(\S+)")


def parse_leader_hint(text: str) -> Optional[str]:
    """The leader's address out of an ENOTLEADER error text, if named."""
    m = _LEADER_HINT_RE.search(text)
    if m is None or m.group(1) == "?":
        return None
    return m.group(1)


@dataclass
class Member:
    """One live worker, with the fields the router's pick reads."""
    addr: str
    role: str = ""
    capacity: int = 1
    queue_depth: int = 0
    kv_pages_in_use: int = 0
    occupancy_x100: int = 0
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

    @property
    def load_per_capacity(self) -> float:
        return self.queue_depth / max(self.capacity, 1)

    def holds_prefix(self, key: str) -> bool:
        return bool(key) and key in self.prefix_digest.split(",")

    def holds_page(self, key: str) -> bool:
        return bool(key) and key in self.page_digest.split(",")


_MEMBER_INT_FIELDS = {"w": "capacity", "qd": "queue_depth",
                      "kv": "kv_pages_in_use", "occ": "occupancy_x100",
                      "ttft": "p99_ttft_us", "hb": "heartbeats"}
_MEMBER_STR_FIELDS = {"role": "role", "pfx": "prefix_digest",
                      "pg": "page_digest", "st": "state", "md": "model"}


def parse_members(body: str) -> Tuple[int, List[Member]]:
    """A Cluster.list/watch body -> (index, members)."""
    lines = body.splitlines()
    if not lines:
        raise ValueError("empty membership body")
    index = int(lines[0].split()[0])
    members = []
    for line in lines[1:]:
        parts = line.split()
        if not parts:
            continue
        m = Member(addr=parts[0])
        for tok in parts[1:]:
            k, eq, v = tok.partition("=")
            if not eq:
                continue
            if k in _MEMBER_INT_FIELDS:
                setattr(m, _MEMBER_INT_FIELDS[k], int(v))
            elif k in _MEMBER_STR_FIELDS:
                setattr(m, _MEMBER_STR_FIELDS[k], v)
        members.append(m)
    return index, members


class Registry:
    """One registry server: a runtime.Server with the lease registry
    attached. ``wal_path`` makes it persistent; ``self_addr``/``peers``
    make it one replica of a replicated registry (``RegistryCluster`` is
    the multi-process version)."""

    def __init__(self, port: int = 0, default_ttl_ms: int = 3000, *,
                 wal_path: str = "", self_addr: str = "", peers: str = ""):
        self.server = runtime.Server()
        self.server.add_registry(default_ttl_ms, wal_path=wal_path,
                                 self_addr=self_addr, peers=peers)
        self.port = self.server.start(port)
        self.addr = self_addr or f"127.0.0.1:{self.port}"

    def counts(self) -> dict:
        return self.server.registry_counts()

    def close(self) -> None:
        self.server.stop()
        self.server.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class _Endpoints:
    """Client-side endpoint failover for the replicated registry: one
    channel to the current endpoint. ``call`` follows ENOTLEADER redirects
    (the error text names the leader), rotates to the next replica on a
    transport failure, and paces re-dials with a capped, jittered
    exponential backoff, so a dead control plane costs one dial per
    backoff step. One loop thread owns it, plus ``close`` from the
    owner."""

    BACKOFF_BASE_S = 0.1
    BACKOFF_MAX_S = 5.0

    def __init__(self, addrs: str, timeout_ms: int,
                 backoff_max_s: float = BACKOFF_MAX_S):
        self.addrs = [a.strip() for a in addrs.split(",") if a.strip()]
        if not self.addrs:
            raise ValueError("empty registry endpoint list")
        self.timeout_ms = timeout_ms
        self.backoff_max_s = backoff_max_s
        self.ix = 0
        self.reconnects = 0          # endpoint rotations / re-dials
        self._backoff_s = self.BACKOFF_BASE_S
        self._mu = threading.Lock()
        self._ch: Optional[runtime.Channel] = None

    @property
    def current(self) -> str:
        return self.addrs[self.ix % len(self.addrs)]

    def _channel(self) -> runtime.Channel:
        with self._mu:
            if self._ch is None:
                # No channel retries: call() fails over itself.
                self._ch = runtime.Channel(self.current,
                                           timeout_ms=self.timeout_ms,
                                           max_retry=0)
            return self._ch

    def _switch(self, target: Optional[str]) -> None:
        with self._mu:
            ch, self._ch = self._ch, None
            if target is not None and target in self.addrs:
                self.ix = self.addrs.index(target)
            else:
                self.ix = (self.ix + 1) % len(self.addrs)
            self.reconnects += 1
        if ch is not None:
            ch.close()

    def backoff(self, wait: Callable[[float], bool]) -> None:
        """Sleep one jittered backoff step through ``wait`` (an Event.wait,
        so close() interrupts it) and double the next step, capped."""
        wait(self._backoff_s * random.uniform(0.75, 1.25))
        self._backoff_s = min(self._backoff_s * 2, self.backoff_max_s)

    def reset_backoff(self) -> None:
        self._backoff_s = self.BACKOFF_BASE_S

    def call(self, method: str, req: bytes, *,
             wait: Optional[Callable[[float], bool]] = None,
             hops: Optional[int] = None) -> bytes:
        """One registry op with leader redirects and endpoint rotation.

        Business errors (ENOLEASE, EREQUEST, ...) surface at once; only
        ENOTLEADER and transport failures fail over. The attempt budget is
        one rotation plus two redirect hops; a longer outage surfaces the
        last error (the renew and watch loops retry, each with its own
        backoff)."""
        if wait is None:
            wait = lambda s: time.sleep(s) or False  # noqa: E731
        budget = hops if hops is not None else len(self.addrs) + 2
        last: Optional[Exception] = None
        for _ in range(budget):
            try:
                rsp = self._channel().call(SERVICE, method, req)
                self.reset_backoff()
                return rsp
            except runtime.RpcError as e:
                if e.code == runtime.ENOTLEADER:
                    # A fresh hint goes straight to the leader; a stale or
                    # absent one rotates.
                    last = e
                    self._switch(parse_leader_hint(e.text))
                    continue
                if e.code not in runtime.RETRIABLE_ERRNOS:
                    # ENOLEASE is the re-register trigger: it must not sit
                    # out a rotation of backoffs first.
                    raise
                last = e
                self._switch(None)
                self.backoff(wait)
            except OSError as e:  # channel init failed (endpoint dead)
                last = e
                self._switch(None)
                self.backoff(wait)
        assert last is not None
        raise last

    def close(self) -> None:
        with self._mu:
            ch, self._ch = self._ch, None
        if ch is not None:
            ch.close()

    def leak(self) -> None:
        """Abandon the channel without destroying it (a native call may
        still be in flight on a wedged loop thread)."""
        with self._mu:
            self._ch = None


_counter_mu = threading.Lock()  # the app counters are process-wide


def _raise_counter(name: str, value: int) -> None:
    """Raise the process-wide app counter ``name`` to ``value`` if it is
    below (a maximum kept in an add-only counter)."""
    with _counter_mu:
        cur = runtime.app_counter_add(name)
        if value > cur:
            runtime.app_counter_add(name, value - cur)


class WorkerLease:
    """A worker's registration and heartbeat loop.

    ``registry_addr`` may name several replicas: writes follow the leader,
    connect failures rotate endpoints with jittered backoff. ``load_fn()``
    returns the live load folded into each renew (``queue_depth``,
    ``kv_pages_in_use``, ``occupancy_x100``, ``p99_ttft_us``, the
    ``prefix_digest`` / ``page_digest``, the ``series`` tail, ``state``,
    ``model``; missing keys report 0 or nothing). Renews run every
    ``ttl_ms / 3`` with +-20% jitter. Under the loop, ``load_fn`` runs on
    a sampler thread of its own: a renew asks it for a fresh sample and
    waits at most ``LOAD_WAIT`` of the TTL, else folds in the newest
    finished one, so a slow ``load_fn`` (a busy worker's batcher, metrics
    and digests) cannot hold a heartbeat back toward an expel. Driven by
    hand (``autostart=False``), ``renew_once`` calls ``load_fn`` inline.
    A renew answered with ENOLEASE (the
    lease lapsed, the registry restarted or failed over past the last
    committed renew) re-registers under a fresh lease. Role advice lands
    in ``.advice`` and fires ``on_advice(role)`` once per suggestion.

    ``worst`` holds the longest ``renew_gap`` between two successful
    renews (the first measured from the register), and the three parts a
    slow renew can come from: ``wake_late`` (the loop thread woke this
    much past its period: the GIL or the host held it), ``load_wait``
    (the renew waiting for its load sample) and ``rpc`` (the renew call);
    and ``load``, the time in ``load_fn`` itself. A gap near
    ``ttl_ms`` risks an expel. The process's app counters
    ``cluster_lease_renews``, ``cluster_lease_re_registers``,
    ``cluster_lease_failovers`` and ``cluster_lease_<part>_max_us`` (the
    worst over its leases) publish them on its servers' /vars."""

    RENEW_JITTER = 0.2
    LOAD_WAIT = 1 / 30  # of ttl_ms: 50 ms at the fleet's 1500 ms

    def __init__(self, registry_addr: str, role: str, addr: str, *,
                 capacity: int = 1, ttl_ms: int = 2000,
                 load_fn: Optional[Callable[[], dict]] = None,
                 on_advice: Optional[Callable[[str], None]] = None,
                 autostart: bool = True):
        self.registry_addr = registry_addr
        self.role = role
        self.addr = addr
        self.capacity = capacity
        self.ttl_ms = ttl_ms
        self.load_fn = load_fn
        self.on_advice = on_advice
        self.advice: str = ""
        self.lease_id = 0
        self.renews = 0
        self.re_registers = 0
        self.role_flips = 0
        self.worst = {"renew_gap": 0.0, "wake_late": 0.0,
                      "load_wait": 0.0, "rpc": 0.0, "load": 0.0}
        self._last_ok: Optional[float] = None
        self._published = {"renews": 0, "re_registers": 0, "failovers": 0}
        # The renew loop and a flip's set_role (the runner's thread) both
        # update the maxima and the published counters.
        self._note_mu = threading.Lock()
        # Short backoff cap: the ttl/3 renew loop paces the long haul, and
        # a recovering registry's grace window is one TTL.
        self._eps = _Endpoints(registry_addr, timeout_ms=2000,
                               backoff_max_s=min(1.0,
                                                 max(ttl_ms / 3000.0, 0.2)))
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # The sampler's newest finished load_fn() result; a renew sets
        # _want_sample and waits on _sampled.
        self._sample: dict = {}
        self._want_sample = threading.Event()
        self._sampled = threading.Event()
        self._sampler: Optional[threading.Thread] = None
        self.register()
        if autostart:
            self.start()

    @property
    def failovers(self) -> int:
        """Registry endpoint switches this lease has made."""
        return self._eps.reconnects

    def register(self) -> int:
        req = f"{self.role} {self.addr} {self.capacity} {self.ttl_ms}"
        rsp = self._eps.call("register", req.encode(), wait=self._stop.wait)
        self.lease_id = int(rsp.split()[0])
        # The role this lease was granted under: renew_once re-registers
        # when self.role has moved past it (a set_role whose register
        # failed mid-flip converges on the next heartbeat).
        self._registered_role = self.role
        self._note_ok()
        return self.lease_id

    def set_role(self, role: str) -> int:
        """Re-register under a new role, the last step of a role flip.
        The registry replaces by address, so subscribers see one atomic
        change; the fresh lease starts at hb=0, so routers hold traffic
        until a heartbeat under the new role lands. Clears the advice."""
        self.role = role
        self.advice = ""
        self.role_flips += 1
        return self.register()

    def _note(self, part: str, seconds: float) -> None:
        with self._note_mu:
            self.worst[part] = max(self.worst[part], seconds)

    def _note_ok(self) -> None:
        now = time.monotonic()
        with self._note_mu:
            if self._last_ok is not None:
                self.worst["renew_gap"] = max(self.worst["renew_gap"],
                                              now - self._last_ok)
            self._last_ok = now
            try:
                for name, val in (("renews", self.renews),
                                  ("re_registers", self.re_registers),
                                  ("failovers", self.failovers)):
                    runtime.app_counter_add(f"cluster_lease_{name}",
                                            val - self._published[name])
                    self._published[name] = val
                for part, sec in self.worst.items():
                    _raise_counter(f"cluster_lease_{part}_max_us",
                                   int(sec * 1e6))
            except Exception:  # noqa: BLE001 — the counters are best-effort
                pass

    def renew_once(self) -> None:
        if self.role != getattr(self, "_registered_role", self.role):
            # A flip whose re-register failed: renewing the old lease
            # would advertise the old role forever.
            self.register()
            self.re_registers += 1
            return
        load = self._load_sample()
        req = "{} {} {} {} {}".format(
            self.lease_id,
            int(load.get("queue_depth", 0)),
            int(load.get("kv_pages_in_use", 0)),
            int(load.get("occupancy_x100", 0)),
            int(load.get("p99_ttft_us", 0)))
        for key, tag in (("prefix_digest", "pfx"), ("page_digest", "pg"),
                         ("series", "sr"), ("state", "st")):
            val = load.get(key, "")
            if val:
                req += f" {tag}={val}"
        model = load.get("model", "")
        if model and not any(c.isspace() for c in model):
            req += f" md={model}"
        # The wall clock rides along for observability only: leases expire
        # on the registry's own monotonic clock.
        req += f" ts={int(time.time() * 1000)}"
        t0 = time.monotonic()
        try:
            rsp = self._eps.call("renew", req.encode(),
                                 wait=self._stop.wait).decode()
            self._note("rpc", time.monotonic() - t0)
        except runtime.RpcError as e:
            if e.code != runtime.ENOLEASE:
                raise
            # The lease lapsed under us: the worker is alive, so take a
            # fresh one (replace by address: no flap).
            self.register()
            self.re_registers += 1
            return
        self.renews += 1
        self._note_ok()
        parts = rsp.split()
        advice = parts[1] if len(parts) > 1 else ""
        if advice and advice != self.advice and self.on_advice is not None:
            self.on_advice(advice)
        self.advice = advice

    def _take_sample(self) -> dict:
        t0 = time.monotonic()
        try:
            self._sample = self.load_fn()
        finally:
            self._note("load", time.monotonic() - t0)
        return self._sample

    def _load_sample(self) -> dict:
        """The load to fold into a renew: inline without the sampler,
        else a fresh sample if it lands within LOAD_WAIT of the TTL, or
        the newest finished one."""
        if self.load_fn is None:
            return {}
        if self._sampler is None:
            return self._take_sample()
        t0 = time.monotonic()
        self._sampled.clear()
        self._want_sample.set()
        self._sampled.wait(self.ttl_ms * self.LOAD_WAIT / 1000.0)
        self._note("load_wait", time.monotonic() - t0)
        return self._sample

    def _sample_loop(self) -> None:
        while True:
            self._want_sample.wait()
            if self._stop.is_set():
                return
            self._want_sample.clear()
            try:
                self._take_sample()
            except Exception:  # noqa: BLE001 — renews keep the last sample
                pass
            self._sampled.set()

    def next_period_s(self) -> float:
        """The next heartbeat delay: ttl/3 with +-20% jitter."""
        base = max(self.ttl_ms / 3000.0, 0.05)
        return base * random.uniform(1.0 - self.RENEW_JITTER,
                                     1.0 + self.RENEW_JITTER)

    def start(self) -> None:
        if self._thread is not None:
            return
        if self.load_fn is not None:
            self._sampler = threading.Thread(
                target=self._sample_loop, daemon=True,
                name=f"lease-load-{self.role}")
            self._want_sample.set()  # the first renew's sample, early
            self._sampler.start()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"lease-{self.role}")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            period = self.next_period_s()
            t0 = time.monotonic()
            if self._stop.wait(period):
                return
            self._note("wake_late", time.monotonic() - t0 - period)
            try:
                self.renew_once()
            except Exception:  # noqa: BLE001 — registry briefly down: the
                pass           # lease survives ttl_ms of missed renews

    def close(self) -> None:
        self._stop.set()
        self._want_sample.set()  # the sampler sees _stop and returns
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=5)
            if thread.is_alive():
                # Still inside a native call (registry wedged): leak the
                # channel rather than destroy it under the call; expiry
                # expels us anyway.
                self._eps.leak()
                return
        if self._sampler is not None:
            self._sampler.join(timeout=5)  # inside load_fn at worst
        try:
            if self.lease_id:
                self._eps.call("leave", str(self.lease_id).encode(), hops=2)
        except Exception:  # noqa: BLE001 — expiry will expel us anyway
            pass
        self._eps.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class MembershipWatcher:
    """Longpoll watch loop: ``callback(members)`` fires with every watch
    response, so membership changes arrive with push latency and loads
    refresh at least every ``hold_ms``.

    Any replica serves a watch; a failed one rotates endpoints under
    capped, jittered backoff (``reconnects``). While the whole control
    plane is unreachable the last member set stays in force: after
    ``stale_after`` consecutive failures ``stale`` flips and
    ``on_stale(True)`` fires once; the next fresh watch fires
    ``on_stale(False)``.

    With ``fence_collectives`` the watcher is the collective plane's
    out-of-band death signal: whenever a fresh watch shows a member seen
    before gone (its lease expired or it left), the process's collective
    membership epoch is bumped (``runtime.coll_epoch_bump``), so frames of
    collectives planned over the old membership are fenced at every sink.
    ``fences`` counts the bumps."""

    def __init__(self, registry_addr: str, role: str,
                 callback: Callable[[List[Member]], None], *,
                 hold_ms: int = 1000, stale_after: int = 2,
                 on_stale: Optional[Callable[[bool], None]] = None,
                 fence_collectives: bool = False,
                 autostart: bool = True):
        self.registry_addr = registry_addr
        self.role = role
        self.callback = callback
        self.hold_ms = hold_ms
        self.stale_after = stale_after
        self.on_stale = on_stale
        self.index = 0
        self.updates = 0
        self.stale = False
        self.fence_collectives = fence_collectives
        self.fences = 0
        self._known_names: set = set()
        self.last_members: List[Member] = []
        self._failures = 0
        self._last_reconnects = 0
        self._eps = _Endpoints(registry_addr, timeout_ms=hold_ms + 5000)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        if autostart:
            self.start()

    @property
    def reconnects(self) -> int:
        return self._eps.reconnects

    def poll_once(self, hold_ms: Optional[int] = None) -> List[Member]:
        if self._eps.reconnects != self._last_reconnects:
            # Another replica answers now, with its own index space: index
            # 0 returns its full body at once.
            self._last_reconnects = self._eps.reconnects
            self.index = 0
        req = "{} {}{}".format(self.index,
                               self.hold_ms if hold_ms is None else hold_ms,
                               f" {self.role}" if self.role else "")
        try:
            # hops=1: the loop is the retry, one backoff step a failure.
            body = self._eps.call("watch", req.encode(), hops=1,
                                  wait=self._stop.wait).decode()
        except Exception:
            self._failures += 1
            if self._failures == self.stale_after:
                # Frozen, not cleared: the data plane keeps serving on the
                # last-known set.
                self.stale = True
                if self.on_stale is not None:
                    self.on_stale(True)
            raise
        self._failures = 0
        index, members = parse_members(body)
        self.index = index
        self.updates += 1
        self.last_members = members
        if self.fence_collectives:
            names = {m.addr for m in members}
            if self._known_names - names:  # someone we knew is gone
                runtime.coll_epoch_bump()
                self.fences += 1
            self._known_names = names
        if self.stale:
            self.stale = False
            if self.on_stale is not None:
                self.on_stale(False)
        self.callback(members)
        return members

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name=f"watch-{self.role or 'all'}")
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — registry briefly down: keep
                # the last membership. Transport failures already slept a
                # backoff step; business errors (a wrong address, a
                # malformed body) are paced here.
                self._stop.wait(0.5)

    def close(self) -> None:
        self._stop.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            # The thread may be parked in a held watch: wait out the hold
            # and the channel's slack before touching the channel.
            thread.join(timeout=self.hold_ms / 1000 + 6)
            if thread.is_alive():
                self._eps.leak()
                return
        self._eps.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---- replicated registry as subprocesses ------------------------------------

_REGISTRY_SRC = """
import sys
from brpc_tpu_torch import cluster
cluster._registry_main(sys.argv[1:])
"""


def _registry_main(argv: List[str]) -> None:
    """Subprocess entry of one registry replica: --port N --ttl MS
    [--wal PATH] [--self ADDR] [--peers A,B,C]. Prints "READY <port>" and
    serves until stdin closes (the parent holds the pipe)."""
    import sys
    args = dict(zip(argv[::2], argv[1::2]))
    srv = runtime.Server()
    srv.add_registry(int(args.get("--ttl", "3000")),
                     wal_path=args.get("--wal", ""),
                     self_addr=args.get("--self", ""),
                     peers=args.get("--peers", ""))
    port = srv.start(int(args.get("--port", "0")))
    print(f"READY {port}", flush=True)
    try:
        while sys.stdin.read(1):
            pass
    except KeyboardInterrupt:
        pass
    srv.stop()
    srv.close()


class RegistryCluster:
    """N replicas of the persistent lease registry as subprocesses, each
    with its own WAL under ``wal_dir``. ``addr`` is the comma-separated
    endpoint list WorkerLease, MembershipWatcher, DisaggRouter and
    ``registry://`` channels take. ``kill(i)`` SIGKILLs a replica (a pod
    OOM: nothing cleans up), ``restart(i)`` respawns it on its port from
    its WAL, ``leader_index()`` polls the replicas' /vars. A replica
    imports neither torch nor anything that would touch a device."""

    def __init__(self, n: int = 3, default_ttl_ms: int = 3000, *,
                 wal_dir: Optional[str] = None):
        import socket
        import tempfile

        self.n = n
        self.default_ttl_ms = default_ttl_ms
        self._tmp = None
        if wal_dir is None:
            self._tmp = tempfile.TemporaryDirectory(prefix="brpc-registry-")
            wal_dir = self._tmp.name
        self.wal_dir = wal_dir
        # Fixed ports: every replica must know the whole peer list before
        # any of them starts.
        self.ports: List[int] = []
        socks = []
        for _ in range(n):
            s = socket.socket()
            s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            s.bind(("127.0.0.1", 0))
            self.ports.append(s.getsockname()[1])
            socks.append(s)
        for s in socks:
            s.close()
        self.addrs = [f"127.0.0.1:{p}" for p in self.ports]
        self.addr = ",".join(self.addrs)
        self.procs: List = [None] * n
        try:
            for i in range(n):
                self._spawn(i)
        except BaseException:
            self.close()
            raise

    def _spawn(self, i: int) -> None:
        import subprocess
        import sys

        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        p = subprocess.Popen(
            [sys.executable, "-c", _REGISTRY_SRC,
             "--port", str(self.ports[i]),
             "--ttl", str(self.default_ttl_ms),
             "--wal", os.path.join(self.wal_dir, f"replica{i}.wal"),
             "--self", self.addrs[i],
             "--peers", self.addr],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True,
            cwd=repo)
        self.procs[i] = p  # close() reaps it whatever happens next
        line = p.stdout.readline().strip()
        if not line.startswith("READY "):
            raise RuntimeError(f"registry replica {i} failed: {line!r}")

    def counts(self, i: int) -> dict:
        """Replica i's cluster_* gauges off its /vars page ("cluster_"
        and "cluster_registry_" stripped: members, registers, renews,
        lease_expels, role, term, commit_index, failovers, grace_holds,
        advices, ...)."""
        vals = runtime.http_vars(self.addrs[i], "cluster_")
        return {k.replace("cluster_registry_", "").replace("cluster_", ""):
                int(v) for k, v in vals.items()}

    def live(self) -> List[int]:
        """Indices of the replicas whose process runs."""
        return [i for i, p in enumerate(self.procs)
                if p is not None and p.poll() is None]

    def leader_index(self, timeout_s: float = 10.0) -> Optional[int]:
        """Poll until exactly one live replica reports the leader role."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            leaders = []
            for i in self.live():
                try:
                    if self.counts(i).get("role") == 1:
                        leaders.append(i)
                except Exception:  # noqa: BLE001 — replica mid-start/dead
                    continue
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.1)
        return None

    def kill(self, i: int) -> None:
        """SIGKILL replica i (no cleanup)."""
        p = self.procs[i]
        if p is not None:
            p.kill()
            p.wait(timeout=10)

    def kill_leader(self, timeout_s: float = 10.0) -> int:
        li = self.leader_index(timeout_s)
        if li is None:
            raise RuntimeError("no stable registry leader to kill")
        self.kill(li)
        return li

    def kill_all(self) -> None:
        for i in range(self.n):
            self.kill(i)

    def restart(self, i: int) -> None:
        """Respawn replica i on its port from its WAL."""
        p = self.procs[i]
        if p is not None and p.poll() is None:
            raise RuntimeError(f"replica {i} is still running")
        if p is not None:
            p.stdin.close()
            p.stdout.close()
        self._spawn(i)

    def close(self) -> None:
        for p in self.procs:
            if p is None:
                continue
            try:
                p.kill()
                p.wait(timeout=10)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                pass
            for f in (p.stdin, p.stdout):
                f.close()
        self.procs = [None] * self.n
        if self._tmp is not None:
            self._tmp.cleanup()
            self._tmp = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
