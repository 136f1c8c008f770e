"""ctypes surface of the native RPC runtime, as far as the serving path
needs it: Server, Channel with bidirectional streams, the request batcher,
error codes, the flight recorder's stamps, the host-tier KV page store and
the metrics dump.

The C ABI is ``cpp/trpc/c_api.h``; the library is this package's own build
(``native.lib()``). Handlers and stream sinks run on native worker threads
and call back into Python, so they stay short.
"""

from __future__ import annotations

import ctypes
import json
import queue
import threading
import traceback
from typing import Optional

from brpc_tpu_torch import native

_STREAM_SINK = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_uint64,
                                ctypes.POINTER(ctypes.c_char),
                                ctypes.c_size_t)

_configured = False
_configure_mu = threading.Lock()


class BatchItem(ctypes.Structure):
    """Mirror of trpc_batch_item (c_api.h)."""
    _fields_ = [
        ("req_id", ctypes.c_ulonglong),
        ("data", ctypes.POINTER(ctypes.c_char)),
        ("len", ctypes.c_size_t),
        ("priority", ctypes.c_int),
        ("remaining_us", ctypes.c_longlong),
    ]


def _lib() -> ctypes.CDLL:
    global _configured
    lib = native.lib()
    with _configure_mu:
        if _configured:
            return lib
        c_char_pp = ctypes.POINTER(ctypes.POINTER(ctypes.c_char))
        lib.trpc_init.argtypes = [ctypes.c_int]
        lib.trpc_server_create.argtypes = []
        lib.trpc_server_create.restype = ctypes.c_void_p
        lib.trpc_server_start.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
        lib.trpc_server_stop.argtypes = [ctypes.c_void_p]
        lib.trpc_server_destroy.argtypes = [ctypes.c_void_p]
        lib.trpc_channel_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.trpc_channel_create.restype = ctypes.c_void_p
        lib.trpc_channel_destroy.argtypes = [ctypes.c_void_p]
        lib.trpc_buf_free.argtypes = [ctypes.POINTER(ctypes.c_char)]
        lib.trpc_app_counter_add.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong]
        lib.trpc_app_counter_add.restype = ctypes.c_longlong
        lib.trpc_stream_close.argtypes = [ctypes.c_uint64]
        lib.trpc_stream_open3.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t, _STREAM_SINK, ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_char_p,
            ctypes.c_size_t]
        lib.trpc_flight_stamp.argtypes = [ctypes.c_ulonglong, ctypes.c_int]
        lib.trpc_flight_route.argtypes = [ctypes.c_ulonglong, ctypes.c_uint]
        lib.trpc_flight_fetch.argtypes = [c_char_pp]
        lib.trpc_flight_fetch.restype = ctypes.c_size_t
        lib.trpc_batcher_create2.argtypes = [
            ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_char_p]
        lib.trpc_batcher_create2.restype = ctypes.c_void_p
        lib.trpc_batcher_add_method.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_int]
        lib.trpc_batcher_next_batch.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(BatchItem), ctypes.c_int,
            ctypes.c_longlong]
        lib.trpc_batcher_emit.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_char_p,
            ctypes.c_size_t]
        lib.trpc_batcher_finish.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_char_p]
        lib.trpc_batcher_note_occupancy.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong]
        lib.trpc_batcher_stop.argtypes = [ctypes.c_void_p]
        lib.trpc_batcher_destroy.argtypes = [ctypes.c_void_p]
        lib.trpc_batcher_stats.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.trpc_kv_host_configure.argtypes = [ctypes.c_longlong]
        lib.trpc_kv_host_put.argtypes = [
            ctypes.c_ulonglong, ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_kv_host_bytes.argtypes = [ctypes.c_ulonglong]
        lib.trpc_kv_host_bytes.restype = ctypes.c_longlong
        lib.trpc_kv_host_get.argtypes = [
            ctypes.c_ulonglong, ctypes.c_void_p, ctypes.c_size_t]
        lib.trpc_kv_host_drop.argtypes = [ctypes.c_ulonglong]
        lib.trpc_kv_tier_stats.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.trpc_kv_tier_note_fill.argtypes = [
            ctypes.c_longlong, ctypes.c_int]
        lib.trpc_dump_metrics.argtypes = [c_char_pp]
        lib.trpc_dump_metrics.restype = ctypes.c_size_t
        for fn in (lib.trpc_init, lib.trpc_server_start,
                   lib.trpc_server_stop, lib.trpc_stream_close,
                   lib.trpc_stream_open3, lib.trpc_flight_stamp,
                   lib.trpc_flight_route, lib.trpc_batcher_add_method,
                   lib.trpc_batcher_next_batch, lib.trpc_batcher_emit,
                   lib.trpc_batcher_finish, lib.trpc_batcher_note_occupancy,
                   lib.trpc_batcher_stop, lib.trpc_batcher_stats,
                   lib.trpc_kv_host_configure, lib.trpc_kv_host_put,
                   lib.trpc_kv_host_get, lib.trpc_kv_host_drop,
                   lib.trpc_kv_tier_stats):
            fn.restype = ctypes.c_int
        for fn in (lib.trpc_server_destroy, lib.trpc_channel_destroy,
                   lib.trpc_buf_free, lib.trpc_batcher_destroy,
                   lib.trpc_kv_tier_note_fill):
            fn.restype = None
        rc = lib.trpc_init(0)
        if rc != 0:
            raise OSError(rc, "trpc_init (fiber scheduler start) failed")
        _configured = True
    return lib


# Framework errno values (mirror cpp/trpc/rpc_errno.h).
ERPCTIMEDOUT = 1008    # deadline reached before a response
ENORESPONSE = 1010     # connection closed before response
ELIMIT = 1012          # concurrency limit rejected the request
ECLOSE = 1014          # connection closed by peer
EFAILEDSOCKET = 1015   # the socket was failed during the call
EREJECT = 1016         # request rejected outright (no retry)
EINTERNAL = 2001
EREQUEST = 2003
# OS errno values the transport also surfaces (Linux numbers).
ECONNRESET = 104
ENOTCONN = 107
ECONNREFUSED = 111
EHOSTDOWN = 112
EPIPE = 32
ECANCELED = 125

# Errors a caller may retry: transport failures where the request may never
# have reached a handler, plus deadline expiry (cpp/trpc/channel.cc's
# DefaultRetriableErrnos, with the application-level timeout added).
RETRIABLE_ERRNOS = frozenset({
    EFAILEDSOCKET, ECLOSE, ENORESPONSE, ECONNREFUSED, ECONNRESET, EPIPE,
    EHOSTDOWN, ENOTCONN, ERPCTIMEDOUT,
})


class RpcError(RuntimeError):
    """RPC failure: ``code`` (an RPC errno) + server ``text``."""

    def __init__(self, code: int, text: str):
        super().__init__(f"rpc failed (errno {code}): {text}")
        self.code = code
        self.text = text

    @property
    def retriable(self) -> bool:
        return self.code in RETRIABLE_ERRNOS


class Server:
    """An RPC server; the batcher registers its methods on it before
    ``start``."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.trpc_server_create()
        self.port: Optional[int] = None

    def start(self, port: int = 0) -> int:
        bound = ctypes.c_int(0)
        rc = self._lib.trpc_server_start(self._h, port, ctypes.byref(bound))
        if rc != 0:
            raise OSError(rc, "server start failed")
        self.port = bound.value
        return self.port

    def stop(self) -> None:
        if self._h:
            self._lib.trpc_server_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.trpc_server_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


class Channel:
    """Client stub to ``"ip:port"``; ``open_stream_rx`` opens the serving
    gateway's token-delivery stream."""

    def __init__(self, addr: str, timeout_ms: int = -1, max_retry: int = -1):
        self._lib = _lib()
        self._h = self._lib.trpc_channel_create(addr.encode(), b"",
                                                timeout_ms, max_retry)
        if not self._h:
            raise OSError(f"channel init failed for {addr!r}")

    def open_stream_rx(self, service: str, method: str,
                       request: bytes = b"") -> "ReadableStream":
        """Open a bidirectional stream: ``request`` rides the RPC body and
        the server pushes messages back, queued on the ReadableStream."""
        rs = ReadableStream(self._lib)
        sid = ctypes.c_uint64(0)
        tid = ctypes.c_ulonglong(0)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.trpc_stream_open3(
            self._h, service.encode(), method.encode(), request,
            len(request), rs._sink, None, ctypes.byref(sid),
            ctypes.byref(tid), err, len(err))
        rs.trace_id = tid.value
        if rc != 0:
            # The native side still delivers the final close callback,
            # which detaches the sink; detaching here would free it early.
            raise RpcError(rc, err.value.decode(errors="replace"))
        rs.id = sid.value
        return rs

    def close(self) -> None:
        if self._h:
            self._lib.trpc_channel_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ReadableStream:
    """Receive half of a stream opened by ``Channel.open_stream_rx``.

    ``read(timeout)`` pops one message (None once the stream closed and the
    queue drained). The sink trampoline stays registered until the native
    close callback, so dropping the object early frees nothing the native
    side still calls."""

    def __init__(self, lib):
        self._lib = lib
        self.id = 0
        self.trace_id = 0
        self._q = queue.Queue()
        self.closed = False

        @_STREAM_SINK
        def sink(_arg, sid, data_ptr, data_len):
            try:
                if not data_ptr:
                    self._q.put(None)
                    _rx_sinks.pop(id(self._sink), None)
                else:
                    self._q.put(ctypes.string_at(data_ptr, data_len))
            except Exception:  # noqa: BLE001 — can't cross ctypes boundary
                traceback.print_exc()

        self._sink = sink
        _rx_sinks[id(sink)] = sink

    def read(self, timeout: Optional[float] = None) -> Optional[bytes]:
        """Next message, or None once closed and drained; TimeoutError when
        ``timeout`` seconds pass first."""
        if self.closed and self._q.empty():
            return None
        try:
            msg = self._q.get(timeout=timeout)
        except queue.Empty:
            raise TimeoutError("no stream message within timeout") from None
        if msg is None:
            self.closed = True
        return msg

    def close(self) -> None:
        """Abandon the stream (the server observes a peer close)."""
        if self.id:
            self._lib.trpc_stream_close(self.id)


# Keeps rx-sink trampolines alive until their stream's close callback.
_rx_sinks: dict = {}


# Priority lanes of the serving batcher (mirror trpc::BatcherLane).
LANE_INTERACTIVE = 0
LANE_BATCH = 1

BATCHER_STAT_NAMES = (
    "queue_depth", "admitted", "rejected_limit", "culled_deadline",
    "culled_closed", "batches", "batched_requests", "emitted", "live",
    "occupancy_sum", "occupancy_samples",
)


class NativeBatcher:
    """The serving gateway's request scheduler (cpp/trpc/batcher.h):
    priority lanes, batches under ``max_batch_size`` OR
    ``max_queue_delay_us``, deadline culling of queued requests, and
    per-request partial results streamed back to the caller."""

    def __init__(self, max_batch_size: int = 8,
                 max_queue_delay_us: int = 2000, max_queue_len: int = 1024,
                 limiter: str = ""):
        self._lib = _lib()
        self._h = self._lib.trpc_batcher_create2(
            max_batch_size, max_queue_delay_us, max_queue_len,
            limiter.encode())
        if not self._h:
            raise OSError("batcher create failed")
        self.max_batch_size = max_batch_size

    def add_method(self, server: Server, service: str, method: str,
                   priority: int = LANE_INTERACTIVE) -> None:
        rc = self._lib.trpc_batcher_add_method(
            self._h, server._h, service.encode(), method.encode(), priority)
        if rc != 0:
            raise OSError(rc, "batcher add_method failed")

    def next_batch(self, max_items: Optional[int] = None,
                   wait_us: int = -1) -> Optional[list]:
        """[(req_id, payload, priority, remaining_us)]; [] when the wait
        budget is spent; None once stopped and drained."""
        n = max_items if max_items is not None else self.max_batch_size
        items = (BatchItem * max(n, 1))()
        got = self._lib.trpc_batcher_next_batch(self._h, items, n, wait_us)
        if got < 0:
            return None
        out = []
        for i in range(got):
            payload = (ctypes.string_at(items[i].data, items[i].len)
                       if items[i].len else b"")
            out.append((int(items[i].req_id), payload,
                        int(items[i].priority), int(items[i].remaining_us)))
        return out

    def emit(self, req_id: int, data: bytes) -> int:
        """Stream one partial result: 0, or an errno (ECLOSE once the
        client is gone)."""
        return self._lib.trpc_batcher_emit(self._h, req_id, data, len(data))

    def finish(self, req_id: int, status: int = 0,
               error_text: str = "") -> int:
        return self._lib.trpc_batcher_finish(
            self._h, req_id, status, error_text.encode()[:200])

    def note_occupancy(self, n: int) -> None:
        self._lib.trpc_batcher_note_occupancy(self._h, n)

    def stats(self) -> dict:
        buf = (ctypes.c_longlong * len(BATCHER_STAT_NAMES))()
        got = self._lib.trpc_batcher_stats(self._h, buf, len(buf))
        return dict(zip(BATCHER_STAT_NAMES[:got],
                        [int(v) for v in buf[:got]]))

    def stop(self) -> None:
        if self._h:
            self._lib.trpc_batcher_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.trpc_batcher_destroy(self._h)
            self._h = None


def app_counter_add(name: str, delta: int = 0) -> int:
    """Advance (or with ``delta`` 0, read) a process-wide application
    counter exposed beside the native metrics."""
    return int(_lib().trpc_app_counter_add(name.encode(), int(delta)))


def dump_metrics() -> str:
    """All native metrics (and the application counters) in Prometheus
    text format."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.trpc_dump_metrics(ctypes.byref(out))
    try:
        return ctypes.string_at(out, n).decode(errors="replace")
    finally:
        lib.trpc_buf_free(out)


def metrics() -> dict:
    """``dump_metrics()`` parsed into ``{name: float}``; labelled samples
    keep the label text in the key."""
    out = {}
    for line in dump_metrics().splitlines():
        if not line or line.startswith("#"):
            continue
        name, _, value = line.rpartition(" ")
        try:
            out[name] = float(value)
        except ValueError:
            continue
    return out


# ---- host-tier KV page store (cpp/trpc/kv_transfer.h "host tier") ----------

KV_TIER_STAT_NAMES = (
    "kv_tier_budget_bytes", "kv_tier_host_bytes", "kv_tier_host_pages",
    "kv_tier_spills", "kv_tier_fills", "kv_tier_peer_fills",
    "kv_tier_spill_bytes", "kv_tier_evictions", "kv_tier_misses",
    "kv_tier_pull_serves",
)


def kv_host_configure(budget_bytes: int = 0) -> None:
    """(Re)size the process-wide host page store; <= 0 keeps the current
    budget (env TRPC_KV_HOST_MB, default 64 MB)."""
    _lib().trpc_kv_host_configure(budget_bytes)


def kv_host_put(key: int, data) -> int:
    """Store one page's bytes (``bytes`` or a contiguous numpy array, read
    in place) under a 64-bit content key (idempotent per key, bounded
    LRU). 0, or an errno when not stored (ELIMIT: larger than the whole
    budget); callers treat nonzero as "not stored"."""
    if isinstance(data, bytes):
        return _lib().trpc_kv_host_put(key, data, len(data))
    import numpy as np

    arr = np.ascontiguousarray(data)
    return _lib().trpc_kv_host_put(
        key, ctypes.cast(arr.ctypes.data, ctypes.c_char_p), arr.nbytes)


def kv_host_has(key: int) -> bool:
    """Whether the store holds ``key`` (no LRU touch)."""
    return _lib().trpc_kv_host_bytes(key) >= 0


def kv_host_entry_bytes(key: int) -> int:
    """Size of the entry under ``key``, -1 when absent (no LRU touch)."""
    return _lib().trpc_kv_host_bytes(key)


def kv_host_get(key: int):
    """The page bytes under ``key`` as a numpy uint8 array, or None when
    the store no longer holds it."""
    import numpy as np

    lib = _lib()
    n = lib.trpc_kv_host_bytes(key)
    if n < 0:
        return None
    out = np.empty(n, dtype=np.uint8)
    if lib.trpc_kv_host_get(key, out.ctypes.data_as(ctypes.c_void_p), n):
        return None
    return out


def kv_host_drop(key: int) -> bool:
    """Drop one entry; True when it existed."""
    return _lib().trpc_kv_host_drop(key) == 0


def kv_tier_stats() -> dict:
    """Host-tier occupancy and spill/fill counters, ``{name: int}`` (also
    on /vars and the metrics dump as kv_tier_* gauges)."""
    buf = (ctypes.c_longlong * len(KV_TIER_STAT_NAMES))()
    n = _lib().trpc_kv_tier_stats(buf, len(buf))
    return dict(zip(KV_TIER_STAT_NAMES[:n], [int(v) for v in buf[:n]]))


def kv_tier_note_fill(fill_us: int, peer: bool = False) -> None:
    """Feed the kv_tier_fill_us recorder (and, with ``peer``, the peer-fill
    counter) with one fill's wall time."""
    _lib().trpc_kv_tier_note_fill(int(fill_us), 1 if peer else 0)


# ---- flight recorder (cpp/trpc/flight.h) -----------------------------------

# Phase indices (mirror trpc::FlightPhase).
FLIGHT_ADMIT = 0
FLIGHT_BATCH_FORMED = 1
FLIGHT_PREFILL_START = 2
FLIGHT_PREFILL_DONE = 3
FLIGHT_KV_TRANSFER = 4
FLIGHT_FIRST_EMIT = 5
FLIGHT_REDISPATCH = 6
FLIGHT_END = 7

# Route classification bits (mirror trpc::FlightRoute).
ROUTE_HBM_HIT = 1
ROUTE_HOST_FILL = 2
ROUTE_PEER_PULL = 4
ROUTE_SPLICE = 8
ROUTE_DISAGG = 16
ROUTE_REDISPATCH = 32
ROUTE_DEGRADED = 64
ROUTE_DRAIN = 128

# SLO-tier byte (mirror trpc::FlightTier).
TIER_NONE = 0
TIER_INTERACTIVE = 1
TIER_STANDARD = 2
TIER_BATCH = 3


def flight_stamp(req_id: int, phase: int) -> None:
    """Stamp ``phase`` (a FLIGHT_* index) on ``req_id``'s record now;
    unknown or finished ids are ignored."""
    _lib().trpc_flight_stamp(req_id, phase)


def flight_route(req_id: int, bits: int) -> None:
    """OR ROUTE_* bits into ``req_id``'s record."""
    _lib().trpc_flight_route(req_id, bits)


def flight_records(max_items: int = 4096, oldest_first: bool = True) -> list:
    """Finished flight records as dicts (``ttft_us``, phase stamps such as
    ``admit_us``/``first_emit_us``, ``route``, ``status``, ``tokens``)."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.trpc_flight_fetch(ctypes.byref(out))
    try:
        recs = json.loads(ctypes.string_at(out, n).decode(errors="replace"))
    finally:
        lib.trpc_buf_free(out)
    if oldest_first:
        recs.reverse()
    return recs[-max_items:] if oldest_first else recs[:max_items]
