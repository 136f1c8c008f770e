"""ctypes surface of the native RPC runtime, the reference runtime's whole
surface: Server (unary handlers, stream sinks, TLS, TCP or the device
fabric, the lease registry, the ``__rd`` redistribute service), Channel
(unary calls, a retry policy, TLS, naming urls with a load balancer),
writable and bidirectional streams, the fan-out ParallelChannel with its
progressive gather and the wire-integrity rail, the collective
observatory's records, link stats and schedule advisor, the membership
epoch, the redistribute shard table, fault injection, the process's
framed-protocol body cap, the request batcher, error codes, the flight
recorder, rpcz tracing, the KV transfer of disaggregated serving
(layer-wise sender, receive pool, claim), the host-tier KV page store with
the peer page pull, and the metrics dump.

The C ABI is ``cpp/trpc/c_api.h``; the library is this package's own build
(``native.lib()``). Handlers and stream sinks run on native worker threads
and call back into Python, so they stay short.
"""

from __future__ import annotations

import ctypes
import json
import queue
import re
import threading
import time
import traceback
from typing import Callable, List, Optional, Sequence

from brpc_tpu_torch import native

_HANDLER = ctypes.CFUNCTYPE(None, ctypes.c_void_p, ctypes.c_void_p,
                            ctypes.POINTER(ctypes.c_char), ctypes.c_size_t)
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
        lib.trpc_server_add_method.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, _HANDLER,
            ctypes.c_void_p]
        lib.trpc_call_respond.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t, ctypes.c_int,
            ctypes.c_char_p]
        lib.trpc_call_remaining_us.argtypes = [ctypes.c_void_p]
        lib.trpc_call_remaining_us.restype = ctypes.c_longlong
        lib.trpc_call.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t, c_char_pp,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
            ctypes.c_size_t]
        lib.trpc_channel_create.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int]
        lib.trpc_channel_create.restype = ctypes.c_void_p
        lib.trpc_channel_create_ex.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.trpc_channel_create_ex.restype = ctypes.c_void_p
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
        lib.trpc_flight_tier.argtypes = [ctypes.c_ulonglong, ctypes.c_uint]
        lib.trpc_flight_note.argtypes = [ctypes.c_ulonglong, ctypes.c_char_p]
        lib.trpc_flight_note_once.argtypes = [
            ctypes.c_ulonglong, ctypes.c_char_p]
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
        lib.trpc_kv_pool_configure.argtypes = [
            ctypes.c_longlong, ctypes.c_int]
        lib.trpc_kv_send_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_int]
        lib.trpc_kv_send_begin.restype = ctypes.c_void_p
        lib.trpc_kv_send_layer.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_kv_send_commit.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_kv_send_abort.argtypes = [ctypes.c_void_p]
        lib.trpc_kv_send_abort.restype = None
        lib.trpc_kv_recv_claim.argtypes = [
            ctypes.c_ulonglong, ctypes.c_longlong,
            ctypes.POINTER(ctypes.c_int)]
        lib.trpc_kv_recv_layer_bytes.argtypes = [
            ctypes.c_ulonglong, ctypes.c_int]
        lib.trpc_kv_recv_layer_bytes.restype = ctypes.c_longlong
        lib.trpc_kv_recv_copy_layer.argtypes = [
            ctypes.c_ulonglong, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_size_t]
        lib.trpc_kv_recv_release.argtypes = [ctypes.c_ulonglong]
        lib.trpc_kv_abort.argtypes = [ctypes.c_void_p, ctypes.c_ulonglong]
        lib.trpc_kv_stats.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.trpc_kv_pull.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, ctypes.c_void_p,
            ctypes.c_size_t, ctypes.POINTER(ctypes.c_longlong)]
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
        lib.trpc_server_start_device.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
        lib.trpc_pchan_create5.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_int, ctypes.c_longlong]
        lib.trpc_pchan_create5.restype = ctypes.c_void_p
        lib.trpc_pchan_add.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        lib.trpc_pchan_call.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t, c_char_pp,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
            ctypes.c_size_t]
        lib.trpc_pchan_call_ranks.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t, c_char_pp,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int),
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_pchan_destroy.argtypes = [ctypes.c_void_p]
        lib.trpc_pchan_gather_begin.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_pchan_gather_begin.restype = ctypes.c_void_p
        lib.trpc_pchan_gather_wait_rank.argtypes = [
            ctypes.c_void_p, ctypes.c_int, c_char_pp,
            ctypes.POINTER(ctypes.c_size_t), ctypes.c_char_p,
            ctypes.c_size_t]
        lib.trpc_pchan_gather_wait_prefix.argtypes = [
            ctypes.c_void_p, ctypes.c_ulonglong, c_char_pp,
            ctypes.POINTER(ctypes.c_size_t), ctypes.POINTER(ctypes.c_int),
            ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_pchan_gather_end.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_pchan_gather_mode.argtypes = [ctypes.c_void_p]
        lib.trpc_coll_crc_enable.argtypes = [ctypes.c_int]
        lib.trpc_coll_crc_enabled.argtypes = []
        lib.trpc_server_add_registry.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong]
        lib.trpc_server_add_registry2.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.trpc_registry_counts.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.trpc_coll_epoch_bump.argtypes = []
        lib.trpc_coll_epoch_bump.restype = ctypes.c_ulonglong
        lib.trpc_coll_records.argtypes = [c_char_pp, ctypes.c_size_t]
        lib.trpc_coll_records.restype = ctypes.c_size_t
        lib.trpc_link_stats.argtypes = [c_char_pp]
        lib.trpc_link_stats.restype = ctypes.c_size_t
        lib.trpc_coll_observe_enable.argtypes = [ctypes.c_int]
        lib.trpc_coll_observe_enabled.argtypes = []
        lib.trpc_coll_observe_reset.argtypes = []
        lib.trpc_server_add_stream_sink.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, _STREAM_SINK,
            ctypes.c_void_p]
        lib.trpc_stream_open.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_uint64), ctypes.c_char_p,
            ctypes.c_size_t]
        lib.trpc_stream_write.argtypes = [
            ctypes.c_uint64, ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_server_enable_tls.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p]
        lib.trpc_channel_create_tls.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_char_p]
        lib.trpc_channel_create_tls.restype = ctypes.c_void_p
        lib.trpc_rd_enable.argtypes = [ctypes.c_void_p]
        lib.trpc_rd_put.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_size_t]
        lib.trpc_rd_get.argtypes = [
            ctypes.c_char_p, c_char_pp, ctypes.POINTER(ctypes.c_size_t)]
        lib.trpc_rd_drop.argtypes = [ctypes.c_char_p]
        lib.trpc_rd_stats.argtypes = [
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int]
        lib.trpc_trace_set_sampling.argtypes = [
            ctypes.c_int, ctypes.c_longlong]
        lib.trpc_trace_fetch.argtypes = [ctypes.c_ulonglong, c_char_pp]
        lib.trpc_trace_fetch.restype = ctypes.c_size_t
        lib.trpc_trace_dump.argtypes = [c_char_pp]
        lib.trpc_trace_dump.restype = ctypes.c_size_t
        lib.trpc_trace_count.argtypes = []
        lib.trpc_trace_count.restype = ctypes.c_ulonglong
        lib.trpc_trace_set_tail.argtypes = [ctypes.c_int]
        lib.trpc_trace_promote.argtypes = [ctypes.c_ulonglong]
        lib.trpc_trace_promote.restype = ctypes.c_ulonglong
        lib.trpc_trace_pending.argtypes = []
        lib.trpc_trace_pending.restype = ctypes.c_ulonglong
        lib.trpc_fault_set.argtypes = [ctypes.c_char_p]
        lib.trpc_fault_counters.argtypes = [
            ctypes.POINTER(ctypes.c_ulonglong), ctypes.c_int]
        lib.trpc_coll_debug.argtypes = [ctypes.POINTER(ctypes.c_int)] * 4
        lib.trpc_coll_advise.argtypes = [
            ctypes.c_ulonglong, ctypes.POINTER(ctypes.c_double)]
        lib.trpc_coll_advise2.argtypes = [
            ctypes.c_ulonglong, ctypes.c_uint,
            ctypes.POINTER(ctypes.c_double)]
        lib.trpc_coll_epoch.argtypes = []
        lib.trpc_coll_epoch.restype = ctypes.c_ulonglong
        lib.trpc_coll_epoch_observe.argtypes = [ctypes.c_ulonglong]
        lib.trpc_coll_link_quarantined.argtypes = [ctypes.c_char_p]
        lib.trpc_flight_count.argtypes = []
        lib.trpc_flight_count.restype = ctypes.c_ulonglong
        lib.trpc_flight_reset.argtypes = []
        for fn in (lib.trpc_init, lib.trpc_server_start,
                   lib.trpc_server_stop, lib.trpc_server_add_method,
                   lib.trpc_call, lib.trpc_stream_close,
                   lib.trpc_stream_open3, lib.trpc_flight_stamp,
                   lib.trpc_flight_route, lib.trpc_batcher_add_method,
                   lib.trpc_batcher_next_batch, lib.trpc_batcher_emit,
                   lib.trpc_batcher_finish, lib.trpc_batcher_note_occupancy,
                   lib.trpc_batcher_stop, lib.trpc_batcher_stats,
                   lib.trpc_kv_host_configure, lib.trpc_kv_host_put,
                   lib.trpc_kv_host_get, lib.trpc_kv_host_drop,
                   lib.trpc_kv_tier_stats, lib.trpc_flight_tier,
                   lib.trpc_flight_note, lib.trpc_flight_note_once,
                   lib.trpc_kv_pool_configure, lib.trpc_kv_send_layer,
                   lib.trpc_kv_send_commit, lib.trpc_kv_recv_claim,
                   lib.trpc_kv_recv_copy_layer, lib.trpc_kv_recv_release,
                   lib.trpc_kv_abort, lib.trpc_kv_stats, lib.trpc_kv_pull,
                   lib.trpc_server_start_device, lib.trpc_pchan_add,
                   lib.trpc_pchan_call, lib.trpc_pchan_call_ranks,
                   lib.trpc_pchan_gather_wait_rank,
                   lib.trpc_pchan_gather_wait_prefix,
                   lib.trpc_pchan_gather_end, lib.trpc_pchan_gather_mode,
                   lib.trpc_coll_crc_enabled, lib.trpc_server_add_registry,
                   lib.trpc_server_add_registry2, lib.trpc_registry_counts,
                   lib.trpc_coll_observe_enabled,
                   lib.trpc_server_add_stream_sink, lib.trpc_stream_open,
                   lib.trpc_stream_write, lib.trpc_server_enable_tls,
                   lib.trpc_rd_enable, lib.trpc_rd_put, lib.trpc_rd_get,
                   lib.trpc_rd_drop, lib.trpc_rd_stats,
                   lib.trpc_fault_set, lib.trpc_fault_counters,
                   lib.trpc_coll_advise, lib.trpc_coll_advise2,
                   lib.trpc_coll_link_quarantined,
                   lib.trpc_trace_set_sampling):
            fn.restype = ctypes.c_int
        for fn in (lib.trpc_server_destroy, lib.trpc_channel_destroy,
                   lib.trpc_call_respond,
                   lib.trpc_buf_free, lib.trpc_batcher_destroy,
                   lib.trpc_kv_tier_note_fill, lib.trpc_pchan_destroy,
                   lib.trpc_coll_crc_enable, lib.trpc_coll_observe_enable,
                   lib.trpc_coll_observe_reset, lib.trpc_trace_set_tail,
                   lib.trpc_coll_debug, lib.trpc_coll_epoch_observe,
                   lib.trpc_flight_reset):
            fn.restype = None
        rc = lib.trpc_init(0)
        if rc != 0:
            raise OSError(rc, "trpc_init (fiber scheduler start) failed")
        _configured = True
    return lib


# Application-handler failure code (mirror TRPC_EAPP in c_api.h).
EAPP = 3001

# Framework errno values (mirror cpp/trpc/rpc_errno.h).
ERPCTIMEDOUT = 1008    # deadline reached before a response
ENORESPONSE = 1010     # connection closed before response
ELIMIT = 1012          # concurrency limit rejected the request
ECLOSE = 1014          # connection closed by peer
EFAILEDSOCKET = 1015   # the socket was failed during the call
EREJECT = 1016         # request rejected outright (no retry)
EINTERNAL = 2001
ERESPONSE = 2002       # response parse/format error
EREQUEST = 2003
ENOMETHOD = 2005       # service/method not found on the server
ENOLEASE = 2007        # membership lease expired or unknown: re-register
ENOTLEADER = 2008      # registry write hit a follower; the error text
                       # names the leader ("leader=host:port")
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

    @property
    def retry_after_ms(self) -> Optional[int]:
        """A shedding router's backoff hint, the ``retry_after_ms=N`` token
        of the error text (the cluster control plane's ELIMIT rejections
        carry one); None without it."""
        m = re.search(r"retry_after_ms=(\d+)", self.text)
        return int(m.group(1)) if m else None


class RetryPolicy:
    """Channel retry behaviour: attempt budget, exponential backoff with
    jitter, and the errno whitelist that gates which failures retry.

    ``backoff_base_ms == 0`` retries at once. The delay before retry k is
    ``min(base << (k-1), max)`` scaled by ``1 +- jitter``.
    ``retriable=None`` uses the transport-error default whitelist."""

    def __init__(self, max_retry: int = 3, backoff_base_ms: int = 0,
                 backoff_max_ms: int = 2000, jitter: float = 0.2,
                 retriable: Optional[Sequence[int]] = None):
        if not 0.0 <= jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        self.max_retry = max_retry
        self.backoff_base_ms = backoff_base_ms
        self.backoff_max_ms = backoff_max_ms
        self.jitter = jitter
        self.retriable = list(retriable) if retriable is not None else None


def fault_inject(spec: str) -> None:
    """Arm (or with ``""`` disarm) the process-wide fault-injection shim
    at the native frame send/receive boundary, e.g.
    ``fault_inject("seed=42,send_drop=0.1,send_kill=0.02,delay_ms=20")``
    (env ``TRPC_FAULT_SPEC`` arms it at start-up). Disarm it before other
    work in the process."""
    if _lib().trpc_fault_set(spec.encode()) != 0:
        raise ValueError(f"bad fault spec {spec!r}")


FAULT_COUNTER_NAMES = (
    "send_drop", "send_delay", "send_trunc", "send_corrupt", "send_kill",
    "recv_drop", "recv_delay", "recv_kill", "send_frames", "recv_chunks",
    "payload_corrupt",
)


def fault_counters() -> dict:
    """The shim's injection counters since it was last (re)configured."""
    buf = (ctypes.c_ulonglong * len(FAULT_COUNTER_NAMES))()
    n = _lib().trpc_fault_counters(buf, len(buf))
    return dict(zip(FAULT_COUNTER_NAMES[:n], [int(v) for v in buf[:n]]))


def _c_buf(data):
    """``data`` in a form a ``const char*`` argument takes: ``bytes`` as
    they are, a writable buffer (a ``bytearray`` or a slice of one) in
    place, anything else copied once."""
    if isinstance(data, bytes):
        return data
    mv = memoryview(data)
    if mv.readonly or not mv.c_contiguous:
        return bytes(mv)
    return (ctypes.c_char * mv.nbytes).from_buffer(mv.cast("B"))


def _native_bytes(ptr, n: int):
    """A writable ctypes array over ``n`` bytes at a native pointer, no
    copy. (``ctypes.string_at`` takes its size as a C int and fails past
    2 GiB.)"""
    return (ctypes.c_char * n).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value)


def _native_view(ptr, n: int) -> memoryview:
    """A read-only memoryview of ``n`` native bytes at ``ptr``, no copy."""
    if not n:
        return memoryview(b"")
    return memoryview(_native_bytes(ptr, n)).cast("B").toreadonly()


class NativeBuffer:
    """A response buffer owned by the native runtime, exposed without a
    copy: ``view`` is a read-only memoryview of it. ``release()`` (or
    garbage collection) frees it; nothing derived from ``view`` may
    outlive that."""

    def __init__(self, lib, ptr, length: int):
        self._lib = lib
        self._ptr = ptr
        self.view = _native_view(ptr, length)

    def __len__(self) -> int:
        return len(self.view)

    def release(self) -> None:
        if self._ptr is not None:
            self.view.release()
            self._lib.trpc_buf_free(self._ptr)
            self._ptr = None

    def __del__(self):
        try:
            self.release()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


_handler_ctx = threading.local()


def remaining_budget_ms() -> Optional[float]:
    """Remaining deadline budget of the RPC being handled on this thread
    (None when the client sent no deadline, or outside a handler); it
    shrinks as the handler runs, clamped at 0."""
    deadline = getattr(_handler_ctx, "deadline_mono", None)
    if deadline is None:
        return None
    return max(0.0, (deadline - time.monotonic()) * 1000.0)


class Server:
    """An RPC server. ``add_method`` registers unary handlers, and the
    batcher its methods, before ``start``."""

    def __init__(self):
        self._lib = _lib()
        self._h = self._lib.trpc_server_create()
        self._callbacks = []  # keeps the handler trampolines alive
        self.port: Optional[int] = None

    def add_method(self, service: str, method: str,
                   fn: Callable[[bytes], bytes]) -> None:
        """Serve ``service.method`` with ``fn(request) -> response``
        (``bytes``, or any buffer: a writable one is sent in place; sync,
        on a native worker thread). A raise fails the call with EAPP and
        the exception's text; ``remaining_budget_ms()`` reads the caller's
        deadline inside ``fn``."""
        lib = self._lib

        @_HANDLER
        def trampoline(_arg, call, req_ptr, req_len):
            try:
                req = (bytes(_native_bytes(req_ptr, req_len)) if req_len
                       else b"")
                # Restored on exit, so a nested handler on the same worker
                # thread sees its own budget.
                prev = getattr(_handler_ctx, "deadline_mono", None)
                rem_us = lib.trpc_call_remaining_us(call)
                _handler_ctx.deadline_mono = (
                    time.monotonic() + rem_us / 1e6 if rem_us >= 0 else None)
                try:
                    rsp = fn(req)
                finally:
                    _handler_ctx.deadline_mono = prev
                rsp = b"" if rsp is None else _c_buf(rsp)
                lib.trpc_call_respond(call, rsp, len(rsp), 0, None)
            except Exception as e:  # noqa: BLE001 — surface as RPC error
                lib.trpc_call_respond(call, None, 0, EAPP,
                                      str(e).encode()[:200])

        self._callbacks.append(trampoline)
        rc = lib.trpc_server_add_method(self._h, service.encode(),
                                        method.encode(), trampoline, None)
        if rc != 0:
            raise OSError(rc, "add_method failed")

    def add_stream_sink(self, service: str, method: str,
                        fn: Callable[[int, Optional[bytes]], None]) -> None:
        """Accept streams (``Channel.open_stream``) on ``service.method``:
        ``fn(stream_id, data)`` runs for each message on a native worker
        thread, and once with ``data`` None when the peer closed the
        stream."""
        @_STREAM_SINK
        def sink(_arg, sid, data_ptr, data_len):
            # An exception cannot cross into native code: print it, as the
            # message is lost either way.
            try:
                fn(sid, ctypes.string_at(data_ptr, data_len)
                   if data_ptr else None)
            except Exception:  # noqa: BLE001
                traceback.print_exc()

        self._callbacks.append(sink)
        rc = self._lib.trpc_server_add_stream_sink(
            self._h, service.encode(), method.encode(), sink, None)
        if rc != 0:
            raise OSError(rc, "add_stream_sink failed")

    def enable_tls(self, cert_file: str, key_file: str) -> None:
        """Serve TLS on the data port (call before ``start``); plaintext
        clients keep working on the same port (the first byte tells)."""
        rc = self._lib.trpc_server_enable_tls(
            self._h, cert_file.encode(), key_file.encode())
        if rc != 0:
            raise OSError(rc, "enable_tls failed")

    def enable_redistribute(self) -> None:
        """Register the native ``__rd`` service (shard get, fetch, commit,
        drop), the data plane of ``brpc_tpu_torch.redistribute``. Call
        before ``start``."""
        rc = self._lib.trpc_rd_enable(self._h)
        if rc != 0:
            raise RpcError(rc, "rd enable failed (server already started?)")

    def add_registry(self, default_ttl_ms: int = 3000, *,
                     wal_path: str = "", self_addr: str = "",
                     peers: str = "") -> None:
        """Attach the lease registry (call before ``start``): a "Cluster"
        service with register/renew/leave/list/watch, the fleet's control
        plane (``brpc_tpu_torch/cluster.py`` is its client side; channels
        subscribe with ``registry://host:port[/role]`` naming urls).

        ``wal_path`` journals membership facts, so a restarted replica
        recovers its lease table under a one-TTL expiry grace. ``peers``
        (every replica's address, ``self_addr`` included) makes this one
        replica of a replicated registry: the replicas elect a leader and
        a write to a follower fails with ENOTLEADER naming the leader."""
        if wal_path or peers:
            rc = self._lib.trpc_server_add_registry2(
                self._h, default_ttl_ms, wal_path.encode(),
                self_addr.encode(), peers.encode())
        else:
            rc = self._lib.trpc_server_add_registry(self._h, default_ttl_ms)
        if rc != 0:
            raise OSError(rc, "add_registry failed")

    REGISTRY_COUNT_KEYS = ("members", "registers", "renews", "expels",
                           "index", "role", "term", "commit_index",
                           "failovers", "grace_holds", "advices")

    def registry_counts(self) -> dict:
        """The registry's counters: members, registers, renews, lease
        expels, the membership index, the replication state (role: 0
        follower, 1 leader, 2 candidate; term; commit index; failovers;
        grace holds) and the role-flip advices."""
        out = (ctypes.c_longlong * len(self.REGISTRY_COUNT_KEYS))()
        n = self._lib.trpc_registry_counts(self._h, out,
                                           len(self.REGISTRY_COUNT_KEYS))
        if n < 0:
            raise OSError(-n, "server has no registry")
        return {k: int(out[i])
                for i, k in enumerate(self.REGISTRY_COUNT_KEYS[:n])}

    def start(self, port: int = 0) -> int:
        bound = ctypes.c_int(0)
        rc = self._lib.trpc_server_start(self._h, port, ctypes.byref(bound))
        if rc != 0:
            raise OSError(rc, "server start failed")
        self.port = bound.value
        return self.port

    def start_device(self, slice_: int, chip: int) -> None:
        """Listen on the device fabric's coordinate ``ici://slice/chip``
        (shared memory between the processes of one namespace, env
        ``TRPC_FABRIC_NS``; ``cpp/trpc/device_transport.h``)."""
        rc = self._lib.trpc_server_start_device(self._h, slice_, chip)
        if rc != 0:
            raise OSError(rc, "server start_device failed")

    def stop(self) -> None:
        if self._h:
            self._lib.trpc_server_stop(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.trpc_server_destroy(self._h)
            self._h = None

    def __del__(self):
        # The native server must not outlive the trampolines that
        # _callbacks keeps alive: destroy it before they are freed.
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Channel:
    """Client stub to ``"ip:port"``, a device-fabric coordinate
    ``"ici://slice/chip"``, or a naming url with a load balancer, e.g.
    ``Channel("registry://a:p,b:p,c:p/decode", lb="la")`` (the registry's
    live membership, followed natively): ``call`` makes a unary call,
    ``open_stream_rx`` opens the serving gateway's token-delivery stream.
    ``retry_policy`` replaces the bare ``max_retry`` with backoff-spaced
    retries gated on an errno whitelist. ``tls`` (or a ``tls_ca_file`` to
    verify the server's chain against, with ``tls_sni_host`` the name to
    pin) speaks TLS; it takes no retry policy."""

    def __init__(self, addr: str, timeout_ms: int = -1, max_retry: int = -1,
                 retry_policy: Optional[RetryPolicy] = None, *,
                 lb: str = "", tls: bool = False, tls_ca_file: str = "",
                 tls_sni_host: str = ""):
        self._lib = _lib()
        use_tls = tls or tls_ca_file or tls_sni_host
        if retry_policy is not None and use_tls:
            raise ValueError("retry_policy with TLS is not supported")
        if use_tls:
            self._h = self._lib.trpc_channel_create_tls(
                addr.encode(), lb.encode(), timeout_ms, max_retry,
                tls_ca_file.encode(), tls_sni_host.encode())
        elif retry_policy is None:
            self._h = self._lib.trpc_channel_create(
                addr.encode(), lb.encode(), timeout_ms, max_retry)
        else:
            rp = retry_policy
            if rp.retriable is not None:
                # [] retries nothing: the C side keys "the default
                # whitelist" on a NULL pointer, not on an empty list.
                n_codes = len(rp.retriable)
                codes = (ctypes.c_int * max(n_codes, 1))(*rp.retriable)
            else:
                codes, n_codes = None, 0
            self._h = self._lib.trpc_channel_create_ex(
                addr.encode(), lb.encode(), timeout_ms, rp.max_retry,
                rp.backoff_base_ms, rp.backoff_max_ms, int(rp.jitter * 100),
                codes, n_codes)
        if not self._h:
            raise OSError(f"channel init failed for {addr!r}")

    def call(self, service: str, method: str, request: bytes = b"") -> bytes:
        """One unary call; RpcError with the server's code and text on
        failure."""
        buf = self.call_view(service, method, request)
        try:
            return bytes(buf.view)
        finally:
            buf.release()

    def call_view(self, service: str, method: str,
                  request: bytes = b"") -> "NativeBuffer":
        """Like ``call``, but the response stays in the runtime's buffer,
        returned as a zero-copy view (``NativeBuffer``)."""
        rsp_ptr = ctypes.POINTER(ctypes.c_char)()
        rsp_len = ctypes.c_size_t(0)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.trpc_call(self._h, service.encode(), method.encode(),
                                 request, len(request), ctypes.byref(rsp_ptr),
                                 ctypes.byref(rsp_len), err, len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        return NativeBuffer(self._lib, rsp_ptr, rsp_len.value)

    def open_stream(self, service: str, method: str) -> "Stream":
        """Open a flow-controlled byte stream to a server's stream sink
        (``Server.add_stream_sink``); on the device fabric it is the bulk
        lane. Writes block while the peer's window is full."""
        sid = ctypes.c_uint64(0)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.trpc_stream_open(self._h, service.encode(),
                                        method.encode(), ctypes.byref(sid),
                                        err, len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        return Stream(self._lib, sid.value)

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


class Stream:
    """Writable half of a stream opened by ``Channel.open_stream``."""

    def __init__(self, lib, sid: int):
        self._lib = lib
        self.id = sid
        self._closed = False

    def write(self, data) -> None:
        """Write one message (``bytes``, or a writable buffer sent in
        place); blocks while the peer's window is full. A stream the peer
        closed, or whose connection died, raises RpcError(ECLOSE), which
        is retriable on a fresh stream."""
        buf = _c_buf(data)
        rc = self._lib.trpc_stream_write(self.id, buf, len(buf))
        if rc != 0:
            raise RpcError(rc, "stream closed by peer" if rc == ECLOSE
                           else "stream write failed")

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._lib.trpc_stream_close(self.id)

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

    def __iter__(self):
        while True:
            msg = self.read()
            if msg is None:
                return
            yield msg

    def close(self) -> None:
        """Abandon the stream (the server observes a peer close)."""
        if self.id:
            self._lib.trpc_stream_close(self.id)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Keeps rx-sink trampolines alive until their stream's close callback.
_rx_sinks: dict = {}


# ---- fan-out: ParallelChannel and the progressive gather ---------------------

def coll_crc_enable(on: bool = True) -> None:
    """Arm (or disarm) the wire-integrity rail: a crc32c over each
    collective, KV and ``__rd`` frame, checked before any fold, stash or
    commit; a mismatch drops the frame (the sender retries). Off by
    default; env ``TRPC_COLL_CRC=1`` arms it at start-up."""
    _lib().trpc_coll_crc_enable(1 if on else 0)


def coll_crc_enabled() -> bool:
    return bool(_lib().trpc_coll_crc_enabled())


def coll_epoch() -> int:
    """This process's collective membership epoch. Collective frames carry
    it; a receiver adopts the larger and rejects older requests (the fence
    after a rank death)."""
    return int(_lib().trpc_coll_epoch())


def coll_epoch_bump() -> int:
    """Advance this process's collective membership epoch, fencing the
    frames of every collective started under the old one, and return the
    new value: the out-of-band death signal of a registry watch."""
    return int(_lib().trpc_coll_epoch_bump())


def coll_epoch_observe(epoch: int) -> None:
    """Adopt ``epoch`` if it is newer than this process's (a coordinator
    that broadcasts a reformation)."""
    _lib().trpc_coll_epoch_observe(int(epoch))


def coll_link_quarantined(peer: str) -> bool:
    """Whether the link to ``peer`` ("ip:port") is quarantined: its crc32c
    errors passed ``TRPC_COLL_CRC_QUARANTINE_ERRS`` (default 8). The
    schedule advisor and the mesh2d orientation route around it."""
    return bool(_lib().trpc_coll_link_quarantined(peer.encode()))


def coll_debug() -> dict:
    """The collective plumbing's occupancy, for drain and leak checks: live
    root collectives and relay hops, chunk assemblies (this call sweeps
    the expired ones), pickup waiters and stashes. All four drain to 0
    once the collectives in flight finish or expire (``coll_records``
    carries the same under ``"debug"``)."""
    vals = [ctypes.c_int(0) for _ in range(4)]
    _lib().trpc_coll_debug(*[ctypes.byref(v) for v in vals])
    return {"collectives": vals[0].value,
            "chunk_assemblies": vals[1].value,
            "pickup_waiters": vals[2].value,
            "pickup_stashes": vals[3].value}


# Schedule names as the observatory's records and advisor give them
# (cpp/trpc/coll_observatory.h CollObsSched).
COLL_SCHED_NAMES = ("star", "ring_gather", "ring_reduce", "reduce_scatter",
                    "mesh2d_gather", "mesh2d_reduce", "mesh2d_gather_row",
                    "mesh2d_reduce_row")


def coll_advise(payload_bytes: int,
                allowed: Optional[list] = None) -> Optional[dict]:
    """The measured best schedule for a payload of ``payload_bytes`` (the
    nearest populated advisor bucket), ``{"sched", "gbps"}``; None until a
    collective was recorded. ``allowed`` limits the vote to those
    ``COLL_SCHED_NAMES``; cells older than ``TRPC_COLL_ADVISOR_STALE_S``
    (600 s) never vote."""
    gbps = ctypes.c_double(0)
    if allowed is None:
        sched = _lib().trpc_coll_advise(payload_bytes, ctypes.byref(gbps))
    else:
        mask = 0
        for name in allowed:
            mask |= 1 << COLL_SCHED_NAMES.index(name)
        sched = _lib().trpc_coll_advise2(payload_bytes, mask,
                                         ctypes.byref(gbps))
    if sched < 0:
        return None
    return {"sched": COLL_SCHED_NAMES[sched], "gbps": gbps.value}


# ---- the redistribute shard table (cpp/trpc/redistribute.cc) ---------------

def rd_put(name: str, data) -> None:
    """Put a complete named shard into this process's redistribute table
    (copied into registered send-arena blocks, so a pull over a device
    link posts it by descriptor)."""
    buf = _c_buf(data)
    rc = _lib().trpc_rd_put(name.encode(), buf, len(buf))
    if rc != 0:
        raise RpcError(rc, f"rd_put {name!r} failed")


def rd_get(name: str) -> bytes:
    """The bytes of a complete entry; KeyError when there is none, and
    RpcError while a fetch still assembles it."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_char)()
    n = ctypes.c_size_t(0)
    rc = lib.trpc_rd_get(name.encode(), ctypes.byref(out), ctypes.byref(n))
    if rc == EREQUEST:
        raise KeyError(name)
    if rc != 0:
        raise RpcError(rc, f"rd_get {name!r} failed")
    try:
        return ctypes.string_at(out, n.value)
    finally:
        lib.trpc_buf_free(out)


def rd_drop(name: str) -> bool:
    """Drop an entry; True when it existed."""
    return _lib().trpc_rd_drop(name.encode()) == 0


RD_STAT_NAMES = ("entries", "bytes", "serves", "pulls", "pull_bytes",
                 "local_bytes", "fetch_errors")


def rd_stats() -> dict:
    """The table's entries and bytes, and its serve, pull and fetch
    counters."""
    vals = (ctypes.c_longlong * len(RD_STAT_NAMES))()
    n = _lib().trpc_rd_stats(vals, len(vals))
    return {k: int(vals[i]) for i, k in enumerate(RD_STAT_NAMES[:n])}


def redistribute(*args, **kwargs):
    """``brpc_tpu_torch.redistribute.redistribute`` (the planner and the
    executor live there)."""
    from brpc_tpu_torch import redistribute as _rd
    return _rd.redistribute(*args, **kwargs)


# ---- the collective and fabric observatory (cpp/trpc/coll_observatory.h) ----

def _json_out(fn, *args):
    """Call a native ``(char** out, ...) -> length`` dump and parse its
    malloc'd JSON."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_char)()
    n = fn(ctypes.byref(out), *args)
    try:
        return json.loads(ctypes.string_at(out, n).decode(errors="replace"))
    finally:
        lib.trpc_buf_free(out)


def coll_records(max_items: int = 0) -> dict:
    """The observatory's /coll surface: ``records`` (one per collective,
    newest first: schedule, ranks, chunking, wire and effective bytes,
    per-hop ``hops`` with transit, span, fold and overlap,
    ``critical_hop``, ``skew``, the straggler verdict), the ``advisor``
    table, totals and the ``debug`` occupancy counters. ``max_items`` 0
    dumps the whole ring."""
    return _json_out(_lib().trpc_coll_records, max_items)


def coll_link_stats() -> list:
    """One row per fabric peer (the /fabric surface): bytes and frames
    each way, EWMA GB/s, credit stalls, retain grants against fallback
    copies, staged copies, wire against effective bytes."""
    return _json_out(_lib().trpc_link_stats).get("links", [])


def coll_observe_enable(on: bool = True) -> None:
    """Arm (or disarm) the observatory's records and per-link
    accounting. Armed by default; env ``TRPC_COLL_OBSERVE=0`` disarms it
    at start-up."""
    _lib().trpc_coll_observe_enable(1 if on else 0)


def coll_observe_enabled() -> bool:
    return bool(_lib().trpc_coll_observe_enabled())


def coll_observe_reset() -> None:
    """Forget the finished records, the advisor table and the straggler
    baseline, and zero the per-link counters."""
    _lib().trpc_coll_observe_reset()


class GatherHandle:
    """An in-flight progressive gather (``ParallelChannel.gather_begin``).

    Star gathers (``mode == "rank"``): ``wait_rank(r)`` blocks until rank
    r's response landed and returns it. Ring gathers (``mode ==
    "prefix"``): ``wait_prefix(n)`` returns the rank-ordered concat as far
    as it has arrived. Both return read-only zero-copy memoryviews of
    buffers the handle owns: they must not outlive ``end()``, which waits
    for the whole collective and frees them. A failed collective raises
    ``RpcError`` from whichever call observes it (all-or-nothing)."""

    def __init__(self, lib, h, nranks: int):
        self._lib = lib
        self._h = h
        self.nranks = nranks
        self.mode = "prefix" if lib.trpc_pchan_gather_mode(h) == 1 else "rank"

    def _check(self, rc: int, err) -> None:
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))

    def wait_prefix(self, min_total: int):
        """Block until at least ``min_total`` bytes of the concat arrived
        (or it completed); ``(view of the whole prefix so far, done)``.
        Views from earlier calls stay valid until ``end()`` (the buffer's
        growth retires old storage, never frees it)."""
        if self._h is None:
            raise RuntimeError("gather already ended")
        data = ctypes.POINTER(ctypes.c_char)()
        n = ctypes.c_size_t(0)
        done = ctypes.c_int(0)
        err = ctypes.create_string_buffer(256)
        self._check(self._lib.trpc_pchan_gather_wait_prefix(
            self._h, min_total, ctypes.byref(data), ctypes.byref(n),
            ctypes.byref(done), err, len(err)), err)
        return _native_view(data, n.value), bool(done.value)

    def wait_rank(self, rank: int) -> memoryview:
        if self._h is None:
            raise RuntimeError("gather already ended")
        data = ctypes.POINTER(ctypes.c_char)()
        n = ctypes.c_size_t(0)
        err = ctypes.create_string_buffer(256)
        self._check(self._lib.trpc_pchan_gather_wait_rank(
            self._h, rank, ctypes.byref(data), ctypes.byref(n), err,
            len(err)), err)
        return _native_view(data, n.value)

    def end(self) -> None:
        if self._h is not None:
            h, self._h = self._h, None
            err = ctypes.create_string_buffer(256)
            self._check(self._lib.trpc_pchan_gather_end(h, err, len(err)),
                        err)

    def __del__(self):
        try:
            self.end()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        try:
            self.end()
        except RpcError:
            if exc[0] is None:  # don't mask the body's own exception
                raise


class RankResult:
    """One rank's outcome in a partial-success gather (``call_ranks``):
    ``data`` is None and ``error`` its errno when the rank failed."""

    __slots__ = ("rank", "data", "error")

    def __init__(self, rank: int, data: Optional[bytes], error: int):
        self.rank = rank
        self.data = data
        self.error = error

    @property
    def ok(self) -> bool:
        return self.error == 0

    def __repr__(self):
        return (f"RankResult(rank={self.rank}, ok={self.ok}, "
                f"error={self.error}, len={len(self.data or b'')})")


class ParallelChannel:
    """Fan-out over Channels: one call broadcast to every rank, the
    responses gathered in rank order (the concat of the rank payloads).
    With ``lower_to_collective`` the broadcast is one collective frame on
    the wire (``cpp/trpc/policy/collective.cc``), all-or-nothing.

    ``schedule``: ``star`` (the root asks every rank), ``ring`` (a chain
    that carries the concat, cut into ``chunk_bytes`` frames: -1 the
    default, env ``TRPC_COLL_CHUNK_BYTES`` or 256 KiB; 0 unchunked),
    ``mesh2d`` (rings per row of ``mesh=(rows, cols)``, rank (i, j) =
    ``subs[i * cols + j]``) or ``auto`` (picked from measured links;
    ``advise_bytes`` keys the pick when the response size is known).
    ``reduce_op`` folds the payloads instead of concatenating them,
    ``reduce_scatter`` leaves each rank its slice. ``fail_limit > 0``
    lets a call succeed with up to that many dead ranks (``call_ranks``
    reports each rank); it forces one unicast per rank."""

    _SCHEDULES = ("star", "ring", "mesh2d", "auto")

    def __init__(self, subs: Sequence[Channel],
                 lower_to_collective: bool = True, timeout_ms: int = 5000,
                 schedule: str = "star", reduce_op: int = 0,
                 reduce_scatter: bool = False, fail_limit: int = 0,
                 chunk_bytes: int = -1, mesh: Optional[tuple] = None,
                 advise_bytes: int = 0):
        if schedule not in self._SCHEDULES:
            raise ValueError(
                "schedule must be one of 'star', 'ring', 'mesh2d', 'auto'")
        if schedule == "mesh2d" and mesh is None:
            raise ValueError("mesh2d schedule needs mesh=(rows, cols)")
        rows, cols = mesh if mesh is not None else (0, 0)
        self._lib = _lib()
        self._h = self._lib.trpc_pchan_create5(
            1 if lower_to_collective else 0, timeout_ms,
            self._SCHEDULES.index(schedule), reduce_op,
            1 if reduce_scatter else 0, fail_limit, chunk_bytes, rows, cols,
            advise_bytes)
        if not self._h:
            raise OSError("pchan create failed")
        self._per_rank = fail_limit > 0 or not lower_to_collective
        self._subs = list(subs)  # the native pchan does not own them
        try:
            for sub in self._subs:
                rc = self._lib.trpc_pchan_add(self._h, sub._h)
                if rc != 0:
                    raise OSError(rc, "pchan add failed")
        except Exception:
            self.close()
            raise

    def call(self, service: str, method: str, request: bytes = b"") -> bytes:
        buf = self.call_view(service, method, request)
        try:
            return bytes(buf.view)
        finally:
            buf.release()

    def call_view(self, service: str, method: str,
                  request: bytes = b"") -> NativeBuffer:
        """``call`` whose gathered response stays in the runtime's buffer,
        returned as a zero-copy view (``NativeBuffer``)."""
        rsp = ctypes.POINTER(ctypes.c_char)()
        rsp_len = ctypes.c_size_t(0)
        err = ctypes.create_string_buffer(256)
        rc = self._lib.trpc_pchan_call(
            self._h, service.encode(), method.encode(), request,
            len(request), ctypes.byref(rsp), ctypes.byref(rsp_len), err,
            len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        return NativeBuffer(self._lib, rsp, rsp_len.value)

    def gather_begin(self, service: str, method: str,
                     request: bytes = b"") -> GatherHandle:
        """Start the collective and return a ``GatherHandle`` that yields
        each rank's payload as soon as it lands: per rank on star pchans,
        as a growing in-order prefix on ring gathers. Other pchans (mesh2d,
        reduce, fail_limit, unlowered) raise ValueError."""
        h = self._lib.trpc_pchan_gather_begin(
            self._h, service.encode(), method.encode(), request,
            len(request))
        if not h:
            raise ValueError(
                "gather_begin needs a star- or ring-gather-lowered pchan "
                "with fail_limit 0")
        return GatherHandle(self._lib, h, len(self._subs))

    def call_ranks(self, service: str, method: str,
                   request: bytes = b"") -> List[RankResult]:
        """Partial-success gather: one ``RankResult`` per rank, in rank
        order. Raises RpcError only when more than ``fail_limit`` ranks
        failed, and ValueError on a lowered all-or-nothing pchan."""
        if not self._per_rank:
            raise ValueError(
                "call_ranks needs fail_limit > 0 (or "
                "lower_to_collective=False); a lowered collective gather "
                "is all-or-nothing with no per-rank report — use call()")
        n = len(self._subs)
        rsp = ctypes.POINTER(ctypes.c_char)()
        rsp_len = ctypes.c_size_t(0)
        rank_err = (ctypes.c_int * n)()
        rank_len = (ctypes.c_ulonglong * n)()
        err = ctypes.create_string_buffer(256)
        rc = self._lib.trpc_pchan_call_ranks(
            self._h, service.encode(), method.encode(), request,
            len(request), ctypes.byref(rsp), ctypes.byref(rsp_len),
            rank_err, rank_len, n, err, len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))
        buf = NativeBuffer(self._lib, rsp, rsp_len.value)
        try:
            out: List[RankResult] = []
            off = 0
            for i in range(n):
                if rank_err[i] == 0:
                    size = int(rank_len[i])
                    out.append(RankResult(
                        i, bytes(buf.view[off:off + size]), 0))
                    off += size
                else:
                    out.append(RankResult(i, None, int(rank_err[i])))
            return out
        finally:
            buf.release()

    def close(self) -> None:
        if self._h:
            self._lib.trpc_pchan_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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


# ---- KV transfer of disaggregated serving (cpp/trpc/kv_transfer.h) --------

KV_STAT_NAMES = (
    "page_bytes", "max_pages", "kv_pages_in_use", "kv_transfer_inflight",
    "kv_transfers_ready", "kv_transfer_bytes", "kv_transfers_completed",
    "kv_transfers_failed", "kv_pages_evicted", "kv_send_bytes",
    "kv_send_retries", "kv_zero_copy_pages",
)


def kv_pool_configure(page_bytes: int = 0, max_pages: int = 0) -> None:
    """(Re)configure the process-wide KV receive pool: ``page_bytes`` per
    pool page (a wire layer takes ceil(layer bytes / page_bytes) pages) and
    the ``max_pages`` budget. 0 keeps the current value (1 MiB, 512); the
    page size changes only while the pool is empty."""
    rc = _lib().trpc_kv_pool_configure(page_bytes, max_pages)
    if rc != 0:
        raise OSError(rc, "kv pool configure failed (pool not empty?)")


def kv_stats() -> dict:
    """Receive-pool occupancy and transfer counters, ``{name: int}`` (also
    on /vars and the metrics dump as kv_* gauges)."""
    buf = (ctypes.c_longlong * len(KV_STAT_NAMES))()
    n = _lib().trpc_kv_stats(buf, len(buf))
    return dict(zip(KV_STAT_NAMES[:n], [int(v) for v in buf[:n]]))


class KvSender:
    """Layer-wise, chunked sender of one KV transfer over a Channel.

    ``send_layer`` queues that layer's bytes as pipelined chunk RPCs (at
    most ``window`` in flight) and returns; ``commit()`` waits for every
    chunk's ack and seals the transfer on the receiver. Chunks ride the
    channel's retry policy plus a kv-level re-post of dropped frames, so a
    fault surfaces as a failed ``send_layer`` or commit, never as a torn
    transfer."""

    def __init__(self, channel: "Channel", handle: int, total_layers: int,
                 chunk_bytes: int = -1, window: int = 8):
        self._lib = _lib()
        self._h = self._lib.trpc_kv_send_begin(
            channel._h, handle, total_layers, chunk_bytes, window)
        if not self._h:
            raise OSError("kv send begin failed")
        self.handle = handle
        self.bytes_sent = 0  # wire bytes queued so far

    def send_layer(self, layer: int, data) -> None:
        if self._h is None:
            raise RuntimeError("sender already finished")
        if not isinstance(data, bytes):
            data = bytes(data)
        self.bytes_sent += len(data)
        rc = self._lib.trpc_kv_send_layer(self._h, layer, data, len(data))
        if rc != 0:
            self.abort()
            raise RpcError(rc, f"kv send_layer {layer} failed")

    def commit(self) -> None:
        if self._h is None:
            raise RuntimeError("sender already finished")
        err = ctypes.create_string_buffer(256)
        h, self._h = self._h, None
        rc = self._lib.trpc_kv_send_commit(h, err, len(err))
        if rc != 0:
            raise RpcError(rc, err.value.decode(errors="replace"))

    def abort(self) -> None:
        if self._h is not None:
            h, self._h = self._h, None
            self._lib.trpc_kv_send_abort(h)

    def __del__(self):
        try:
            self.abort()
        except Exception:  # noqa: BLE001 — interpreter may be tearing down
            pass


def kv_recv_claim(handle: int, timeout_ms: int) -> int:
    """Wait until transfer ``handle`` is committed, claim it (pinned
    against eviction) and return its wire-layer count. RpcError on
    timeout."""
    n = ctypes.c_int(0)
    rc = _lib().trpc_kv_recv_claim(handle, timeout_ms, ctypes.byref(n))
    if rc != 0:
        raise RpcError(rc, f"kv transfer {handle:#x} not ready")
    return n.value


def kv_recv_layer(handle: int, layer: int):
    """One claimed wire layer's bytes as a fresh numpy uint8 array."""
    import numpy as np

    lib = _lib()
    nbytes = lib.trpc_kv_recv_layer_bytes(handle, layer)
    if nbytes < 0:
        raise RpcError(EREQUEST, f"kv layer {layer} unknown")
    out = np.empty(nbytes, dtype=np.uint8)
    rc = lib.trpc_kv_recv_copy_layer(
        handle, layer, out.ctypes.data_as(ctypes.c_void_p), nbytes)
    if rc != 0:
        raise RpcError(rc, f"kv layer {layer} copy failed")
    return out


def kv_recv_release(handle: int) -> None:
    """Drop the claim on ``handle`` and free its pool pages."""
    _lib().trpc_kv_recv_release(handle)


def kv_abort(channel: "Channel", handle: int) -> int:
    """Tell the receiver behind ``channel`` to drop transfer ``handle``'s
    unclaimed assembly now (a committed transfer nobody will adopt).
    Best-effort: returns the errno without raising."""
    return _lib().trpc_kv_abort(channel._h, handle)


def set_max_body_size(nbytes: int) -> None:
    """Set this process's cap on a received framed-protocol body, the
    native flag ``trpc_max_body_size`` (256 MiB by default,
    ``cpp/trpc/policy/trpc_protocol.cc:46``). The flag is settable only
    through a server's ``/flags`` page, so a loopback server is started
    for the one request."""
    import urllib.request

    srv = Server()
    try:
        port = srv.start(0)
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{port}/flags?trpc_max_body_size={int(nbytes)}",
            timeout=10).read().decode()
    finally:
        srv.stop()
        srv.close()
    if f"trpc_max_body_size = {int(nbytes)}" not in body:
        raise OSError(f"trpc_max_body_size not set: {body.strip()!r}")


def http_vars(addr: str, prefix: str = "") -> dict:
    """A server's /vars page over HTTP (the data port sniffs HTTP) parsed
    into ``{name: float}``."""
    import urllib.request

    url = f"http://{addr}/vars" + (f"?filter={prefix}" if prefix else "")
    body = urllib.request.urlopen(url, timeout=10).read().decode()
    out = {}
    for line in body.splitlines():
        name, _, val = line.partition(":")
        try:
            out[name.strip()] = float(val)
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


def kv_pull(channel: "Channel", key: int, max_bytes: int):
    """Pull one page by content key from the host store behind ``channel``
    (the peer tier): the page bytes as a numpy uint8 array, or None when
    the peer does not hold it. A transport failure raises RpcError."""
    import numpy as np

    out = np.empty(max_bytes, dtype=np.uint8)
    got = ctypes.c_longlong(0)
    rc = _lib().trpc_kv_pull(channel._h, key,
                             out.ctypes.data_as(ctypes.c_void_p), max_bytes,
                             ctypes.byref(got))
    if rc == EREQUEST:
        return None  # the peer does not hold the page: a miss
    if rc != 0:
        raise RpcError(rc, f"kv pull {key:#x} failed")
    return out[:got.value]


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


def flight_tier(req_id: int, tier: int) -> None:
    """Set the SLO-tier byte (a TIER_* value) on ``req_id``'s record."""
    _lib().trpc_flight_tier(req_id, tier)


def flight_note(req_id: int, text: str) -> None:
    """Attach a short note (about 55 bytes kept) to ``req_id``'s record."""
    _lib().trpc_flight_note(req_id, text.encode()[:55])


def flight_note_once(req_id: int, text: str) -> None:
    """``flight_note`` only where the record has no note yet, so a
    breadcrumb never clobbers an earlier note (a re-dispatch's)."""
    _lib().trpc_flight_note_once(req_id, text.encode()[:55])


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


def flight_count() -> int:
    """Flight records finished since the process started."""
    return int(_lib().trpc_flight_count())


def flight_reset() -> None:
    """Forget the finished flight records (flights in progress keep
    recording)."""
    _lib().trpc_flight_reset()


# ---- distributed tracing (rpcz, cpp/trpc/rpcz*) ----------------------------

def trace_set_sampling(enabled: bool, max_per_sec: int = 1000) -> None:
    """Turn span collection on or off. ``max_per_sec`` budgets the traces
    this process starts; a request sampled upstream is always continued.
    Off (the default), the unsampled path allocates no span."""
    _lib().trpc_trace_set_sampling(1 if enabled else 0, max_per_sec)


def trace_fetch(trace_id: int = 0) -> list:
    """The spans of one finished trace as dicts (``trace_id`` 0: the whole
    ring, newest first), after a flush of the collector. Ids are hex
    strings; a span has its start, end and latency in us, its error code
    and its annotations with span-relative times."""
    lib = _lib()
    out = ctypes.POINTER(ctypes.c_char)()
    n = lib.trpc_trace_fetch(trace_id, ctypes.byref(out))
    try:
        return json.loads(ctypes.string_at(out, n).decode(errors="replace"))
    finally:
        lib.trpc_buf_free(out)


def trace_dump() -> dict:
    """The span ring as a Chrome trace (a dict with ``traceEvents``), for
    Perfetto or chrome://tracing."""
    return _json_out(_lib().trpc_trace_dump)


def trace_count() -> int:
    """Spans collected since the process started (after a flush); it does
    not move while sampling is off."""
    return int(_lib().trpc_trace_count())


def trace_set_tail(enabled: bool) -> None:
    """Tail sampling: every request gets spans, but those the head budget
    declined wait in a bounded pending ring and reach the store only when
    the request's flight record ends slow, failed or degraded. Works with
    head sampling off."""
    _lib().trpc_trace_set_tail(1 if enabled else 0)


def trace_promote(trace_id: int) -> int:
    """Move every pending span of ``trace_id`` into the store; returns how
    many moved."""
    return int(_lib().trpc_trace_promote(trace_id))


def trace_pending() -> int:
    """Spans waiting in the tail-sampling pending ring."""
    return int(_lib().trpc_trace_pending())
