"""RPC fan-out -> device landing: the port's copy of
brpc_tpu/mesh_bridge.py, with a list of torch devices in place of the JAX
mesh and its axis.

- ``ShardServer``: a rank process serving its named arrays over the native
  runtime (TCP or the device fabric, ``ici://slice/chip``). A ``get``
  answers one length-framed TPS1 blob (``param_server``'s codec), so the
  rank-ordered concat of a collective gather stays splittable; ``put``
  merges arrays in.
- ``rpc_all_gather``: one lowered collective call; every rank's array.
- ``gather_to_mesh``: one collective call whose rank rows land on the
  devices, rank i on device i * n / k of n (k % n == 0). The result is one
  tensor per device holding its ``[k / n, *shape]`` rows. The response
  stays in the runtime's buffer (``call_view``); each rank's array is
  decoded as a view into it (``decode_arrays(copy=False)``) and copied
  straight into its row of the device's output, which is allocated once:
  no host staging copy, and no concatenate on the device (the reference
  lands each row with its own ``jax.device_put`` and joins a device's
  rows with ``jnp.concatenate``).
- ``gather_to_mesh_stream``: the pipelined lane. Up to ``depth`` calls
  stay in flight, and within a call each rank's copy starts as soon as
  that rank's response has landed (``ParallelChannel.gather_begin``: per
  rank on star pchans, out of the in-order prefix on ring gathers), so
  the host-to-device copies overlap the receive of the ranks still on
  the wire.
- ``scatter_from_mesh``: the reverse lane; it reads the rows back one
  rank row at a time, so no host read is larger than one rank's shard,
  and pushes each with ``put``.

On a card the copies run on a side stream of each device
(``copy_(non_blocking=True)`` from the runtime's pageable buffer; the
copy engine does the work, no kernel is launched). A CUDA event recorded
after a gather's copies is what the native buffer waits for before it is
freed, and the caller's current stream waits on it, so the tensors handed
out are safe to use on that stream. ``stats()`` proves the zero-copy
claims: ``staging_copy_bytes`` (host memcpys beyond the send-side encode)
stays 0, ``zero_copy_bytes`` counts each row copied straight from an RPC
buffer to its device.

``devices`` defaults to the card; without one (and without ``devices``)
the bridge raises, never falling back to the CPU. The tests pass
``devices=[torch.device("cpu")] * n``.
"""

from __future__ import annotations

import queue
import struct
import threading
import warnings
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np
import torch

from brpc_tpu_torch import runtime
from brpc_tpu_torch.param_server import decode_arrays, encode_arrays, _encode
from brpc_tpu_torch.utils import resolve_device

SERVICE = "Shard"

# Proof counters of the zero-copy landing (see the module docstring).
_stats = {
    "staging_copy_bytes": 0,   # host memcpys beyond the send-side encode
    "zero_copy_bytes": 0,      # row bytes copied straight from an RPC buffer
}
_stats_mu = threading.Lock()

# Megatron-style tensor-parallel cut of a transformer layer's matrices:
# column-parallel (last axis) for the projections into the heads and the
# FFN, row-parallel (the input axis) for the two projections out of them.
TP_AXIS = {"wq": -1, "wk": -1, "wv": -1, "w_gate": -1, "w_up": -1,
           "wo": -2, "w_down": -2}


def stats() -> Dict[str, int]:
    with _stats_mu:
        return dict(_stats)


def reset_stats() -> None:
    with _stats_mu:
        for k in _stats:
            _stats[k] = 0


def _count(key: str, n: int) -> None:
    with _stats_mu:
        _stats[key] += n


def enable_wire_integrity(on: bool = True) -> None:
    """Arm the per-frame crc32c rail for every frame this bridge moves,
    collective gathers and scatters included (``runtime.coll_crc_enable``,
    env ``TRPC_COLL_CRC=1``): a corrupted frame is dropped and resent,
    never folded."""
    runtime.coll_crc_enable(on)


def split_frames(blob) -> List:
    """Split the rank-ordered gather (a concat of length-framed payloads)
    into its payloads: slices of ``blob``, views when it is a view."""
    out = []
    mv = blob if isinstance(blob, bytes) else memoryview(blob)
    off = 0
    total = len(mv)
    while off < total:
        if total - off < 8:
            raise ValueError("truncated gather frame")
        (n,) = struct.unpack_from("<Q", mv, off)
        off += 8
        if total - off < n:
            raise ValueError("truncated gather payload")
        out.append(mv[off:off + n])
        off += n
    return out


class ShardServer:
    """One rank: holds named arrays (numpy arrays, torch tensors, bf16 as
    torch bf16 tensors or ``Bfloat16Bits``) and serves ``get``/``put``.

    The arrays are kept as their length-framed TPS1 blob, the very bytes a
    ``get`` answers (byte-identical to the reference's frame for the same
    arrays); a ``put`` merges its arrays in and encodes the frame anew."""

    def __init__(self, arrays: Dict[str, object]):
        self._mu = threading.Lock()  # handlers run on native threads
        self._frame = self._encode_frame(arrays)
        self._srv = runtime.Server()
        self._srv.add_method(SERVICE, "get", self._get)
        self._srv.add_method(SERVICE, "put", self._put)

    @staticmethod
    def _encode_frame(arrays: Dict[str, object]) -> bytearray:
        blob = _encode(arrays)
        return bytearray(struct.pack("<Q", len(blob))) + blob

    def _get(self, _req: bytes) -> bytearray:
        with self._mu:
            return self._frame

    def _put(self, req: bytes) -> bytes:
        # Merge, don't replace: a scatter of one named array must not drop
        # the rank's other arrays.
        update = decode_arrays(req, copy=False)
        with self._mu:
            merged = decode_arrays(memoryview(self._frame)[8:], copy=False)
            merged.update(update)
            self._frame = self._encode_frame(merged)
        return b"ok"

    def arrays(self) -> Dict[str, object]:
        """A copy of the rank's arrays (numpy, or torch bf16 tensors)."""
        with self._mu:
            frame = self._frame
        return decode_arrays(memoryview(frame)[8:])

    def start(self, port: int = 0) -> int:
        return self._srv.start(port)

    def start_device(self, slice_: int, chip: int) -> None:
        self._srv.start_device(slice_, chip)

    def close(self) -> None:
        self._srv.stop()
        self._srv.close()


def rpc_all_gather(pchan: "runtime.ParallelChannel", name: str) -> List:
    """One collective call; rank-ordered copies of each rank's ``name``.

    On a pchan with ``fail_limit > 0`` the self-healing ring may reform
    around a dead rank mid-call, and the gather then returns the
    survivors' arrays (fewer, still rank-ordered): callers that need every
    rank check the length."""
    blob = pchan.call(SERVICE, "get")
    shards = []
    for payload in split_frames(blob):
        arrays = decode_arrays(payload)
        if name not in arrays:
            raise KeyError(f"rank shard missing {name!r}")
        shards.append(arrays[name])
    return shards


def _as_tensor(a) -> torch.Tensor:
    """A decoded array (numpy view, or a torch bf16 view) as a CPU tensor
    over the same bytes."""
    if isinstance(a, torch.Tensor):
        return a
    with warnings.catch_warnings():
        # A read-only RPC buffer: torch warns that it cannot guard writes.
        warnings.simplefilter("ignore", UserWarning)
        return torch.from_numpy(np.asarray(a))


def _resolve_devices(devices) -> List[torch.device]:
    """The landing's devices: the card by default (raises without one),
    a CUDA device with its index made explicit."""
    devs = ([resolve_device(None)] if devices is None
            else [resolve_device(d) for d in devices])
    if not devs:
        raise ValueError("no devices to land on")
    return [torch.device("cuda", torch.cuda.current_device())
            if d.type == "cuda" and d.index is None else d for d in devs]


class _Landing:
    """One gather's rows landing on their devices: rank r's row goes to
    ``devices[r // (k / n)]``, into a ``[k / n, *shape]`` tensor allocated
    there once (on the caller's current stream). On a card the copies run
    on a side stream that first waits for the current stream (the fresh
    allocation may reuse memory its pending work frees); ``finish()``
    records an event after them and makes the current stream wait on it.
    The source views must stay alive until ``synchronize()``."""

    def __init__(self, k: int, devices: List[torch.device]):
        if k == 0 or k % len(devices):
            raise ValueError(f"{k} rank shards do not divide "
                             f"{len(devices)} devices")
        self.k = k
        self.devices = devices
        self.per = k // len(devices)
        self.tensors: List[Optional[torch.Tensor]] = [None] * len(devices)
        self._streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._events: List["torch.cuda.Event"] = []

    def put(self, r: int, shard) -> None:
        src = _as_tensor(shard)
        d, row = divmod(r, self.per)
        dev = self.devices[d]
        out = self.tensors[d]
        if out is None:
            out = self.tensors[d] = torch.empty(
                (self.per, *src.shape), dtype=src.dtype, device=dev)
        if out.shape[1:] != src.shape or out.dtype != src.dtype:
            raise ValueError(
                f"rank {r} shard {tuple(src.shape)} {src.dtype} differs "
                f"from {tuple(out.shape[1:])} {out.dtype}")
        if dev.type == "cuda":
            stream = self._streams.get(dev)
            if stream is None:
                stream = self._streams[dev] = torch.cuda.Stream(dev)
                stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                out[row].copy_(src, non_blocking=True)
        else:
            out[row].copy_(src)
        _count("zero_copy_bytes", src.numel() * src.element_size())

    def finish(self) -> List[torch.Tensor]:
        """Record each side stream's event and order the current stream
        after it; the landed tensors, one per device."""
        for dev, stream in self._streams.items():
            ev = torch.cuda.Event()
            ev.record(stream)
            torch.cuda.current_stream(dev).wait_event(ev)
            self._events.append(ev)
        self._streams.clear()
        return list(self.tensors)

    def synchronize(self) -> None:
        """Block the host until every copy has read its source."""
        self.finish()
        for ev in self._events:
            ev.synchronize()


def _land_ranks(k: int, devices: List[torch.device], shard_for_rank
                ) -> _Landing:
    """The landing core: ``shard_for_rank(r)`` yields rank r's array as a
    view (blocking until it has arrived: the handle decides how) and its
    copy starts at once, so the copies pipeline against the receive of
    the later ranks. Returns the landing in flight: the caller keeps the
    sources alive until ``synchronize()``."""
    landing = _Landing(k, devices)
    try:
        for r in range(k):
            landing.put(r, shard_for_rank(r))
        landing.finish()
    except BaseException:
        # A later rank failed (all-or-nothing): copies already queued from
        # views into the caller's buffers may still be reading them.
        landing.synchronize()
        raise
    return landing


def _decode_payload(payload, name: str):
    arrays = decode_arrays(payload, copy=False)
    if name not in arrays:
        raise KeyError(f"rank shard missing {name!r}")
    return arrays[name]


def _assemble_on_devices(buf, name: str, devices) -> _Landing:
    """Decode the rank frames of a gathered buffer as views and land them
    (the port of the reference's ``_assemble_on_mesh``)."""
    payloads = split_frames(buf.view)
    return _land_ranks(len(payloads), devices,
                       lambda r: _decode_payload(payloads[r], name))


def gather_to_mesh(pchan: "runtime.ParallelChannel", name: str,
                   devices: Optional[Sequence] = None
                   ) -> List[torch.Tensor]:
    """RPC all-gather -> rank rows on ``devices`` (default: the card).

    Rank i of k lands on device i * n / k of the n devices (k % n == 0).
    Returns one tensor per device, its ``[k / n, *shape]`` rows, safe to
    use on the caller's current stream; the native buffer is freed once
    the copies have read it."""
    devs = _resolve_devices(devices)
    buf = pchan.call_view(SERVICE, "get")
    try:
        landing = _assemble_on_devices(buf, name, devs)
        landing.synchronize()
        return landing.tensors
    finally:
        buf.release()


def _decode_rank_frame(view, name: str):
    """One rank's response, one length-framed TPS1 blob -> its ``name``
    as a zero-copy view into ``view``."""
    mv = memoryview(view)
    if len(mv) < 8:
        raise ValueError("truncated gather frame")
    (n,) = struct.unpack_from("<Q", mv, 0)
    if len(mv) - 8 != n:
        raise ValueError("truncated gather payload")
    return _decode_payload(mv[8:], name)


def _assemble_ranks(handle: "runtime.GatherHandle", name: str,
                    devices) -> _Landing:
    """Per-rank landing (star): rank r's copy starts when its own
    response has landed (``wait_rank``)."""
    return _land_ranks(handle.nranks, devices,
                       lambda r: _decode_rank_frame(handle.wait_rank(r),
                                                    name))


def _assemble_prefix_ranks(handle: "runtime.GatherHandle", name: str,
                           devices) -> _Landing:
    """Ring-pickup landing: the concat of length-framed rank payloads
    arrives in order, so each rank's frame is decoded (as views into the
    handle's prefix buffer, valid until ``end()``) as soon as enough of
    the prefix has landed, while later ranks are still on the wire."""
    off = 0

    def shard_for_rank(r):
        nonlocal off
        view, _ = handle.wait_prefix(off + 8)
        if len(view) < off + 8:
            raise ValueError("truncated gather frame")
        (nbytes,) = struct.unpack_from("<Q", view, off)
        view, _ = handle.wait_prefix(off + 8 + nbytes)
        if len(view) < off + 8 + nbytes:
            raise ValueError("truncated gather payload")
        shard = _decode_payload(view[off + 8:off + 8 + nbytes], name)
        off += 8 + nbytes
        return shard

    return _land_ranks(handle.nranks, devices, shard_for_rank)


def _gather_stream_ranks(pchan, first_handle, name, devices, iters: int,
                         depth: int):
    """Up to ``depth`` collective calls in flight; within each, rank r's
    copy overlaps the receive of ranks r + 1.. (per rank on star pchans,
    out of the prefix on ring gathers). A handle ends only after its
    landing's copies have read it."""
    assemble = (_assemble_prefix_ranks if first_handle.mode == "prefix"
                else _assemble_ranks)
    inflight = deque([first_handle])
    started = 1

    def start():
        nonlocal started
        if started < iters:
            inflight.append(pchan.gather_begin(SERVICE, "get"))
            started += 1

    while len(inflight) < min(depth, iters):
        start()
    prev = None  # (landing, handle) whose copies may still be in flight
    cur = None   # the handle being landed now
    try:
        while inflight:
            cur = inflight.popleft()
            start()  # keep the pipe full: the next receive overlaps these
            landing = assemble(cur, name, devices)
            if prev is not None:
                prev[0].synchronize()
                prev[1].end()
            prev, cur = (landing, cur), None
            yield landing.tensors
        if prev is not None:
            (landing, handle), prev = prev, None
            landing.synchronize()
            handle.end()
    finally:
        if prev is not None:
            prev[0].synchronize()
            _end_quietly(prev[1])
        if cur is not None:
            _end_quietly(cur)  # its landing synchronised before raising
        while inflight:
            _end_quietly(inflight.popleft())


def _end_quietly(handle) -> None:
    try:
        handle.end()
    except runtime.RpcError:
        pass  # the failure already surfaced (or the caller stopped early)


def gather_to_mesh_stream(pchan: "runtime.ParallelChannel", name: str,
                          iters: int, depth: int = 2,
                          devices: Optional[Sequence] = None):
    """Pipelined ``gather_to_mesh``: yields ``iters`` landings (each one
    tensor per device), with up to ``depth`` collective calls in flight
    and, within a call, each rank's copy started as its response lands.
    Pchans without a progressive lane (mesh2d, reduce, fail_limit,
    unlowered) keep a whole-response prefetch pipeline. A yielded landing
    may still be copying; the caller's current stream is ordered after it,
    so use it there as usual."""
    if iters <= 0:
        return
    devs = _resolve_devices(devices)
    try:
        first = pchan.gather_begin(SERVICE, "get")
    except ValueError:
        yield from _gather_stream_buffers(pchan, name, devs, iters, depth)
        return
    yield from _gather_stream_ranks(pchan, first, name, devs, iters, depth)


def _gather_stream_buffers(pchan, name, devices, iters: int, depth: int):
    """Whole-response pipeline: a prefetch thread keeps up to ``depth``
    collective responses in flight (the native call releases the GIL),
    and a buffer is freed only after its landing's copies read it."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def prefetch():
        try:
            for _ in range(iters):
                if stop.is_set():
                    break
                q.put(pchan.call_view(SERVICE, "get"))
            q.put(None)
        except Exception as e:  # noqa: BLE001 — raised on the consumer side
            q.put(e)

    t = threading.Thread(target=prefetch, daemon=True)
    t.start()
    prev = None  # (landing, buf) whose copies may still be in flight
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, Exception):
                raise item
            try:
                landing = _assemble_on_devices(item, name, devices)
            except BaseException:
                item.release()  # the landing synchronised before raising
                raise
            if prev is not None:
                prev[0].synchronize()
                prev[1].release()
            prev = (landing, item)
            yield landing.tensors
    finally:
        stop.set()
        if prev is not None:
            prev[0].synchronize()
            prev[1].release()

        def drain():  # free prefetched buffers nobody consumed
            while True:
                try:
                    item = q.get_nowait()
                except queue.Empty:
                    return
                if isinstance(item, runtime.NativeBuffer):
                    item.release()

        drain()  # frees a slot a blocked put may be waiting on
        t.join(timeout=5)
        drain()  # whatever that last put delivered


def _read_row(row: torch.Tensor) -> torch.Tensor:
    """One rank row back to the host (the scatter's only device read)."""
    return row.to("cpu")


def scatter_from_mesh(x: Union[torch.Tensor, Sequence[torch.Tensor]],
                      channels: Sequence["runtime.Channel"],
                      name: str) -> None:
    """Push rank rows back to the rank servers: ``x`` is a landing (one
    ``[k / n, *shape]`` tensor per device, ``gather_to_mesh``'s result) or
    one ``[k, *shape]`` tensor; row i goes to ``channels[i]`` as ``name``.
    Rows are read back one at a time, so no host read is larger than one
    rank's shard, even when one card holds every row."""
    blocks = [x] if isinstance(x, torch.Tensor) else list(x)
    k = len(channels)
    if sum(b.shape[0] for b in blocks) != k:
        raise ValueError("leading dim must equal rank count")
    r = 0
    for block in blocks:
        for i in range(block.shape[0]):
            payload = encode_arrays({name: _read_row(block[i])})
            if channels[r].call(SERVICE, "put", payload) != b"ok":
                raise RuntimeError(f"rank {r} put failed")
            r += 1


def pack_tp_shards(weights: Dict[str, torch.Tensor], k: int
                   ) -> List[torch.Tensor]:
    """Cut a layer stack's matrices (``TP_AXIS`` names, stacked ``[L, in,
    out]``) into k tensor-parallel shards and pack each rank's shards into
    one flat array, in ``TP_AXIS`` order: rank r's ``"w"``."""
    out = []
    for r in range(k):
        parts = [weights[n].chunk(k, dim=TP_AXIS[n])[r].reshape(-1)
                 for n in TP_AXIS]
        out.append(torch.cat(parts))
    return out


def unpack_tp_shards(rows: torch.Tensor, shapes: Dict[str, tuple]
                     ) -> Dict[str, torch.Tensor]:
    """The inverse of ``pack_tp_shards`` on landed rows (``[k, n]``, on
    any device): each matrix of ``shapes`` (its full stacked shape) joined
    from its k shards, on the rows' device."""
    k = rows.shape[0]
    out, off = {}, 0
    for name in TP_AXIS:
        shape = list(shapes[name])
        axis = TP_AXIS[name]
        if shape[axis] % k:
            raise ValueError(f"{name} {tuple(shape)} does not split {k} ways")
        shape[axis] //= k
        n = int(np.prod(shape))
        out[name] = torch.cat([rows[r, off:off + n].view(shape)
                               for r in range(k)], dim=axis)
        off += n
    if off != rows.shape[1]:
        raise ValueError(f"rows hold {rows.shape[1]} elements, the shapes "
                         f"{off}")
    return out
