"""Parameter server over the native RPC runtime: the port's own copy of
brpc_tpu/param_server.py's TPS1 blob codec, ``ParamServer`` and
``ParamClient``, speaking the same bytes.

A blob is the magic ``TPS1``, a u32 count, then per array (sorted by name):
u32 name length, name, u32 dtype-tag length, dtype tag (numpy's name for
the dtype), u32 ndim, ndim x i64 shape, the raw C-order bytes.

bfloat16 has no numpy dtype without ``ml_dtypes``, which this package does
not need: a torch bf16 tensor (or a ``Bfloat16Bits`` wrapper of its raw
16-bit view) encodes under the tag ``"bfloat16"``, as the reference's
ml_dtypes arrays do, and a ``"bfloat16"`` entry decodes into a torch bf16
tensor through an int16 view. Every other entry decodes into a numpy
array.

One blob travels as one frame in ``pull``, whose body size the native
codec writes as a u32 (``cpp/trpc/meta_codec.cc:263``), and a receiver
accepts a body only up to its ``trpc_max_body_size`` (256 MiB by default).
So a blob is at most ``MAX_BLOB_BYTES``, and a ``ParamServer`` or
``ParamClient`` raises its own process's receive cap to fit one. A larger
dict is split into groups of whole arrays, each behind its own server
(``groups``). A server keeps its parameters as their blob, which a pull
sends without encoding anew.

Besides the reference's ``pull`` and ``push``, the port's server answers
``info`` (<u64 blob bytes> <u64 version>) and ``pull_range`` (<u64
version> <u64 offset> <u64 length> -> those bytes of that version's
blob), and ``ParamClient.pull_blob`` fetches a blob as ranges of
``RANGE_BYTES`` over ``RANGE_STREAMS`` connections at once: one frame of
a few GiB costs the native runtime tens of seconds of CPU on each side,
and 16 MiB frames over 8 connections move the same bytes about ten
times as fast (H100 host, ``chip_smoke.py``'s cold starts). Against the
reference's server, which has no ``info``, it falls back to ``pull``.

Checkpoints (``brpc_tpu_torch.checkpoint``): ``ParamServer.snapshot_to``
wraps the blob the server keeps in a TCK1 header, without decoding it,
and streams it to a ``CheckpointStore``; ``ParamServer.restore`` builds a
server from the store's latest snapshot with the same parameters and
step count, so pushes go on from N + 1. ``start_device`` serves on the
device fabric (``ici://slice/chip``) beside TCP.
"""

from __future__ import annotations

import random
import struct
import threading
import time
import warnings
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, NamedTuple

import numpy as np
import torch

from brpc_tpu_torch import runtime

_MAGIC = b"TPS1"
BF16_TAG = "bfloat16"
# A blob and its frame (12-byte header, then the RPC meta) must fit the
# u32 body size of cpp/trpc/meta_codec.cc:263; 1 MiB covers the meta.
MAX_BLOB_BYTES = (1 << 32) - (1 << 20)
RANGE_BYTES = 16 << 20
RANGE_STREAMS = 8
_INFO = struct.Struct("<QQ")
_RANGE = struct.Struct("<QQQ")


class Bfloat16Bits(NamedTuple):
    """The raw 16-bit view (``uint16`` or ``int16``) of a bf16 array, to
    encode under the tag ``"bfloat16"``."""
    bits: np.ndarray


def _tag_and_bytes(a):
    """(dtype tag, C-order numpy array of the entry's bytes)."""
    if isinstance(a, Bfloat16Bits):
        bits = np.asarray(a.bits, order="C")
        if bits.dtype.itemsize != 2:
            raise TypeError(f"bfloat16 bits must be 16-bit, not {bits.dtype}")
        return BF16_TAG, bits
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return BF16_TAG, t.view(torch.int16).numpy()
        a = t.numpy()
    # (np.ascontiguousarray would promote 0-d arrays to 1-d)
    a = np.asarray(a, order="C")
    return str(a.dtype), a


def _entry_bytes(name: str, a) -> int:
    """Bytes of one entry in a blob, from the array's metadata alone."""
    if isinstance(a, torch.Tensor):
        tag = (BF16_TAG if a.dtype == torch.bfloat16
               else str(np.dtype(str(a.dtype).removeprefix("torch."))))
        shape, nbytes = a.shape, a.numel() * a.element_size()
    else:
        bits = a.bits if isinstance(a, Bfloat16Bits) else a
        bits = np.asarray(bits)
        tag = BF16_TAG if isinstance(a, Bfloat16Bits) else str(bits.dtype)
        shape, nbytes = bits.shape, bits.nbytes
    return 12 + len(name.encode()) + len(tag.encode()) + 8 * len(shape) \
        + nbytes


def blob_bytes(arrays: Dict[str, object]) -> int:
    """Size of ``encode_arrays(arrays)``, without encoding."""
    return 8 + sum(_entry_bytes(name, a) for name, a in arrays.items())


def _encode(arrays: Dict[str, object]) -> bytearray:
    """TPS1 bytes of ``arrays`` in one buffer, each array's data copied
    once."""
    entries = [(name.encode(), *_tag_and_bytes(a))
               for name, a in sorted(arrays.items())]
    out = bytearray(8 + sum(12 + len(nb) + len(tag) + 8 * data.ndim
                            + data.nbytes for nb, tag, data in entries))
    struct.pack_into("<4sI", out, 0, _MAGIC, len(entries))
    off = 8
    for nb, tag, data in entries:
        db = tag.encode()
        head = struct.pack(f"<I{len(nb)}sI{len(db)}sI{data.ndim}q", len(nb),
                           nb, len(db), db, data.ndim, *data.shape)
        out[off:off + len(head)] = head
        off += len(head)
        np.frombuffer(out, np.uint8, count=data.nbytes, offset=off)[:] = \
            data.reshape(-1).view(np.uint8)
        off += data.nbytes
    return out


def encode_arrays(arrays: Dict[str, object]) -> bytes:
    """name -> array dict (numpy arrays, torch tensors, ``Bfloat16Bits``)
    to TPS1 bytes."""
    return bytes(_encode(arrays))


def decode_arrays(blob, copy: bool = True) -> Dict[str, object]:
    """TPS1 bytes (or any buffer) -> name -> numpy array, or torch bf16
    tensor for a ``"bfloat16"`` entry.

    ``copy=False`` returns read-only views into ``blob`` (they keep it
    alive and must not be written)."""
    mv = memoryview(blob)
    if bytes(mv[:4]) != _MAGIC:
        raise ValueError("bad tensor blob")
    off = 4
    (n_arrays,) = struct.unpack_from("<I", mv, off)
    off += 4
    out = {}
    for _ in range(n_arrays):
        (nlen,) = struct.unpack_from("<I", mv, off)
        off += 4
        name = bytes(mv[off:off + nlen]).decode()
        off += nlen
        (dlen,) = struct.unpack_from("<I", mv, off)
        off += 4
        tag = bytes(mv[off:off + dlen]).decode()
        off += dlen
        (ndim,) = struct.unpack_from("<I", mv, off)
        off += 4
        shape = struct.unpack_from(f"<{ndim}q", mv, off)
        off += 8 * ndim
        n_elems = int(np.prod(shape)) if ndim else 1
        if tag == BF16_TAG:
            a = _bf16_tensor(mv, off, n_elems, shape, copy)
            off += 2 * n_elems
        else:
            dtype = np.dtype(tag)
            a = np.frombuffer(mv, dtype=dtype, count=n_elems,
                              offset=off).reshape(shape)
            if copy:
                a = a.copy()  # independent of the blob's lifetime
            off += n_elems * dtype.itemsize
        out[name] = a
    return out


def _bf16_tensor(mv, off: int, n: int, shape, copy: bool) -> torch.Tensor:
    """A bf16 tensor of ``n`` elements at ``off`` of ``mv``, read as int16
    (numpy has no bfloat16 without ml_dtypes)."""
    if n == 0:
        return torch.empty(shape, dtype=torch.bfloat16)
    if copy:
        bits = torch.from_numpy(
            np.frombuffer(mv, dtype=np.int16, count=n, offset=off).copy())
    else:
        with warnings.catch_warnings():
            # A read-only blob: torch warns that it cannot guard writes.
            warnings.simplefilter("ignore", UserWarning)
            bits = torch.frombuffer(mv, dtype=torch.int16, count=n,
                                    offset=off)
    return bits.reshape(shape).view(torch.bfloat16)


def groups(arrays: Dict[str, object],
           cap: int = 0) -> List[Dict[str, object]]:
    """Split a name -> array dict into groups of whole arrays whose blobs
    are each at most ``cap`` bytes (``MAX_BLOB_BYTES`` by default): largest
    first, each into the first group with room. One group when the dict
    fits. A single array too large for a blob of its own raises."""
    cap = cap or MAX_BLOB_BYTES
    sized = []
    for name, a in arrays.items():
        n = _entry_bytes(name, a)
        if 8 + n > cap:
            raise ValueError(
                f"array {name!r} takes {8 + n} bytes as a blob, more than "
                f"the cap of {cap} (a frame's u32 body size, "
                f"cpp/trpc/meta_codec.cc:263)")
        sized.append((n, name))
    out: List[Dict[str, object]] = []
    room: List[int] = []
    for n, name in sorted(sized, key=lambda x: (-x[0], x[1])):
        for i, r in enumerate(room):
            if n <= r:
                out[i][name] = arrays[name]
                room[i] -= n
                break
        else:
            out.append({name: arrays[name]})
            room.append(cap - 8 - n)
    return out


_body_cap_mu = threading.Lock()
_body_cap_set = False


def fit_blobs_in_frames() -> None:
    """Raise this process's receive cap (``trpc_max_body_size``) so a frame
    carrying a blob of ``MAX_BLOB_BYTES`` is accepted. Once per process."""
    global _body_cap_set
    with _body_cap_mu:
        if not _body_cap_set:
            runtime.set_max_body_size(1 << 32)
            _body_cap_set = True


def _check_cap(size: int) -> None:
    if size > MAX_BLOB_BYTES:
        raise ValueError(
            f"blob of {size} bytes exceeds MAX_BLOB_BYTES {MAX_BLOB_BYTES} "
            f"(a frame's u32 body size, cpp/trpc/meta_codec.cc:263); serve "
            f"it in groups")


def fetch_ranges(size: int, connect, fetch) -> bytearray:
    """A blob of ``size`` bytes fetched as ranges of ``RANGE_BYTES`` over
    ``RANGE_STREAMS`` connections at once: ``connect()`` opens a client
    for one thread (closed after its ranges), ``fetch(client, offset,
    length)`` returns a ``runtime.NativeBuffer`` of those bytes."""
    blob = bytearray(size)
    offsets = list(range(0, size, RANGE_BYTES))
    streams = max(1, min(RANGE_STREAMS, len(offsets)))

    def fetch_some(offs) -> None:
        if not offs:
            return
        client = connect()
        try:
            for off in offs:
                n = min(RANGE_BYTES, size - off)
                buf = fetch(client, off, n)
                try:
                    if len(buf) != n:
                        raise runtime.RpcError(
                            runtime.ERESPONSE,
                            f"range of {len(buf)} bytes, want {n}")
                    blob[off:off + n] = buf.view
                finally:
                    buf.release()
        finally:
            client.close()

    with ThreadPoolExecutor(max_workers=streams,
                            thread_name_prefix="blob-range") as ex:
        for fut in [ex.submit(fetch_some, offsets[k::streams])
                    for k in range(streams)]:
            fut.result()
    return blob


class ParamServer:
    """Holds parameters; serves ``pull`` and ``push`` (SGD apply).

    The parameters are kept as their TPS1 blob, which a pull sends as it
    is and a push replaces; a blob over ``MAX_BLOB_BYTES`` is refused at
    construction and never sent."""

    SERVICE = "ParamServer"

    def __init__(self, params: Dict[str, object], lr: float = 1e-2,
                 version: int = 0):
        _check_cap(blob_bytes(params))
        self._setup(_encode(params), lr, version)

    def _setup(self, blob: bytearray, lr: float, version: int) -> None:
        self._blob = blob  # never written once built
        self._lr = lr
        self._mu = threading.Lock()
        self._version = version
        fit_blobs_in_frames()  # a push may carry a full blob
        self._srv = runtime.Server()
        for name in ("pull", "push", "info", "pull_range"):
            self._srv.add_method(self.SERVICE, name,
                                 getattr(self, f"_{name}"))

    # -- checkpoint and resume (brpc_tpu_torch.checkpoint) --------------------

    def snapshot_to(self, store_addr: str) -> int:
        """Stream a consistent snapshot to a ``CheckpointStore`` and return
        the step count it holds (its commit confirmed)."""
        from brpc_tpu_torch import checkpoint

        with self._mu:
            step, lr, blob = self._version, self._lr, self._blob
        checkpoint.save_blob(store_addr, step, lr, blob)
        return step

    @classmethod
    def restore(cls, store_addr: str) -> "ParamServer":
        """A server rebuilt from the store's latest snapshot: the same
        parameters (its blob byte for byte) and step count; pushes go on
        from N + 1."""
        from brpc_tpu_torch import checkpoint

        step, lr, body = checkpoint._split(checkpoint.load_blob(store_addr))
        decode_arrays(body, copy=False)  # the body must decode
        srv = cls.__new__(cls)
        srv._setup(bytearray(body), lr, step)
        return srv

    def version(self) -> int:
        with self._mu:
            return self._version

    def _pull(self, _req: bytes) -> bytearray:
        with self._mu:
            _check_cap(len(self._blob))
            return self._blob

    def _info(self, _req: bytes) -> bytes:
        with self._mu:
            return _INFO.pack(len(self._blob), self._version)

    def _pull_range(self, req: bytes) -> memoryview:
        version, off, n = _RANGE.unpack(req)
        with self._mu:
            if version != self._version:
                raise ValueError(f"version {version} replaced by "
                                 f"{self._version}")
            blob = self._blob
        if off + n > len(blob):
            raise ValueError(f"range [{off}, {off + n}) past the blob's "
                             f"{len(blob)} bytes")
        return memoryview(blob)[off:off + n]

    def _push(self, req: bytes) -> bytes:
        grads = decode_arrays(req)
        with self._mu:
            params = decode_arrays(self._blob)
            # Validate everything before changing anything: a failed push
            # must leave params untouched so clients may safely retry.
            for name, g in grads.items():
                p = params.get(name)
                if p is None or tuple(p.shape) != tuple(g.shape):
                    raise ValueError(f"bad grad for {name!r}")
            for name, g in grads.items():
                p = params[name]
                if isinstance(p, torch.Tensor):
                    params[name] = (p - self._lr * torch.as_tensor(g)).to(
                        p.dtype)
                else:
                    params[name] = (p - self._lr * g).astype(p.dtype)
            self._blob = _encode(params)
            self._version += 1
            return struct.pack("<Q", self._version)

    def start(self, port: int = 0) -> int:
        return self._srv.start(port)

    def start_device(self, slice_: int, chip: int) -> None:
        """Also serve on the device fabric at ``ici://slice_/chip``."""
        self._srv.start_device(slice_, chip)

    def params(self) -> Dict[str, object]:
        with self._mu:
            return decode_arrays(self._blob)

    def close(self) -> None:
        self._srv.stop()
        self._srv.close()


class ParamClient:
    """Worker-side stub: pull params, push grads.

    Retriable RPC errors (``RpcError.retriable``) are retried up to
    ``retries`` times with exponential backoff and jitter; a re-pushed
    gradient the server did apply re-applies (``retries=0`` for at most
    once)."""

    def __init__(self, addr: str, retries: int = 8,
                 backoff_s: float = 0.02, backoff_max_s: float = 1.0,
                 **channel_kw):
        fit_blobs_in_frames()  # a pull answers with a full blob
        self._addr = addr
        self._channel_kw = channel_kw
        self._ch = runtime.Channel(addr, **channel_kw)
        self._retries = retries
        self._backoff_s = backoff_s
        self._backoff_max_s = backoff_max_s

    def _call_with_retry(self, method: str, payload: bytes = b"",
                         view: bool = False):
        """The call's response as ``bytes``, or with ``view`` as a
        ``runtime.NativeBuffer`` (no copy; the caller releases it)."""
        call = self._ch.call_view if view else self._ch.call
        attempt = 0
        while True:
            try:
                return call(ParamServer.SERVICE, method, payload)
            except runtime.RpcError as e:
                if not e.retriable or attempt >= self._retries:
                    raise
                delay = min(self._backoff_s * (2 ** attempt),
                            self._backoff_max_s)
                time.sleep(delay * (1.0 + 0.25 * random.random()))
                attempt += 1

    def pull(self) -> Dict[str, object]:
        return decode_arrays(self._call_with_retry("pull"))

    def pull_blob(self):
        """The server's whole TPS1 blob (a ``bytearray``): ranges of
        ``RANGE_BYTES`` over ``RANGE_STREAMS`` connections at once, or one
        ``pull`` from a server without ranges (the reference's). A push
        that lands mid-fetch restarts it."""
        for _ in range(self._retries + 1):
            try:
                size, version = _INFO.unpack(self._call_with_retry("info"))
            except runtime.RpcError as e:
                if e.code != runtime.ENOMETHOD:
                    raise
                return self._call_with_retry("pull")
            try:
                return fetch_ranges(
                    size, lambda: ParamClient(self._addr,
                                              retries=self._retries,
                                              **self._channel_kw),
                    lambda c, off, n: c._call_with_retry(
                        "pull_range", _RANGE.pack(version, off, n),
                        view=True))
            except runtime.RpcError as e:
                if e.code != runtime.EAPP or "replaced" not in e.text:
                    raise
                # A push replaced the blob: fetch the new one.
        raise runtime.RpcError(runtime.EAPP, "blob kept changing mid-fetch")

    def push(self, grads: Dict[str, object]) -> int:
        rsp = self._call_with_retry("push", encode_arrays(grads))
        return struct.unpack("<Q", rsp)[0]

    def close(self) -> None:
        self._ch.close()
