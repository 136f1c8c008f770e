"""Checkpoint and resume for the parameter server: the port's own copy of
the reference's ``checkpoint`` module, on the same TCK1 bytes and the same
``CkptStore`` wire, so either package's writer works against either
package's store.

- A checkpoint is one self-describing blob: the magic ``TCK1``, a
  ``<IQdQ`` header (format version, step count, learning rate, body
  length), then the parameters as a TPS1 body (``param_server``'s codec,
  so torch tensors, bf16 and CUDA ones included, encode as the
  reference's arrays do).
- A snapshot streams to a ``CheckpointStore`` in 1 MiB messages (the
  windowed stream, over TCP or the device fabric). The store commits at
  the stream's close, and only a blob that decodes: a writer that died
  mid-stream leaves the previous snapshot in force.
- With a directory, a commit is durable: ``ckpt-<step>.tck`` is written
  to a temporary file, fsynced, renamed into place and the directory
  fsynced. The store keeps the ``keep`` newest snapshots and, restarted
  on its directory (after a ``kill -9``, say), recovers them, dropping
  temporary files and quarantining files that fail to decode. Each file
  is a whole blob that ``decode_checkpoint`` loads on its own.
- A writer confirms its own step by membership (``confirm``), so writers
  committing other steps at the same time can neither hide nor fake its
  commit. ``load_checkpoint`` fetches the latest or a retained step.

Differences from the reference:

- A blob travels back in one frame of ``get``, whose body size is a u32
  (``cpp/trpc/meta_codec.cc:263``), so a checkpoint is at most
  ``param_server.MAX_BLOB_BYTES``: a larger one is refused before its
  first byte is sent, and the error names its size. The store and
  ``load_checkpoint`` raise their process's receive cap to fit such a
  frame (``param_server.fit_blobs_in_frames``).
- The port's store also answers ``info`` (``<Q step>`` or empty -> ``<u64
  blob bytes> <u64 step>``) and ``get_range`` (``<u64 step> <u64 offset>
  <u64 length>`` -> those bytes of that step's blob), and
  ``load_checkpoint`` fetches a blob from it as ranges of
  ``param_server.RANGE_BYTES`` over ``RANGE_STREAMS`` connections at
  once, as ``ParamClient.pull_blob`` does: one frame of a few GiB costs
  the native runtime tens of seconds of CPU on each side. Against the
  reference's store, which has no ``info``, it falls back to ``get``.
- A store adds its commits' write and fsync time to application
  counters on its process's ``/vars`` (``ckpt_write_us``,
  ``ckpt_fsync_us``).

    python -m brpc_tpu_torch.checkpoint --dir DIR [--keep N] [--port P]

runs a store in a process of its own: it prints ``READY <port> <seconds
the recovery took> <steps recovered>`` and serves until killed or until
its standard input closes.
"""

from __future__ import annotations

import itertools
import os
import struct
import sys
import threading
import time
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from brpc_tpu_torch import runtime
from brpc_tpu_torch.param_server import (MAX_BLOB_BYTES, _encode,
                                         blob_bytes, decode_arrays,
                                         fetch_ranges, fit_blobs_in_frames)

_CKPT_MAGIC = b"TCK1"
_FORMAT_VERSION = 1
_HEADER = struct.Struct("<4sIQdQ")  # the magic, then <IQdQ: 32 bytes
_CHUNK = 1 << 20  # 1 MiB stream messages
_STEP = struct.Struct("<Q")
_INFO = struct.Struct("<QQ")
_RANGE = struct.Struct("<QQQ")
# A call's deadline: a blob's one-frame get takes tens of seconds at a few
# GiB, and a 16 MiB range of a busy store can outlast the native default
# of 1 s.
_TIMEOUT_MS = 600_000

_tmp_seq = itertools.count()


def checkpoint_bytes(params: Dict[str, object]) -> int:
    """Size of ``encode_checkpoint(step, lr, params)``, without encoding."""
    return _HEADER.size + blob_bytes(params)


def _check_size(size: int) -> None:
    if size > MAX_BLOB_BYTES:
        raise ValueError(
            f"checkpoint of {size} bytes exceeds MAX_BLOB_BYTES "
            f"{MAX_BLOB_BYTES}: a store returns a blob in one frame, whose "
            f"body size is a u32 (cpp/trpc/meta_codec.cc:263)")


def _header(step: int, lr: float, body_len: int) -> bytes:
    return _HEADER.pack(_CKPT_MAGIC, _FORMAT_VERSION, step, lr, body_len)


def encode_checkpoint(step: int, lr: float,
                      params: Dict[str, object]) -> bytes:
    """The TCK1 blob of ``params`` (numpy arrays, torch tensors,
    ``param_server.Bfloat16Bits``) at ``step`` and ``lr``."""
    _check_size(checkpoint_bytes(params))
    body = _encode(params)
    return _header(step, lr, len(body)) + body


def _split(blob) -> Tuple[int, float, memoryview]:
    """(step, lr, the TPS1 body as a view of ``blob``); ValueError for a
    blob that is not a whole TCK1 checkpoint."""
    mv = memoryview(blob)
    if len(mv) < _HEADER.size or bytes(mv[:4]) != _CKPT_MAGIC:
        raise ValueError("bad checkpoint magic")
    _, fmt, step, lr, body_len = _HEADER.unpack_from(mv)
    if fmt != _FORMAT_VERSION:
        raise ValueError(f"unsupported checkpoint format {fmt}")
    body = mv[_HEADER.size:]
    if len(body) != body_len:
        raise ValueError(f"truncated checkpoint: {len(body)} != {body_len}")
    return step, lr, body


def decode_checkpoint(blob) -> Tuple[int, float, Dict[str, object]]:
    """(step, lr, name -> numpy array, or torch bf16 tensor for a bf16
    entry)."""
    step, lr, body = _split(blob)
    return step, lr, decode_arrays(body)


def _validate(blob) -> int:
    """The step of a blob that decodes whole; raises otherwise."""
    step, _lr, body = _split(blob)
    decode_arrays(body, copy=False)
    return step


def _ckpt_filename(step: int) -> str:
    return f"ckpt-{step:020d}.tck"


def _step_of_filename(name: str) -> Optional[int]:
    if not (name.startswith("ckpt-") and name.endswith(".tck")):
        return None
    try:
        return int(name[5:-4])
    except ValueError:
        return None


class CheckpointStore:
    """Checkpoint peer: accepts snapshot streams and serves them back.

    - stream ``put``: a chunked upload, committed at the stream's close
      only if the whole blob decodes;
    - unary ``get``: empty request, the latest blob; ``<Q step>``, that
      retained step;
    - unary ``stat``: ``<Q step>`` of the latest (``2**64 - 1`` when
      empty);
    - unary ``confirm``: ``<Q step>`` -> ``b"\\x01"`` iff that step
      committed (also when GC has since displaced it);
    - unary ``list``: packed ``<Q`` steps retained, ascending;
    - unary ``info`` and ``get_range``: a blob's size, and its bytes by
      range (see the module docstring).

    With ``directory``, commits are durable and a restarted store
    recovers its history; without it the history lives in memory.
    ``keep`` bounds the history (older snapshots are removed after each
    commit)."""

    SERVICE = "CkptStore"
    _EMPTY = (1 << 64) - 1
    _COMMIT_LOG_BOUND = 4096

    def __init__(self, directory: Optional[str] = None, keep: int = 4) -> None:
        if keep < 1:
            raise ValueError("keep must be >= 1")
        self._mu = threading.Lock()
        self._dir = directory
        self._keep = keep
        # step -> blob in memory (a disk store keeps only the newest);
        # membership is self._steps.
        self._cache: "OrderedDict[int, bytes]" = OrderedDict()
        self._steps: set = set()
        # Every step that ever committed (bounded): confirm() answers
        # "committed, then displaced by GC" truthfully.
        self._committed_log: "OrderedDict[int, None]" = OrderedDict()
        self._partial: Dict[int, list] = {}  # stream id -> chunks
        self.recover_s = 0.0
        if self._dir is not None:
            os.makedirs(self._dir, exist_ok=True)
            t0 = time.monotonic()
            self._recover_from_disk()
            self.recover_s = time.monotonic() - t0
        fit_blobs_in_frames()  # a get answers with a whole blob
        self._srv = runtime.Server()
        self._srv.add_stream_sink(self.SERVICE, "put", self._on_put)
        for name in ("get", "stat", "confirm", "list", "info", "get_range"):
            self._srv.add_method(self.SERVICE, name,
                                 getattr(self, f"_{name}"))

    # -- durability -----------------------------------------------------------

    def _recover_from_disk(self) -> None:
        """Load the committed history; drop temporary files (a writer that
        died before its rename) and quarantine files that do not decode
        (renamed only after their fsync, so damaged at rest)."""
        for name in sorted(os.listdir(self._dir)):
            path = os.path.join(self._dir, name)
            if name.endswith(".tmp"):
                os.unlink(path)
                continue
            step = _step_of_filename(name)
            if step is None:
                continue
            try:
                with open(path, "rb") as f:
                    blob = f.read()
                if _validate(blob) != step:
                    raise ValueError("filename/blob step mismatch")
            except Exception:  # noqa: BLE001 — any damage quarantines
                os.rename(path, path + ".corrupt")
                continue
            self._steps.add(step)
            self._remember(step, blob)

    def _persist(self, step: int, blob: bytes) -> None:
        """Write to a temporary file, fsync, rename, fsync the directory."""
        final = os.path.join(self._dir, _ckpt_filename(step))
        # Two threads committing the same step never share a temp file.
        tmp = (final +
               f".{os.getpid()}.{threading.get_ident()}.{next(_tmp_seq)}.tmp")
        t0 = time.monotonic()
        fd = os.open(tmp, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
        try:
            # A write(2) moves at most ~2 GiB: loop.
            view = memoryview(blob)
            while view:
                view = view[os.write(fd, view):]
            t1 = time.monotonic()
            os.fsync(fd)
        finally:
            os.close(fd)
        os.rename(tmp, final)
        dfd = os.open(self._dir, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        t2 = time.monotonic()
        runtime.app_counter_add("ckpt_write_us", int((t1 - t0) * 1e6))
        runtime.app_counter_add("ckpt_fsync_us", int((t2 - t1) * 1e6))

    def _remember(self, step: int, blob: bytes) -> None:
        """Cache a blob under the store's bound, evicting the smallest step
        (an out-of-order commit must not evict the latest); a disk store
        caches only the newest, its history is read from the files."""
        self._committed_log[step] = None
        self._committed_log.move_to_end(step)
        while len(self._committed_log) > self._COMMIT_LOG_BOUND:
            self._committed_log.popitem(last=False)
        self._cache[step] = blob
        bound = 1 if self._dir is not None else self._keep
        while len(self._cache) > bound:
            del self._cache[min(self._cache)]

    def _gc(self) -> None:
        """Drop the oldest snapshots past ``keep`` (never the latest)."""
        while len(self._steps) > self._keep:
            victim = min(self._steps)
            self._steps.discard(victim)
            self._cache.pop(victim, None)
            if self._dir is not None:
                try:
                    os.unlink(os.path.join(self._dir, _ckpt_filename(victim)))
                except FileNotFoundError:
                    pass

    # -- the service ----------------------------------------------------------

    def _on_put(self, sid: int, data: Optional[bytes]) -> None:
        if data is not None:
            with self._mu:
                self._partial.setdefault(sid, []).append(data)
            return
        # The stream closed: commit or discard. The assembly, the check and
        # the disk commit run outside the lock, which covers only the
        # metadata, so no other call waits on a commit.
        with self._mu:
            chunks = self._partial.pop(sid, [])
        blob = b"".join(chunks)
        del chunks
        try:
            step = _validate(blob)
        except Exception:  # noqa: BLE001 — a partial or corrupt upload
            return         # leaves the previous snapshot in force
        if self._dir is not None:
            try:
                self._persist(step, blob)
            except OSError:
                return  # nothing committed
        with self._mu:
            self._steps.add(step)
            self._remember(step, blob)
            self._gc()

    def _cached(self, req: bytes) -> Tuple[int, Optional[bytes]]:
        """(the step a get-like request names, empty for the latest; its
        blob when in memory, else None)."""
        with self._mu:
            if not self._steps:
                raise ValueError("no checkpoint committed yet")
            if len(req) == 8:
                (step,) = _STEP.unpack(req)
                if step not in self._steps:
                    raise ValueError(f"step {step} not committed/retained")
            elif not req:
                step = max(self._steps)
            else:
                raise ValueError("request must be empty or <Q step>")
            return step, self._cache.get(step)

    def _read(self, step: int, off: int = 0, n: int = -1) -> bytes:
        """Bytes of a step's file, read outside the lock (a memory store
        holds every retained blob); a GC meanwhile reads as "not
        retained"."""
        try:
            if self._dir is None:
                raise FileNotFoundError
            with open(os.path.join(self._dir, _ckpt_filename(step)),
                      "rb") as f:
                f.seek(off)
                return f.read(n)
        except FileNotFoundError:
            raise ValueError(f"snapshot for step {step} not retained") \
                from None

    def _get(self, req: bytes) -> bytes:
        step, blob = self._cached(req)
        if blob is None:
            blob = self._read(step)
        _check_size(len(blob))
        return blob

    def _info(self, req: bytes) -> bytes:
        step, blob = self._cached(req)
        if blob is None:
            try:
                return _INFO.pack(os.path.getsize(os.path.join(
                    self._dir, _ckpt_filename(step))), step)
            except FileNotFoundError:
                raise ValueError(f"snapshot for step {step} not retained") \
                    from None
        return _INFO.pack(len(blob), step)

    def _get_range(self, req: bytes):
        step, off, n = _RANGE.unpack(req)
        step, blob = self._cached(_STEP.pack(step))
        out = (memoryview(blob)[off:off + n] if blob is not None
               else self._read(step, off, n))
        if len(out) != n:
            raise ValueError(f"range [{off}, {off + n}) past step {step}'s "
                             f"blob")
        return out

    def _stat(self, _req: bytes) -> bytes:
        return _STEP.pack(self.step())

    def _confirm(self, req: bytes) -> bytes:
        (step,) = _STEP.unpack(req)
        with self._mu:
            ok = step in self._steps or step in self._committed_log
        return b"\x01" if ok else b"\x00"

    def _list(self, _req: bytes) -> bytes:
        return b"".join(_STEP.pack(s) for s in self.steps())

    # -- lifecycle ------------------------------------------------------------

    def start(self, port: int = 0) -> int:
        return self._srv.start(port)

    def start_device(self, slice_: int, chip: int) -> None:
        """Also listen on the device fabric at ``ici://slice_/chip``."""
        self._srv.start_device(slice_, chip)

    def step(self) -> int:
        with self._mu:
            return max(self._steps) if self._steps else self._EMPTY

    def steps(self) -> List[int]:
        with self._mu:
            return sorted(self._steps)

    def close(self) -> None:
        self._srv.stop()
        self._srv.close()


def _save_parts(store_addr: str, step: int, parts, timeout_s: float) -> None:
    """Stream a blob given as consecutive buffers to the store in messages
    of at most ``_CHUNK`` bytes, then wait until ``step`` is confirmed."""
    with runtime.Channel(store_addr, timeout_ms=_TIMEOUT_MS) as ch:
        with ch.open_stream(CheckpointStore.SERVICE, "put") as stream:
            for part in parts:
                mv = memoryview(part).cast("B")
                for off in range(0, len(mv), _CHUNK):
                    stream.write(mv[off:off + _CHUNK])
        # The commit happens when the close lands: confirm by membership.
        want = _STEP.pack(step)
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if ch.call(CheckpointStore.SERVICE, "confirm", want) == b"\x01":
                return
            time.sleep(0.02)
    raise TimeoutError("checkpoint commit not observed")


def save_checkpoint(store_addr: str, step: int, lr: float,
                    params: Dict[str, object],
                    timeout_s: float = 30.0) -> None:
    """Stream a snapshot to the store and wait for its commit.

    A raise means nothing was committed, so the caller may retry against
    the same or another store. (Two writers of the same step: the last
    commit wins.) A checkpoint over ``MAX_BLOB_BYTES`` raises ValueError
    before anything is sent."""
    _check_size(checkpoint_bytes(params))
    body = _encode(params)
    _save_parts(store_addr, step, (_header(step, lr, len(body)), body),
                timeout_s)


def save_blob(store_addr: str, step: int, lr: float, body,
              timeout_s: float = 30.0) -> None:
    """``save_checkpoint`` of a TPS1 body that is already encoded (a
    ``ParamServer``'s), wrapped in the TCK1 header without decoding it."""
    _check_size(_HEADER.size + len(body))
    _save_parts(store_addr, step, (_header(step, lr, len(body)), body),
                timeout_s)


def load_blob(store_addr: str, step: Optional[int] = None):
    """The latest (or ``step``'s) TCK1 blob from a store: ranges over
    ``RANGE_STREAMS`` connections from the port's store, one ``get`` from
    the reference's."""
    req = b"" if step is None else _STEP.pack(step)
    fit_blobs_in_frames()  # a get answers with a whole blob
    with runtime.Channel(store_addr, timeout_ms=_TIMEOUT_MS) as ch:
        try:
            size, got = _INFO.unpack(
                ch.call(CheckpointStore.SERVICE, "info", req))
        except runtime.RpcError as e:
            if e.code != runtime.ENOMETHOD:
                raise
            return ch.call(CheckpointStore.SERVICE, "get", req)
    return fetch_ranges(
        size, lambda: runtime.Channel(store_addr, timeout_ms=_TIMEOUT_MS),
        lambda ch, off, n: ch.call_view(CheckpointStore.SERVICE, "get_range",
                                        _RANGE.pack(got, off, n)))


def load_checkpoint(store_addr: str, step: Optional[int] = None
                    ) -> Tuple[int, float, Dict[str, object]]:
    """Fetch the latest (or a retained ``step``) and decode it."""
    return decode_checkpoint(load_blob(store_addr, step))


def list_checkpoints(store_addr: str) -> List[int]:
    with runtime.Channel(store_addr, timeout_ms=_TIMEOUT_MS) as ch:
        raw = ch.call(CheckpointStore.SERVICE, "list")
    return [s for (s,) in struct.iter_unpack("<Q", raw)]


def _store_main(argv: List[str]) -> None:
    """A store in a process of its own (see the module docstring)."""
    args = dict(zip(argv[::2], argv[1::2]))
    store = CheckpointStore(directory=args["--dir"],
                            keep=int(args.get("--keep", "4")))
    port = store.start(int(args.get("--port", "0")))
    print(f"READY {port} {store.recover_s:.6f} {len(store.steps())}",
          flush=True)
    sys.stdin.read()  # until the parent closes the pipe
    store.close()


if __name__ == "__main__":
    _store_main(sys.argv[1:])
