"""Array redistribution: ``redistribute(src_sharding, dst_sharding)``, the
port's own copy of the reference's planner and executor, over this
package's runtime and on the same ``__rd`` wire.

A sharding change is decomposed into the minimal byte exchange ("Memory-
efficient array redistribution through portable collective
communication"): every byte a destination rank needs lands exactly once,
sourced locally when the rank already holds it and pulled from exactly
one holder otherwise, instead of gathering everything and slicing (k x N
bytes moved, the whole array on every rank).

The data plane is the native ``__rd`` service (cpp/trpc/redistribute.cc):
ranks hold named shards in a process-wide table whose bytes live in
registered send-arena blocks, so every pull between ranks on the device
fabric posts by descriptor and lands retained. The planner emits one
fetch work order per destination rank, a batch of rank-local moves and
direct peer pulls that never route through the root; the root's only
traffic is the small control RPCs.

Layers:

- ``ShardSpec``: how a flattened (C-order) byte array is sharded across k
  ranks — per-rank lists of (offset, length) byte runs. Constructors for
  replicated layouts and block shardings; ``Mesh.sharding`` is the
  mesh-aware wrapper (partition array axes over named mesh axes, exactly
  the usual named-axis model, dependency-free).
- ``plan_redistribute(src, dst)``: the minimal transfer plan.
- ``execute_plan`` / ``redistribute``: drive the fetches (concurrently,
  one per destination rank) and optionally commit the assembled entries
  over the old name — the atomic cut-over a role flip wants.
"""

from __future__ import annotations

import bisect
import itertools
import struct
import threading
from typing import Dict, List, Optional, Sequence, Tuple

Run = Tuple[int, int]  # (byte offset into the flattened array, length)


def _coalesce(runs: List[Run]) -> List[Run]:
    """Sort and merge adjacent/overlapping runs."""
    out: List[Run] = []
    for off, ln in sorted(runs):
        if ln <= 0:
            continue
        if out and off <= out[-1][0] + out[-1][1]:
            po, pl = out[-1]
            out[-1] = (po, max(pl, off + ln - po))
        else:
            out.append((off, ln))
    return out


class ShardSpec:
    """Per-rank byte-run layout of one logical array.

    ``ranges[r]`` lists the (offset, length) byte runs of the flattened
    array that rank r holds, in offset order; a rank's ENTRY in the native
    shard table is those runs concatenated in order.
    """

    def __init__(self, nbytes: int, ranges: Sequence[Sequence[Run]]):
        self.nbytes = int(nbytes)
        self.ranges: List[List[Run]] = [_coalesce(list(rr)) for rr in ranges]
        for rr in self.ranges:
            for off, ln in rr:
                if off < 0 or off + ln > self.nbytes:
                    raise ValueError("run outside the array")

    @property
    def nranks(self) -> int:
        return len(self.ranges)

    def entry_bytes(self, rank: int) -> int:
        return sum(ln for _, ln in self.ranges[rank])

    @classmethod
    def replicated(cls, nbytes: int, nranks: int) -> "ShardSpec":
        return cls(nbytes, [[(0, nbytes)]] * nranks)

    @classmethod
    def blocks(cls, shape: Sequence[int], itemsize: int,
               grid: Sequence[int]) -> "ShardSpec":
        """Block sharding: axis d of `shape` is split into grid[d] equal
        blocks (grid[d] must divide shape[d]); ranks enumerate the grid in
        row-major order. grid entries of 1 leave an axis whole."""
        shape = list(shape)
        grid = list(grid)
        if len(grid) != len(shape):
            raise ValueError("grid rank must match array rank")
        for dim, g in zip(shape, grid):
            if g <= 0 or dim % g != 0:
                raise ValueError(f"grid {g} does not divide axis {dim}")
        ranges = []
        for cell in itertools.product(*(range(g) for g in grid)):
            lo = [c * (dim // g) for c, dim, g in zip(cell, shape, grid)]
            hi = [(c + 1) * (dim // g) for c, dim, g in zip(cell, shape, grid)]
            ranges.append(_block_runs(shape, itemsize, lo, hi))
        nbytes = itemsize
        for dim in shape:
            nbytes *= dim
        return cls(nbytes, ranges)


def _block_runs(shape: Sequence[int], itemsize: int, lo: Sequence[int],
                hi: Sequence[int]) -> List[Run]:
    """Byte runs of the hyperrectangle [lo, hi) of a C-order array,
    coalesced into maximal contiguous spans."""
    nd = len(shape)
    strides = [itemsize] * nd
    for d in range(nd - 2, -1, -1):
        strides[d] = strides[d + 1] * shape[d + 1]
    # `cut`: the first axis after which the block spans every trailing
    # axis completely — everything from cut onward is one contiguous span
    # per index combination of the leading axes.
    cut = nd - 1
    while cut > 0 and lo[cut] == 0 and hi[cut] == shape[cut]:
        cut -= 1
    span = (hi[cut] - lo[cut]) * strides[cut]
    runs = []
    for idx in itertools.product(*(range(lo[d], hi[d]) for d in range(cut))):
        base = sum(i * strides[d] for d, i in enumerate(idx))
        runs.append((base + lo[cut] * strides[cut], span))
    return _coalesce(runs)


class Mesh:
    """Dependency-free mesh-aware wrapper: name the device mesh's axes,
    then partition array axes over them (the named-axis sharding model
    on the RPC rank set)."""

    def __init__(self, shape: Sequence[int],
                 axis_names: Optional[Sequence[str]] = None):
        self.shape = tuple(int(s) for s in shape)
        self.axis_names = tuple(axis_names) if axis_names is not None else \
            tuple(f"axis{i}" for i in range(len(self.shape)))
        if len(self.axis_names) != len(self.shape):
            raise ValueError("one name per mesh axis")

    @property
    def nranks(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def sharding(self, array_shape: Sequence[int], itemsize: int,
                 partition: Sequence[Optional[str]]) -> "ShardSpec":
        """ShardSpec for `array_shape` with array axis d split over the
        named mesh axis ``partition[d]`` (None = unsplit). Mesh axes not
        named in `partition` REPLICATE: every rank along them holds the
        same block (the all-gather direction of a resharding)."""
        if len(partition) != len(array_shape):
            raise ValueError("one partition entry per array axis")
        used: Dict[str, int] = {}
        grid = []
        for d, p in enumerate(partition):
            if p is None:
                grid.append(1)
                continue
            if p not in self.axis_names:
                raise ValueError(f"unknown mesh axis {p!r}")
            if p in used:
                raise ValueError(f"mesh axis {p!r} used twice")
            used[p] = d
            grid.append(self.shape[self.axis_names.index(p)])
        base = ShardSpec.blocks(array_shape, itemsize, grid)
        # Expand the block grid onto the full mesh: rank (i0, i1, ...) in
        # mesh row-major order maps to the block cell named by its used
        # axes (unused axes replicate).
        ranges: List[List[Run]] = []
        for cell in itertools.product(*(range(s) for s in self.shape)):
            # blocks() enumerates the grid row-major INCLUDING grid-1
            # axes; compute this rank's row-major index over that grid.
            gcell = []
            for d, p in enumerate(partition):
                gcell.append(0 if p is None else cell[
                    self.axis_names.index(p)])
            idx = 0
            for d, g in enumerate(grid):
                idx = idx * g + gcell[d]
            ranges.append(base.ranges[idx])
        return ShardSpec(base.nbytes, ranges)


class Step:
    """One fetch instruction for a destination rank (wire format of
    ``__rd.fetch``): move `length` bytes to `dst_off` of the assembling
    entry, from `src_rank`'s entry at `src_off` — rank-local when
    src_rank == the destination."""

    __slots__ = ("src_rank", "src_off", "dst_off", "length")

    def __init__(self, src_rank: int, src_off: int, dst_off: int,
                 length: int):
        self.src_rank = src_rank
        self.src_off = src_off
        self.dst_off = dst_off
        self.length = length

    def __repr__(self):
        return (f"Step(src_rank={self.src_rank}, src_off={self.src_off}, "
                f"dst_off={self.dst_off}, len={self.length})")


class _RunIndex:
    """Bisect index over a ShardSpec's per-rank runs: a realistically
    strided sharding (one run per array row) has thousands of runs per
    rank, and the planner touches them once per STEP — linear rescans
    made planning quadratic in run count."""

    def __init__(self, spec: ShardSpec):
        self.runs = spec.ranges
        self.starts = [[o for o, _ in rr] for rr in spec.ranges]
        self.entry_pos: List[List[int]] = []  # prefix sums of run lengths
        for rr in spec.ranges:
            pos, acc = [], 0
            for _, ln in rr:
                pos.append(acc)
                acc += ln
            self.entry_pos.append(pos)

    def _run_i(self, rank: int, goff: int) -> int:
        """Index of rank's run containing global byte `goff`, or -1."""
        i = bisect.bisect_right(self.starts[rank], goff) - 1
        if i >= 0:
            o, ln = self.runs[rank][i]
            if o <= goff < o + ln:
                return i
        return -1

    def entry_off(self, rank: int, goff: int) -> int:
        i = self._run_i(rank, goff)
        if i < 0:
            raise ValueError(f"rank {rank} does not hold byte {goff}")
        return self.entry_pos[rank][i] + (goff - self.runs[rank][i][0])

    def run_at(self, rank: int, goff: int) -> Optional[Run]:
        i = self._run_i(rank, goff)
        return self.runs[rank][i] if i >= 0 else None

    def intersect(self, rank: int, off: int, ln: int) -> List[Run]:
        """Runs of [off, off+ln) that rank holds (window-narrowed)."""
        starts = self.starts[rank]
        lo = max(0, bisect.bisect_right(starts, off) - 1)
        hi = bisect.bisect_left(starts, off + ln)
        out = []
        for ro, rl in self.runs[rank][lo:hi]:
            o = max(off, ro)
            h = min(off + ln, ro + rl)
            if h > o:
                out.append((o, h - o))
        return out


def plan_redistribute(src: ShardSpec, dst: ShardSpec) -> List[List[Step]]:
    """The minimal transfer plan: per destination rank, the instruction
    list assembling its `dst` shard from the `src` layout. Every needed
    byte is sourced once — locally when the rank holds it under `src`,
    else from ONE holder (rotated across holders so a replicated source
    spreads the pull load). Raises when `src` does not collectively hold
    a byte some destination needs."""
    if src.nbytes != dst.nbytes:
        raise ValueError("src/dst describe different array sizes")
    if src.nranks != dst.nranks:
        raise ValueError("src/dst describe different rank counts")
    k = src.nranks
    idx = _RunIndex(src)
    plans: List[List[Step]] = []
    rotate = 0
    for d in range(k):
        steps: List[Step] = []
        entry_pos = 0
        for off, ln in dst.ranges[d]:
            # Local coverage first: bytes this rank already holds.
            covered = idx.intersect(d, off, ln)
            for co, cl in covered:
                steps.append(Step(d, idx.entry_off(d, co),
                                  entry_pos + (co - off), cl))
            # The remainder pulls from one holder per gap.
            gaps = _subtract(off, ln, covered)
            for go, gl in gaps:
                pos = go
                while pos < go + gl:
                    holder, piece = _pick_holder(idx, d, pos, go + gl - pos,
                                                 rotate)
                    rotate += 1
                    steps.append(Step(holder, idx.entry_off(holder, pos),
                                      entry_pos + (pos - off), piece))
                    pos += piece
            entry_pos += ln
        plans.append(steps)
    return plans


def _subtract(off: int, ln: int, covered: List[Run]) -> List[Run]:
    out = []
    pos = off
    for co, cl in sorted(covered):
        if co > pos:
            out.append((pos, co - pos))
        pos = max(pos, co + cl)
    if pos < off + ln:
        out.append((pos, off + ln - pos))
    return out


def _pick_holder(idx: _RunIndex, d: int, off: int, ln: int,
                 rotate: int) -> Tuple[int, int]:
    """A (holder, contiguous length) pair for the byte range starting at
    `off`, rotating the start rank so replicated sources share load."""
    k = len(idx.runs)
    for step in range(k):
        s = (rotate + step) % k
        if s == d:
            continue
        run = idx.run_at(s, off)
        if run is not None:
            ro, rl = run
            return s, min(ln, ro + rl - off)
    raise ValueError(f"no source rank holds byte {off}")


# ---- execution --------------------------------------------------------------


def encode_fetch(dst_name: str, expected: int, steps: Sequence[Step],
                 addrs: Sequence[str], src_name: str,
                 dst_rank: int) -> bytes:
    """The ``__rd.fetch`` wire payload for one destination rank."""
    name = dst_name.encode()
    out = [struct.pack("<H", len(name)), name,
           struct.pack("<QI", expected, len(steps))]
    sname = src_name.encode()
    for st in steps:
        if st.src_rank == dst_rank:
            out.append(struct.pack("<BQQ", 0, st.dst_off, st.length))
        else:
            addr = addrs[st.src_rank].encode()
            out.append(struct.pack("<BQQ", 1, st.dst_off, st.length))
            out.append(struct.pack("<H", len(addr)) + addr)
        out.append(struct.pack("<H", len(sname)) + sname)
        out.append(struct.pack("<Q", st.src_off))
    return b"".join(out)


class RedistributeAborted(RuntimeError):
    """A redistribute pass was aborted fleet-wide before any commit.

    Raised when a rank died mid-pass (fetch or pre-commit wave): every
    surviving rank's staging entry has been dropped, the ``__rd``
    rendezvous swept, and the collective membership epoch bumped — frames
    of the dead pass are fenced (ESTALEEPOCH) at every sink. Source
    entries are untouched on every survivor, so a retry can re-plan
    against ``survivors`` under ``epoch``."""

    def __init__(self, msg: str, survivors: List[int],
                 dead: Dict[int, int], epoch: int):
        super().__init__(msg)
        self.survivors = survivors  # rank indices that answered the probe
        self.dead = dead            # rank index -> probe errno
        self.epoch = epoch          # membership epoch after the bump


# Server-generated probe answers proving the process alive and serving;
# anything else (timeout / closed / refused) marks the rank dead.
_ALIVE_CODES = (2005,)  # ENOMETHOD


def _named(n: str) -> bytes:
    b = n.encode()
    return struct.pack("<H", len(b)) + b


def _drop_staging(channels, dst_name: str, ranks) -> None:
    for r in ranks:  # best-effort: no staging entries linger
        try:
            channels[r].call("__rd", "drop", _named(dst_name))
        except Exception:
            pass


def _probe_membership(channels) -> Tuple[List[int], Dict[int, int]]:
    """Short probe per rank: ENOMETHOD back proves the process alive; a
    transport failure marks it dead (same contract as the C++ harness)."""
    survivors: List[int] = []
    dead: Dict[int, int] = {}
    for d, ch in enumerate(channels):
        try:
            ch.call("__selfheal", "probe", b"")
            survivors.append(d)
        except Exception as e:
            code = getattr(e, "code", -1)
            if code in _ALIVE_CODES:
                survivors.append(d)
            else:
                dead[d] = code
    return survivors, dead


def _abort_fleet(channels, dst_name: str, context: str,
                 cause: Exception) -> None:
    """Fleet-wide abort of an uncommitted pass: drop every rank's staging
    (sweeping the ``__rd`` rendezvous with it), probe the membership, and
    fence the dead pass's zombie frames behind a bumped epoch. Raises
    RedistributeAborted when a corpse is confirmed; otherwise returns so
    the caller re-raises its transient error."""
    _drop_staging(channels, dst_name, range(len(channels)))
    survivors, dead = _probe_membership(channels)
    if not dead:
        return  # transient failure, not a death: caller keeps its error
    from brpc_tpu_torch import runtime  # lazy: runtime imports this module
    epoch = runtime.coll_epoch_bump()
    raise RedistributeAborted(
        f"redistribute aborted fleet-wide ({context}): rank(s) "
        f"{sorted(dead)} dead, staging freed on survivors {survivors}, "
        f"epoch fenced at {epoch}; sources intact — re-plan against the "
        f"survivors ({cause})", survivors, dead, epoch) from cause


def commit_staged(channels, dst_name: str, src_name: str) -> None:
    """Two-phase cut-over of an assembled pass: a pre-commit wave proves
    every rank still holds its complete staging entry (a rank dying
    between fetch and commit is caught HERE and aborts the whole pass,
    sources untouched on every survivor), then the per-rank renames run.
    The window between the wave and the renames is small but real: a
    failure DURING the rename loop leaves a mixed layout, reported as
    such."""
    k = len(channels)
    probe = _named(dst_name) + struct.pack("<QQ", 0, 0)
    for d in range(k):
        try:
            channels[d].call("__rd", "get", probe)
        except Exception as e:
            _abort_fleet(channels, dst_name,
                         f"pre-commit check failed on rank {d}", e)
            _drop_staging(channels, dst_name, range(k))
            raise RuntimeError(
                f"redistribute pre-commit check failed on rank {d} "
                f"(sources intact): {e}") from e
    cpayload = _named(dst_name) + _named(src_name)
    committed: List[int] = []
    for d in range(k):
        try:
            if bytes(channels[d].call("__rd", "commit",
                                      cpayload)) != b"ok":
                raise RuntimeError("commit answered not-ok")
        except Exception as e:
            _drop_staging(channels, dst_name, range(d + 1, k))
            raise RuntimeError(
                f"redistribute commit failed on rank {d}: layout is "
                f"MIXED — ranks {committed} committed the NEW "
                f"sharding under {src_name!r}, rank {d}'s state is "
                f"UNKNOWN (a timed-out commit may have applied "
                f"server-side), later ranks hold the old one; "
                f"re-put entries before retrying ({e})") from e
        committed.append(d)


def execute_plan(plans: Sequence[Sequence[Step]], channels, addrs,
                 src_name: str, dst: ShardSpec, dst_name: str, *,
                 commit: bool = False) -> Dict[str, int]:
    """Issue one fetch per destination rank, ALL CONCURRENTLY (the ctypes
    call releases the GIL, so k fetches - and the peer pulls inside them -
    overlap); optionally commit every assembled entry over `src_name`
    (two-phase, via :func:`commit_staged`). A rank death anywhere before
    the commit loop aborts the pass fleet-wide (RedistributeAborted);
    other failures raise on the first failed rank. Returns transfer
    totals."""
    k = len(plans)
    if len(channels) != k or len(addrs) != k:
        raise ValueError("one channel + addr per rank")

    errors: List[Optional[Exception]] = [None] * k

    def run(d: int) -> None:
        try:
            payload = encode_fetch(dst_name, dst.entry_bytes(d), plans[d],
                                   addrs, src_name, d)
            rsp = channels[d].call("__rd", "fetch", payload)
            if bytes(rsp) != b"ok":
                raise RuntimeError(f"rank {d} fetch answered {rsp!r}")
        except Exception as e:  # surfaced below, rank-attributed
            errors[d] = e

    threads = [threading.Thread(target=run, args=(d,)) for d in range(k)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for d, e in enumerate(errors):
        if e is not None:
            # Ranks whose fetch SUCCEEDED hold complete staging entries the
            # TTL sweep never touches (it only covers incomplete ones) —
            # the abort drops them so a failed pass neither pins budget nor
            # trips the retry's staging with EREQUEST.
            _abort_fleet(channels, dst_name,
                         f"fetch failed on rank {d}", e)
            _drop_staging(channels, dst_name, range(k))
            raise RuntimeError(f"redistribute fetch failed on rank {d}: {e}")
    if commit:
        commit_staged(channels, dst_name, src_name)
    pulled = sum(st.length for d, p in enumerate(plans) for st in p
                 if st.src_rank != d)
    local = sum(st.length for d, p in enumerate(plans) for st in p
                if st.src_rank == d)
    return {"ranks": k, "pull_bytes": pulled, "local_bytes": local,
            "total_bytes": pulled + local}


def redistribute(channels, addrs, src: ShardSpec, dst: ShardSpec,
                 name: str, *, dst_name: Optional[str] = None,
                 commit: bool = True) -> Dict[str, int]:
    """Reshard the named array: every rank's `name` entry (laid out per
    `src`) becomes its `dst` shard. `channels`/`addrs` give the root's
    channel to each rank and the address PEERS dial it by (the fabric
    address — pulls flow rank-to-rank, never through the root). With
    `commit` (default) the assembled entry replaces `name` on every rank
    once ALL ranks assembled AND a pre-commit wave confirmed each still
    holds its staging entry — a failed fetch or pre-commit check leaves
    the source entries untouched (staging dropped everywhere). The
    per-rank renames themselves are not transactional: a failure DURING
    that loop raises with the committed-rank list and the layout stays
    mixed until the caller re-puts. A rank DEATH before any commit raises
    :class:`RedistributeAborted` instead — staging freed fleet-wide,
    epoch bumped, retry re-plans against ``.survivors``. Returns transfer
    totals; the zero-copy
    proof (retain grants vs fallback copies on the pulls) is on the
    workers' fabric counters."""
    plan = plan_redistribute(src, dst)
    staging = dst_name or f"{name}.rd"
    stats = execute_plan(plan, channels, addrs, name, dst, staging,
                         commit=commit)
    return stats
