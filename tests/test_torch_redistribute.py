"""The port's redistribute against the JAX package's: the same minimal
plans (step for step) and fetch payloads (byte for byte) for the same
shardings, and resharding over rank processes on the native ``__rd``
wire, where one rank runs the reference's runtime among the port's:
every sharding pair byte-exact over TCP, a pre-commit failure and a dead
rank that leave every source intact, and zero-copy retained pulls on the
device fabric.

Each test function loops over its cases and names the case in its
messages.

    python -m pytest tests/test_torch_redistribute.py -q
"""

import os
import signal
import struct
import subprocess
import sys

import numpy as np
import pytest

from brpc_tpu import redistribute as jrd
from brpc_tpu import runtime as jrt
from brpc_tpu_torch import redistribute as rd
from brpc_tpu_torch import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _steps(plan) -> list:
    return [[(s.src_rank, s.src_off, s.dst_off, s.length) for s in p]
            for p in plan]


def _simulate(plan, src, dst, flat):
    """Apply a plan to in-memory entries: each rank's dst bytes."""
    entries = {r: b"".join(flat[o:o + n] for o, n in src.ranges[r])
               for r in range(src.nranks)}
    out = []
    for d in range(dst.nranks):
        buf = bytearray(dst.entry_bytes(d))
        for st in plan[d]:
            buf[st.dst_off:st.dst_off + st.length] = \
                entries[st.src_rank][st.src_off:st.src_off + st.length]
        out.append(bytes(buf))
    return out


def _entry(spec, flat, r) -> bytes:
    return b"".join(flat[o:o + n] for o, n in spec.ranges[r])


def _pairs(pkg, shape, itemsize, k):
    """name -> (src, dst) of one package, for an array of ``shape``."""
    m = pkg.Mesh((k,), ("x",))
    nbytes = int(np.prod(shape)) * itemsize
    row = m.sharding(shape, itemsize, ("x", None))
    col = m.sharding(shape, itemsize, (None, "x"))
    rep = pkg.ShardSpec.replicated(nbytes, k)
    third = (nbytes // 3) // itemsize * itemsize
    return {
        "row_col": (row, col),
        "sharded_replicated": (row, rep),
        "replicated_sharded": (rep, col),
        # A rotated assignment of the same shards.
        "degenerate_1axis": (row, pkg.ShardSpec(
            nbytes, row.ranges[1:] + row.ranges[:1])),
        # Ranks 0 and 3 end up holding nothing.
        "empty_dst_shard": (row, pkg.ShardSpec(
            nbytes, [[], [(0, third)], [(third, nbytes - third)], []]
            + [[]] * (k - 4))),
    }


def test_plans_match_reference():
    cases = []
    for pkg in (rd, jrd):
        m = pkg.Mesh((4,), ("x",))
        m2 = pkg.Mesh((2, 2), ("x", "y"))
        mk = {
            "row_to_col 8x8": (m.sharding((8, 8), 8, ("x", None)),
                               m.sharding((8, 8), 8, (None, "x"))),
            "replicated_to_sharded": (pkg.ShardSpec.replicated(512, 4),
                                      m.sharding((8, 8), 8, ("x", None))),
            "sharded_to_replicated": (m.sharding((8, 8), 8, ("x", None)),
                                      pkg.ShardSpec.replicated(512, 4)),
            "2d_transpose": (m2.sharding((4, 4), 8, ("x", "y")),
                             m2.sharding((4, 4), 8, ("y", "x"))),
            "awkward 6x10 f32": (
                pkg.Mesh((2,), ("x",)).sharding((6, 10), 4, ("x", None)),
                pkg.Mesh((2,), ("x",)).sharding((6, 10), 4, (None, "x"))),
            "w_gate rows to columns, 64 x 448 bf16": (
                m.sharding((64, 448), 2, ("x", None)),
                m.sharding((64, 448), 2, (None, "x"))),
            "2d mesh, replicated axis": (
                m2.sharding((8, 6), 4, ("x", None)),
                m2.sharding((8, 6), 4, (None, "y"))),
        }
        for name, pair in _pairs(pkg, (12, 20), 4, 4).items():
            mk[f"pair {name}"] = pair
        cases.append(mk)
    ours, theirs = cases
    assert list(ours) == list(theirs)
    for name in ours:
        (s, d), (js, jd) = ours[name], theirs[name]
        assert s.ranges == js.ranges and d.ranges == jd.ranges, \
            f"{name}: shard specs differ"
        plan = rd.plan_redistribute(s, d)
        assert _steps(plan) == _steps(jrd.plan_redistribute(js, jd)), \
            f"{name}: plans differ"
        flat = np.arange(s.nbytes, dtype=np.uint8).tobytes()
        assert _simulate(plan, s, d, flat) == [
            _entry(d, flat, r) for r in range(d.nranks)], \
            f"{name}: the plan does not assemble the dst shards"
        for r in range(d.nranks):
            assert sum(st.length for st in plan[r]) == d.entry_bytes(r), \
                f"{name}: rank {r} receives more than its shard"
        addrs = [f"127.0.0.1:{7000 + r}" for r in range(d.nranks)]
        for r in range(d.nranks):
            assert rd.encode_fetch("x.rd", d.entry_bytes(r), plan[r], addrs,
                                   "x", r) == jrd.encode_fetch(
                "x.rd", jd.entry_bytes(r), jrd.plan_redistribute(js, jd)[r],
                addrs, "x", r), f"{name}: rank {r} fetch payload differs"
    # Uncoverable sources and mismatched specs raise in both packages.
    for pkg in (rd, jrd):
        with pytest.raises(ValueError):
            pkg.plan_redistribute(pkg.ShardSpec(64, [[(0, 32)], [(0, 32)]]),
                                  pkg.ShardSpec.replicated(64, 2))
        with pytest.raises(ValueError):
            pkg.plan_redistribute(pkg.ShardSpec.replicated(64, 2),
                                  pkg.ShardSpec.replicated(32, 2))
        with pytest.raises(ValueError):
            pkg.Mesh((2,), ("x",)).sharding((3, 4), 4, ("x", None))


# A rank process: ``pkg`` is brpc_tpu_torch (the port) or brpc_tpu (the
# reference); the first shard comes on stdin.
_RANK_SRC = """
import struct, sys, time
pkg, mode = sys.argv[1], sys.argv[2]
rank, n = int(sys.argv[3]), int(sys.argv[4])
runtime = __import__(pkg + ".runtime", fromlist=["runtime"])
runtime.rd_put("x", sys.stdin.buffer.read(n))
srv = runtime.Server()
srv.enable_redistribute()
srv.add_method("T", "report", lambda req: runtime.rd_get(req.decode()))

def put(req):
    (nl,) = struct.unpack_from("<H", req)
    runtime.rd_put(req[2:2 + nl].decode(), req[2 + nl:])
    return b"ok"

def stats(_req):
    links = runtime.coll_link_stats()
    st = runtime.rd_stats()
    return struct.pack(
        "<5q", sum(l.get("retain_grants", 0) for l in links),
        sum(l.get("retain_fallbacks", 0) for l in links),
        sum(l.get("staged_copies", 0) for l in links),
        st["pulls"], st["pull_bytes"])

srv.add_method("T", "put", put)
srv.add_method("T", "stats", stats)
srv.add_method("T", "rdents", lambda _req: struct.pack(
    "<q", runtime.rd_stats()["entries"]))
port = srv.start(0)
if mode == "ici":
    srv.start_device(int(sys.argv[5]), rank)
print("ready", port, flush=True)
while True:
    time.sleep(1)
"""


def _spawn(pkgs, shards, mode="tcp", slice_=0, env=None):
    procs, addrs = [], []
    try:
        for r, pkg in enumerate(pkgs):
            p = subprocess.Popen(
                [sys.executable, "-c", _RANK_SRC, pkg, mode, str(r),
                 str(len(shards[r])), str(slice_)],
                stdin=subprocess.PIPE, stdout=subprocess.PIPE, cwd=REPO,
                env=dict(os.environ, **(env or {})))
            procs.append(p)
            p.stdin.write(shards[r])
            p.stdin.close()
            line = p.stdout.readline().split()
            assert line and line[0] == b"ready", f"rank {r} ({pkg}): {line!r}"
            addrs.append(f"127.0.0.1:{int(line[1])}")
    except BaseException:
        _kill(procs)
        raise
    return procs, addrs


def _kill(procs) -> None:
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
        p.wait()


def _put(ch, name: str, data: bytes) -> None:
    nb = name.encode()
    assert ch.call("T", "put", struct.pack("<H", len(nb)) + nb + data) == b"ok"


def _entries(ch) -> int:
    return struct.unpack("<q", ch.call("T", "rdents", b""))[0]


class _ProbeFails:
    """A live channel whose ``__rd`` pre-commit probe fails."""

    def __init__(self, ch):
        self._ch = ch

    def call(self, service, method, payload):
        if service == "__rd" and method == "get":
            raise RuntimeError("injected probe failure")
        return self._ch.call(service, method, payload)


def test_redistribute_over_rank_processes():
    jrt.Server().close()  # the reference runtime's first call, this thread
    k = 4
    A = np.arange(240, dtype=np.float32).reshape(12, 20)
    flat = A.tobytes()
    pairs = _pairs(rd, A.shape, 4, k)
    row = pairs["row_col"][0]
    shards = [_entry(row, flat, r) for r in range(k)]
    # Rank 2 runs the reference's runtime.
    pkgs = ["brpc_tpu_torch", "brpc_tpu_torch", "brpc_tpu", "brpc_tpu_torch"]
    procs, addrs = _spawn(pkgs, shards)
    chans = []
    try:
        chans = [runtime.Channel(a, timeout_ms=15000) for a in addrs]
        for name, (src, dst) in pairs.items():
            for r in range(k):
                _put(chans[r], "x", _entry(src, flat, r))
            stats = rd.redistribute(chans, addrs, src, dst, "x")
            assert stats["total_bytes"] == sum(
                dst.entry_bytes(d) for d in range(k)), name
            for d in range(k):
                assert chans[d].call("T", "report", b"x") == \
                    _entry(dst, flat, d), f"{name}: rank {d} mismatch"
                assert _entries(chans[d]) == 1, f"{name}: rank {d} staging"

        # A pre-commit failure backs out before any rename: sources intact,
        # staging dropped everywhere.
        for r in range(k):
            _put(chans[r], "x", shards[r])
        src, dst = pairs["row_col"]
        wrapped = list(chans)
        wrapped[1] = _ProbeFails(chans[1])
        with pytest.raises(RuntimeError, match="pre-commit"):
            rd.redistribute(wrapped, addrs, src, dst, "x")
        for d in range(k):
            assert chans[d].call("T", "report", b"x") == shards[d], \
                f"pre-commit: rank {d} source changed"
            assert _entries(chans[d]) == 1, f"pre-commit: rank {d} staging"

        # A dead rank fails the pass before any commit: every survivor
        # still serves its source, and the abort bumped the epoch.
        epoch = runtime.coll_epoch()
        procs[3].send_signal(signal.SIGKILL)
        procs[3].wait()
        with pytest.raises(RuntimeError) as ei:
            rd.redistribute(chans, addrs, src, dst, "x")
        assert isinstance(ei.value, rd.RedistributeAborted), ei.value
        assert ei.value.dead.keys() == {3}, ei.value.dead
        assert ei.value.survivors == [0, 1, 2], ei.value.survivors
        assert runtime.coll_epoch() > epoch, "dead rank: epoch not bumped"
        for d in (0, 1, 2):
            assert chans[d].call("T", "report", b"x") == shards[d], \
                f"dead rank: rank {d} source changed"
    finally:
        for ch in chans:
            ch.close()
        _kill(procs)

    # Zero-copy retain on the device fabric: the pulls show retain grants
    # and no fallback copy (control plane over TCP, data over the fabric).
    k = 2
    B = np.arange(1 << 19, dtype=np.int64).reshape(1024, 512)  # 4 MB
    flat = B.tobytes()
    m = rd.Mesh((k,), ("x",))
    src = m.sharding(B.shape, 8, ("x", None))
    dst = m.sharding(B.shape, 8, (None, "x"))
    slice_ = 18
    procs, addrs = _spawn(["brpc_tpu_torch"] * k,
                          [_entry(src, flat, r) for r in range(k)], "ici",
                          slice_, {"TRPC_FABRIC_NS": f"rdzc-{os.getpid()}"})
    chans = []
    try:
        chans = [runtime.Channel(a, timeout_ms=20000) for a in addrs]
        rd.redistribute(chans, [f"ici://{slice_}/{r}" for r in range(k)],
                        src, dst, "x")
        grants = fallbacks = pulls = pull_bytes = 0
        for d in range(k):
            g, f, _s, p, pb = struct.unpack(
                "<5q", chans[d].call("T", "stats", b""))
            grants, fallbacks = grants + g, fallbacks + f
            pulls, pull_bytes = pulls + p, pull_bytes + pb
            assert chans[d].call("T", "report", b"x") == \
                _entry(dst, flat, d), f"fabric: rank {d} mismatch"
        assert pulls > 0 and pull_bytes >= len(flat) // 2, (pulls,
                                                             pull_bytes)
        assert fallbacks == 0, f"fabric: {fallbacks} retain-fallback copies"
        assert grants > 0, "fabric: no zero-copy retain"
    finally:
        for ch in chans:
            ch.close()
        _kill(procs)
