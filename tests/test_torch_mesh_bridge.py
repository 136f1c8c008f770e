"""The port's mesh bridge (``brpc_tpu_torch.mesh_bridge``) and fan-out
surface (``runtime.ParallelChannel``, ``GatherHandle``) against the
reference's, on the CPU, on the same seeded numpy shards.

The port's rank servers sit on the device fabric (``ici://15/r``, a
namespace of this process's own); the reference's on TCP. The port lands
onto ``devices=[torch.device("cpu")] * n``, the reference onto a JAX mesh
of n CPU devices: every landed row must be bit-equal to the reference's
and to the source. Each test function loops over its cases and names the
case in its messages.

    python -m pytest tests/test_torch_mesh_bridge.py -q
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from brpc_tpu import mesh_bridge as jmb
from brpc_tpu import parallel as jparallel
from brpc_tpu import runtime as jrt
from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import mesh_bridge as tmb
from brpc_tpu_torch import runtime
from brpc_tpu_torch.models import transformer as tt
from brpc_tpu_torch.param_server import decode_arrays, encode_arrays

RANKS = 4
SLICE = 15          # the port's fabric coordinates in these tests
CPU = torch.device("cpu")
# Model logits: float32 on both sides, summed in other orders
# (tests/test_torch_model.py's tolerance).
TOL = dict(rtol=1e-4, atol=1e-4)


def _shards(seed=7):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((8, 16)).astype(np.float32)
            for _ in range(RANKS)]


@pytest.fixture(scope="module")
def ranks():
    """RANKS port ShardServers (device fabric) and RANKS reference
    ShardServers (TCP) holding the same shards, with channels to each."""
    os.environ.setdefault("TRPC_FABRIC_NS", f"torch-meshbridge-{os.getpid()}")
    shards = _shards()
    tsrv, jsrv, tch, jch = [], [], [], []
    for i, s in enumerate(shards):
        srv = tmb.ShardServer({"w": s, "rank": np.int32(i)})
        srv.start_device(SLICE, i)
        tsrv.append(srv)
        tch.append(runtime.Channel(f"ici://{SLICE}/{i}", timeout_ms=10_000))
        js = jmb.ShardServer({"w": s, "rank": np.int32(i)})
        jch.append(jrt.Channel(f"127.0.0.1:{js.start(0)}", timeout_ms=10_000))
        jsrv.append(js)
    yield {"shards": shards, "tsrv": tsrv, "jsrv": jsrv, "tch": tch,
           "jch": jch}
    for ch in tch + jch:
        ch.close()
    for srv in tsrv + jsrv:
        srv.close()


def _bits(a: np.ndarray) -> np.ndarray:
    """bf16 as its int16 bits (compared bit for bit); others as they are."""
    return a.view(np.int16) if a.dtype == ml_dtypes.bfloat16 else a


def _rows(landing):
    """A landing (one [k / n, ...] tensor per device) as k numpy rows,
    bf16 as int16 bits."""
    return [(r.view(torch.int16) if r.dtype == torch.bfloat16 else r).numpy()
            for t in landing for r in t]


def _jax_rows(global_arr):
    return [_bits(r) for r in np.asarray(global_arr)]


def test_gather_lands_rows_bit_equal_to_jax_landing(ranks):
    """rpc_all_gather and gather_to_mesh over star and ring pchans, k = 4
    rank rows into 4, 2 and 1 devices: each device's rows in one tensor,
    bit-equal to the reference's mesh landing and to the source, with no
    staging copy and every payload byte counted as zero-copy."""
    shards = ranks["shards"]
    payload = sum(s.nbytes for s in shards)
    for sched in ("star", "ring"):
        with runtime.ParallelChannel(ranks["tch"], schedule=sched) as tpc, \
                jrt.ParallelChannel(ranks["jch"], schedule=sched) as jpc:
            got = tmb.rpc_all_gather(tpc, "w")
            want = jmb.rpc_all_gather(jpc, "w")
            for r in range(RANKS):
                assert np.array_equal(got[r], want[r]), f"{sched} rank {r}"
                assert np.array_equal(got[r], shards[r]), f"{sched} rank {r}"
            for n in (4, 2, 1):
                case = f"{sched}, {RANKS} ranks into {n} devices"
                tmb.reset_stats()
                landing = tmb.gather_to_mesh(tpc, "w", devices=[CPU] * n)
                st = tmb.stats()
                mesh = jparallel.make_mesh((n,), ("x",))
                jrows = _jax_rows(jmb.gather_to_mesh(jpc, "w", mesh, "x"))
                assert len(landing) == n, case
                assert all(t.shape == (RANKS // n, 8, 16)
                           for t in landing), case
                for r, row in enumerate(_rows(landing)):
                    assert np.array_equal(row, jrows[r]), f"{case} row {r}"
                    assert np.array_equal(row, shards[r]), f"{case} row {r}"
                assert st["staging_copy_bytes"] == 0, (case, st)
                assert st["zero_copy_bytes"] >= payload, (case, st)


def test_gather_stream_star_and_ring_prefix_lane(ranks):
    """gather_to_mesh_stream: 5 star gathers (per-rank lane) and 4 ring
    gathers at chunk_bytes=128 (the prefix lane: each rank frame spans
    many pickup chunks), each landing bit-equal to the reference's stream
    and to the source, staging-free."""
    shards = ranks["shards"]
    mesh = jparallel.make_mesh((RANKS,), ("x",))
    for sched, iters, kw, mode in (("star", 5, {}, "rank"),
                                   ("ring", 4, {"chunk_bytes": 128},
                                    "prefix")):
        with runtime.ParallelChannel(ranks["tch"], schedule=sched,
                                     **kw) as tpc, \
                jrt.ParallelChannel(ranks["jch"], schedule=sched,
                                    **kw) as jpc:
            h = tpc.gather_begin(tmb.SERVICE, "get")
            assert h.mode == mode, sched
            h.end()
            tmb.reset_stats()
            got = list(tmb.gather_to_mesh_stream(tpc, "w", iters=iters,
                                                 depth=2, devices=[CPU]))
            st = tmb.stats()
            want = [_jax_rows(a) for a in jmb.gather_to_mesh_stream(
                jpc, "w", mesh, "x", iters=iters, depth=2)]
        assert len(got) == len(want) == iters, sched
        for i, landing in enumerate(got):
            for r, row in enumerate(_rows(landing)):
                case = f"{sched} landing {i} row {r}"
                assert np.array_equal(row, want[i][r]), case
                assert np.array_equal(row, shards[r]), case
        assert st["staging_copy_bytes"] == 0, (sched, st)
        assert st["zero_copy_bytes"] == iters * sum(s.nbytes
                                                    for s in shards), sched


def test_scatter_round_trip_reads_one_shard_at_a_time(ranks, monkeypatch):
    """scatter_from_mesh from one tensor holding every row and from a
    two-device landing: the servers end with exactly the rows, as the
    reference's servers do after its scatter of the same array, and no
    host read exceeds one rank's shard (a spy on the bridge's row read)."""
    seen = []
    real = tmb._read_row

    def spy(row):
        out = real(row)
        seen.append(out.numel() * out.element_size())
        return out

    monkeypatch.setattr(tmb, "_read_row", spy)
    rng = np.random.default_rng(11)
    mesh = jparallel.make_mesh((RANKS,), ("x",))
    from jax.sharding import NamedSharding, PartitionSpec
    try:
        for case, split in (("one tensor", 1), ("two devices", 2)):
            fresh = rng.standard_normal((RANKS, 8, 16)).astype(np.float32)
            x = torch.from_numpy(fresh)
            seen.clear()
            tmb.scatter_from_mesh(x if split == 1 else list(x.chunk(split)),
                                  ranks["tch"], "w")
            jmb.scatter_from_mesh(jax.device_put(fresh, NamedSharding(
                mesh, PartitionSpec("x", None, None))), ranks["jch"], "w")
            assert seen and max(seen) <= fresh[0].nbytes, (case, seen)
            for r in range(RANKS):
                got = ranks["tsrv"][r].arrays()
                want = ranks["jsrv"][r].arrays()
                assert np.array_equal(got["w"], fresh[r]), (case, r)
                assert np.array_equal(got["w"], want["w"]), (case, r)
                assert got["rank"] == r, (case, r)  # put merges
        with pytest.raises(ValueError):
            tmb.scatter_from_mesh(torch.zeros(RANKS - 1, 2), ranks["tch"],
                                  "w")
    finally:
        for ch, s in zip(ranks["tch"] + ranks["jch"], 2 * ranks["shards"]):
            ch.call(tmb.SERVICE, "put", encode_arrays({"w": s}))


def _who_servers(lib, n):
    servers, ports = [], []
    for rank in range(n):
        srv = lib.Server()
        srv.add_method("G", "who", lambda req, r=rank: b"rank%d:" % r + req)
        ports.append(srv.start(0))
        servers.append(srv)
    return servers, ports


def test_gather_handle_and_partial_gather_match_jax():
    """The port's GatherHandle and call_ranks beside the reference's:
    out-of-order wait_rank, a dead rank raising from wait_rank and from
    end, each schedule's handle mode (ring -> prefix, ring + reduce and
    unlowered -> ValueError), and call_ranks with fail_limit=1."""
    for name, lib in (("port", runtime), ("jax", jrt)):
        servers, ports = _who_servers(lib, 4)
        subs = [lib.Channel(f"127.0.0.1:{p}", timeout_ms=2000,
                            max_retry=0) for p in ports]
        try:
            with lib.ParallelChannel(subs, timeout_ms=3000) as pch:
                h = pch.gather_begin("G", "who", b"ping")
                assert h.mode == "rank", name
                for r in (3, 0, 2, 1):
                    assert bytes(h.wait_rank(r)) == b"rank%d:ping" % r, name
                h.end()
                assert pch.call("G", "who", b"ping") == b"".join(
                    b"rank%d:ping" % r for r in range(4)), name
            with lib.ParallelChannel(subs, schedule="ring",
                                     timeout_ms=3000) as pch:
                h = pch.gather_begin("G", "who", b"x")
                assert h.mode == "prefix", name
                view, _ = h.wait_prefix(1 << 20)
                assert bytes(view) == b"".join(
                    b"rank%d:x" % r for r in range(4)), name
                h.end()
            for kw in ({"schedule": "ring", "reduce_op": 5},
                       {"lower_to_collective": False}):
                with lib.ParallelChannel(subs, timeout_ms=3000,
                                         **kw) as pch:
                    with pytest.raises(ValueError):
                        pch.gather_begin("G", "who", b"x")
            servers[2].close()  # a dead rank
            with lib.ParallelChannel(subs, timeout_ms=2000,
                                     fail_limit=1) as pch:
                got = [(r.rank, r.ok, r.data) for r in
                       pch.call_ranks("G", "who", b"y")]
            assert got == [(r, r != 2, None if r == 2 else b"rank%d:y" % r)
                           for r in range(4)], (name, got)
            with lib.ParallelChannel(subs, timeout_ms=2000) as pch:
                with pytest.raises(ValueError):
                    pch.call_ranks("G", "who", b"y")  # lowered: no ranks
                h = pch.gather_begin("G", "who", b"z")
                with pytest.raises(lib.RpcError):
                    h.wait_rank(2)
                with pytest.raises(lib.RpcError):
                    h.end()
        finally:
            for sub in subs:
                sub.close()
            for i, srv in enumerate(servers):
                if i != 2:
                    srv.close()


def test_mixed_packages_gather_each_others_shard_servers():
    """Over TCP, in both directions: the port gathers the reference's
    ShardServers and the reference the port's, in f32 and in bf16, and a
    ``get`` frame of the port's server is byte-identical to the
    reference's for the same arrays."""
    rng = np.random.default_rng(5)
    f32 = [rng.standard_normal((4, 6)).astype(np.float32)
           for _ in range(RANKS)]
    bf16 = [rng.standard_normal((3, 8)).astype(ml_dtypes.bfloat16)
            for _ in range(RANKS)]
    servers = []
    try:
        tsrv = [tmb.ShardServer({"f": a, "b": torch.from_numpy(
            b.view(np.int16)).view(torch.bfloat16)})
            for a, b in zip(f32, bf16)]
        jsrv = [jmb.ShardServer({"f": a, "b": b}) for a, b in zip(f32, bf16)]
        servers = tsrv + jsrv
        taddr = [f"127.0.0.1:{s.start(0)}" for s in tsrv]
        jaddr = [f"127.0.0.1:{s.start(0)}" for s in jsrv]
        for i in range(RANKS):
            with runtime.Channel(taddr[i]) as tc, jrt.Channel(jaddr[i]) as jc:
                assert tc.call(tmb.SERVICE, "get") == \
                    jc.call(jmb.SERVICE, "get"), f"rank {i} frame"
        mesh = jparallel.make_mesh((RANKS,), ("x",))
        for case, gatherer, addrs in (("port gathers jax", "port", jaddr),
                                      ("jax gathers port", "jax", taddr)):
            lib = runtime if gatherer == "port" else jrt
            subs = [lib.Channel(a, timeout_ms=10_000) for a in addrs]
            try:
                with lib.ParallelChannel(subs) as pc:
                    for name, want in (("f", f32), ("b", bf16)):
                        rows = (_rows(tmb.gather_to_mesh(
                            pc, name, devices=[CPU])) if gatherer == "port"
                            else _jax_rows(jmb.gather_to_mesh(
                                pc, name, mesh, "x")))
                        for r in range(RANKS):
                            assert np.array_equal(rows[r], _bits(want[r])), \
                                f"{case} {name} rank {r}"
            finally:
                for s in subs:
                    s.close()
    finally:
        for s in servers:
            s.close()


def test_landed_layers_serve_jax_forward_logits():
    """The slice as a whole: a 2-layer model at D 64 whose layer matrices
    are cut 4 ways (column quarters of wq, wk, wv, w_gate, w_up, row
    quarters of wo, w_down), packed one array a rank on 4 port rank
    servers, gathered and landed, and unpacked into the port's params:
    the matrices equal the originals, and the port's forward over them
    agrees with the reference's forward on the original weights (star and
    ring, into 1 and 2 devices)."""
    jcfg = dataclasses.replace(jt.TransformerConfig.tiny(), d_model=64,
                               n_layers=2, n_heads=4, n_kv_heads=2,
                               d_ff=128, dtype=jnp.float32)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(), d_model=64,
                               n_layers=2, n_heads=4, n_kv_heads=2,
                               d_ff=128, dtype=torch.float32)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(3))
    tree = jax.tree.map(np.asarray, jp)
    layers = {n: torch.from_numpy(np.array(tree["layers"][n]))
              for n in tmb.TP_AXIS}
    shapes = {n: tuple(t.shape) for n, t in layers.items()}
    packed = tmb.pack_tp_shards(layers, RANKS)
    os.environ.setdefault("TRPC_FABRIC_NS", f"torch-meshbridge-{os.getpid()}")
    servers = [tmb.ShardServer({"w": p}) for p in packed]
    for i, s in enumerate(servers):
        s.start_device(SLICE + 1, i)
    chans = [runtime.Channel(f"ici://{SLICE + 1}/{i}", timeout_ms=10_000)
             for i in range(RANKS)]
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 13),
                                             dtype=np.int32)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    try:
        for sched in ("star", "ring"):
            with runtime.ParallelChannel(chans, schedule=sched) as pc:
                for n in (1, 2):
                    case = f"{sched} into {n} devices"
                    rows = torch.cat(tmb.gather_to_mesh(pc, "w",
                                                        devices=[CPU] * n))
                    got_layers = tmb.unpack_tp_shards(rows, shapes)
                    for name, t in got_layers.items():
                        assert torch.equal(t, layers[name]), (case, name)
                    tree_landed = {**tree, "layers": {**tree["layers"],
                                                      **got_layers}}
                    params = tt.params_from_numpy(tree_landed, tcfg,
                                                  device="cpu")
                    got = tt.forward(params, torch.from_numpy(toks),
                                     tcfg).numpy()
                    np.testing.assert_allclose(got, want, **TOL,
                                               err_msg=case)
    finally:
        for ch in chans:
            ch.close()
        for s in servers:
            s.close()


def test_refusals_and_zero_copy_views(ranks, monkeypatch):
    """Without a card and without ``devices`` the landing raises (no
    fallback to the CPU); garbage frames raise; a dead rank fails the
    gather with RpcError; ``decode_arrays(copy=False)`` returns read-only
    views into the blob (bf16 through an int16 view)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with runtime.ParallelChannel(ranks["tch"]) as pc:
        with pytest.raises(RuntimeError, match="CUDA"):
            tmb.gather_to_mesh(pc, "w")
        with pytest.raises(RuntimeError, match="CUDA"):
            list(tmb.gather_to_mesh_stream(pc, "w", iters=1))
        with pytest.raises(KeyError):
            tmb.gather_to_mesh(pc, "absent", devices=[CPU])
        with pytest.raises(ValueError, match="divide"):
            tmb.gather_to_mesh(pc, "w", devices=[CPU] * 3)
    for bad in (b"\x05\x00\x00", b"\xff\x00\x00\x00\x00\x00\x00\x00xy"):
        with pytest.raises(ValueError):
            tmb.split_frames(bad)
        with pytest.raises(ValueError):
            tmb._decode_rank_frame(bad, "w")
    with pytest.raises(ValueError):
        decode_arrays(b"NOPE\x00\x00\x00\x00")
    srv = tmb.ShardServer({"w": np.zeros(3, np.float32)})
    port = srv.start(0)
    srv.close()  # a dead rank
    dead = runtime.Channel(f"127.0.0.1:{port}", timeout_ms=500, max_retry=0)
    try:
        with runtime.ParallelChannel(ranks["tch"][:2] + [dead],
                                     timeout_ms=1000) as pc:
            with pytest.raises(runtime.RpcError):
                tmb.gather_to_mesh(pc, "w", devices=[CPU])
    finally:
        dead.close()
    bits = np.arange(12, dtype=np.int16).reshape(3, 4)
    src = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
           "b": torch.from_numpy(bits).view(torch.bfloat16)}
    blob = np.frombuffer(encode_arrays(src), dtype=np.uint8)
    views = decode_arrays(blob, copy=False)
    assert np.array_equal(views["a"], src["a"])
    assert not views["a"].flags.owndata and not views["a"].flags.writeable
    lo = blob.ctypes.data
    assert lo <= views["b"].data_ptr() < lo + blob.nbytes
    assert torch.equal(views["b"].view(torch.int16), torch.from_numpy(bits))


def test_observatory_records_match_jax_for_the_same_gathers(ranks):
    """The collective observatory through each package's runtime: after
    the same 4-rank star and ring gathers, the port's records agree with
    the reference's in schedule, ranks, chunking and bytes, hop by hop
    (rank and payload bytes, for the ring, whose records carry hops);
    disarmed, neither records a gather; the port's link stats name its
    fabric peers."""
    def summary(doc):
        return [(r["sched"], r["ranks"], r["chunked"], r["req_bytes"],
                 r["rsp_bytes"], r["payload_bytes"], r["wire_bytes"],
                 [(h["rank"], h["payload_bytes"], h["wire_bytes"])
                  for h in r.get("hops", [])])
                for r in doc["records"]]

    for rt in (runtime, jrt):
        rt.coll_observe_reset()
        assert rt.coll_observe_enabled(), rt.__name__
    try:
        for sched in ("star", "ring"):
            with runtime.ParallelChannel(ranks["tch"], schedule=sched) as tpc, \
                    jrt.ParallelChannel(ranks["jch"], schedule=sched) as jpc:
                tmb.rpc_all_gather(tpc, "w")
                jmb.rpc_all_gather(jpc, "w")
        got, want = runtime.coll_records(), jrt.coll_records()
        assert summary(got) == summary(want), (summary(got), summary(want))
        assert [r["sched"] for r in got["records"]] == ["ring_gather",
                                                        "star"], got
        assert got["total"] == want["total"] == 2
        ring = got["records"][0]
        assert len(ring["hops"]) == RANKS, ring
        assert 0 <= ring["critical_hop"] < RANKS, ring
        assert all(h["transit_us"] >= 0 and h["span_us"] >= 0
                   for h in ring["hops"]), ring
        peers = {link["peer"] for link in runtime.coll_link_stats()}
        assert {f"ici://{SLICE}/{i}" for i in range(RANKS)} <= peers, peers
        for rt in (runtime, jrt):
            rt.coll_observe_enable(False)
        with runtime.ParallelChannel(ranks["tch"]) as tpc, \
                jrt.ParallelChannel(ranks["jch"]) as jpc:
            tmb.rpc_all_gather(tpc, "w")
            jmb.rpc_all_gather(jpc, "w")
        assert runtime.coll_records()["total"] == jrt.coll_records()[
            "total"] == 2
    finally:
        for rt in (runtime, jrt):
            rt.coll_observe_enable(True)
