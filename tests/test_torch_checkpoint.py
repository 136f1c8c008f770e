"""The port's checkpoint/resume against the JAX package's: TCK1 blobs
byte-identical for the same arrays, the store's all-or-nothing commits,
durable history that survives a restart and drops torn and corrupt files,
writers and stores of either package working together, and the port's
ParamServer snapshotting to a store process that is killed with SIGKILL,
restarted on its directory and restored from, over TCP, the device fabric
and TLS.

Each test function loops over its cases and names the case in its
messages.

    python -m pytest tests/test_torch_checkpoint.py -q
"""

import os
import shutil
import signal
import struct
import subprocess
import sys
import time

import ml_dtypes
import numpy as np
import pytest
import torch

from brpc_tpu import checkpoint as jck
from brpc_tpu import runtime as jrt
from brpc_tpu_torch import checkpoint as ck
from brpc_tpu_torch import param_server as ps
from brpc_tpu_torch import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE = 17  # this file's device-fabric coordinates


def _jax_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "w": rng.standard_normal((64, 32)).astype(np.float32),
        "b": rng.standard_normal((32,)).astype(np.float32),
        "step_scale": np.float32(0.5),
        "ids": rng.integers(-9, 9, 7).astype(np.int32),
        "bf": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
    }


def _port_arrays(arrays: dict) -> dict:
    """The same arrays as the port passes them: bf16 as a torch tensor."""
    return {k: (torch.from_numpy(v.view(np.int16).copy()).view(torch.bfloat16)
                if v.dtype == ml_dtypes.bfloat16 else v)
            for k, v in arrays.items()}


def _bits(a) -> bytes:
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    return np.ascontiguousarray(a).tobytes()


def _same(got: dict, want: dict, case: str) -> None:
    assert set(got) == set(want), f"{case}: names {set(got)} != {set(want)}"
    for k in want:
        assert tuple(np.shape(got[k])) == tuple(np.shape(want[k])), \
            f"{case}: {k} shape"
        assert _bits(got[k]) == _bits(want[k]), f"{case}: {k} bytes differ"


def _wait_step(addr: str, step: int, case: str) -> None:
    with runtime.Channel(addr) as ch:
        deadline = time.monotonic() + 5
        while time.monotonic() < deadline:
            (got,) = struct.unpack("<Q", ch.call(ck.CheckpointStore.SERVICE,
                                                 "stat"))
            if got == step:
                return
            time.sleep(0.02)
    raise AssertionError(f"{case}: the store's latest step is not {step}")


def test_checkpoint_codec_and_store_match_reference(tmp_path):
    jrt.Server().close()  # the reference runtime's first call, this thread

    # TCK1 bytes: f32, bf16, int and 0-d arrays; also from a CUDA-less
    # torch f32 tensor and a bf16 one.
    for seed in (1, 2):
        arrays = _jax_arrays(seed)
        want = jck.encode_checkpoint(7 + seed, 0.01 * seed, arrays)
        got = ck.encode_checkpoint(7 + seed, 0.01 * seed,
                                   _port_arrays(arrays))
        assert got == want, f"seed {seed}: TCK1 bytes differ"
        assert len(got) == ck.checkpoint_bytes(_port_arrays(arrays)), \
            f"seed {seed}: checkpoint_bytes"
        step, lr, back = ck.decode_checkpoint(want)
        assert (step, lr) == (7 + seed, 0.01 * seed), f"seed {seed}"
        _same(back, _port_arrays(arrays), f"seed {seed} decode")
    t = {"t": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    assert ck.encode_checkpoint(1, 0.1, t) == jck.encode_checkpoint(
        1, 0.1, {"t": t["t"].numpy()}), "torch f32 tensor"

    # Garbage, truncation, a foreign format, and a blob over the frame cap
    # (refused before anything is sent, with its size named).
    blob = ck.encode_checkpoint(1, 0.1, _port_arrays(_jax_arrays(3)))
    bad_fmt = blob[:4] + struct.pack("<I", 2) + blob[8:]
    for case, bad in (("garbage", b"nope"), ("truncated", blob[:-10]),
                      ("format", bad_fmt), ("magic", b"XCK1" + blob[4:])):
        with pytest.raises(ValueError):
            ck.decode_checkpoint(bad)
        with pytest.raises(ValueError):
            jck.decode_checkpoint(bad)
    huge = {"x": torch.zeros(1, dtype=torch.uint8).expand(ps.MAX_BLOB_BYTES)}
    store = ck.CheckpointStore()
    addr = f"127.0.0.1:{store.start(0)}"
    try:
        size = ck.checkpoint_bytes(huge)
        with pytest.raises(ValueError, match=str(size)):
            ck.save_checkpoint(addr, 5, 0.1, huge)
        assert store.steps() == [], "over the cap: nothing may be sent"

        # A partial upload (the writer died mid-stream) keeps the previous
        # snapshot; a multi-chunk blob round-trips.
        good = _port_arrays(_jax_arrays(4))
        ck.save_checkpoint(addr, 3, 0.01, good)
        part = ck.encode_checkpoint(9, 0.01, _port_arrays(_jax_arrays(5)))
        with runtime.Channel(addr) as ch:
            with ch.open_stream(ck.CheckpointStore.SERVICE, "put") as stream:
                stream.write(part[:len(part) // 2])
        time.sleep(0.2)
        _wait_step(addr, 3, "partial upload")
        step, _lr, back = ck.load_checkpoint(addr)
        assert step == 3, "partial upload replaced the good snapshot"
        _same(back, good, "partial upload")
        big = {"embed": np.arange(3_000_000, dtype=np.float32)
               .reshape(1000, 3000)}
        ck.save_checkpoint(addr, 11, 0.001, big)
        step, lr, back = ck.load_checkpoint(addr)
        assert (step, lr) == (11, 0.001), "multi-chunk"
        _same(back, big, "multi-chunk")
        assert ck.list_checkpoints(addr) == [3, 11], "multi-chunk list"
    finally:
        store.close()

    # Durable history: keep=3 of 5 commits, a new store on the directory
    # recovers it; torn and corrupt files are dropped.
    d = str(tmp_path / "ckpts")
    store = ck.CheckpointStore(directory=d, keep=3)
    addr = f"127.0.0.1:{store.start(0)}"
    saved = {}
    try:
        for step in (1, 2, 3, 4, 5):
            saved[step] = _port_arrays(_jax_arrays(10 + step))
            ck.save_checkpoint(addr, step, 0.01, saved[step])
        assert ck.list_checkpoints(addr) == [3, 4, 5], "keep=3"
        assert len([f for f in os.listdir(d) if f.endswith(".tck")]) == 3
    finally:
        store.close()
    with open(os.path.join(d, "ckpt-00000000000000000009.tck.123.tmp"),
              "wb") as f:
        f.write(b"partial")
    with open(os.path.join(d, "ckpt-00000000000000000008.tck"), "wb") as f:
        f.write(b"TCK1garbage")
    store = ck.CheckpointStore(directory=d, keep=3)
    addr = f"127.0.0.1:{store.start(0)}"
    try:
        assert store.steps() == [3, 4, 5], "restart: torn/corrupt files"
        assert not any(f.endswith(".tmp") for f in os.listdir(d))
        assert os.path.exists(
            os.path.join(d, "ckpt-00000000000000000008.tck.corrupt"))
        for step in (None, 3):
            got_step, _lr, back = ck.load_checkpoint(addr, step=step)
            assert got_step == (step or 5), f"restart: step {step}"
            _same(back, saved[got_step], f"restart: step {step}")
        # The port store's files are whole reference blobs.
        for name in sorted(os.listdir(d)):
            if name.endswith(".tck"):
                with open(os.path.join(d, name), "rb") as f:
                    step, _lr, back = jck.decode_checkpoint(f.read())
                _same({k: v for k, v in back.items() if k != "bf"},
                      {k: v for k, v in saved[step].items() if k != "bf"},
                      f"reference decode of {name}")
                assert _bits(back["bf"]) == _bits(saved[step]["bf"]), name
    finally:
        store.close()

    # Across packages: a port writer against the reference's store (the
    # port's load falls back to one get), a reference writer against the
    # port's store (the reference loads with get, the port with ranges).
    arrays = _jax_arrays(21)
    jstore = jck.CheckpointStore()
    jaddr = f"127.0.0.1:{jstore.start(0)}"
    pstore = ck.CheckpointStore()
    paddr = f"127.0.0.1:{pstore.start(0)}"
    try:
        ck.save_checkpoint(jaddr, 4, 0.25, _port_arrays(arrays))
        step, lr, back = jck.load_checkpoint(jaddr)
        assert (step, lr) == (4, 0.25), "port writer, reference store"
        _same(back, arrays, "port writer, reference store")
        step, lr, back = ck.load_checkpoint(jaddr)
        _same(back, _port_arrays(arrays), "port load from reference store")
        jck.save_checkpoint(paddr, 6, 0.5, arrays)
        step, lr, back = ck.load_checkpoint(paddr)
        assert (step, lr) == (6, 0.5), "reference writer, port store"
        _same(back, _port_arrays(arrays), "reference writer, port store")
        step, lr, back = jck.load_checkpoint(paddr)
        _same(back, arrays, "reference load from port store")
        assert jck.list_checkpoints(paddr) == [6]
        assert ck.list_checkpoints(jaddr) == [4]
    finally:
        jstore.close()
        pstore.close()


def _spawn_store(d: str):
    proc = subprocess.Popen(
        [sys.executable, "-m", "brpc_tpu_torch.checkpoint", "--dir", d],
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True, cwd=REPO)
    line = proc.stdout.readline().split()
    assert line and line[0] == "READY", f"store process said {line!r}"
    return proc, f"127.0.0.1:{int(line[1])}", int(line[3])


def _kill(proc) -> None:
    proc.send_signal(signal.SIGKILL)
    proc.wait()


def _grads(rng) -> dict:
    return {"w": rng.standard_normal((64, 32)).astype(np.float32),
            "b": rng.standard_normal((32,)).astype(np.float32),
            "step_scale": np.float32(0.1)}


def test_param_server_snapshot_restore_and_store_kill9(tmp_path):
    jrt.Server().close()  # the reference runtime's first call, this thread

    # 5 pushes, a snapshot, a restore bit-exact, version 6 on the next push.
    store = ck.CheckpointStore()
    addr = f"127.0.0.1:{store.start(0)}"
    params = {k: v for k, v in _jax_arrays(2).items() if k != "ids"}
    params["bf"] = _port_arrays({"bf": params["bf"]})["bf"]
    try:
        a = ps.ParamServer(params, lr=0.05)
        client = ps.ParamClient(f"127.0.0.1:{a.start(0)}")
        rng = np.random.default_rng(3)
        for _ in range(5):
            client.push(_grads(rng))
        final = a.params()
        assert a.version() == 5
        assert a.snapshot_to(addr) == 5, "snapshot step"
        client.close()
        a_blob = bytes(a._blob)
        a.close()
        b = ps.ParamServer.restore(addr)
        assert b.version() == 5, "restored version"
        assert bytes(b._blob) == a_blob, "restored blob"
        _same(b.params(), final, "restored params")
        client = ps.ParamClient(f"127.0.0.1:{b.start(0)}")
        assert client.push({k: np.zeros_like(v) for k, v in
                            _grads(rng).items()}) == 6, "push after restore"
        client.close()
        b.close()
    finally:
        store.close()

    # The store process killed with SIGKILL and restarted on its
    # directory; the snapshot's file is the reference's blob too.
    d = str(tmp_path / "ckpts")
    os.makedirs(d)
    proc, saddr, n = _spawn_store(d)
    try:
        assert n == 0, "fresh directory"
        a = ps.ParamServer(params, lr=0.05)
        client = ps.ParamClient(f"127.0.0.1:{a.start(0)}")
        rng = np.random.default_rng(12)
        for _ in range(4):
            client.push(_grads(rng))
        final = a.params()
        assert a.snapshot_to(saddr) == 4, "kill -9: snapshot step"
        client.close()
        a.close()
    finally:
        _kill(proc)
    proc, saddr, n = _spawn_store(d)
    try:
        assert n == 1, f"kill -9: {n} steps recovered"
        b = ps.ParamServer.restore(saddr)
        assert b.version() == 4, "kill -9: restored version"
        _same(b.params(), final, "kill -9: restored params")
        b.close()
        step, _lr, back = jck.load_checkpoint(saddr)
        assert step == 4, "kill -9: reference load"
    finally:
        _kill(proc)

    # Training over the device transport (tests/test_param_server.py's
    # linear regression, gradients in torch).
    os.environ.setdefault("TRPC_FABRIC_NS", f"torch-ckpt-{os.getpid()}")
    g = torch.Generator().manual_seed(0)
    true_w = torch.randn(8, generator=g)
    x = torch.randn(256, 8, generator=g)
    y = x @ true_w + 0.01 * torch.randn(256, generator=g)
    server = ps.ParamServer({"w": np.zeros(8, np.float32)}, lr=0.1)
    server.start_device(SLICE, 0)
    try:
        client = ps.ParamClient(f"ici://{SLICE}/0")
        for step in range(60):
            w = torch.from_numpy(client.pull()["w"]).requires_grad_(True)
            loss = ((x @ w - y) ** 2).mean()
            (grad,) = torch.autograd.grad(loss, w)
            assert client.push({"w": grad.numpy()}) == step + 1, \
                f"device transport: version at step {step}"
        np.testing.assert_allclose(server.params()["w"], true_w.numpy(),
                                   atol=0.05, err_msg="device transport")
        client.close()
    finally:
        server.close()

    # TLS: a certificate made on the spot; the client verifies the chain
    # and pins the host name.
    if shutil.which("openssl") is None:
        pytest.skip("openssl is not installed: the TLS case needs it")
    cert, key = str(tmp_path / "c.pem"), str(tmp_path / "k.pem")
    subprocess.run(
        ["openssl", "req", "-x509", "-newkey", "rsa:2048", "-keyout", key,
         "-out", cert, "-days", "2", "-nodes", "-subj", "/CN=localhost",
         "-addext", "subjectAltName=DNS:localhost,IP:127.0.0.1"],
        check=True, capture_output=True)
    w0 = np.arange(12, dtype=np.float32).reshape(3, 4)
    srv = ps.ParamServer({"w": w0}, lr=0.5)
    srv._srv.enable_tls(cert, key)
    port = srv.start(0)
    client = None
    try:
        client = ps.ParamClient(f"127.0.0.1:{port}", tls=True,
                                tls_ca_file=cert, tls_sni_host="localhost")
        np.testing.assert_array_equal(client.pull()["w"], w0, "TLS pull")
        assert client.push({"w": np.ones((3, 4), np.float32)}) == 1, "TLS"
        np.testing.assert_allclose(srv.params()["w"], w0 - 0.5,
                                   err_msg="TLS push")
        assert bytes(client.pull_blob()) == bytes(srv._blob), "TLS ranges"
    finally:
        if client is not None:
            client.close()
        srv.close()
