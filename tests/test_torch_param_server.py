"""The port's TPS1 codec and parameter server against the JAX package's:
blobs byte-identical in both directions (f32, int32, a 0-d array, an empty
one, bf16; bf16 also in a process where ml_dtypes cannot be imported), JAX
and port clients and servers pulling and pushing across packages, and the
split of a dict too large for one frame into groups that a worker's pull
merges back."""

import os
import struct
import subprocess
import sys
import tempfile

import ml_dtypes
import numpy as np
import pytest
import torch

from brpc_tpu import param_server as jps
from brpc_tpu_torch import disagg, param_server as tps, runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {
        "layers/w": rng.standard_normal((3, 5)).astype(np.float32),
        "ids": rng.integers(-9, 9, 7).astype(np.int32),
        "scalar": np.array(2.5, np.float32),
        "empty": np.zeros((0, 4), np.float32),
        "bf": rng.standard_normal((4, 6)).astype(ml_dtypes.bfloat16),
    }


def _bits(a) -> np.ndarray:
    """Any array or tensor's raw bytes, for an exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16).numpy() if a.dtype == torch.bfloat16 \
            else a.numpy()
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def _torch_bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)


# The port's codec in a process where ml_dtypes cannot be imported (so numpy
# has no "bfloat16" dtype): decode the reference's blob, re-encode it.
_NO_ML_DTYPES = """
import sys
sys.modules["ml_dtypes"] = None
import numpy as np, torch
from brpc_tpu_torch import param_server
try:
    np.dtype("bfloat16")
    raise SystemExit("numpy knows bfloat16")
except TypeError:
    pass
blob = open(sys.argv[1], "rb").read()
arrays = param_server.decode_arrays(blob)
assert arrays["bf"].dtype == torch.bfloat16, arrays["bf"].dtype
view = param_server.decode_arrays(blob, copy=False)
assert param_server.encode_arrays(view) == blob
open(sys.argv[2], "wb").write(param_server.encode_arrays(arrays))
"""


def test_tps1_codec_byte_identical_to_jax():
    arrays = _arrays(0)
    want = jps.encode_arrays(arrays)
    ports = {
        "numpy (ml_dtypes bf16)": arrays,
        "torch bf16": {**arrays, "bf": _torch_bf16(arrays["bf"])},
        "raw bf16 bits": {**arrays, "bf": tps.Bfloat16Bits(
            arrays["bf"].view(np.uint16))},
        "torch tensors": {k: torch.from_numpy(np.asarray(v).copy())
                          for k, v in arrays.items() if k != "bf"}
        | {"bf": _torch_bf16(arrays["bf"])},
    }
    for case, port_arrays in ports.items():
        assert tps.encode_arrays(port_arrays) == want, case
        assert tps.blob_bytes(port_arrays) == len(want), case
    # The port decodes the reference's blob: bf16 as a torch bf16 tensor,
    # the rest as numpy, every byte the same, and re-encodes it unchanged.
    for copy in (True, False):
        got = tps.decode_arrays(want, copy=copy)
        assert got["bf"].dtype == torch.bfloat16, copy
        for k, v in arrays.items():
            assert tuple(got[k].shape) == v.shape, (k, copy)
            assert np.array_equal(_bits(got[k]), _bits(v)), (k, copy)
        assert tps.encode_arrays(got) == want, copy
    # The reference decodes the port's blob to the same arrays.
    back = jps.decode_arrays(tps.encode_arrays(ports["torch bf16"]))
    for k, v in arrays.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        assert np.array_equal(_bits(back[k]), _bits(v)), k
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "ref.tps1"), os.path.join(d, "port.tps1")
        with open(src, "wb") as f:
            f.write(want)
        proc = subprocess.run([sys.executable, "-c", _NO_ML_DTYPES, src, dst],
                              cwd=REPO, capture_output=True, text=True,
                              timeout=120)
        assert proc.returncode == 0, proc.stderr[-2000:]
        with open(dst, "rb") as f:
            assert f.read() == want
    with pytest.raises(ValueError):
        tps.decode_arrays(b"TPS0" + want[4:])


def test_param_servers_interoperate_with_jax(monkeypatch):
    """A JAX client pulls from the port's server; the port's client pulls
    from and pushes to the JAX server (SGD, retried transport errors
    aside), and to the port's own, with the same results; a whole blob
    comes in ranges from the port's server and in one pull from the
    JAX package's."""
    arrays = {k: v for k, v in _arrays(1).items() if k != "bf"}
    grads = {"layers/w": np.full((3, 5), 0.5, np.float32),
             "scalar": np.array(-1.0, np.float32)}
    want = {**arrays,
            "layers/w": (arrays["layers/w"] - 0.1 * grads["layers/w"]),
            "scalar": (arrays["scalar"] - 0.1 * grads["scalar"])}
    tsrv = tps.ParamServer(arrays, lr=0.1)
    jsrv = jps.ParamServer(arrays, lr=0.1)
    clients = []
    try:
        taddr = f"127.0.0.1:{tsrv.start(0)}"
        jaddr = f"127.0.0.1:{jsrv.start(0)}"
        jc = jps.ParamClient(taddr)
        tc_j = tps.ParamClient(jaddr, timeout_ms=10_000)
        tc_t = tps.ParamClient(taddr, timeout_ms=10_000)
        clients = [jc, tc_j, tc_t]
        for case, client in (("jax client, port server", jc),
                             ("port client, jax server", tc_j)):
            got = client.pull()
            for k, v in arrays.items():
                assert np.array_equal(_bits(got[k]), _bits(v)), (case, k)
        for case, client, srv in (("port client, jax server", tc_j, jsrv),
                                  ("port client, port server", tc_t, tsrv)):
            assert client.push(grads) == 1, case
            assert srv.version() == 1, case
            for k, v in srv.params().items():
                assert np.array_equal(_bits(v), _bits(want[k])), (case, k)
            with pytest.raises(runtime.RpcError) as e:
                client.push({"nope": np.zeros(2, np.float32)})
            assert e.value.code == runtime.EAPP and not e.value.retriable
            assert srv.version() == 1, case  # a failed push changes nothing
        # The JAX client sees the port server's update.
        assert np.array_equal(jc.pull()["layers/w"], want["layers/w"])
        # Whole blobs: in ranges over several connections from the port's
        # server, in one pull from the JAX package's (no ranges there).
        blob = jps.encode_arrays(want)
        for case, client in (("ranges", tc_t), ("jax server", tc_j)):
            for streams, range_bytes in ((3, 64), (8, 1 << 24)):
                monkeypatch.setattr(tps, "RANGE_STREAMS", streams)
                monkeypatch.setattr(tps, "RANGE_BYTES", range_bytes)
                got = client.pull_blob()
                assert bytes(got) == blob, (case, streams, range_bytes)
        with pytest.raises(runtime.RpcError) as e:  # a stale version
            tc_t._call_with_retry("pull_range", struct.pack("<QQQ", 0, 0, 8))
        assert e.value.code == runtime.EAPP and "replaced" in e.value.text
    finally:
        for c in clients:
            c.close()
        tsrv.close()
        jsrv.close()


def test_groups_split_under_the_cap_and_merge_in_a_pull(monkeypatch):
    """Under a lowered MAX_BLOB_BYTES a dict splits into groups of whole
    arrays, each blob within the cap; one ParamServer per group and a
    worker factory's pull of "a+b+c" merges them back, counting wire and
    effective bytes. An array over the cap raises with its name; a server
    is refused a blob over the cap, and one whose blob is over it fails
    the pull and sends nothing."""
    rng = np.random.default_rng(2)
    flat = {f"layers/w{i}": rng.standard_normal((16, 8 + i)).astype(
        np.float32) for i in range(6)}
    flat["ln"] = np.ones(8, np.float32)
    whole = tps.ParamServer(flat)
    cap = 1200
    monkeypatch.setattr(tps, "MAX_BLOB_BYTES", cap)
    groups = tps.groups(flat)
    assert len(groups) > 1
    assert sorted(k for g in groups for k in g) == sorted(flat)
    for g in groups:
        assert len(tps.encode_arrays(g)) == tps.blob_bytes(g) <= cap, sorted(g)
    assert tps.groups({"ln": flat["ln"]}) == [{"ln": flat["ln"]}]
    with pytest.raises(ValueError, match="'big'"):
        tps.groups({"big": np.zeros(400, np.float32)})
    with pytest.raises(ValueError, match="MAX_BLOB_BYTES.*meta_codec.cc:263"):
        tps.ParamServer(flat)
    servers = [tps.ParamServer(g) for g in groups]
    try:
        addrs = "+".join(f"127.0.0.1:{s.start(0)}" for s in servers)
        factory = disagg._WorkerFactory({}, None, None,
                                        param_addrs={"m": addrs},
                                        device="cpu")
        groups_before = runtime.app_counter_add("cluster_model_fetch_groups")
        got = factory._pull("m")
        assert sorted(got) == sorted(flat)
        for k, v in flat.items():
            assert got[k].dtype == torch.float32
            assert np.array_equal(got[k].numpy(), v), k
        assert runtime.app_counter_add("cluster_model_fetch_groups") \
            == groups_before + len(groups)
        assert factory.fetch_wire_bytes == sum(tps.blob_bytes(g)
                                               for g in groups)
        assert factory.fetch_effective_bytes == sum(v.nbytes
                                                    for v in flat.values())
        client = tps.ParamClient(f"127.0.0.1:{whole.start(0)}", retries=0,
                                 timeout_ms=10_000)
        try:
            with pytest.raises(runtime.RpcError) as e:
                client.pull()
        finally:
            client.close()
        assert e.value.code == runtime.EAPP
        assert "MAX_BLOB_BYTES" in e.value.text
        assert "meta_codec.cc:263" in e.value.text
    finally:
        for s in servers + [whole]:
            s.close()
