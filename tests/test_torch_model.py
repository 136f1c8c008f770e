"""brpc_tpu_torch model parity with the JAX reference, on the CPU.

Inputs and weights come from the JAX package (``init_params(PRNGKey(0))``)
and move to the port with ``params_from_numpy``. Every check runs for the
tiny config in float32 and for its grouped-query variant (KV < H), since
tiny() alone has H == KV. Tolerance 1e-4 (rtol and atol): both sides are
float32, and XLA and PyTorch sum dot products in different orders.
"""

import ast
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import kv_cache as tkv
from brpc_tpu_torch import serving as ts
from brpc_tpu_torch.models import transformer as tt

TOL = dict(rtol=1e-4, atol=1e-4)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _configs(n_kv_heads):
    jcfg = dataclasses.replace(jt.TransformerConfig.tiny(), dtype=jnp.float32,
                               n_kv_heads=n_kv_heads)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                               dtype=torch.float32, n_kv_heads=n_kv_heads)
    return jcfg, tcfg


@pytest.fixture(scope="module", params=[4, 2], ids=["mha", "gqa"])
def models(request):
    jcfg, tcfg = _configs(request.param)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    tp = tt.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                              device="cpu")
    return jcfg, jp, tcfg, tp


def test_params_from_numpy_keeps_values(models):
    jcfg, jp, tcfg, tp = models
    np.testing.assert_array_equal(tp["layers"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["wq"]))
    assert tp["layers"]["ln_attn"].dtype == torch.float32
    assert tp["w_out"].shape == (tcfg.d_model, tcfg.vocab)


def test_forward_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    toks = np.random.default_rng(0).integers(0, tcfg.vocab, (2, 11),
                                             dtype=np.int32)
    want = np.asarray(jt.forward(jp, jnp.asarray(toks), jcfg))
    got = tt.forward(tp, torch.from_numpy(toks), tcfg).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


def test_rope_formulations_match_jax(models):
    jcfg, _, tcfg, _ = models
    x = np.random.default_rng(1).standard_normal((1, 9, 2, tcfg.d_head),
                                                 dtype=np.float32)
    np.testing.assert_allclose(
        tt._rope(torch.from_numpy(x), tcfg.rope_theta).numpy(),
        np.asarray(jt._rope(jnp.asarray(x), jcfg.rope_theta)), **TOL)
    jc, js = jt._rope_tables(jcfg)
    tc, tsin = tt._rope_tables(tcfg, torch.device("cpu"))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), **TOL)
    np.testing.assert_allclose(tsin.numpy(), np.asarray(js), **TOL)
    pos = np.array([0, 5, 77], np.int64)
    want = jt._rope_apply(jnp.asarray(x[0, :3]), jc[pos][:, None, :],
                          js[pos][:, None, :])
    got = tt._rope_apply(torch.from_numpy(x[0, :3]),
                         tc[torch.from_numpy(pos)][:, None, :],
                         tsin[torch.from_numpy(pos)][:, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_matches_jax(models):
    jcfg, jp, tcfg, tp = models
    prompt = np.array([3, 17, 91, 7, 42], np.int32)
    padded = np.pad(prompt, (0, 11))
    jl, jk, jv = jt.prefill(jp, jnp.asarray(padded), jnp.int32(5), jcfg)
    tl, tk, tv = tt.prefill(tp, torch.from_numpy(padded), 5, tcfg)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    P = len(padded)
    assert tk.shape == (tcfg.n_layers, P, tcfg.n_kv_heads, tcfg.d_head)
    # Pad positions [5, 16) write KV as the reference's do.
    np.testing.assert_allclose(tk.numpy(), np.asarray(jk)[:, :P], **TOL)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv)[:, :P], **TOL)
    # And the prefill logits equal the full forward's last position.
    ref = tt.forward(tp, torch.from_numpy(prompt)[None], tcfg)[0, -1]
    np.testing.assert_allclose(tl.numpy(), ref.numpy(), **TOL)


def test_padded_prefill_matches_unpadded(models):
    _, _, tcfg, tp = models
    prompt = np.array([9, 2, 55], np.int32)
    a, _, _ = tt.prefill(tp, torch.from_numpy(np.pad(prompt, (0, 13))), 3,
                         tcfg)
    b, _, _ = tt.prefill(tp, torch.from_numpy(prompt), 3, tcfg)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-5)


def test_decode_step_matches_jax(models):
    """A rollout of the port's batched paged decode against the JAX
    per-sequence decode_step (vmapped over dense caches), across a page
    boundary (page 4), with two lanes at different positions."""
    from functools import partial

    jcfg, jp, tcfg, tp = models
    page = 4
    prompts = [np.array([9, 2, 55], np.int32),
               np.array([1, 4, 9, 16, 25, 36], np.int32)]
    nb = tcfg.max_seq // page
    pool = tkv.PagedKvPool(tcfg, 2 * nb + 1, page, device="cpu")
    tables = np.zeros((2, nb), np.int32)
    jk, jv, toks, pos, blocks = [], [], [], [], []
    for i, pr in enumerate(prompts):
        padded = np.pad(pr, (0, 8 - len(pr)))
        jl, k, v = jt.prefill(jp, jnp.asarray(padded), jnp.int32(len(pr)),
                              jcfg)
        jk.append(k)
        jv.append(v)
        tl, tk, tv = tt.prefill(tp, torch.from_numpy(padded), len(pr), tcfg)
        b = pool.alloc(tkv.pages_for(len(pr), page))
        kp, vp = tkv.prefill_cache_pages(tk, tv, len(pr), page)
        pool.write_blocks(b, kp, vp)
        tables[i, :len(b)] = b
        blocks.append(b)
        toks.append(int(np.asarray(jl).argmax()))
        pos.append(len(pr))
    kc, vc = jnp.stack(jk), jnp.stack(jv)
    mono = jax.jit(jax.vmap(partial(jt.decode_step, cfg=jcfg),
                            in_axes=(None, 0, 0, 0, 0)))
    step = tkv.paged_decode_fn(tcfg, page)
    for _ in range(5):
        for i in range(2):  # grow the tables to cover this step's write
            need = pos[i] // page + 1
            while len(blocks[i]) < need:
                fresh = pool.alloc(1)
                blocks[i] += fresh
                tables[i, len(blocks[i]) - 1] = fresh[0]
        want, kc, vc = mono(jp, jnp.asarray(toks, jnp.int32),
                            jnp.asarray(pos, jnp.int32), kc, vc)
        got, pool.k, pool.v = step(
            tp, torch.tensor(toks, dtype=torch.int32),
            torch.tensor(pos, dtype=torch.int32), torch.from_numpy(tables),
            pool.k, pool.v)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        toks = [int(t) for t in np.asarray(want).argmax(-1)]
        pos = [p + 1 for p in pos]


@pytest.mark.parametrize("entry", ["init_params", "params_from_numpy",
                                   "greedy_reference", "pool", "engine"])
def test_entry_points_raise_without_cuda(entry):
    """No card and no explicit device="cpu": every entry point raises; none
    falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default device is valid")
    _, tcfg = _configs(4)
    with pytest.raises(RuntimeError, match="CUDA"):
        if entry == "init_params":
            tt.init_params(tcfg, torch.Generator().manual_seed(0))
        elif entry == "params_from_numpy":
            jcfg, _ = _configs(4)
            tt.params_from_numpy(jax.tree.map(
                np.asarray, jt.init_params(jcfg, jax.random.PRNGKey(0))),
                tcfg)
        elif entry == "greedy_reference":
            tt.greedy_reference({}, tcfg, [1], 1)
        elif entry == "pool":
            tkv.PagedKvPool(tcfg, 9, 16)
        else:
            ts.ServingEngine({}, tcfg, autostart=False)


def _port_sources():
    pkg = os.path.join(REPO, "brpc_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(pkg):
        out += [os.path.join(root, f) for f in files
                if f.endswith((".py", ".cu", ".cuh"))]
    return out


def test_port_sources_import_no_jax_and_no_library_attention():
    scanned = {os.path.relpath(p, REPO) for p in _port_sources()}
    for rel in ("brpc_tpu_torch/parallel/__init__.py",
                "brpc_tpu_torch/parallel/pipeline.py",
                "brpc_tpu_torch/parallel/world.py",
                "brpc_tpu_torch/ops/ring_attention.py",
                "brpc_tpu_torch/models/moe.py",
                "brpc_tpu_torch/csrc/ring_attention.cu"):
        assert rel in scanned, f"the scan misses {rel}"
    imported = {}
    for path in _port_sources():
        text = open(path).read()
        rel = os.path.relpath(path, REPO)
        if rel.startswith("brpc_tpu_torch"):
            for banned in ("scaled_dot_product_attention", "torch.compile",
                           "cpp_extension"):
                assert banned not in text, f"{rel} mentions {banned}"
        if not path.endswith(".py"):
            continue
        for node in ast.walk(ast.parse(text)):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                imported.setdefault(n.split(".")[0], set()).add(rel)
    assert "jax" not in imported, imported.get("jax")
    assert "brpc_tpu" not in imported, imported.get("brpc_tpu")
    assert "jaxlib" not in imported, imported.get("jaxlib")
    assert "brpc_tpu_torch" in imported
