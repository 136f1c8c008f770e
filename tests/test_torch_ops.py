"""The port's kernels: each plain version against the JAX computation it
stands for (on the CPU, float32, tolerance 1e-4 for summation order) and
the wrappers' device dispatch. The CUDA kernels against their plain
versions on a card: tests/test_torch_kernels_card.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from brpc_tpu.models import transformer as jt
from brpc_tpu_torch import ops
from brpc_tpu_torch.ops import attention, norm

TOL = dict(rtol=1e-4, atol=1e-4)
HEADS = [(4, 4, 32), (4, 2, 32), (8, 2, 64)]  # (H, KV, Dh)


def _jax_paged_decode_attention(q, k_pool, v_pool, tables, pos, layer):
    """The reference's decode attention: gather the tables' blocks into the
    dense view (brpc_tpu/kv_cache.py:336-341), then per lane the masked f32
    softmax attention of transformer.py:450-461."""
    S, nb = tables.shape
    _, L, page, KV, Dh = k_pool.shape
    H = q.shape[1]

    def dense(pool):
        g = pool[tables].transpose(0, 2, 1, 3, 4, 5)
        return g.reshape(S, L, nb * page, KV, Dh)[:, layer]

    def one(q, kc, vc, p):
        kr, vr = kc, vc
        if KV != H:
            kr = jnp.repeat(kc, H // KV, axis=1)
            vr = jnp.repeat(vc, H // KV, axis=1)
        scale = 1.0 / jnp.sqrt(jnp.float32(Dh))
        logits = jnp.einsum("hd,shd->hs", q, kr,
                            preferred_element_type=jnp.float32) * scale
        mask = jnp.arange(nb * page) <= p
        logits = jnp.where(mask[None, :], logits, jnp.float32(-1e30))
        probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
        return jnp.einsum("hs,shd->hd", probs, vr,
                          preferred_element_type=jnp.float32).astype(q.dtype)

    return jax.vmap(one)(q, dense(k_pool), dense(v_pool), pos)


def _jax_prefill_attention(q, k, v, length):
    """transformer.py:237-258: causal attention with the pad-key mask."""
    P, H, Dh = q.shape
    KV = k.shape[1]
    span = jnp.arange(P)
    mask = (span[:, None] >= span[None, :]) & (span[None, :] < length)
    kr, vr = k, v
    if KV != H:
        kr = jnp.repeat(k, H // KV, axis=1)
        vr = jnp.repeat(v, H // KV, axis=1)
    scale = 1.0 / jnp.sqrt(jnp.float32(Dh))
    logits = jnp.einsum("qhd,khd->hqk", q, kr,
                        preferred_element_type=jnp.float32) * scale
    logits = jnp.where(mask[None, :, :], logits, jnp.float32(-1e30))
    probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("hqk,khd->qhd", probs, vr,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _jax_resume_attention(q, k_pool, v_pool, table, start, layer, view):
    """The attention of a prefix-cache resume: gather the table's pages
    into the dense prefix view (brpc_tpu/kv_cache.py:1170-1174), then the
    masked f32 softmax attention of transformer.py:398-411 over it, query
    i at position start + i."""
    n, H, Dh = q.shape
    _, L, page, KV, _ = k_pool.shape

    def dense(pool):
        g = pool[table].transpose(1, 0, 2, 3, 4)
        return g.reshape(L, view * page, KV, Dh)[layer]

    kr, vr = dense(k_pool), dense(v_pool)
    if KV != H:
        kr = jnp.repeat(kr, H // KV, axis=1)
        vr = jnp.repeat(vr, H // KV, axis=1)
    idx = start + jnp.arange(n)
    mask = jnp.arange(view * page)[None, :] <= idx[:, None]
    scale = 1.0 / jnp.sqrt(jnp.float32(Dh))
    logits = jnp.einsum("qhd,shd->hqs", q, kr,
                        preferred_element_type=jnp.float32) * scale
    logits = jnp.where(mask[None, :, :], logits, jnp.float32(-1e30))
    probs = jax.nn.softmax(logits, axis=-1).astype(q.dtype)
    return jnp.einsum("hqs,shd->qhd", probs, vr,
                      preferred_element_type=jnp.float32).astype(q.dtype)


def _decode_inputs(H, KV, Dh, seed=0):
    rng = np.random.default_rng(seed)
    S, L, page, nb = 5, 3, 16, 8  # max_seq 128
    pos = np.array([0, 15, 16, 77, 127], np.int32)
    n_blocks = 1 + sum(p // page + 1 for p in pos)
    k_pool = rng.standard_normal((n_blocks, L, page, KV, Dh), np.float32)
    v_pool = rng.standard_normal((n_blocks, L, page, KV, Dh), np.float32)
    order = rng.permutation(np.arange(1, n_blocks)).astype(np.int32)
    tables = np.zeros((S, nb), np.int32)  # unused entries: garbage block 0
    used = 0
    for s, p in enumerate(pos):
        n = p // page + 1
        tables[s, :n] = order[used:used + n]
        used += n
    q = rng.standard_normal((S, H, Dh), np.float32)
    return q, k_pool, v_pool, tables, pos


@pytest.mark.parametrize("H,KV,Dh", HEADS)
@pytest.mark.parametrize("layer", [0, 2])
def test_paged_decode_attention_plain_matches_jax(H, KV, Dh, layer):
    q, k_pool, v_pool, tables, pos = _decode_inputs(H, KV, Dh)
    want = _jax_paged_decode_attention(*map(jnp.asarray, (
        q, k_pool, v_pool, tables, pos)), layer)
    got = attention.paged_decode_attention(*map(torch.from_numpy, (
        q, k_pool, v_pool, tables, pos)), layer)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("H,KV,Dh", HEADS)
@pytest.mark.parametrize("P,length", [(8, 5), (16, 16), (64, 37)])
def test_prefill_attention_plain_matches_jax(H, KV, Dh, P, length):
    rng = np.random.default_rng(P)
    q = rng.standard_normal((P, H, Dh), np.float32)
    k = rng.standard_normal((P, KV, Dh), np.float32)
    v = rng.standard_normal((P, KV, Dh), np.float32)
    want = _jax_prefill_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), length)
    got = attention.prefill_attention(torch.from_numpy(q),
                                      torch.from_numpy(k),
                                      torch.from_numpy(v), length)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (start, n): page-aligned, mid-page start ending mid-page, one query deep,
# no cached prefix, one query mid-page, a full 64-query tile, two tiles
RESUME_CASES = [(32, 9), (21, 30), (77, 1), (0, 20), (15, 1), (47, 64),
                (100, 70)]


@pytest.mark.parametrize("start,n", RESUME_CASES)
@pytest.mark.parametrize("H,KV,Dh", HEADS)
def test_paged_prefill_attention_plain_matches_jax(H, KV, Dh, start, n):
    """K4's plain version against the attention of the reference's
    ``prefill_resume`` over its gathered prefix view, on a shuffled table
    and the last layer of a strided pool."""
    rng = np.random.default_rng(start + n)
    L, page = 3, 16
    pages = -(-(start + n) // page)
    n_blocks = pages + 3
    k_pool = rng.standard_normal((n_blocks, L, page, KV, Dh), np.float32)
    v_pool = rng.standard_normal((n_blocks, L, page, KV, Dh), np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[:pages].astype(np.int32)
    q = rng.standard_normal((n, H, Dh), np.float32)
    want = _jax_resume_attention(*map(jnp.asarray, (q, k_pool, v_pool,
                                                    table)), start, L - 1,
                                 pages)
    got = attention.paged_prefill_attention(
        *map(torch.from_numpy, (q, k_pool, v_pool, table)), start, L - 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("start,n", RESUME_CASES)
def test_paged_prefill_attention_plain_bf16_matches_jax(start, n):
    """bf16 pools and queries, f32 logits and softmax inside, the
    probabilities rounded to bf16 before P.V: the reference's rounding
    points; one bf16 rounding step of difference at most."""
    H, KV, Dh = 8, 2, 64
    rng = np.random.default_rng(start + n + 1)
    L, page = 2, 16
    pages = -(-(start + n) // page)
    n_blocks = pages + 2
    k_pool = rng.standard_normal((n_blocks, L, page, KV, Dh), np.float32)
    v_pool = rng.standard_normal((n_blocks, L, page, KV, Dh), np.float32)
    table = rng.permutation(np.arange(1, n_blocks))[:pages].astype(np.int32)
    q = rng.standard_normal((n, H, Dh), np.float32)
    want = _jax_resume_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k_pool, v_pool)),
        jnp.asarray(table), start, 0, pages)
    got = attention.paged_prefill_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k_pool,
                                                           v_pool)),
        torch.from_numpy(table), start, 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=1e-2, atol=2e-2)


@pytest.mark.parametrize("shape", [(8, 128), (3, 5, 96)])
def test_rms_norm_plain_matches_jax(shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal(shape, np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    want = jt._rms_norm(jnp.asarray(x), jnp.asarray(g), 1e-5)
    got = norm.rms_norm(torch.from_numpy(x), torch.from_numpy(g), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rms_norm_plain_bf16_matches_jax():
    """bf16 in and out, f32 inside: the same rounding points as the
    reference; one bf16 rounding step of difference at most."""
    rng = np.random.default_rng(4)
    x32 = rng.standard_normal((4, 64), np.float32)
    x = torch.from_numpy(x32).to(torch.bfloat16)
    g = torch.ones(64)
    want = jt._rms_norm(jnp.asarray(x.float().numpy()).astype(jnp.bfloat16),
                        jnp.ones(64, jnp.float32), 1e-5)
    got = norm.rms_norm(x, g, 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=8e-3, atol=8e-3)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_add_rms_norm_plain_matches_jax(dtype):
    """The fused residual add and norm against the reference's add then
    ``_rms_norm`` (transformer.py:102): the sum exactly (one rounding to
    the model dtype on both sides), the norm within f32 summation order or
    one bf16 rounding step."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((6, 128), np.float32)).to(dtype)
    d = torch.from_numpy(rng.standard_normal((6, 128), np.float32)).to(dtype)
    g = (1.0 + 0.1 * rng.standard_normal(128)).astype(np.float32)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    js = (jnp.asarray(x.float().numpy()).astype(jdt)
          + jnp.asarray(d.float().numpy()).astype(jdt))
    jh = jt._rms_norm(js, jnp.asarray(g), 1e-5)
    s, h = norm.add_rms_norm(x, d, torch.from_numpy(g), 1e-5)
    np.testing.assert_array_equal(s.float().numpy(),
                                  np.asarray(js.astype(jnp.float32)))
    tol = TOL if dtype == torch.float32 else dict(rtol=8e-3, atol=8e-3)
    np.testing.assert_allclose(h.float().numpy(),
                               np.asarray(jh.astype(jnp.float32)), **tol)


def test_cpu_tensors_take_plain_versions_and_count_no_launch():
    before = ops.launch_counts()
    q, k_pool, v_pool, tables, pos = map(torch.from_numpy,
                                         _decode_inputs(4, 2, 32))
    attention.paged_decode_attention(q, k_pool, v_pool, tables, pos, 0)
    x = torch.randn(8, 4, 32)
    attention.prefill_attention(x, x[:, :2], x[:, :2], 5)
    attention.paged_prefill_attention(x, k_pool, v_pool, tables[3], 3, 0)
    norm.rms_norm(x, torch.ones(32), 1e-5)
    norm.add_rms_norm(x, x, torch.ones(32), 1e-5)
    assert ops.launch_counts() == before


def test_other_devices_raise():
    x = torch.empty((8, 4, 32), device="meta")
    with pytest.raises(ValueError):
        norm.rms_norm(x, torch.empty(32, device="meta"), 1e-5)
    with pytest.raises(ValueError):
        norm.add_rms_norm(x, x, torch.empty(32, device="meta"), 1e-5)
    with pytest.raises(ValueError):
        attention.prefill_attention(x, x[:, :2], x[:, :2], 5)
    with pytest.raises(ValueError):
        attention.paged_decode_attention(
            x, torch.empty((2, 1, 16, 2, 32), device="meta"),
            torch.empty((2, 1, 16, 2, 32), device="meta"),
            torch.empty((8, 1), dtype=torch.int32, device="meta"),
            torch.empty((8,), dtype=torch.int32, device="meta"), 0)
    with pytest.raises(ValueError):
        attention.paged_prefill_attention(
            x, torch.empty((2, 1, 16, 2, 32), device="meta"),
            torch.empty((2, 1, 16, 2, 32), device="meta"),
            torch.empty((1,), dtype=torch.int32, device="meta"), 4, 0)
