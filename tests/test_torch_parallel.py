"""The port's parallelism path (brpc_tpu_torch.parallel, ops.ring_attention,
models.moe) against the JAX package on the same numpy inputs.

The port runs in gloo worlds of 4 spawned ranks (``parallel.world.run``,
rank bodies in tests/torch_parallel_ranks.py, which import no JAX); the JAX
side runs here, on a 4-device sub-mesh of the virtual CPU mesh. Tolerances
are the reference tests' own: collectives rtol 1e-5 (exact where data only
moves), ring attention rtol 2e-4 / atol 2e-5 and its gradient rtol 1e-3 /
atol 1e-4 (tests/test_ring_attention.py), the pipeline atol 1e-5 and MoE
atol 1e-4 (tests/test_parallel.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from brpc_tpu import parallel as jpar
from brpc_tpu.models import moe as jmoe
from brpc_tpu.ops import attention_reference as j_attention_reference
from brpc_tpu.ops import ring_attention as j_ring_attention
from brpc_tpu.parallel.pipeline import pipeline_forward as jpipeline
from brpc_tpu_torch import parallel as par
from brpc_tpu_torch.models import moe
from brpc_tpu_torch.ops import ring_attention as ra
from brpc_tpu_torch.parallel import world

N = 4
RING_TOL = dict(rtol=2e-4, atol=2e-5)


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < N:
        pytest.skip(f"need {N} JAX devices")
    return jpar.make_mesh((N,), ("x",))


def _qkv(seed, B, S, H, D):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, H, D)).astype(np.float32)
                 for _ in range(3))


def _jax_ring(mesh, q, k, v, causal):
    return np.asarray(j_ring_attention(mesh, "x", jnp.asarray(q),
                                           jnp.asarray(k), jnp.asarray(v),
                                           causal=causal))


def test_collectives_match_jax_in_a_gloo_world(mesh):
    x_gather = np.arange(N * 4, dtype=np.float32).reshape(N, 4)
    x_reduce = np.random.RandomState(0).randn(N, 4).astype(np.float32)
    per_rank = np.random.RandomState(1).randn(N, N * 2).astype(np.float32)
    # Distinct values per rank and chunk: a wrong chunk order shows.
    x_a2a = np.arange(N * N * 2, dtype=np.float32).reshape(N, N * 2)
    x_a2a3 = np.arange(N * 2 * N * 3, dtype=np.float32).reshape(N * 2, N, 3)
    x_shift = np.arange(N * 3, dtype=np.float32).reshape(N, 3)
    x_fan = np.random.RandomState(2).randn(4, 4).astype(np.float32)
    got = world.run(N, ranks.collectives, x_gather, x_reduce, per_rank,
                    x_a2a, x_a2a3, x_shift, x_fan)

    def jx(f, x, *a):
        return np.asarray(f(mesh, "x", jnp.asarray(x), *a))

    def per_rank_fn(rank, full):
        return full * (rank + 1)

    replicated = {
        "all_gather": jx(jpar.all_gather, x_gather),
        "all_reduce": jx(jpar.all_reduce, x_reduce),
        "fanout_concat": jx(lambda m, a, x: jpar.fanout_call(
            m, a, per_rank_fn, x, merger="concat"), x_fan),
        "fanout_sum": jx(lambda m, a, x: jpar.fanout_call(
            m, a, per_rank_fn, x, merger="sum"), x_fan),
    }
    sharded = {
        "reduce_scatter": jx(jpar.reduce_scatter, per_rank),
        "all_to_all": jx(jpar.all_to_all, x_a2a),
        "all_to_all_3d": jx(jpar.all_to_all, x_a2a3),
    }
    for s in ranks.SHIFTS:
        sharded[f"ring_shift_{s}"] = jx(jpar.ring_shift, x_shift, s)
    np.testing.assert_array_equal(sharded["all_to_all"],
                                  x_a2a.reshape(N, N, 2).transpose(1, 0, 2)
                                  .reshape(N, N * 2))
    for name, want in replicated.items():
        for r in range(N):
            np.testing.assert_allclose(got[r][name], want, rtol=1e-5,
                                       err_msg=f"{name} on rank {r}")
    for name, want in sharded.items():
        np.testing.assert_allclose(
            np.concatenate([got[r][name] for r in range(N)]), want,
            rtol=1e-5, err_msg=name)
    with pytest.raises(ValueError, match="unknown merger"):
        par.fanout_call(lambda r, x: x, torch.zeros(2), merger="max")


RING_CASES = [(0, 2, 64, 4, 16, False), (1, 1, 64, 2, 8, True),
              (2, 1, 512, 2, 16, True)]  # (seed, B, S, H, D, causal)


def test_ring_attention_matches_jax_in_a_gloo_world(mesh):
    """The distributed ring (blocks shifted over gloo) against the JAX ring
    on the 4-device mesh, causal and not, up to S 512; n == 1 (each rank
    alone in a group, no shift) against the JAX ring on one device; and
    the in-process form bit for bit against the distributed one."""
    cases = [_qkv(seed, B, S, H, D) + (causal,)
             for seed, B, S, H, D, causal in RING_CASES]
    got = world.run(N, ranks.ring, cases)
    for i, (q, k, v, causal) in enumerate(cases):
        dist_out = np.concatenate([got[r][0][i] for r in range(N)], axis=1)
        np.testing.assert_allclose(dist_out, _jax_ring(mesh, q, k, v, causal),
                                   err_msg=f"case {RING_CASES[i]}",
                                   **RING_TOL)
        s = q.shape[1] // N
        local = ra.ring_attention_local(
            *[[torch.from_numpy(a[:, r * s:(r + 1) * s]) for r in range(N)]
              for a in (q, k, v)], causal)
        assert np.array_equal(torch.cat(local, dim=1).numpy(), dist_out), \
            f"in-process ring differs from the distributed one, case {i}"
    q, k, v, causal = cases[0]
    one = jpar.make_mesh((1,), ("x",))
    for r in range(N):
        np.testing.assert_allclose(got[r][1], _jax_ring(one, q, k, v, causal),
                                   err_msg=f"n == 1 on rank {r}", **RING_TOL)


def test_ring_attention_local_gradient_matches_dense():
    """The in-process ring (the form the card runs) on the CPU, where the
    fold is the plain version, is differentiable: its gradient equals the
    dense oracle's (the reference's test_ring_grad_flows, in the port),
    and the port's dense oracle equals the JAX package's, causal."""
    q, k, v = _qkv(3, 1, 32, 1, 8)
    grads = []
    for ring in (True, False):
        ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
        if ring:
            blocks = [list(t.split(32 // N, dim=1)) for t in ts]
            out = torch.cat(ra.ring_attention_local(*blocks), dim=1)
        else:
            out = ra.attention_reference(*ts)
        (out ** 2).sum().backward()
        grads.append([t.grad.numpy() for t in ts])
    for name, g_ring, g_dense in zip("qkv", *grads):
        np.testing.assert_allclose(g_ring, g_dense, rtol=1e-3, atol=1e-4,
                                   err_msg=f"d loss / d {name}")
    q, k, v = _qkv(4, 2, 64, 2, 16)
    dense = np.asarray(j_attention_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True))
    np.testing.assert_allclose(
        ra.attention_reference(*map(torch.from_numpy, (q, k, v)), True)
        .numpy(), dense, **RING_TOL)


def test_pipeline_forward_matches_jax_in_a_gloo_world():
    """4 stages of tanh(a @ w) over 6 microbatches: one stage per rank
    against the JAX pipeline on a 4-device mesh; then 8 stages, two per
    rank, against applying them in sequence."""
    pp = jpar.make_mesh((N,), ("pp",))
    w = (jax.random.normal(jax.random.PRNGKey(0), (N, 8, 8)) * 0.3)
    x = jax.random.normal(jax.random.PRNGKey(1), (6, 3, 8))
    want = np.asarray(jpipeline(pp, "pp", lambda a, b: jnp.tanh(b @ a), w, x))
    w, x = np.asarray(w), np.array(x)
    w8 = np.random.default_rng(5).standard_normal((2 * N, 8, 8)).astype(
        np.float32) * 0.3
    got = world.run(N, ranks.pipeline, [w, w8], x)
    seq = torch.from_numpy(x.copy())
    for i in range(2 * N):
        seq = torch.tanh(seq @ torch.from_numpy(w8[i]))
    for r in range(N):
        np.testing.assert_allclose(got[r][0], want, atol=1e-5,
                                   err_msg=f"rank {r}")
        np.testing.assert_allclose(got[r][1], seq.numpy(), atol=1e-5,
                                   err_msg=f"two stages a rank, rank {r}")


def test_moe_matches_jax_in_a_gloo_world():
    """moe_forward over 4 ranks (experts sharded, all_to_all over gloo)
    against the JAX package's on a 4-device mesh, with ample capacity and
    with drops at capacity 1 and 2 (capacity holds per rank's shard, so
    with drops the parity is against moe_forward, not the oracle); with
    ample capacity also against both oracles."""
    ep = jpar.make_mesh((N,), ("ep",))
    jp = jmoe.moe_init(jax.random.PRNGKey(2), 16, 32, 8)
    x = jax.random.normal(jax.random.PRNGKey(3), (8, 4, 16))
    caps = (64, 1, 2)
    want = [np.asarray(jmoe.moe_forward(ep, "ep", jp, x, capacity=c))
            for c in caps]
    params = {k: np.asarray(a) for k, a in jp.items()}
    got = world.run(N, ranks.moe_ranks, params, np.asarray(x), caps)
    for i, c in enumerate(caps):
        np.testing.assert_allclose(
            np.concatenate([got[r][i] for r in range(N)]), want[i],
            atol=1e-4, err_msg=f"capacity {c}")
    oracle = np.asarray(jmoe.moe_reference(jp, x, capacity=64))
    np.testing.assert_allclose(want[0], oracle, atol=1e-4)
    tp = moe.moe_params_from_numpy(params, device="cpu")
    np.testing.assert_allclose(
        moe.moe_reference(tp, torch.from_numpy(np.asarray(x)), 64).numpy(),
        oracle, atol=1e-4)


def test_moe_routing_matches_jax():
    """The router alone, in f32: dispatch and combine equal the
    reference's, at ample capacity and with drops."""
    rng = np.random.default_rng(6)
    x2d = rng.standard_normal((64, 16)).astype(np.float32)
    router = rng.standard_normal((16, 8)).astype(np.float32) * 0.25
    for cap in (64, 3, 1):
        jd, jc = jmoe._route(jnp.asarray(x2d), jnp.asarray(router), cap, 8)
        td, tc = moe._route(torch.from_numpy(x2d), torch.from_numpy(router),
                            cap, 8)
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd),
                                      err_msg=f"dispatch, capacity {cap}")
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6,
                                   err_msg=f"combine, capacity {cap}")
    p = moe.moe_init(torch.Generator().manual_seed(0), 16, 32, 8,
                     device="cpu")
    assert {k: tuple(v.shape) for k, v in p.items()} == {
        "router": (16, 8), "w_in": (8, 16, 32), "w_out": (8, 32, 16)}


def test_world_run_reports_failed_exited_and_hung_ranks():
    with pytest.raises(RuntimeError) as err:
        world.run(3, ranks.misbehave, timeout_s=8)
    msg = str(err.value)
    assert "rank 0" in msg and "fails on purpose" in msg, msg
    assert "rank 1: exited with code 3" in msg, msg
    assert "ranks [2] had not finished" in msg, msg
