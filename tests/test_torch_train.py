"""The port's training path (models.transformer.loss_fn, train.train_step,
the backward of K2, K3 and K5, the ring's gradient and the dp x tp dry-run
twin) against the JAX package on the same numpy inputs, on the CPU in f32.

On the CPU every wrapper runs its plain version: here ``loss_fn`` runs
the plain forward and the plain backward formulas (the K2b, K3b and K5b
arithmetic), each held to autograd of its plain forward, and the whole to
``jax.value_and_grad``. Tolerances: the loss within 1e-5 relative (both
f32), gradients rtol 1e-3 / atol 1e-4 as tests/test_ring_attention.py:71
holds the reference ring's, updated parameters rtol 1e-4 / atol 1e-5 (a
step moves each by 1e-3 g); plain backwards against autograd rtol 1e-4 /
atol 1e-5 (the same f32 sums in another order). The worlds are gloo worlds
of 4 ranks (``parallel.world.run``; rank bodies in
tests/torch_parallel_ranks.py), the JAX side on a 4-device sub-mesh.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_ranks as ranks
from brpc_tpu import parallel as jpar
from brpc_tpu.models import transformer as jt
from brpc_tpu.ops import ring_attention as j_ring_attention
from brpc_tpu_torch import dryrun, train
from brpc_tpu_torch.models import transformer as tt
from brpc_tpu_torch.ops import attention, norm
from brpc_tpu_torch.ops import ring_attention as ra
from brpc_tpu_torch.parallel import world

N = 4
GRAD_TOL = dict(rtol=1e-3, atol=1e-4)
STEP_TOL = dict(rtol=1e-4, atol=1e-5)
PLAIN_TOL = dict(rtol=1e-4, atol=1e-5)


def _configs(n_kv_heads):
    jcfg = dataclasses.replace(jt.TransformerConfig.tiny(), dtype=jnp.float32,
                               n_kv_heads=n_kv_heads)
    tcfg = dataclasses.replace(tt.TransformerConfig.tiny(),
                               dtype=torch.float32, n_kv_heads=n_kv_heads)
    return jcfg, tcfg


def _leaves(tree):
    """(name, array) of a parameter tree, in a fixed order."""
    out = [("embed", tree["embed"]), ("ln_out", tree["ln_out"]),
           ("w_out", tree["w_out"])]
    return out + [(k, tree["layers"][k]) for k in sorted(tree["layers"])]


@pytest.fixture(scope="module")
def reference():
    """For KV 4 (H == KV) and KV 2: the reference's f32 parameters, random
    tokens [2, 17], and jax.value_and_grad(loss_fn) on them."""
    out = {}
    toks = np.random.default_rng(2).integers(0, 256, (2, 17),
                                             dtype=np.int32)
    for kv in (4, 2):
        jcfg, tcfg = _configs(kv)
        jp = jt.init_params(jcfg, jax.random.PRNGKey(1))
        loss, grads = jax.jit(jax.value_and_grad(jt.loss_fn),
                              static_argnums=2)(jp, jnp.asarray(toks), jcfg)
        out[kv] = (tcfg, jax.tree.map(np.asarray, jp), toks, float(loss),
                   jax.tree.map(np.asarray, grads))
    return out


def test_loss_and_grads_match_jax(reference):
    """loss_fn (the training forward) and loss_fn_plain (the plain forward
    under autograd) against jax.value_and_grad(loss_fn), with and without
    grouped-query heads."""
    for kv, (tcfg, params, toks, j_loss, j_grads) in reference.items():
        tp = tt.train_params_from_numpy(params, tcfg, device="cpu")
        for fn in (tt.loss_fn, tt.loss_fn_plain):
            case = f"{fn.__name__} KV={kv}"
            loss, grads = train.value_and_grad(fn, tp, toks, tcfg,
                                               device="cpu")
            assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss), case
            got = tt.train_params_to_numpy(train.unflatten(grads, tp))
            for (name, g), (_, want) in zip(_leaves(got), _leaves(j_grads)):
                assert np.isfinite(g).all(), (case, name)
                np.testing.assert_allclose(g, want, **GRAD_TOL,
                                           err_msg=f"{case} d/d{name}")


def test_train_step_matches_jax(reference):
    """train_step's update against the reference's p - 1e-3 g, on f32
    master parameters (train_params_from_numpy keeps every leaf f32, and
    train_params_to_numpy gives the values back)."""
    tcfg, params, toks, j_loss, j_grads = reference[2]
    tp = tt.train_params_from_numpy(params, tcfg, device="cpu")
    assert all(t.dtype == torch.float32 for t in train.flatten(tp))
    for (name, a), (_, b) in zip(_leaves(tt.train_params_to_numpy(tp)),
                                 _leaves(params)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    new, loss = train.train_step(tp, toks, tcfg, device="cpu")
    assert abs(float(loss) - j_loss) <= 1e-5 * abs(j_loss)
    want = jax.tree.map(lambda p, g: p - 1e-3 * g, params, j_grads)
    for (name, a), (_, b) in zip(_leaves(tt.train_params_to_numpy(new)),
                                 _leaves(want)):
        np.testing.assert_allclose(a, b, **STEP_TOL, err_msg=name)


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


def test_attention_backward_plain_matches_autograd():
    """K2b's arithmetic (prefill_attention_backward_plain, from the saved
    LSE) against autograd of the plain forward, with H 4 over KV 2 and KV
    4 (a wrong head map in the dK/dV sum shows with distinct values), and
    causal_attention's gradient (the autograd function) equal to it."""
    rng = np.random.default_rng(0)
    for H, KV in ((4, 2), (4, 4)):
        case = f"H={H} KV={KV}"
        q, k, v = _t(rng, 2, 70, H, 16), _t(rng, 2, 70, KV, 16), \
            _t(rng, 2, 70, KV, 16)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        o, lse = attention.causal_attention_plain(*leaves)
        # The LSE's units: the probabilities it gives sum to 1 on each row.
        logits = torch.einsum("bqhd,bkhd->bqhk", q,
                              k.repeat_interleave(H // KV, 2)) \
            * attention.softmax_scale(16)
        mask = torch.ones(70, 70, dtype=torch.bool).tril()[None, :, None]
        p = torch.where(mask, torch.exp(logits - lse[..., None]), 0.0)
        torch.testing.assert_close(p.sum(-1), torch.ones_like(lse),
                                   msg=lambda m: f"{case} LSE: {m}")
        do = _t(rng, *o.shape)
        o.backward(do)
        got = attention.prefill_attention_backward_plain(
            q, k, v, o.detach(), lse.detach(), do)
        fn = [t.clone().requires_grad_(True) for t in (q, k, v)]
        attention.causal_attention(*fn).backward(do)
        for name, g, ref, f in zip("qkv", got, leaves, fn):
            np.testing.assert_allclose(g.numpy(), ref.grad.numpy(),
                                       **PLAIN_TOL,
                                       err_msg=f"{case} d/d{name}")
            np.testing.assert_array_equal(f.grad.numpy(), g.numpy(),
                                          err_msg=f"{case} fn d/d{name}")


def _check_tile_plan(plan, sq, sk, H, KV, diag, causal, case):
    """Each visible (query, key, head) triple lies in exactly one tile of
    each pass (an invisible one in at most one, which then crosses the
    diagonal), every tile holds a visible triple, and a tile not marked as
    crossing holds nothing else."""
    rep = H // KV
    q_pos = np.arange(sq)[:, None]
    k_pos = np.arange(sk)[None, :]
    visible = (k_pos <= diag + q_pos) if causal else np.ones((sq, sk), bool)
    for name in ("kv", "q"):
        count = np.zeros((H, sq, sk), np.int32)
        for own_h, col_h, lo, hi, c0, c1, cross in plan[name]:
            if name == "kv":
                h, qs, ks = col_h, slice(c0, c1), slice(lo, hi)
                assert col_h // rep == own_h, (case, name)
            else:
                h, qs, ks = own_h, slice(lo, hi), slice(c0, c1)
                assert own_h // rep == col_h, (case, name)
            count[h, qs, ks] += 1
            seen = visible[qs, ks]
            assert seen.any(), f"{case} {name}: a tile wholly masked"
            assert cross or seen.all(), f"{case} {name}: an unmarked cross"
        assert (count[:, visible] == 1).all(), f"{case} {name}: coverage"
        assert (count[:, ~visible] <= 1).all(), f"{case} {name}: overlap"


def test_attention_backward_tile_walk_matches_plain():
    """The backward cores' tile walks (backward_tile_plan with the bf16
    core's tiles from csrc/attention_backward.cuh and the f32 core's from
    csrc/attention_f32.cuh), computed tile by tile in f32
    (attention_backward_tiles_plain), against the plain backwards: K2b's
    causal GQA at S 70, 130 and 257 (ragged against the 128- and 64-row own
    tiles and the 64- and 32-row column tiles) with H 4 over KV 2, and
    K5b's block at offsets q_start - k_start of +s, 0 and -s (without the
    mask), and a causal block wholly above the diagonal (no tile, no
    gradient); each plan covers every visible triple once per pass and
    holds no masked tile."""
    rng = np.random.default_rng(3)
    H, KV, Dh = 4, 2, 16
    cores = (("bf16 core", attention.BWD_TILES),
             ("f32 core", attention.F32_BWD_TILES))
    for S in (70, 130, 257):
        q, k, v, do = (_t(rng, 2, S, n, Dh) for n in (H, KV, KV, H))
        o, lse = attention.causal_attention_plain(q, k, v)
        want = attention.prefill_attention_backward_plain(q, k, v, o, lse,
                                                          do)
        for core, tiles in cores:
            case = f"{core} K2b S={S}"
            got = attention.attention_backward_tiles_plain(
                q, k, v, o, lse, do, tiles=tiles)
            for name, g, w in zip("qkv", got, want):
                np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                           atol=1e-5,
                                           err_msg=f"{case} d{name}")
            _check_tile_plan(attention.backward_tile_plan(S, S, H, KV, 0,
                                                          True, tiles),
                             S, S, H, KV, 0, True, case)
    for s in (100, 200):
        q, kb, vb, k2, v2, do = (_t(rng, 1, s, 2, Dh) for _ in range(6))
        for diag, causal in ((s, True), (0, True), (-s, False), (-s, True)):
            q_start, k_start = max(diag, 0), max(-diag, 0)
            st = ra.ring_attention_fold_plain(q, kb, vb, ra.fold_state(q),
                                              q_start, k_start, causal)
            st = ra.ring_attention_fold_plain(q, k2, v2, st, q_start,
                                              q_start, causal)
            o, lse = ra.fold_output(st, torch.float32), ra.fold_lse(st)
            want = ra.ring_attention_fold_backward_plain(
                q, kb, vb, o, lse, do, q_start, k_start, causal)
            for core, tiles in cores:
                case = (f"{core} K5b s={s} q_start - k_start={diag} "
                        f"causal={causal}")
                got = attention.attention_backward_tiles_plain(
                    q, kb, vb, o, lse, do, diag, causal, tiles)
                for name, g, w in zip("qkv", got, want):
                    np.testing.assert_allclose(g.numpy(), w.numpy(),
                                               rtol=1e-5, atol=1e-5,
                                               err_msg=f"{case} d{name}")
                plan = attention.backward_tile_plan(s, s, 2, 2, diag, causal,
                                                    tiles)
                if causal and diag < 0:
                    assert plan == {"kv": [], "q": []}, case
                    assert all(not g.any() for g in got), case
                _check_tile_plan(plan, s, s, 2, 2, diag, causal, case)


def test_rms_norm_backward_plain_matches_autograd():
    """K3b's arithmetic, alone and fused (with and without the stream's
    own gradient), against autograd of the plain forwards; the training
    forms' gradients equal it."""
    rng = np.random.default_rng(1)
    x, delta, dy, ds_out = (_t(rng, 3, 5, 64) for _ in range(4))
    g = 1.0 + 0.1 * _t(rng, 64)
    xa, ga = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    norm.rms_norm_plain(xa, ga, 1e-5).backward(dy)
    dx, dg = norm.rms_norm_backward_plain(x, g, dy, 1e-5)
    np.testing.assert_allclose(dx.numpy(), xa.grad.numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(dg.numpy(), ga.grad.numpy(), **PLAIN_TOL)
    xt, gt = x.clone().requires_grad_(True), g.clone().requires_grad_(True)
    norm.rms_norm_train(xt, gt, 1e-5).backward(dy)
    assert torch.equal(xt.grad, dx) and torch.equal(gt.grad, dg)
    for with_ds in (True, False):
        case = f"fused, ds_out {'given' if with_ds else 'None'}"
        leaves = [t.clone().requires_grad_(True) for t in (x, delta, g)]
        s, h = norm.add_rms_norm_plain(*leaves, 1e-5)
        (h * dy).sum().backward(retain_graph=True)
        if with_ds:
            (s * ds_out).sum().backward()
        got_ds, got_dg = norm.add_rms_norm_backward_plain(
            s.detach(), g, dy, ds_out if with_ds else None, 1e-5)
        for name, t in (("x", leaves[0]), ("delta", leaves[1])):
            np.testing.assert_allclose(got_ds.numpy(), t.grad.numpy(),
                                       **PLAIN_TOL, err_msg=f"{case} {name}")
        np.testing.assert_allclose(got_dg.numpy(), leaves[2].grad.numpy(),
                                   **PLAIN_TOL, err_msg=f"{case} gain")
        fn = [t.clone().requires_grad_(True) for t in (x, delta, g)]
        s2, h2 = norm.add_rms_norm_train(*fn, 1e-5)
        ((h2 * dy).sum() + ((s2 * ds_out).sum() if with_ds else 0)).backward()
        assert torch.equal(fn[0].grad, got_ds), case
        assert torch.equal(fn[1].grad, got_ds), case
        assert torch.equal(fn[2].grad, got_dg), case


def test_ring_fold_backward_plain_matches_autograd():
    """K5b's arithmetic, one block's share of the gradient from the ring's
    final LSE, against autograd of two plain folds (a rank's own diagonal
    block and one other), for the other block below, on and above the
    diagonal and without the mask; a row that saw no key (l = 0, LSE
    +inf) gets no gradient."""
    rng = np.random.default_rng(2)
    for q_start, k_start, causal in ((64, 0, True), (32, 32, True),
                                     (0, 32, True), (0, 32, False)):
        case = f"q_start {q_start} k_start {k_start} causal {causal}"
        q, kb, vb, k2, v2 = (_t(rng, 2, 32, 2, 8) for _ in range(5))
        leaves = [t.clone().requires_grad_(True) for t in (q, kb, vb)]
        st = ra.fold_state(q)
        st = ra.ring_attention_fold_plain(*leaves, st, q_start, k_start,
                                          causal)
        st = ra.ring_attention_fold_plain(leaves[0], k2, v2, st, q_start,
                                          q_start, causal)
        out = ra.fold_output(st, torch.float32)
        do = _t(rng, *out.shape)
        out.backward(do)
        lse = ra.fold_lse(st).detach()
        cq, ck, cv = ra.ring_attention_fold_backward_plain(
            q, kb, vb, out.detach(), lse, do, q_start, k_start, causal)
        cq2, _, _ = ra.ring_attention_fold_backward_plain(
            q, k2, v2, out.detach(), lse, do, q_start, q_start, causal)
        for name, g, t in (("q", cq + cq2, leaves[0]), ("k", ck, leaves[1]),
                           ("v", cv, leaves[2])):
            np.testing.assert_allclose(g.numpy(), t.grad.numpy(),
                                       **PLAIN_TOL,
                                       err_msg=f"{case} d/d{name}")
    q, kb, vb = (_t(rng, 1, 16, 1, 8) for _ in range(3))
    empty = ra.fold_state(q)
    lse = ra.fold_lse(empty)
    assert torch.isinf(lse).all() and (lse > 0).all()
    grads = ra.ring_attention_fold_backward_plain(
        q, kb, vb, ra.fold_output(empty, torch.float32), lse,
        torch.ones_like(q), 0, 16, True)
    assert all(not g.any() for g in grads), "a row with no key has a gradient"


RING_GRAD_CASES = [(3, 1, 32, 1, 8, False), (4, 1, 512, 2, 16, True)]


def test_ring_gradient_matches_jax_in_a_gloo_world():
    """The distributed ring's gradient (its backward pass round the ring
    over gloo) against jax.grad of the JAX ring on a 4-device mesh: the
    shapes of test_ring_grad_flows, and causal at S 512; the in-process
    ring's gradient against the distributed one's."""
    if len(jax.devices()) < N:
        pytest.skip(f"need {N} JAX devices")
    mesh = jpar.make_mesh((N,), ("x",))
    cases = []
    for seed, B, S, H, D, causal in RING_GRAD_CASES:
        rng = np.random.default_rng(seed)
        cases.append(tuple(rng.standard_normal((B, S, H, D)).astype(
            np.float32) for _ in range(3)) + (causal,))
    got = world.run(N, ranks.ring_grads, cases)
    for i, (q, k, v, causal) in enumerate(cases):
        case = f"case {RING_GRAD_CASES[i]}"

        def loss(q, k, v, causal=causal):
            return jnp.sum(j_ring_attention(mesh, "x", q, k, v,
                                            causal=causal) ** 2)

        want = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
            *map(jnp.asarray, (q, k, v)))
        s = q.shape[1] // N
        blocks = [[torch.from_numpy(a[:, r * s:(r + 1) * s].copy())
                   .requires_grad_(True) for r in range(N)]
                  for a in (q, k, v)]
        outs = ra.ring_attention_local(*blocks, causal)
        sum((o ** 2).sum() for o in outs).backward()
        for j, name in enumerate("qkv"):
            dist_grad = np.concatenate([got[r][i][j] for r in range(N)], 1)
            np.testing.assert_allclose(dist_grad, np.asarray(want[j]),
                                       **GRAD_TOL,
                                       err_msg=f"{case} d/d{name}")
            local = torch.cat([b.grad for b in blocks[j]], 1).numpy()
            np.testing.assert_allclose(local, dist_grad, **PLAIN_TOL,
                                       err_msg=f"{case} in-process d/d{name}")


def test_dryrun_twin_matches_jax_in_a_gloo_world():
    """The dry run's twin, dp 2 x tp 2 in one gloo world of 4 on the
    reference's f32 parameters: the step on the reference's zero tokens
    [4, 33] (then the sp, ep and pp legs, each held to its oracle inside
    the ranks) and on random tokens, against the JAX package's unsharded
    step on the same inputs: the loss, and every updated parameter after
    the tp shards are gathered, on both dp ranks."""
    jcfg, tcfg = _configs(4)
    jp = jt.init_params(jcfg, jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, jp)
    zeros = np.zeros((4, jcfg.max_seq // 4 + 1), np.int32)
    rand = np.random.default_rng(5).integers(0, jcfg.vocab, zeros.shape,
                                             dtype=np.int32)
    want = []
    step = jax.jit(jax.value_and_grad(jt.loss_fn), static_argnums=2)
    for toks in (zeros, rand):
        loss, grads = step(jp, jnp.asarray(toks), jcfg)
        want.append((float(loss), jax.tree.map(
            lambda p, g: np.asarray(p - 1e-3 * g), jp, grads)))
    got = world.run(N, ranks.dryrun_twin, tcfg, params, rand)
    assert [(r[0]["dp"], r[0]["tp"]) for r in got] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in range(N):
        for leg in ("sp", "ep", "pp"):
            assert got[r][0][leg]["max_abs_err"] >= 0.0, (r, leg)
    for step, (j_loss, j_params) in enumerate(want):
        tokens = ("zeros", "random")[step]
        for d in range(2):
            res = [got[d * 2 + j][step] for j in range(2)]
            for rr in res:
                np.testing.assert_allclose(rr["loss"], j_loss, **STEP_TOL,
                                           err_msg=f"{tokens} loss")
            full = dryrun.unshard([rr["params"] for rr in res])
            for (name, a), (_, b) in zip(_leaves(full), _leaves(j_params)):
                np.testing.assert_allclose(
                    a, b, **STEP_TOL,
                    err_msg=f"{tokens} tokens, dp rank {d}: {name}")
