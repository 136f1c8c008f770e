"""Ring attention: exact attention over sequences sharded across ranks.

The port of ``brpc_tpu/ops/ring_attention.py``. Queries stay put; key/value
blocks travel the ring, and each step folds one block into the rows'
online softmax, so no rank holds the full [S, S] scores or the full K/V.
After n steps every query has attended to every key once.

- ``ring_attention_fold``: one step, the K5 kernel's wrapper
  (csrc/ring_attention.cu); ``ring_attention_fold_plain`` is the
  reference's ``step`` in PyTorch and runs for CPU tensors;
  ``ring_fold_tiles_plain`` computes the same step tile by tile along
  ``ring_fold_tile_plan``, as one of the kernel's cores walks it (for the
  tests).
- ``ring_attention_fold_backward``: one block's share of the gradient, the
  K5b kernel's wrapper (csrc/ring_attention_backward.cu);
  ``ring_attention_fold_backward_plain`` runs for CPU tensors.
- ``ring_attention``: the distributed form, one rank per process, the
  blocks shifted over ``torch.distributed`` while the fold runs.
- ``ring_attention_local``: the same per-rank fold sequence for n ranks in
  one process (the reference's ring on a one-process mesh; one card cannot
  hold two NCCL ranks).

The running state of a rank's rows is ``(o, ml)``: o [B, s, H, D] and
ml [B, s, H, 2] (the row max m, then the sum l), f32, laid out as q.
"""

from __future__ import annotations

import torch

from brpc_tpu_torch.ops import _build
from brpc_tpu_torch.ops.attention import HEAD_DIMS, _dtype_code, softmax_scale
from brpc_tpu_torch.parallel import rank_and_size, ring_shift_start

__all__ = ["attention_reference", "fold_state", "fold_output", "fold_lse",
           "ring_attention_fold", "ring_attention_fold_plain",
           "ring_fold_tile_plan", "ring_fold_tiles_plain",
           "ring_attention_fold_backward",
           "ring_attention_fold_backward_plain", "grad_buffers",
           "ring_attention", "ring_attention_local"]

def attention_reference(q, k, v, causal: bool = False) -> torch.Tensor:
    """Dense single-device attention (the correctness oracle). q/k/v:
    [B, S, H, D] -> [B, S, H, D] in q's dtype, f32 accumulation."""
    scale = softmax_scale(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if causal:
        S = q.shape[1]
        mask = torch.ones((S, S), dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -float("inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def fold_state(q: torch.Tensor) -> tuple:
    """The state before the first fold: o = 0, m = -inf, l = 0."""
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    ml = torch.zeros(q.shape[:-1] + (2,), dtype=torch.float32,
                     device=q.device)
    ml[..., 0] = -float("inf")
    return o, ml


def fold_output(state: tuple, dtype) -> torch.Tensor:
    """A state's rows o / l in ``dtype``, l = 0 read as 1 (a row that saw
    no key gives 0): the ring's output once every block is folded."""
    o, ml = state
    l = ml[..., 1:]
    return (o / torch.where(l == 0.0, 1.0, l)).to(dtype)


def ring_attention_fold_plain(q, k, v, state: tuple, q_start: int,
                              k_start: int, causal: bool) -> tuple:
    """The reference's ``step`` (brpc_tpu/ops/ring_attention.py:65) in
    PyTorch: fold the block (k, v) at global key positions k_start.. into
    the state of q's rows at positions q_start.. -> the new state (new
    tensors: the plain version is differentiable)."""
    o, ml = state
    sq, sk = q.shape[1], k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bqhk", q.float(), k.float()) \
        * softmax_scale(q.shape[-1])
    if causal:
        k_pos = k_start + torch.arange(sk, device=q.device)
        q_pos = q_start + torch.arange(sq, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]                # [sq, sk]
        scores = scores.masked_fill(~mask[None, :, None, :], -float("inf"))
    m, l = ml[..., 0], ml[..., 1]
    m_new = torch.maximum(m, scores.amax(dim=-1))
    # exp(-inf - -inf) guard: rows with no valid key yet keep m = -inf
    safe_m = torch.where(torch.isneginf(m_new), 0.0, m_new)
    p = torch.exp(scores - safe_m[..., None])
    p = torch.where(torch.isneginf(scores), 0.0, p)
    alpha = torch.where(torch.isneginf(m), 0.0, torch.exp(m - safe_m))
    l_new = l * alpha + p.sum(dim=-1)
    o_new = o * alpha[..., None] + torch.einsum("bqhk,bkhd->bqhd", p,
                                                v.float())
    return o_new, torch.stack([m_new, l_new], dim=-1)


# From csrc/attention_forward.cuh, K5's bf16 core: a block owns FWD_ROWS
# query rows of one (batch, head), each consumer warpgroup FWD_WG_ROWS of
# them, and K/V tiles of FWD_KEYS keys stream past them.
_FWD = _build.header_constants("attention_forward.cuh")
FWD_ROWS = _FWD["kFwdRows"]
FWD_WG_ROWS = _FWD["kFwdWgRows"]
FWD_KEYS = _FWD["kFwdKeys"]
# From csrc/attention_f32.cuh, K5's f32 core: a block of F32_FWD_ROWS rows
# walks its key tiles of F32_FWD_KEYS as one (it skips no tile per warp).
_F32 = _build.header_constants("attention_f32.cuh")
F32_FWD_ROWS = _F32["kF32FwdRows"]
F32_FWD_KEYS = _F32["kF32FwdKeys"]
# (rows of a block, rows that skip a tile together, keys of a tile).
FWD_TILES = (FWD_ROWS, FWD_WG_ROWS, FWD_KEYS)
F32_FWD_TILES = (F32_FWD_ROWS, F32_FWD_ROWS, F32_FWD_KEYS)


def ring_fold_tile_plan(sq: int, n_keys: int, diag: int, causal: bool,
                        tiles: tuple = FWD_TILES) -> list:
    """The (rows, key tile) pairs that K5's core computes for one (batch,
    head), in the order each group of rows meets them: [(lo, hi, c0, c1,
    masked), ...] for query rows [lo, hi) and keys [c0, c1). Key j is
    visible to row i when j < n_keys and, ``causal``, j <= diag + i.
    ``tiles`` = (rows, group, keys): a block of ``rows`` rows reads key
    tiles of ``keys`` from 0 up to its last valid row's causal edge; each
    group of ``group`` rows (a warpgroup of the bf16 core, the whole block
    of the f32 core) skips the tiles in which its rows see no key, and
    applies the mask only where ``masked``: the tile crosses the diagonal
    or the keys' end. Keys past n_keys arrive as zeros and are left out of
    [c0, c1)."""
    rows, group, keys = tiles
    plan = []
    for q0 in range(0, sq, rows):
        end = (max(0, min(n_keys, diag + min(q0 + rows, sq)))
               if causal else n_keys)
        for c0 in range(0, end, keys):
            for lo in range(q0, min(q0 + rows, sq), group):
                hi = min(lo + group, sq)
                if causal and c0 > diag + hi - 1:
                    continue
                masked = (c0 + keys > n_keys
                          or (causal and c0 + keys - 1 > diag + lo))
                plan.append((lo, hi, c0, min(c0 + keys, n_keys), masked))
    return plan


def ring_fold_tiles_plain(q, k, v, state: tuple, q_start: int, k_start: int,
                          causal: bool, n_keys: int = None,
                          tiles: tuple = FWD_TILES) -> tuple:
    """One fold computed tile by tile along ``ring_fold_tile_plan`` with
    ``tiles`` (FWD_TILES, the bf16 core's, or F32_FWD_TILES), as that core
    computes it: each group's rows start from the state (o, m, l) and fold
    its tiles in order, the causal test only on tiles marked ``masked``, p
    = exp(logit - m_new) summed into l unrounded and rounded to q's dtype
    for P.V (the bf16 tensor cores' operand; the f32 core keeps it).
    ``n_keys``: the block's keys the fold reads (k's length, or 0 as the
    wrapper launches a block above the diagonal on the last step). -> the
    new state, in f32. For the tests: the main path never calls it."""
    o, ml = state
    sq, sk = q.shape[1], k.shape[1]
    n_keys = sk if n_keys is None else n_keys
    diag = q_start - k_start
    scale = softmax_scale(q.shape[-1])
    qf, kf, vf = q.float(), k.float(), v.float()
    o, m, l = o.clone(), ml[..., 0].clone(), ml[..., 1].clone()
    rows = torch.arange(sq, device=q.device)
    keys = torch.arange(sk, device=q.device)
    for lo, hi, c0, c1, masked in ring_fold_tile_plan(sq, n_keys, diag,
                                                      causal, tiles):
        s = torch.einsum("bqhd,bkhd->bqhk", qf[:, lo:hi], kf[:, c0:c1]) \
            * scale
        if masked and causal:
            vis = keys[None, c0:c1] <= diag + rows[lo:hi, None]
            s = s.masked_fill(~vis[None, :, None, :], -float("inf"))
        m_old = m[:, lo:hi]
        m_new = torch.maximum(m_old, s.amax(dim=-1))
        mu = torch.where(torch.isneginf(m_new), 0.0, m_new)
        alpha = torch.exp(m_old - mu)
        p = torch.exp(s - mu[..., None])
        l[:, lo:hi] = l[:, lo:hi] * alpha + p.sum(dim=-1)
        o[:, lo:hi] = o[:, lo:hi] * alpha[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(q.dtype).float(), vf[:, c0:c1])
        m[:, lo:hi] = m_new
    return o, torch.stack([m, l], dim=-1)


def fold_lse(state: tuple) -> torch.Tensor:
    """A state's rows' log-sum-exp m + log(l) [B, s, H] f32, +inf for a row
    that saw no key (its probabilities, and gradients, are then 0)."""
    m, l = state[1][..., 0], state[1][..., 1]
    return torch.where(l == 0.0, float("inf"), m + torch.log(l))


def ring_attention_fold(q, k, v, state: tuple, q_start: int, k_start: int,
                        causal: bool, final: bool = False, lse=None):
    """Fold the K/V block at global key positions k_start.. into the
    running state of q's rows (positions q_start..): -> the new state, or
    with ``final`` the rows' attention output [B, s, H, D] in q's dtype
    (and, given ``lse``, a [B, s, H] f32 tensor, the rows' log-sum-exp
    over every block written into it).

    On a CUDA tensor launches csrc/ring_attention.cu (K5), which updates
    the state in place and returns it (with ``final`` it writes the output
    and leaves the state as it was). A causal block wholly above the
    diagonal (k_start > q_start + s - 1) changes nothing and launches no
    kernel, except on the final step, which then launches with no keys
    to write the output. On a CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        state = ring_attention_fold_plain(q, k, v, state, q_start, k_start,
                                          causal)
        if not final:
            return state
        if lse is not None:
            lse.copy_(fold_lse(state))
        return fold_output(state, q.dtype)
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention_fold: unsupported device "
                         f"{q.device}")
    o, ml = state
    B, sq, H, D = q.shape
    sk = k.shape[1]
    if (k.shape != (B, sk, H, D) or v.shape != k.shape or k.dtype != q.dtype
            or v.dtype != q.dtype or D not in HEAD_DIMS
            or k.device != q.device or v.device != q.device):
        raise ValueError("ring_attention_fold: q [B, s, H, D] and k, v "
                         "[B, s_k, H, D] of one dtype on one card, D in "
                         f"{HEAD_DIMS}")
    if (o.shape != q.shape or ml.shape != q.shape[:-1] + (2,)
            or o.dtype != torch.float32 or ml.dtype != torch.float32
            or not (o.is_contiguous() and ml.is_contiguous())
            or o.device != q.device or ml.device != q.device):
        raise ValueError("ring_attention_fold: the state must be contiguous "
                         "f32 o [B, s, H, D] and ml [B, s, H, 2] on q's card")
    if lse is not None and (not final or lse.shape != q.shape[:-1]
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError("ring_attention_fold: lse is the final step's "
                         "contiguous f32 [B, s, H] on q's card")
    above = causal and k_start > q_start + sq - 1
    if above and not final:
        return state
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc) if final else None
    rc = _build.lib().brpc_ring_attention_fold(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        o.data_ptr(), ml.data_ptr(), None if out is None else out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, sq, sk,
        0 if above else sk, H, D, int(q_start - k_start), int(causal),
        softmax_scale(D), _build.stream(q))
    _build.check(rc, "ring_attention_fold")
    _build.count_launch(ring_attention_fold)
    return state if out is None else out


ring_attention_fold.launches = 0


def ring_attention_fold_backward_plain(q, kb, vb, o, lse, do, q_start: int,
                                       k_start: int, causal: bool) -> tuple:
    """One block's share of the ring's gradient, the reference's autodiff
    of ``step`` (brpc_tpu/ops/ring_attention.py:65) in PyTorch: with the
    probabilities P = exp(logit - lse) recomputed from the ring's final
    log-sum-exp under the global causal test k_start + j <= q_start + i,
    delta = rowsum(dO o) and dS = P (dO.V - delta), -> the block's (dq,
    dk, dv) contributions in f32: scale dS.K, scale dS^T.Q, P^T.dO."""
    scale = softmax_scale(q.shape[-1])
    qf, kf, vf, dof = q.float(), kb.float(), vb.float(), do.float()
    logits = torch.einsum("bqhd,bkhd->bqhk", qf, kf) * scale
    p = torch.exp(logits - lse[..., None])
    if causal:
        k_pos = k_start + torch.arange(kb.shape[1], device=q.device)
        q_pos = q_start + torch.arange(q.shape[1], device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]                # [sq, sk]
        p = torch.where(mask[None, :, None, :], p, 0.0)
    delta = (dof * o.float()).sum(-1)
    ds = p * (torch.einsum("bqhd,bkhd->bqhk", dof, vf) - delta[..., None])
    return (torch.einsum("bqhk,bkhd->bqhd", ds, kf) * scale,
            torch.einsum("bqhk,bqhd->bkhd", ds, qf) * scale,
            torch.einsum("bqhk,bqhd->bkhd", p, dof))


def ring_attention_fold_backward(q, kb, vb, o, lse, do, grads: tuple,
                                 q_start: int, k_start: int, causal: bool,
                                 fill_delta: bool) -> None:
    """Add one block's share of the ring's gradient to ``grads`` = (dq,
    dk, dv, delta): f32 accumulators of q's rows [B, s, H, D] and of the
    block's keys [B, s_k, H, D], and delta = rowsum(dO o) [B, s, H] f32,
    which a rank's first block computes (``fill_delta``) and its later
    blocks reuse. o, lse: the ring's output and log-sum-exp on q's rows;
    do: the output's gradient. On a CUDA tensor launches
    csrc/ring_attention_backward.cu (K5b); a causal block wholly above the
    diagonal contributes nothing and launches nothing. On a CPU tensor
    adds the plain version's contributions."""
    dq, dk, dv, delta = grads
    B, sq, H, D = q.shape
    sk = kb.shape[1]
    if causal and k_start > q_start + sq - 1:
        return
    if q.device.type == "cpu":
        cq, ck, cv = ring_attention_fold_backward_plain(
            q, kb, vb, o, lse, do, q_start, k_start, causal)
        dq += cq
        dk += ck
        dv += cv
        return
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention_fold_backward: unsupported device "
                         f"{q.device}")
    if (kb.shape != (B, sk, H, D) or vb.shape != kb.shape
            or o.shape != q.shape or do.shape != q.shape
            or any(t.dtype != q.dtype for t in (kb, vb, o, do))
            or D not in HEAD_DIMS):
        raise ValueError("ring_attention_fold_backward: q, o, do [B, s, H, "
                         "D] and kb, vb [B, s_k, H, D] of one dtype, D in "
                         f"{HEAD_DIMS}")
    for t, shape in ((dq, q.shape), (dk, kb.shape), (dv, kb.shape),
                     (lse, q.shape[:-1]), (delta, q.shape[:-1])):
        if (t.shape != shape or t.dtype != torch.float32
                or not t.is_contiguous() or t.device != q.device):
            raise ValueError("ring_attention_fold_backward: dq, dk, dv, lse "
                             "and delta must be contiguous f32 on q's card")
    qc, kc, vc, oc, doc = (t.contiguous() for t in (q, kb, vb, o, do))
    rc = _build.lib().brpc_ring_attention_fold_backward(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        oc.data_ptr(), doc.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        int(fill_delta), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), B, sq,
        sk, H, D, int(q_start - k_start), int(causal), softmax_scale(D),
        _build.stream(q))
    _build.check(rc, "ring_attention_fold_backward")
    _build.count_launch(ring_attention_fold_backward)


ring_attention_fold_backward.launches = 0


def _ring(q, blocks, my: int, n: int, causal: bool) -> tuple:
    """Rank ``my``'s n folds: ``blocks`` yields the K/V block resident at
    each step t, the one rank (my - t) mod n started with. -> (output,
    lse [B, s, H] f32)."""
    s = q.shape[1]
    state = fold_state(q)
    lse = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    for t, (kb, vb) in enumerate(blocks):
        src = (my - t) % n
        if t == n - 1:
            return ring_attention_fold(q, kb, vb, state, my * s, src * s,
                                       causal, final=True, lse=lse), lse
        state = ring_attention_fold(q, kb, vb, state, my * s, src * s,
                                    causal)
    raise ValueError("the ring has no blocks")


def _shifted_blocks(k, v, n: int, group):
    """The blocks of a rank's ring: its own first, then each one the
    previous rank held a step before. The next shift is in flight while
    the caller folds the current block (the reference's ppermute after
    every step; none after the last)."""
    kb, vb = k, v
    for t in range(n):
        if t + 1 < n:
            (k_next, v_next), wait = ring_shift_start([kb, vb], 1, group)
        yield kb, vb
        if t + 1 < n:
            wait()
            kb, vb = k_next, v_next


def grad_buffers(q, k) -> tuple:
    """Zeroed f32 (dq, dk, dv) accumulators and the delta buffer."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    delta = torch.empty(q.shape[:-1], dtype=torch.float32, device=q.device)
    return dq, dk, torch.zeros_like(dk), delta


class _Ring(torch.autograd.Function):
    """The distributed ring with its backward: a second pass round the
    ring in which dq accumulates on its own rank while each block's dk and
    dv accumulate on the ranks it visits and travel with it."""

    @staticmethod
    def forward(ctx, q, k, v, causal, group):
        my, n = rank_and_size(group)
        out, lse = _ring(q, _shifted_blocks(k, v, n, group), my, n, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.group = causal, group
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        group = ctx.group
        my, n = rank_and_size(group)
        s = q.shape[1]
        dq, dk, dv, delta = grad_buffers(q, k)
        do = do.contiguous()
        kb, vb = k, v
        for t in range(n):
            src = (my - t) % n
            # The block's K/V go on while this rank computes; its dk and
            # dv follow once this rank's share is in. The last step's
            # shift brings every block's dk and dv home.
            if t + 1 < n:
                (k_next, v_next), wait_kv = ring_shift_start([kb, vb], 1,
                                                             group)
            ring_attention_fold_backward(q, kb, vb, out, lse, do,
                                         (dq, dk, dv, delta), my * s,
                                         src * s, ctx.causal, t == 0)
            (dk, dv), wait_grads = ring_shift_start([dk, dv], 1, group)
            wait_grads()
            if t + 1 < n:
                wait_kv()
                kb, vb = k_next, v_next
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None)


class _RingLocal(torch.autograd.Function):
    """The in-process ring with its backward: the distributed backward's
    steps for every rank, each block's dk and dv summed in the order its
    travel round the ring would sum them."""

    @staticmethod
    def forward(ctx, causal, *blocks):
        n = len(blocks) // 3
        qs, ks, vs = blocks[:n], blocks[n:2 * n], blocks[2 * n:]
        outs, lses = zip(*(_ring(q, ((ks[(my - t) % n], vs[(my - t) % n])
                                     for t in range(n)), my, n, causal)
                           for my, q in enumerate(qs)))
        ctx.save_for_backward(*qs, *ks, *vs, *outs, *lses)
        ctx.causal, ctx.n = causal, n
        return outs

    @staticmethod
    def backward(ctx, *dos):
        n = ctx.n
        saved = ctx.saved_tensors
        qs, ks, vs, outs, lses = (saved[i * n:(i + 1) * n] for i in range(5))
        s = qs[0].shape[1]
        dos = [torch.zeros_like(o) if d is None else d.contiguous()
               for o, d in zip(outs, dos)]
        bufs = [grad_buffers(q, k) for q, k in zip(qs, ks)]
        for t in range(n):
            for my in range(n):
                src = (my - t) % n
                ring_attention_fold_backward(
                    qs[my], ks[src], vs[src], outs[my], lses[my], dos[my],
                    (bufs[my][0], bufs[src][1], bufs[src][2], bufs[my][3]),
                    my * s, src * s, ctx.causal, t == 0)
        return (None, *(b[0].to(q.dtype) for b, q in zip(bufs, qs)),
                *(b[1].to(k.dtype) for b, k in zip(bufs, ks)),
                *(b[2].to(v.dtype) for b, v in zip(bufs, vs)))


def ring_attention(q, k, v, causal: bool = False, group=None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``group``: q, k, v
    are this rank's blocks [B, s, H, D] (rank r holds positions
    [r s, (r + 1) s)); returns this rank's output block, in q's dtype.
    Differentiable: the backward runs a second pass round the ring (K5b on
    a card)."""
    return _Ring.apply(q, k, v, causal, group)


def ring_attention_local(qs, ks, vs, causal: bool = False) -> list:
    """``ring_attention`` for n ranks in one process: ``qs``, ``ks``, ``vs``
    are the ranks' blocks in rank order; each rank runs the same fold
    sequence over the blocks in the order the ring brings them. Returns
    the ranks' output blocks; differentiable like ``ring_attention``."""
    return list(_RingLocal.apply(causal, *qs, *ks, *vs))
