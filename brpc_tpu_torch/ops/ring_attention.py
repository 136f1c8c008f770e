"""Ring attention: exact attention over sequences sharded across ranks.

The port of ``brpc_tpu/ops/ring_attention.py``. Queries stay put; key/value
blocks travel the ring, and each step folds one block into the rows'
online softmax, so no rank holds the full [S, S] scores or the full K/V.
After n steps every query has attended to every key once.

- ``ring_attention_fold``: one step, the K5 kernel's wrapper
  (csrc/ring_attention.cu); ``ring_attention_fold_plain`` is the
  reference's ``step`` in PyTorch and runs for CPU tensors.
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
from brpc_tpu_torch.ops.attention import _dtype_code, softmax_scale
from brpc_tpu_torch.parallel import rank_and_size, ring_shift_start

__all__ = ["attention_reference", "fold_state", "fold_output",
           "ring_attention_fold",
           "ring_attention_fold_plain", "ring_attention",
           "ring_attention_local"]

_HEAD_DIMS = (32, 64, 128)


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


class _NoBackward(torch.autograd.Function):
    """Marks K5's output as computed from q, k and v; its backward raises
    (the fold has no backward kernel yet)."""

    @staticmethod
    def forward(ctx, out, q, k, v):
        return out.view_as(out)

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "ring_attention_fold (K5) has no backward fold yet; "
            "differentiate the plain version on the CPU")


def ring_attention_fold(q, k, v, state: tuple, q_start: int, k_start: int,
                        causal: bool, final: bool = False):
    """Fold the K/V block at global key positions k_start.. into the
    running state of q's rows (positions q_start..): -> the new state, or
    with ``final`` the rows' attention output [B, s, H, D] in q's dtype.

    On a CUDA tensor launches csrc/ring_attention.cu (K5), which updates
    the state in place and returns it (with ``final`` it writes the output
    and leaves the state as it was). A causal block wholly above the
    diagonal (k_start > q_start + s - 1) changes nothing and launches no
    kernel, except on the final step, which then launches with no keys
    to write the output. On a CPU tensor runs the plain version."""
    if q.device.type == "cpu":
        state = ring_attention_fold_plain(q, k, v, state, q_start, k_start,
                                          causal)
        return fold_output(state, q.dtype) if final else state
    if q.device.type != "cuda":
        raise ValueError(f"ring_attention_fold: unsupported device "
                         f"{q.device}")
    o, ml = state
    B, sq, H, D = q.shape
    sk = k.shape[1]
    if (k.shape != (B, sk, H, D) or v.shape != k.shape or k.dtype != q.dtype
            or v.dtype != q.dtype or D not in _HEAD_DIMS
            or k.device != q.device or v.device != q.device):
        raise ValueError("ring_attention_fold: q [B, s, H, D] and k, v "
                         "[B, s_k, H, D] of one dtype on one card, D in "
                         f"{_HEAD_DIMS}")
    if (o.shape != q.shape or ml.shape != q.shape[:-1] + (2,)
            or o.dtype != torch.float32 or ml.dtype != torch.float32
            or not (o.is_contiguous() and ml.is_contiguous())
            or o.device != q.device or ml.device != q.device):
        raise ValueError("ring_attention_fold: the state must be contiguous "
                         "f32 o [B, s, H, D] and ml [B, s, H, 2] on q's card")
    above = causal and k_start > q_start + sq - 1
    if above and not final:
        return state
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc) if final else None
    rc = _build.lib().brpc_ring_attention_fold(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        o.data_ptr(), ml.data_ptr(), None if out is None else out.data_ptr(),
        B, sq, sk, 0 if above else sk, H, D, int(q_start - k_start),
        int(causal), softmax_scale(D), _build.stream(q))
    _build.check(rc, "ring_attention_fold")
    _build.count_launch(ring_attention_fold)
    if out is None:
        return state
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = _NoBackward.apply(out, q, k, v)
    return out


ring_attention_fold.launches = 0


def _ring(q, blocks, my: int, n: int, causal: bool) -> torch.Tensor:
    """Rank ``my``'s n folds: ``blocks`` yields the K/V block resident at
    each step t, the one rank (my - t) mod n started with."""
    s = q.shape[1]
    state = fold_state(q)
    for t, (kb, vb) in enumerate(blocks):
        src = (my - t) % n
        if t == n - 1:
            return ring_attention_fold(q, kb, vb, state, my * s, src * s,
                                       causal, final=True)
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


def ring_attention(q, k, v, causal: bool = False, group=None) -> torch.Tensor:
    """Exact attention with the sequence sharded over ``group``: q, k, v
    are this rank's blocks [B, s, H, D] (rank r holds positions
    [r s, (r + 1) s)); returns this rank's output block, in q's dtype."""
    my, n = rank_and_size(group)
    return _ring(q, _shifted_blocks(k, v, n, group), my, n, causal)


def ring_attention_local(qs, ks, vs, causal: bool = False) -> list:
    """``ring_attention`` for n ranks in one process: ``qs``, ``ks``, ``vs``
    are the ranks' blocks in rank order; each rank runs the same fold
    sequence over the blocks in the order the ring brings them. Returns
    the ranks' output blocks."""
    n = len(qs)
    return [_ring(q, ((ks[(my - t) % n], vs[(my - t) % n])
                      for t in range(n)), my, n, causal)
            for my, q in enumerate(qs)]
