"""Attention of the serving path: the K1 (paged decode) and K2 (prefill)
kernels' wrappers, each with its plain PyTorch version.

The plain versions repeat the reference's arithmetic
(brpc_tpu/models/transformer.py): logits in f32 from the model-dtype
operands times 1/sqrt(Dh), -1e30 on masked keys, f32 softmax, the
probabilities cast to the model dtype, and the product with V accumulated
in f32. A wrapper given CPU tensors runs its plain version; given CUDA
tensors it launches its kernel or raises.
"""

from __future__ import annotations

import numpy as np
import torch

from brpc_tpu_torch.ops import _build

_NEG = -1e30


def softmax_scale(d_head: int) -> float:
    """1/sqrt(Dh) rounded as the reference rounds it (f32 sqrt, f32
    division); exact as a Python float."""
    return float(np.float32(1.0) / np.sqrt(np.float32(d_head)))


def _dtype_code(t: torch.Tensor) -> int:
    if t.dtype == torch.float32:
        return _build.DTYPE_FLOAT32
    if t.dtype == torch.bfloat16:
        return _build.DTYPE_BFLOAT16
    raise TypeError(f"unsupported dtype {t.dtype}")


def _repeat_kv(x: torch.Tensor, rep: int, dim: int) -> torch.Tensor:
    return x.repeat_interleave(rep, dim=dim) if rep > 1 else x


# ---- K1: decode attention over the paged pool ------------------------------

def paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                 layer: int) -> torch.Tensor:
    """q: [S, H, Dh]; k_pool/v_pool: [NB, L, page, KV, Dh]; tables:
    [S, max_pages] int32; pos: [S] int32 -> o [S, H, Dh]. Gathers the
    pages up to the largest position and masks keys past each lane's pos
    (the reference's dense view, cut to the pages in play)."""
    S, H, Dh = q.shape
    page, KV = k_pool.shape[2], k_pool.shape[3]
    npages = int(pos.max()) // page + 1
    idx = tables[:, :npages].long()
    kg = k_pool[:, layer][idx].reshape(S, npages * page, KV, Dh)
    vg = v_pool[:, layer][idx].reshape(S, npages * page, KV, Dh)
    kr, vr = _repeat_kv(kg, H // KV, 2), _repeat_kv(vg, H // KV, 2)
    logits = torch.einsum("shd,sthd->sht", q.float(), kr.float()) \
        * softmax_scale(Dh)
    span = torch.arange(npages * page, device=q.device)
    mask = span[None, :] <= pos.long()[:, None]
    logits = torch.where(mask[:, None, :], logits,
                         torch.tensor(_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("sht,sthd->shd", probs.float(),
                        vr.float()).to(q.dtype)


def paged_decode_attention(q, k_pool, v_pool, tables, pos,
                           layer: int) -> torch.Tensor:
    """Decode attention of one token per lane at position ``pos[lane]``
    over layer ``layer`` of the paged pool, read through ``tables``. On a
    CUDA tensor launches csrc/paged_decode_attention.cu (K1)."""
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_pool, v_pool, tables, pos,
                                            layer)
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: unsupported device "
                         f"{q.device}")
    S, H, Dh = q.shape
    NB, L, page, KV, Dh2 = k_pool.shape
    if (Dh2 != Dh or v_pool.shape != k_pool.shape
            or k_pool.dtype != q.dtype or v_pool.dtype != q.dtype
            or not (k_pool.is_contiguous() and v_pool.is_contiguous())):
        raise ValueError("paged_decode_attention: pools must be contiguous "
                         "[NB, L, page, KV, Dh] in q's dtype")
    if (tables.dtype != torch.int32 or pos.dtype != torch.int32
            or tables.shape[0] != S or pos.shape != (S,)
            or tables.device != q.device or pos.device != q.device):
        raise ValueError("paged_decode_attention: tables [S, pages] and pos "
                         "[S] must be int32 on q's device")
    if not 0 <= layer < L or H % KV:
        raise ValueError("paged_decode_attention: bad layer or head counts")
    qc, tc, pc = q.contiguous(), tables.contiguous(), pos.contiguous()
    out = torch.empty_like(qc)
    k_l, v_l = k_pool[:, layer], v_pool[:, layer]
    rc = _build.lib().brpc_paged_decode_attention(
        _dtype_code(q), qc.data_ptr(), k_l.data_ptr(), v_l.data_ptr(),
        tc.data_ptr(), pc.data_ptr(), out.data_ptr(), S, H, KV, Dh, page,
        tc.shape[1], k_pool.stride(0), k_pool.stride(2), k_pool.stride(3),
        softmax_scale(Dh), torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "paged_decode_attention")
    paged_decode_attention.launches += 1
    return out


paged_decode_attention.launches = 0


# ---- K2: prefill attention, causal with a pad-key mask ---------------------

def prefill_attention_plain(q, k, v, length: int) -> torch.Tensor:
    """q: [P, H, Dh]; k, v: [P, KV, Dh]; key k visible to query q when
    k <= q and k < length -> o [P, H, Dh]."""
    P, H, Dh = q.shape
    KV = k.shape[1]
    kr, vr = _repeat_kv(k, H // KV, 1), _repeat_kv(v, H // KV, 1)
    logits = torch.einsum("qhd,khd->hqk", q.float(), kr.float()) \
        * softmax_scale(Dh)
    span = torch.arange(P, device=q.device)
    mask = (span[:, None] >= span[None, :]) & (span[None, :] < length)
    logits = torch.where(mask[None], logits,
                         torch.tensor(_NEG, device=q.device))
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs.float(),
                        vr.float()).to(q.dtype)


def prefill_attention(q, k, v, length: int) -> torch.Tensor:
    """Causal prefill attention of one sequence with keys at or past
    ``length`` masked. On a CUDA tensor launches
    csrc/prefill_attention.cu (K2)."""
    if q.device.type == "cpu":
        return prefill_attention_plain(q, k, v, length)
    if q.device.type != "cuda":
        raise ValueError(f"prefill_attention: unsupported device {q.device}")
    P, H, Dh = q.shape
    KV = k.shape[1]
    if (k.shape != (P, KV, Dh) or v.shape != k.shape
            or k.dtype != q.dtype or v.dtype != q.dtype or H % KV
            or not 1 <= length <= P):
        raise ValueError("prefill_attention: q [P, H, Dh], k/v [P, KV, Dh] "
                         "of one dtype, 1 <= length <= P")
    qc, kc, vc = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty_like(qc)
    rc = _build.lib().brpc_prefill_attention(
        _dtype_code(q), qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
        out.data_ptr(), P, int(length), H, KV, Dh, softmax_scale(Dh),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "prefill_attention")
    prefill_attention.launches += 1
    return out


prefill_attention.launches = 0
