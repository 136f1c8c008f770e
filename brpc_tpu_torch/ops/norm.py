"""RMSNorm: the K3 kernel's wrappers (the norm alone, and fused with the
residual add before it) and their plain PyTorch versions."""

from __future__ import annotations

import torch

from brpc_tpu_torch.ops import _build


def rms_norm_plain(x: torch.Tensor, gain: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """brpc_tpu/models/transformer.py:102 ``_rms_norm`` in plain torch:
    f32 math, cast back to x's dtype."""
    x32 = x.float()
    scale = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * scale * gain.float()).to(x.dtype)


def rms_norm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    """RMSNorm over the last axis. x: [..., D] in float32 or bfloat16;
    gain: [D] float32. A CPU tensor takes the plain version; a CUDA tensor
    launches csrc/rms_norm.cu (K3)."""
    if x.device.type == "cpu":
        return rms_norm_plain(x, gain, eps)
    if x.device.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if gain.shape != (d,) or gain.dtype != torch.float32 \
            or gain.device != x.device:
        raise ValueError("rms_norm: gain must be float32 [D] on x's device")
    xc = x.contiguous()
    g = gain.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // d
    rc = _build.lib().brpc_rms_norm(
        _build.DTYPE_FLOAT32 if x.dtype == torch.float32
        else _build.DTYPE_BFLOAT16, xc.data_ptr(), g.data_ptr(),
        out.data_ptr(), rows, d, float(eps),
        _build.stream(x))
    _build.check(rc, "rms_norm")
    _build.count_launch(rms_norm)
    return out


rms_norm.launches = 0


def add_rms_norm_plain(x: torch.Tensor, delta: torch.Tensor,
                       gain: torch.Tensor, eps: float) -> tuple:
    """The residual add then the norm: s = x + delta (rounded to x's dtype),
    h = rms_norm_plain(s) -> (s, h)."""
    s = x + delta
    return s, rms_norm_plain(s, gain, eps)


def add_rms_norm(x: torch.Tensor, delta: torch.Tensor, gain: torch.Tensor,
                 eps: float) -> tuple:
    """The residual add and the RMSNorm after it -> (s, h): s = x + delta
    in x's dtype (the new residual stream), h = RMSNorm(s). x, delta:
    [..., D] of one dtype (float32 or bfloat16); gain: [D] float32. A CPU
    tensor takes the plain version; a CUDA tensor launches
    csrc/rms_norm.cu's fused entry (K3), one pass for both."""
    if x.device.type == "cpu":
        return add_rms_norm_plain(x, delta, gain, eps)
    if x.device.type != "cuda":
        raise ValueError(f"add_rms_norm: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"add_rms_norm: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    if (delta.shape != x.shape or delta.dtype != x.dtype
            or delta.device != x.device):
        raise ValueError("add_rms_norm: delta must match x")
    if gain.shape != (d,) or gain.dtype != torch.float32 \
            or gain.device != x.device:
        raise ValueError("add_rms_norm: gain must be float32 [D] on x's "
                         "device")
    xc, dc, g = x.contiguous(), delta.contiguous(), gain.contiguous()
    s = torch.empty_like(xc)
    h = torch.empty_like(xc)
    rc = _build.lib().brpc_add_rms_norm(
        _build.DTYPE_FLOAT32 if x.dtype == torch.float32
        else _build.DTYPE_BFLOAT16, xc.data_ptr(), dc.data_ptr(),
        g.data_ptr(), s.data_ptr(), h.data_ptr(), xc.numel() // d, d,
        float(eps), _build.stream(x))
    _build.check(rc, "add_rms_norm")
    _build.count_launch(add_rms_norm)
    return s, h


add_rms_norm.launches = 0
