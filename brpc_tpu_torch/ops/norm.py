"""RMSNorm: the K3 kernel's wrapper and its plain PyTorch version."""

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
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(rc, "rms_norm")
    rms_norm.launches += 1
    return out


rms_norm.launches = 0
