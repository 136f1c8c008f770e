"""RMSNorm: the K3 kernel's wrappers (the norm alone, and fused with the
residual add before it), the K3b kernel's (their backward), their plain
PyTorch versions, and the training path's differentiable forms
(``rms_norm_train``, ``add_rms_norm_train``: K3 forward, K3b backward)."""

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
    dev = x.device
    if dev.type == "cpu":
        return rms_norm_plain(x, gain, eps)
    if dev.type != "cuda":
        raise ValueError(f"rms_norm: unsupported device {dev}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"rms_norm: unsupported dtype {dtype}")
    d = x.shape[-1]
    if gain.shape != (d,) or gain.dtype != torch.float32 \
            or gain.device != dev:
        raise ValueError("rms_norm: gain must be float32 [D] on x's device")
    xc = x.contiguous()
    g = gain.contiguous()
    out = torch.empty_like(xc)
    rows = xc.numel() // d
    rc = _build.lib().brpc_rms_norm(
        _build.DTYPE_FLOAT32 if dtype == torch.float32
        else _build.DTYPE_BFLOAT16, xc.data_ptr(), g.data_ptr(),
        out.data_ptr(), rows, d, float(eps), _build.stream(x))
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
    dev = x.device
    if dev.type == "cpu":
        return add_rms_norm_plain(x, delta, gain, eps)
    if dev.type != "cuda":
        raise ValueError(f"add_rms_norm: unsupported device {dev}")
    dtype = x.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"add_rms_norm: unsupported dtype {dtype}")
    d = x.shape[-1]
    if (delta.shape != x.shape or delta.dtype != dtype
            or delta.device != dev):
        raise ValueError("add_rms_norm: delta must match x")
    if gain.shape != (d,) or gain.dtype != torch.float32 \
            or gain.device != dev:
        raise ValueError("add_rms_norm: gain must be float32 [D] on x's "
                         "device")
    xc, dc, g = x.contiguous(), delta.contiguous(), gain.contiguous()
    s = torch.empty_like(xc)
    h = torch.empty_like(xc)
    rows = xc.numel() // d
    rc = _build.lib().brpc_add_rms_norm(
        _build.DTYPE_FLOAT32 if dtype == torch.float32
        else _build.DTYPE_BFLOAT16, xc.data_ptr(), dc.data_ptr(),
        g.data_ptr(), s.data_ptr(), h.data_ptr(), rows, d, float(eps),
        _build.stream(x))
    _build.check(rc, "add_rms_norm")
    _build.count_launch(add_rms_norm)
    return s, h


add_rms_norm.launches = 0


# ---- K3b: the backward, and the training path's autograd forms ---------------

def rms_norm_backward_plain(x: torch.Tensor, gain: torch.Tensor,
                            dy: torch.Tensor, eps: float) -> tuple:
    """The gradient of ``rms_norm_plain`` -> (dx in x's dtype, dgain f32
    [D]): with r = rsqrt(mean(x32^2) + eps) and xhat = x32 r, dx = r (g dy
    - xhat mean(g dy xhat)) and dgain = sum over rows of dy xhat."""
    d = x.shape[-1]
    x32, dy32 = x.float(), dy.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    gdy = dy32 * gain.float()
    dx = r * (gdy - xhat * torch.mean(gdy * xhat, dim=-1, keepdim=True))
    dgain = (dy32 * xhat).reshape(-1, d).sum(dim=0)
    return dx.to(x.dtype), dgain


def add_rms_norm_backward_plain(s: torch.Tensor, gain: torch.Tensor,
                                dh: torch.Tensor, ds_out, eps: float
                                ) -> tuple:
    """The gradient of ``add_rms_norm_plain`` at its sum s -> (ds, dgain):
    ds = ds_out + dx, in s's dtype (ds_out, the stream's own gradient, may
    be None for 0), is the gradient of both of the add's operands."""
    dx, dgain = rms_norm_backward_plain(s, gain, dh, eps)
    return (dx if ds_out is None else ds_out + dx), dgain


# Blocks of K3b's row pass: the rows are cut into runs of ceil(rows / this)
# consecutive rows, one run a block, each writing one row of partial sums.
_NORM_BACKWARD_BLOCKS = 256


def _norm_backward(name: str, fn, x, gain, dy, ds_out, eps: float) -> tuple:
    """Launches csrc/rms_norm_backward.cu (K3b) -> (dx or ds, dgain)."""
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{name}: unsupported dtype {x.dtype}")
    d = x.shape[-1]
    for t in (dy,) + (() if ds_out is None else (ds_out,)):
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError(f"{name}: gradients must match x")
    if gain.shape != (d,) or gain.dtype != torch.float32 \
            or gain.device != x.device:
        raise ValueError(f"{name}: gain must be float32 [D] on x's device")
    xc, g, dyc = x.contiguous(), gain.contiguous(), dy.contiguous()
    dsc = None if ds_out is None else ds_out.contiguous()
    rows = xc.numel() // d
    per = max(1, -(-rows // _NORM_BACKWARD_BLOCKS))
    n_part = -(-rows // per)
    dx = torch.empty_like(xc)
    scratch = torch.empty((n_part + 1) * d, dtype=torch.float32,
                          device=x.device)
    partial, dgain = scratch[:n_part * d], scratch[n_part * d:]
    rc = _build.lib().brpc_rms_norm_backward(
        _build.DTYPE_FLOAT32 if x.dtype == torch.float32
        else _build.DTYPE_BFLOAT16, xc.data_ptr(), g.data_ptr(),
        dyc.data_ptr(), None if dsc is None else dsc.data_ptr(),
        dx.data_ptr(), partial.data_ptr(), dgain.data_ptr(), rows, d, per,
        float(eps), _build.stream(x))
    _build.check(rc, name)
    _build.count_launch(fn)
    return dx, dgain


def rms_norm_backward(x: torch.Tensor, gain: torch.Tensor, dy: torch.Tensor,
                      eps: float) -> tuple:
    """The gradient of ``rms_norm`` -> (dx, dgain f32 [D]). A CPU tensor
    takes the plain version; a CUDA tensor launches csrc/rms_norm_backward.cu
    (K3b: the row pass, then the pass that sums the partials)."""
    if x.device.type == "cpu":
        return rms_norm_backward_plain(x, gain, dy, eps)
    return _norm_backward("rms_norm_backward", rms_norm_backward, x, gain,
                          dy, None, eps)


rms_norm_backward.launches = 0


def add_rms_norm_backward(s: torch.Tensor, gain: torch.Tensor,
                          dh: torch.Tensor, ds_out, eps: float) -> tuple:
    """The gradient of ``add_rms_norm`` at its sum s -> (ds, dgain): the
    norm's gradient plus the stream's own ``ds_out`` (None for 0), which is
    the gradient of both x and delta. A CPU tensor takes the plain version;
    a CUDA tensor launches K3b's fused form (the add folded into the row
    pass)."""
    if s.device.type == "cpu":
        return add_rms_norm_backward_plain(s, gain, dh, ds_out, eps)
    return _norm_backward("add_rms_norm_backward", add_rms_norm_backward, s,
                          gain, dh, ds_out, eps)


add_rms_norm_backward.launches = 0


class _RmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gain, eps):
        ctx.save_for_backward(x, gain)
        ctx.eps = eps
        return rms_norm(x, gain, eps)

    @staticmethod
    def backward(ctx, dy):
        x, gain = ctx.saved_tensors
        dx, dgain = rms_norm_backward(x, gain, dy, ctx.eps)
        return dx, dgain, None


class _AddRmsNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, delta, gain, eps):
        ctx.set_materialize_grads(False)
        s, h = add_rms_norm(x, delta, gain, eps)
        ctx.save_for_backward(s, gain)
        ctx.eps = eps
        return s, h

    @staticmethod
    def backward(ctx, ds_out, dh):
        s, gain = ctx.saved_tensors
        if dh is None:
            dh = torch.zeros_like(s)
        ds, dgain = add_rms_norm_backward(s, gain, dh, ds_out, ctx.eps)
        return ds, ds, dgain, None


def rms_norm_train(x: torch.Tensor, gain: torch.Tensor,
                   eps: float) -> torch.Tensor:
    """``rms_norm`` (K3 on a card) with a gradient (K3b on a card): the
    training forward's first norm."""
    return _RmsNorm.apply(x, gain, eps)


def add_rms_norm_train(x: torch.Tensor, delta: torch.Tensor,
                       gain: torch.Tensor, eps: float) -> tuple:
    """``add_rms_norm`` (K3's fused entry on a card) with a gradient (K3b's
    fused form on a card) -> (s, h): every norm of the training forward
    but the first, with the residual add before it."""
    return _AddRmsNorm.apply(x, delta, gain, eps)
