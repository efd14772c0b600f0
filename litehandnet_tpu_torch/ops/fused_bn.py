"""Fused BatchNorm-statistics ops (port of
``litehandnet_tpu/ops/fused_bn.py``).

* :func:`moments`: per-channel (mean, biased var) of ``[N, C, H, W]`` in one
  read, through the ``kernels.moments`` CUDA kernel; exact two-pass tiles
  merged by Chan's update. The backward is the analytic closed form.
* :func:`dw_conv3x3_stats`: depthwise 3x3 conv and its output moments in one
  pass, through the ``kernels.dw_conv3x3_stats`` CUDA kernel. The backward
  is autograd over the plain conv plus two-pass moments.

Both are ``torch.autograd.Function``s. On a CPU tensor the kernel wrappers
use their plain versions; on a CUDA tensor they launch or raise. Neither
backward has a kernel: the JAX package has none there either.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels.dw_conv3x3_stats import (
    dilation_supported,
    dw_conv3x3_stats as dw_kernel,
)
from litehandnet_tpu_torch.kernels.moments import (
    DTYPES,
    moments as moments_kernel,
)


class _Moments(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        mean, var = moments_kernel(x)
        ctx.save_for_backward(x, mean)
        return mean, var

    @staticmethod
    def backward(ctx, gmean, gvar):
        x, mean = ctx.saved_tensors
        n = x.numel() // x.shape[1]
        view = (1, -1, 1, 1)
        # d mean / dx_i = 1/n;  d var / dx_i = 2 (x_i - mean) / n
        dx = gmean.view(view) / n + gvar.view(view) * (2.0 / n) * (
            x.float() - mean.view(view))
        return dx.to(x.dtype)


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-channel (mean, biased variance) of ``[N, C, H, W]``, float32,
    differentiable. Raises for what ``kernels.moments`` does not take."""
    return _Moments.apply(x)


def _dw_reference(x, w, dilation):
    """The plain conv plus two-pass moments that the backward
    differentiates (``fused_bn.py:321-330``)."""
    y = F.conv2d(x, w.to(x.dtype), padding=dilation, dilation=dilation,
                 groups=x.shape[1])
    yf = y.float()
    mean = yf.mean(dim=(0, 2, 3))
    var = (yf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    return y, mean, var


class _DwConv3x3Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, dilation):
        y, mean, var = dw_kernel(x, w, dilation)
        ctx.save_for_backward(x, w)
        ctx.dilation = dilation
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, gmean, gvar):
        x, w = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(ctx.needs_input_grad[0])
            wd = w.detach().requires_grad_(ctx.needs_input_grad[1])
            outs = _dw_reference(xd, wd, ctx.dilation)
            wanted = [t for t, need in zip((xd, wd), ctx.needs_input_grad[:2])
                      if need]
            grads = iter(torch.autograd.grad(outs, wanted, (gy, gmean, gvar)))
        gx = next(grads) if ctx.needs_input_grad[0] else None
        gw = next(grads) if ctx.needs_input_grad[1] else None
        return gx, gw, None


def dw_conv3x3_stats_supported(x_shape, dtype, dilation: int = 1) -> bool:
    """Whether :func:`dw_conv3x3_stats` takes this input: 4-D, float32 or
    bfloat16, a dilation the kernel's shared memory holds. Any N, C, H and
    W."""
    return (len(x_shape) == 4 and dtype in DTYPES
            and dilation_supported(dilation))


def dw_conv3x3_stats(x: torch.Tensor, w: torch.Tensor, dilation: int = 1):
    """Depthwise 3x3 'SAME' stride-1 conv + per-channel output moments in
    one fused pass, differentiable. x ``[N, C, H, W]``, w ``[C, 1, 3, 3]``
    -> (y, mean ``[C]``, var ``[C]``).

    Raises:
        ValueError: a shape or dilation outside
            :func:`dw_conv3x3_stats_supported`.
        TypeError: a dtype or device the kernel does not take.
    """
    if not dw_conv3x3_stats_supported(x.shape, x.dtype, dilation):
        raise ValueError(f"dw_conv3x3_stats does not take x {tuple(x.shape)} "
                         f"{x.dtype} at dilation {dilation}")
    return _DwConv3x3Stats.apply(x, w, dilation)
