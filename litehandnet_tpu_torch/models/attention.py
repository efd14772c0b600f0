"""Attention library (port of ``litehandnet_tpu/models/attention.py``):
SoftPool, stacked-stage channel attention, SE, CBAM, SK, BAM and NAM gates.

Modules take NCHW input (``channels_last`` memory where the caller runs it)
and need their input channels at construction, where flax reads them from
the input. CBAM keeps the reference torch names that
``utils/torch_import.py:735-743`` encodes (``pre.0/1/3/4``,
``residual_conv``, ``ca.sharedMLP.0/2``, ``sa.conv``); ``SELayer`` and
``SKConv`` the reference's ``fc.0/2``, ``convs``, ``fcs``; the rest name
their children as flax does (``ln``, ``fc1``, ``fc2`` as lists by stack,
BAM's ``c_fc0`` ... ``s_final``, NAM's ``bn``).

``soft_pool`` runs the hand-written ``kernels.softpool_2x2`` CUDA kernel on a
CUDA tensor (its plain version on a CPU one); its backward is the autograd of
the plain version, recomputed, as JAX differentiates its XLA ``soft_pool``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.kernels.softpool_2x2 import (
    softpool_2x2,
    softpool_2x2_reference,
)
from litehandnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dropout,
    adaptive_avg_pool,
)


class _SoftPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, kernel, stride):
        ctx.save_for_backward(x)
        ctx.window = (kernel, stride)
        return softpool_2x2(x, kernel, stride)

    @staticmethod
    def backward(ctx, gy):
        (x,) = ctx.saved_tensors
        with torch.enable_grad():
            xd = x.detach().requires_grad_(True)
            y = softpool_2x2_reference(xd, *ctx.window)
            (gx,) = torch.autograd.grad(y, xd, gy)
        return gx, None, None


def soft_pool(x: torch.Tensor, kernel: int = 2, stride: int = 2) -> torch.Tensor:
    """SoftPool (exp-weighted average pooling) of ``[B, C, H, W]`` over
    VALID windows, differentiable (JAX ``soft_pool``, attention.py:23-35).
    Raises what ``kernels.softpool_2x2`` raises."""
    return _SoftPool.apply(x, kernel, stride)


class SoftPooling(nn.Module):
    def __init__(self, kernel: int = 2, stride: int = 2):
        super().__init__()
        self.kernel = kernel
        self.stride = stride

    def forward(self, x):
        return soft_pool(x, self.kernel, self.stride)


def _weighted_sum(xs: Sequence[torch.Tensor], att: torch.Tensor) -> torch.Tensor:
    """sum_i xs[i] * att[:, i] over stacks, ``att`` ``[B, n, C]``."""
    return sum(x * att[:, i, :, None, None] for i, x in enumerate(xs))


class StageChannelAttention(nn.Module):
    """Cross-stack heatmap channel selection with LayerNorm (attention.py:
    46-70). Input: a list of ``n_block`` maps ``[B, C, H, W]``."""

    def __init__(self, channels: int, reduction: int = 4, n_block: int = 2,
                 min_unit: int = 16):
        super().__init__()
        mid = max(channels // reduction, min_unit)
        self.n_block = n_block
        self.ln = nn.ModuleList(nn.LayerNorm(channels, eps=1e-5)
                                for _ in range(n_block))
        self.fc1 = nn.ModuleList(nn.Linear(channels, mid, bias=False)
                                 for _ in range(n_block))
        self.fc2 = nn.ModuleList(nn.Linear(mid, channels)
                                 for _ in range(n_block))

    def forward(self, xs):
        vectors = []
        for i, x in enumerate(xs):
            g = self.ln[i](x.mean(dim=(2, 3)))
            g = self.fc2[i](F.relu(self.fc1[i](g)))
            vectors.append(torch.sigmoid(g))
        att = torch.softmax(torch.stack(vectors, dim=1), dim=1)  # [B, n, C]
        return _weighted_sum(xs, att) / self.n_block


class StageChannelAttentionAll(nn.Module):
    """Variant fusing every stack's global features (attention.py:73-102):
    element-wise dropout at 0.3 in train mode."""

    def __init__(self, channels: int, reduction: int = 4, n_block: int = 2,
                 min_unit: int = 12):
        super().__init__()
        mid = max(channels // reduction, min_unit)
        self.ln = nn.ModuleList(nn.LayerNorm(channels, eps=1e-5)
                                for _ in range(n_block))
        self.fc1 = nn.ModuleList(nn.Linear(channels, mid, bias=False)
                                 for _ in range(n_block))
        self.drop = Dropout(0.3)
        self.fc2 = nn.ModuleList(nn.Linear(mid * n_block, channels)
                                 for _ in range(n_block))

    def forward(self, xs):
        feats = [F.relu(self.drop(self.fc1[i](self.ln[i](x.mean(dim=(2, 3))))))
                 for i, x in enumerate(xs)]
        fused = torch.cat(feats, dim=-1)
        att = torch.softmax(torch.stack([fc(fused) for fc in self.fc2], dim=1),
                            dim=1)
        return _weighted_sum(xs, att)


class StageChannelAttentionFC(nn.Module):
    """Gram-matrix variant (attention.py:105-125)."""

    def __init__(self, channels: int, n_block: int = 2):
        super().__init__()
        self.channels = channels
        self.n_block = n_block
        self.ln = nn.LayerNorm(channels * n_block, eps=1e-5)
        self.drop = Dropout(0.3)
        self.fc = nn.Linear(channels * n_block, channels * n_block)

    def forward(self, xs):
        B = xs[0].shape[0]
        g = adaptive_avg_pool(torch.cat(list(xs), dim=1), (2, 2))
        g = g.reshape(B, self.channels * self.n_block, 4)
        gsum = torch.einsum("bcf,bdf->bcd", g, g).sum(dim=2)
        out = self.fc(self.drop(self.ln(gsum)))
        att = torch.softmax(out.reshape(B, self.n_block, self.channels), dim=1)
        return _weighted_sum(xs, att)


class SELayer(nn.Module):
    """Classic SE (attention.py:128-141)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.fc = nn.Sequential(
            nn.Linear(channels, channels // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(channels // reduction, channels, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return x * self.fc(x.mean(dim=(2, 3)))[:, :, None, None]


class RegionChannelAttention(nn.Module):
    """CBAM channel gate: a shared MLP over average and max pools; returns
    the gate ``[B, C, 1, 1]`` (attention.py:144-158)."""

    def __init__(self, channels: int, reduction: int = 16):
        super().__init__()
        self.sharedMLP = nn.Sequential(
            Conv(channels, channels // reduction, 1, bias=False),
            nn.ReLU(),
            Conv(channels // reduction, channels, 1, bias=False),
        )

    def forward(self, x):
        avg = x.mean(dim=(2, 3), keepdim=True)
        mx = x.amax(dim=(2, 3), keepdim=True)
        return torch.sigmoid(self.sharedMLP(avg) + self.sharedMLP(mx))


class RegionSpatialAttention(nn.Module):
    """CBAM spatial gate: a k x k conv over the channel mean and max; returns
    the gate ``[B, 1, H, W]`` (attention.py:161-175)."""

    def __init__(self, kernel: int = 7):
        super().__init__()
        self.conv = Conv(2, 1, kernel, 1, (kernel - 1) // 2, bias=False)

    def forward(self, x):
        s = torch.cat([x.mean(dim=1, keepdim=True),
                       x.amax(dim=1, keepdim=True)], dim=1)
        return torch.sigmoid(self.conv(s))


class CBAM(nn.Module):
    """Conv block, channel and spatial gates, 1x1 residual
    (attention.py:178-198)."""

    def __init__(self, in_channels: int, features: int, reduction: int = 16):
        super().__init__()
        self.pre = nn.Sequential(
            Conv(in_channels, features, 3, 1, 1),
            BatchNorm(features),
            nn.ReLU(),
            Conv(features, features, 3, 1, 1),
            BatchNorm(features),
        )
        self.ca = RegionChannelAttention(features, reduction)
        self.sa = RegionSpatialAttention()
        self.residual_conv = Conv(in_channels, features, 1)

    def forward(self, x):
        out = self.pre(x)
        out = self.ca(out) * out
        out = self.sa(out) * out
        return F.relu(out + self.residual_conv(x))


class SKConv(nn.Module):
    """Selective-kernel conv: n_scale 'SAME' branches of kernel 3, 5, ...,
    a softmax over branches per channel (attention.py:201-235)."""

    def __init__(self, channels: int, groups: int = 1, reduction: int = 16,
                 n_scale: int = 4, stride: int = 1, min_unit: int = 32):
        super().__init__()
        d = max(int(channels / reduction), min_unit)
        self.convs = nn.ModuleList(
            nn.Sequential(
                Conv(channels, channels, 3 + 2 * i, stride, 1 + i,
                     groups=groups),
                BatchNorm(channels),
                nn.ReLU(),
            )
            for i in range(n_scale)
        )
        self.fc = nn.Linear(channels, d)
        self.fcs = nn.ModuleList(nn.Linear(d, channels) for _ in range(n_scale))

    def forward(self, x):
        feats = [conv(x) for conv in self.convs]
        z = self.fc(sum(feats).mean(dim=(2, 3)))
        att = torch.softmax(torch.stack([fc(z) for fc in self.fcs], dim=1),
                            dim=1)
        return _weighted_sum(feats, att)


class BAM(nn.Module):
    """Bottleneck attention module (attention.py:238-273): a channel gate
    (Linear, rank-2 BatchNorm, Linear) times a dilated spatial gate,
    ``(1 + sigmoid(channel * spatial)) * x``."""

    def __init__(self, channels: int, reduction: int = 16, dilation: int = 4):
        super().__init__()
        mid = channels // reduction
        self.c_fc0 = nn.Linear(channels, mid)
        self.c_bn0 = BatchNorm(mid)
        self.c_fc_final = nn.Linear(mid, channels)
        self.s_reduce = Conv(channels, mid, 1)
        self.s_bn0 = BatchNorm(mid)
        self.s_di0 = Conv(mid, mid, 3, 1, dilation, dilation)
        self.s_di0_bn = BatchNorm(mid)
        self.s_di1 = Conv(mid, mid, 3, 1, dilation, dilation)
        self.s_di1_bn = BatchNorm(mid)
        self.s_final = Conv(mid, 1, 1)

    def forward(self, x):
        g = F.relu(self.c_bn0(self.c_fc0(x.mean(dim=(2, 3)))))
        channel = self.c_fc_final(g)[:, :, None, None]
        s = F.relu(self.s_bn0(self.s_reduce(x)))
        s = F.relu(self.s_di0_bn(self.s_di0(s)))
        s = F.relu(self.s_di1_bn(self.s_di1(s)))
        s = self.s_final(s)
        return (1.0 + torch.sigmoid(channel * s)) * x


class NAMChannelAtt(nn.Module):
    """Normalization-based attention (attention.py:276-297): the BN output
    weighted by |gamma| / sum |gamma|, gated into the input. The weights
    read ``bn.weight.detach()`` (JAX ``stop_gradient``), so gamma gets
    gradients only through the normalization."""

    def __init__(self, channels: int):
        super().__init__()
        self.bn = BatchNorm(channels)

    def forward(self, x):
        gamma = self.bn.weight.detach().abs()
        y = self.bn(x) * (gamma / gamma.sum())[None, :, None, None]
        return torch.sigmoid(y) * x
