"""Lite-HRNet: a shuffle stem, multi-resolution stages with conditional
channel weighting, and an iterative head (port of
``litehandnet_tpu/models/litehrnet.py``; reference ``lite_hrnet.py:11-387``).

Depth 18 has ``(3, 4, 3)`` modules per stage, depth 30 ``(3, 8, 3)``.
Submodule names are the reference torch names that
``utils/torch_import.py::_litehrnet_rules`` (:400-465) encodes: ``stem``,
``transition{i}.{j}[.{k}]``, ``stage{i}.{m}.layers.{b}`` and
``.fuse_layers.{dst}.{src}[.{k}]``, ``head_layer.projects.{i}``,
``out_conv``.

The reference's fuse quirk is kept (``lite_hrnet.py:194-202``, JAX
:230-249): branch 0's term enters every row twice, rows i >= 1 fuse the
accumulated pre-ReLU branch-0 sum, and in train mode the ``fuse_layers[i][0]``
modules are called twice, so their BatchNorms move their running statistics
twice a step. In eval mode without gradients each row's sum, upsampling and
ReLU on a CUDA card is one ``kernels/fuse_sum_relu`` launch, bit for bit the
eager ops' (``fuse_row``).

Each ``ConditionalChannelWeighting`` forward is the span
``lhn.litehrnet.weighting`` and each module's fuse the span
``lhn.litehrnet.fuse`` (``utils/profiling.span``: recorded only under
``torch.profiler``, else one flag read); ``CrossResolutionWeighting.calls``
counts the cross-resolution gates every model of the process ran, as
``serve.Predictor.batches`` counts batches.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.kernels.fuse_sum_relu import (
    fuse_sum_relu,
    launch_plan,
)
from litehandnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    adaptive_avg_pool,
    channel_shuffle,
    head_output,
    resize_dtype,
    resize_nearest,
)
from litehandnet_tpu_torch.utils.profiling import register_counters, span


def resize_bilinear_align_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize with torch's ``align_corners=True`` (JAX
    :26-42), in the forward and the backward."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="bilinear",
                         align_corners=True)


def _conv_bn(in_channels, features, kernel=1, stride=1, groups=1, bias=True,
             relu=False) -> nn.Sequential:
    layers = [Conv(in_channels, features, kernel, stride, (kernel - 1) // 2,
                   groups=groups, bias=bias), BatchNorm(features)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


class HRDWConv(nn.Module):
    """Depthwise 3x3 + BN, then pointwise + BN, each with an optional ReLU
    (lite_hrnet.py:11-27)."""

    def __init__(self, in_channels, features, stride=1, mid_relu=True,
                 last_relu=True, bias=False):
        super().__init__()
        self.depthwise_conv = _conv_bn(in_channels, in_channels, 3, stride,
                                       groups=in_channels, bias=bias,
                                       relu=mid_relu)
        self.pointwise_conv = _conv_bn(in_channels, features, bias=bias,
                                       relu=last_relu)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class SpatialWeighting(nn.Module):
    """Per-branch gate (lite_hrnet.py:56-76); the reference applies ReLU
    then sigmoid after both convs."""

    def __init__(self, channels, ratio=4):
        super().__init__()
        mid = int(channels / ratio)
        self.conv1 = nn.Sequential(Conv(channels, mid, 1))
        self.conv2 = nn.Sequential(Conv(mid, channels, 1))

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(F.relu(self.conv1(s)))
        s = torch.sigmoid(F.relu(self.conv2(s)))
        return x * s


class CrossResolutionWeighting(nn.Module):
    """Gate over all branches pooled to the smallest map
    (lite_hrnet.py:78-111)."""

    calls = 0

    def __init__(self, channels: Sequence[int], ratio=8):
        super().__init__()
        self.channels = list(channels)
        total = sum(channels)
        mid = int(total / ratio)
        self.conv1 = _conv_bn(total, mid)
        self.conv2 = _conv_bn(mid, total)

    def forward(self, xs):
        CrossResolutionWeighting.calls += 1
        mini = xs[-1].shape[2:]
        out = torch.cat([adaptive_avg_pool(s, mini) for s in xs[:-1]]
                        + [xs[-1]], dim=1)
        out = torch.sigmoid(F.relu(self.conv1(out)))
        out = torch.sigmoid(F.relu(self.conv2(out)))
        return [s * resize_nearest(a, s.shape[2:])
                for s, a in zip(xs, torch.split(out, self.channels, dim=1))]


register_counters(CrossResolutionWeighting, "calls")


class ConditionalChannelWeighting(nn.Module):
    """Split-channel shuffle block (lite_hrnet.py:113-143): the second half
    of each branch's channels goes through the cross-resolution gate, a
    depthwise 3x3 + BN and the spatial gate."""

    def __init__(self, in_channels: Sequence[int], reduce_ratio=8):
        super().__init__()
        branch = [c // 2 for c in in_channels]
        self.cross_resolution_weighting = CrossResolutionWeighting(
            branch, reduce_ratio)
        self.depthwise_convs = nn.ModuleList(
            _conv_bn(c, c, 3, groups=c) for c in branch)
        self.spatial_weighting = nn.ModuleList(
            SpatialWeighting(c, 4) for c in branch)

    def forward(self, xs):
        with span("lhn.litehrnet.weighting", xs[0].device):
            x1 = [s[:, :s.shape[1] // 2] for s in xs]
            x2 = [s[:, s.shape[1] // 2:] for s in xs]
            x2 = self.cross_resolution_weighting(x2)
            x2 = [sw(dw(s)) for s, dw, sw in
                  zip(x2, self.depthwise_convs, self.spatial_weighting)]
            return [channel_shuffle(torch.cat([a, b], dim=1), 2)
                    for a, b in zip(x1, x2)]


class StageModule(nn.Module):
    """``num_blocks`` conditional channel weighting blocks, then the
    cross-resolution fuse (lite_hrnet.py:145-204)."""

    def __init__(self, in_channels: Sequence[int], num_blocks=2,
                 reduce_ratio=8):
        super().__init__()
        c = list(in_channels)
        n = len(c)
        self.layers = nn.Sequential(*[
            ConditionalChannelWeighting(c, reduce_ratio)
            for _ in range(num_blocks)])
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:      # 1x1 conv + BN, then a nearest upsample
                    row.append(_conv_bn(c[j], c[i], bias=False))
                elif j < i:    # i - j stride-2 depthwise-separable convs
                    row.append(nn.Sequential(*[
                        HRDWConv(c[j], c[i] if k == i - j - 1 else c[j],
                                 stride=2, mid_relu=False, last_relu=False)
                        for k in range(i - j)]))
                else:
                    row.append(nn.Identity())
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def _fuse(self, j, i, s):
        out = self.fuse_layers[i][j](s)
        if j > i:
            f = 2 ** (j - i)
            out = resize_nearest(out, (out.shape[2] * f, out.shape[3] * f))
        return out

    def _train_fuse(self, xs):
        """The fuse in train mode: ``fuse_layers[i][0]`` is called twice,
        so its BatchNorms move twice."""
        n = len(xs)
        s0 = 2.0 * xs[0]
        for j in range(1, n):
            s0 = s0 + self._fuse(j, 0, xs[j])
        out = [F.relu(s0)]
        for i in range(1, n):
            y = self._fuse(0, i, s0) + self._fuse(0, i, s0)
            for j in range(1, n):
                y = y + (xs[j] if i == j else self._fuse(j, i, xs[j]))
            out.append(F.relu(y))
        return out

    def forward(self, xs):
        for block in self.layers:
            xs = block(xs)
        with span("lhn.litehrnet.fuse", xs[0].device):
            if self.training:
                return self._train_fuse(xs)
            n, out, s0 = len(xs), [], None
            for i in range(n):
                # row i's terms: the identity, the chains of finer branches
                # (row 0's pre-ReLU sum for branch 0) and the coarser
                # branches' 1x1 conv + BN at their own resolution
                terms = [self.fuse_layers[i][j](s0 if i and not j else xs[j])
                         for j in range(n)]
                y, s = fuse_row(terms, write_sum=n > 1 and not i)
                out.append(y)
                if not i:
                    s0 = s
            return out


def fuse_kernel_route(terms, dtypes, write_sum) -> bool:
    """Whether an eval-mode fuse row takes ``fuse_sum_relu``: no gradient
    is recorded and the kernel's plan takes the terms (CUDA tensors, C a
    multiple of 8, channels or w innermost, aligned, bfloat16 or float32,
    power-of-two factors)."""
    return (not torch.is_grad_enabled()
            and launch_plan(terms, dtypes, write_sum) is not None)


def eager_fuse_row(terms):
    """``(relu(s), s)`` for ``s = ((2 t_0 + up(t_1)) + ...) + up(t_{n-1})``
    by PyTorch's ops, the coarser terms upsampled to ``t_0``'s size."""
    size = terms[0].shape[2:]
    s = 2.0 * terms[0]
    for t in terms[1:]:
        s = s + resize_nearest(t, size)
    return F.relu(s), s


def fuse_row(terms, write_sum: bool):
    """One row of the eval-mode fuse: ``fuse_sum_relu`` where
    ``fuse_kernel_route`` takes the row (s only where ``write_sum``), else
    ``eager_fuse_row``; the same bits either way."""
    size = terms[0].shape[2:]
    dtypes = [t.dtype if t.shape[2:] == size else resize_dtype(t)
              for t in terms]
    if fuse_kernel_route(terms, dtypes, write_sum):
        return fuse_sum_relu(terms, dtypes, write_sum)
    return eager_fuse_row(terms)


class StemModule(nn.Module):
    """Shuffle stem (lite_hrnet.py:206-248)."""

    def __init__(self, in_channels=3, stem_channels=32, out_channels=32,
                 expand_ratio=1):
        super().__init__()
        self.conv1 = _conv_bn(in_channels, stem_channels, 3, 2, relu=True)
        branch = stem_channels // 2
        mid = int(round(stem_channels * expand_ratio))
        same = stem_channels == out_channels
        inc = out_channels - (branch if same else stem_channels)
        self.branch = branch
        self.branch1 = HRDWConv(branch, inc, stride=2, mid_relu=False,
                                bias=True)
        self.expand_conv = _conv_bn(stem_channels - branch, mid, relu=True)
        self.depthwise_conv = _conv_bn(mid, mid, 3, 2, groups=mid)
        self.linear_conv = _conv_bn(mid, branch if same else stem_channels,
                                    relu=True)

    def forward(self, x):
        x = self.conv1(x)
        x1 = self.branch1(x[:, :self.branch])
        x2 = self.linear_conv(self.depthwise_conv(self.expand_conv(
            x[:, self.branch:])))
        return channel_shuffle(torch.cat([x1, x2], dim=1), 2)


class IterativeHead(nn.Module):
    """Top-down refinement, coarsest branch first (lite_hrnet.py:250-280)."""

    def __init__(self, in_channels: Sequence[int]):
        super().__init__()
        chans = list(in_channels)[::-1]
        n = len(chans)
        self.projects = nn.ModuleList(
            HRDWConv(chans[i], chans[i + 1] if i != n - 1 else chans[i])
            for i in range(n))

    def forward(self, xs):
        y, last = [], None
        for s, proj in zip(xs[::-1], self.projects):
            if last is not None:
                s = s + resize_bilinear_align_corners(last, s.shape[2:])
            last = proj(s)
            y.append(last)
        return y[::-1]


class LiteHRNet(nn.Module):
    """lite_hrnet.py:283-387."""

    NUM_CHANNELS = ((40, 80), (40, 80, 160), (40, 80, 160, 320))

    def __init__(self, num_joints=21, depth=30):
        super().__init__()
        num_modules = (3, 4, 3) if depth == 18 else (3, 8, 3)
        self.stem = StemModule(3, 32, 32, 1)
        prev = [32]
        for i, cur in enumerate(self.NUM_CHANNELS):
            n_prev = len(prev)
            trans = []
            for j, c in enumerate(cur):
                if j < n_prev:
                    trans.append(HRDWConv(prev[j], c, mid_relu=False)
                                 if c != prev[j] else nn.Identity())
                else:
                    steps, ch = [], prev[-1]
                    for k in range(j + 1 - n_prev):
                        out_c = c if k == j - n_prev else ch
                        steps.append(HRDWConv(ch, out_c, stride=2,
                                              mid_relu=False))
                        ch = out_c
                    trans.append(nn.Sequential(*steps))
            self.add_module(f"transition{i}", nn.ModuleList(trans))
            self.add_module(f"stage{i}", nn.ModuleList(
                StageModule(cur, 2, 8) for _ in range(num_modules[i])))
            prev = list(cur)
        self.head_layer = IterativeHead(prev)
        self.out_conv = Conv(prev[0], num_joints, 1)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "LiteHRNet":
        del deploy  # no Rep modules in this family
        return cls(
            num_joints=cfg.MODEL.get("output_channel", cfg.DATASET.num_joints),
            depth=cfg.MODEL.get("depth", 30))

    def forward(self, x):
        ys: List[torch.Tensor] = [self.stem(x)]
        for i in range(len(self.NUM_CHANNELS)):
            trans = getattr(self, f"transition{i}")
            xs = [t(ys[min(j, len(ys) - 1)]) for j, t in enumerate(trans)]
            for module in getattr(self, f"stage{i}"):
                xs = module(xs)
            ys = xs
        return head_output(self.out_conv(self.head_layer(ys)[0]))
