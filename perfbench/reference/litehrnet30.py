"""Plain reference of the litehandnet repository's Lite-HRNet
(``models/pose_estimation/lite_hrnet.py:283-390``, experiment
``litehrnet/freihand_256_d30``): Yu et al., "Lite-HRNet: A Lightweight
High-Resolution Network", CVPR 2021 (arXiv:2104.06403), as that file builds
it, at depth 30 (``(3, 8, 3)`` modules) or 18 (``(3, 4, 3)``).

A shuffle stem (a 3x3 s2 conv, then a stride-2 split block) gives 32
channels at a quarter of the input. Three stages then run 2, 3 and 4
branches of 40 / 80 / 160 / 320 channels, each branch at half the
resolution of the one before; a transition adds each new branch from the
last one with a stride-2 depthwise-separable conv (and widens branch 0 from
32 to 40). A stage is modules of two conditional channel weighting blocks
(ratios 8 and 4) and a fuse of every branch into every other. An iterative
head refines the branches coarsest first, and a 1x1 conv maps branch 0 to
the joints.

Where this departs from the paper's equations (it follows the file):
- Fuse: branch 0's own term enters every row twice, and rows 1.. fuse the
  accumulated pre-ReLU sum of row 0 rather than branch 0 itself (an
  in-place ``+=`` on the branch list in the file). In train mode the file
  runs the ``fuse_layers[i][0]`` modules twice, so their BatchNorms move
  their running statistics twice a step; ``common.BN`` keeps none, so here
  the term is computed once and doubled in both modes.
- Both gates put a ReLU and then a sigmoid after each of their two 1x1
  convs (the paper: a ReLU after the first, a sigmoid after the second).
- The convs of the gates, the stem, the depthwise 3x3 of each block and
  the transitions' and head's convs are as biased or bias-free as the file
  builds them (a conv carries a bias before its BatchNorm where the file
  leaves ``bias`` at its default).
- The head is mmpose's ``IterativeHead``: branch i + 1's output, resized
  to branch i by an align-corners bilinear resize, is added before branch
  i's depthwise-separable projection; the paper's head reads branch 0 only.

The gates pool every branch to the smallest map by a mean over whole
blocks (the maps here halve exactly from branch to branch; another shape
is refused) and bring the gate back by pixel repetition. Written anew in
plain ``torch`` from ``reference/common.py``'s ``Conv`` and ``BN``, with the
program's state-dict names, so one seeded dict loads into both and
``core/flops.py`` counts every conv.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from perfbench.reference.common import BN, Conv

WIDTHS = ((40, 80), (40, 80, 160), (40, 80, 160, 320))
MODULES = {18: (3, 4, 3), 30: (3, 8, 3)}


def conv_bn(cin, cout, k=1, stride=1, groups=1, bias=True, relu=False):
    layers = [Conv(cin, cout, k, stride, (k - 1) // 2, groups=groups,
                   bias=bias), BN(cout)]
    return nn.Sequential(*layers, nn.ReLU()) if relu else nn.Sequential(*layers)


def shuffle(x: torch.Tensor, groups: int = 2) -> torch.Tensor:
    """Channel ``g * C / groups + i`` goes to ``i * groups + g``."""
    C = x.shape[1]
    order = torch.arange(C, device=x.device).view(groups, C // groups).t()
    return x.index_select(1, order.reshape(-1))


def block_mean(x: torch.Tensor, size) -> torch.Tensor:
    """The mean over each ``H / h`` x ``W / w`` block."""
    B, C, H, W = x.shape
    h, w = size
    if H % h or W % w:
        raise ValueError(f"{H}x{W} does not pool to {h}x{w} in whole blocks")
    return x.view(B, C, h, H // h, w, W // w).mean(dim=(3, 5))


def repeat_pixels(x: torch.Tensor, size) -> torch.Tensor:
    """Each pixel repeated ``H / h`` x ``W / w`` times."""
    h, w = x.shape[2:]
    H, W = size
    if H % h or W % w:
        raise ValueError(f"{h}x{w} does not repeat to {H}x{W}")
    return x.repeat_interleave(H // h, dim=2).repeat_interleave(W // w, dim=3)


def _lerp_axis(x: torch.Tensor, dim: int, n_out: int) -> torch.Tensor:
    """Linear interpolation along ``dim`` to ``n_out`` samples, with the
    first and last samples on the first and last inputs."""
    n_in = x.shape[dim]
    if n_in == n_out:
        return x
    pos = torch.arange(n_out, dtype=torch.float64, device=x.device)
    pos = pos * ((n_in - 1) / (n_out - 1))
    lo = pos.floor().clamp(max=n_in - 1)
    frac = (pos - lo).to(torch.promote_types(x.dtype, torch.float32))
    lo = lo.long()
    hi = (lo + 1).clamp(max=n_in - 1)
    shape = [1] * x.dim()
    shape[dim] = n_out
    frac = frac.view(shape)
    a, b = x.index_select(dim, lo), x.index_select(dim, hi)
    return a + (b - a) * frac


def bilinear_corners(x: torch.Tensor, size) -> torch.Tensor:
    """Bilinear resize with the corner samples aligned, rows then
    columns."""
    return _lerp_axis(_lerp_axis(x, 2, size[0]), 3, size[1])


class DWSep(nn.Module):
    """Depthwise 3x3 + BN, then 1x1 + BN, each with an optional ReLU."""

    def __init__(self, cin, cout, stride=1, mid_relu=True, last_relu=True,
                 bias=False):
        super().__init__()
        self.depthwise_conv = conv_bn(cin, cin, 3, stride, groups=cin,
                                      bias=bias, relu=mid_relu)
        self.pointwise_conv = conv_bn(cin, cout, bias=bias, relu=last_relu)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class Stem(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv_bn(3, 32, 3, 2, relu=True)
        self.branch1 = DWSep(16, 16, stride=2, mid_relu=False, bias=True)
        self.expand_conv = conv_bn(16, 32, relu=True)
        self.depthwise_conv = conv_bn(32, 32, 3, 2, groups=32)
        self.linear_conv = conv_bn(32, 16, relu=True)

    def forward(self, x):
        x = self.conv1(x)
        a = self.branch1(x[:, :16])
        b = self.linear_conv(self.depthwise_conv(self.expand_conv(x[:, 16:])))
        return shuffle(torch.cat([a, b], dim=1))


class Gate(nn.Module):
    """The per-branch spatial gate: channel means, two 1x1 convs."""

    def __init__(self, c, ratio=4):
        super().__init__()
        self.conv1 = nn.Sequential(Conv(c, int(c / ratio), 1))
        self.conv2 = nn.Sequential(Conv(int(c / ratio), c, 1))

    def forward(self, x):
        g = x.mean(dim=(2, 3), keepdim=True)
        g = torch.sigmoid(torch.relu(self.conv1(g)))
        g = torch.sigmoid(torch.relu(self.conv2(g)))
        return x * g


class CrossGate(nn.Module):
    """The gate over all branches, each pooled to the smallest map."""

    def __init__(self, widths: Sequence[int], ratio=8):
        super().__init__()
        self.widths = list(widths)
        total = sum(widths)
        self.conv1 = conv_bn(total, int(total / ratio))
        self.conv2 = conv_bn(int(total / ratio), total)

    def forward(self, xs):
        small = tuple(xs[-1].shape[2:])
        g = torch.cat([block_mean(x, small) for x in xs[:-1]] + [xs[-1]],
                      dim=1)
        g = torch.sigmoid(torch.relu(self.conv1(g)))
        g = torch.sigmoid(torch.relu(self.conv2(g)))
        return [x * repeat_pixels(part, x.shape[2:])
                for x, part in zip(xs, torch.split(g, self.widths, dim=1))]


class WeightingBlock(nn.Module):
    """Each branch split in halves; the second half through the cross gate,
    a depthwise 3x3 + BN and its spatial gate; the halves joined and
    shuffled."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        half = [c // 2 for c in widths]
        self.cross_resolution_weighting = CrossGate(half, 8)
        self.depthwise_convs = nn.ModuleList(
            conv_bn(c, c, 3, groups=c) for c in half)
        self.spatial_weighting = nn.ModuleList(Gate(c, 4) for c in half)

    def forward(self, xs):
        keep = [x[:, :x.shape[1] // 2] for x in xs]
        work = self.cross_resolution_weighting(
            [x[:, x.shape[1] // 2:] for x in xs])
        work = [gate(dw(x)) for x, dw, gate in
                zip(work, self.depthwise_convs, self.spatial_weighting)]
        return [shuffle(torch.cat([a, b], dim=1)) for a, b in zip(keep, work)]


class Module(nn.Module):
    """Two weighting blocks, then every branch fused into every other."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        c = list(widths)
        n = len(c)
        self.layers = nn.Sequential(WeightingBlock(c), WeightingBlock(c))
        rows = []
        for i in range(n):
            row = []
            for j in range(n):
                if j > i:      # 1x1 + BN, then pixel repetition up to i
                    row.append(conv_bn(c[j], c[i], bias=False))
                elif j < i:    # i - j stride-2 depthwise-separable convs
                    row.append(nn.Sequential(*[
                        DWSep(c[j], c[i] if k == i - j - 1 else c[j], 2,
                              mid_relu=False, last_relu=False)
                        for k in range(i - j)]))
                else:
                    row.append(nn.Identity())
            rows.append(nn.ModuleList(row))
        self.fuse_layers = nn.ModuleList(rows)

    def into(self, i, j, x):
        y = self.fuse_layers[i][j](x)
        if j <= i:
            return y
        f = 2 ** (j - i)
        return repeat_pixels(y, (y.shape[2] * f, y.shape[3] * f))

    def forward(self, xs):
        for block in self.layers:
            xs = block(xs)
        n = len(xs)
        row0 = xs[0] + xs[0]
        for j in range(1, n):
            row0 = row0 + self.into(0, j, xs[j])
        out = [torch.relu(row0)]
        for i in range(1, n):
            y = self.into(i, 0, row0) * 2.0
            for j in range(1, n):
                y = y + (xs[j] if j == i else self.into(i, j, xs[j]))
            out.append(torch.relu(y))
        return out


class Head(nn.Module):
    """Coarsest branch first: add the coarser branch's output, resized,
    then project."""

    def __init__(self, widths: Sequence[int]):
        super().__init__()
        c = list(widths)[::-1]
        self.projects = nn.ModuleList(
            DWSep(c[i], c[i + 1] if i + 1 < len(c) else c[i])
            for i in range(len(c)))

    def forward(self, xs):
        out, prev = [], None
        for x, proj in zip(xs[::-1], self.projects):
            if prev is not None:
                x = x + bilinear_corners(prev, x.shape[2:])
            prev = proj(x)
            out.append(prev)
        return out[::-1]


class LiteHRNet(nn.Module):
    def __init__(self, joints=21, depth=30):
        super().__init__()
        self.stem = Stem()
        prev = [32]
        for i, (widths, count) in enumerate(zip(WIDTHS, MODULES[depth])):
            trans = []
            for j, c in enumerate(widths):
                if j < len(prev):
                    trans.append(nn.Identity() if c == prev[j] else
                                 DWSep(prev[j], c, mid_relu=False))
                else:         # a new branch, from the last one
                    trans.append(nn.Sequential(
                        DWSep(prev[-1], c, 2, mid_relu=False)))
            self.add_module(f"transition{i}", nn.ModuleList(trans))
            self.add_module(f"stage{i}", nn.ModuleList(
                Module(widths) for _ in range(count)))
            prev = list(widths)
        self.head_layer = Head(prev)
        self.out_conv = Conv(prev[0], joints, 1)

    def forward(self, x):
        xs: List[torch.Tensor] = [self.stem(x)]
        for i in range(len(WIDTHS)):
            xs = [t(xs[min(j, len(xs) - 1)]) for j, t in
                  enumerate(getattr(self, f"transition{i}"))]
            for module in getattr(self, f"stage{i}"):
                xs = module(xs)
        y = self.out_conv(self.head_layer(xs)[0])
        return y.to(torch.promote_types(y.dtype, torch.float32))


def build(model: dict) -> LiteHRNet:
    """The reference from the configuration file's ``MODEL`` entry."""
    if model["name"] != "litehrnet" or model["depth"] not in MODULES:
        raise ValueError("the reference is Lite-HRNet at depth 18 or 30")
    return LiteHRNet(model["output_channel"], model["depth"])
