"""Classic stacked hourglass, princeton-vl lineage (port of
``litehandnet_tpu/models/hourglass.py``; reference ``hourglassnet.py:1-137``).

Pre (7x7 stride-2 conv, residuals, pool) -> ``num_stack`` x (recursive
depth-``num_level`` hourglass -> features -> 1x1 out), with merge
connections between stacks. Returns the stacked heatmaps ``[B, S, K, H/4,
W/4]`` (JAX ``[B, S, H, W, K]``). Submodule names are the reference torch
names that ``utils/torch_import.py::_hourglass_rules`` (:468-520) encodes:
``pre.{0..4}``, ``hgs.{n}.0`` with its ``up1``/``low1``/``low2``/``low3``
tree, ``features.{n}.{0,1}``, ``outs``, ``merge_features``, ``merge_preds``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    head_output,
    max_pool2,
    resize_nearest,
)


class HgConv(nn.Module):
    """Biased conv, then BatchNorm and ReLU where asked
    (hourglassnet.py:6-25)."""

    def __init__(self, in_channels, features, kernel=3, stride=1, bn=False,
                 relu=True):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride,
                         (kernel - 1) // 2)
        self.bn = BatchNorm(features) if bn else None
        self.relu = relu

    def forward(self, x):
        x = self.conv(x)
        if self.bn is not None:
            x = self.bn(x)
        return F.relu(x) if self.relu else x


class HgResidual(nn.Module):
    """Pre-activation bottleneck residual (hourglassnet.py:27-54)."""

    def __init__(self, in_channels, features):
        super().__init__()
        half = features // 2
        self.bn1 = BatchNorm(in_channels)
        self.conv1 = HgConv(in_channels, half, 1, relu=False)
        self.bn2 = BatchNorm(half)
        self.conv2 = HgConv(half, half, 3, relu=False)
        self.bn3 = BatchNorm(half)
        self.conv3 = HgConv(half, features, 1, relu=False)
        self.skip_layer = (None if in_channels == features
                           else HgConv(in_channels, features, 1, relu=False))

    def forward(self, x):
        residual = x if self.skip_layer is None else self.skip_layer(x)
        out = self.conv1(F.relu(self.bn1(x)))
        out = self.conv2(F.relu(self.bn2(out)))
        out = self.conv3(F.relu(self.bn3(out)))
        return out + residual


class HourglassModule(nn.Module):
    """Recursive hourglass (hourglassnet.py:56-80)."""

    def __init__(self, depth: int, features: int):
        super().__init__()
        self.up1 = HgResidual(features, features)
        self.low1 = HgResidual(features, features)
        self.low2 = (HourglassModule(depth - 1, features) if depth > 1
                     else HgResidual(features, features))
        self.low3 = HgResidual(features, features)

    def forward(self, x):
        up1 = self.up1(x)
        low = self.low3(self.low2(self.low1(max_pool2(x))))
        return up1 + resize_nearest(low, up1.shape[2:])


class HourglassNet(nn.Module):
    """Stacked hourglass (hourglassnet.py:90-136)."""

    def __init__(self, num_joints=21, num_stack=2, num_level=4, features=256):
        super().__init__()
        f = features
        self.num_stack = num_stack
        self.pre = nn.Sequential(
            HgConv(3, 64, 7, 2, bn=True, relu=True),
            HgResidual(64, 128),
            nn.MaxPool2d(2, 2, ceil_mode=True),
            HgResidual(128, 128),
            HgResidual(128, f),
        )
        self.hgs = nn.ModuleList(nn.Sequential(HourglassModule(num_level, f))
                                 for _ in range(num_stack))
        self.features = nn.ModuleList(
            nn.Sequential(HgResidual(f, f),
                          HgConv(f, f, 1, bn=True, relu=True))
            for _ in range(num_stack))
        self.outs = nn.ModuleList(HgConv(f, num_joints, 1, relu=False)
                                  for _ in range(num_stack))
        self.merge_features = nn.ModuleList(
            _Merge(f, f) for _ in range(num_stack - 1))
        self.merge_preds = nn.ModuleList(
            _Merge(num_joints, f) for _ in range(num_stack - 1))

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "HourglassNet":
        del deploy  # no Rep modules in this family
        m = cfg.MODEL
        return cls(
            num_joints=m.get("output_channel", cfg.DATASET.num_joints),
            num_stack=m.get("num_stack", 8),
            num_level=m.get("num_level", 4),
            features=m.get("input_channel", 256),
        )

    def forward(self, imgs):
        x = self.pre(imgs)
        outs = []
        for i in range(self.num_stack):
            feat = self.features[i](self.hgs[i](x))
            preds = self.outs[i](feat)
            outs.append(head_output(preds))
            if i < self.num_stack - 1:
                x = (x + self.merge_preds[i](preds)
                     + self.merge_features[i](feat))
        return torch.stack(outs, dim=1)


class _Merge(nn.Module):
    """The reference's ``Merge``: a biased 1x1 conv (``conv.conv``)."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.conv = HgConv(in_channels, features, 1, relu=False)

    def forward(self, x):
        return self.conv(x)
