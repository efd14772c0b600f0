"""SRHandNet: a three-dilation stem, three downsampling stages and four
refine heads (port of ``litehandnet_tpu/models/srhandnet.py``; reference
``SRhandNet.py:41-144``).

Returns a 4-tuple of float32 ``[B, out_c, h_i, w_i]`` maps at 1/16, 1/16,
1/8 and 1/4 of the input (16/16/32/64 for a 256 input); ``out_c`` is 24 with
``pred_bbox``: 21 keypoints, the center, then w/h. Submodule names are the
reference torch names that ``utils/torch_import.py::_srhandnet_rules``
(:373-397) encodes: ``stem.conv{1,2,3}``, ``block{1..7}.{0,1}`` residual
blocks (``conv3x3.{0,1,3,4}``, projection ``conv1x1``) and the 1x1 output
convs ``block{4..7}.2``.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    head_output,
    resize_nearest,
)


class SRStem(nn.Module):
    """Three parallel 3x3 stride-2 convs of dilation 1, 2 and 5
    (SRhandNet.py:41-54), 21 channels each, concatenated."""

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.conv1 = Conv(in_channels, 21, 3, 2, 1, dilation=1)
        self.conv2 = Conv(in_channels, 21, 3, 2, 2, dilation=2)
        self.conv3 = Conv(in_channels, 21, 3, 2, 5, dilation=5)

    def forward(self, x):
        return F.relu(torch.cat([self.conv1(x), self.conv2(x), self.conv3(x)],
                                dim=1))


class SRBasicBlock(nn.Module):
    """3x3 conv pair with a 1x1 projection skip where the shape changes
    (SRhandNet.py:56-79)."""

    def __init__(self, in_channels: int, features: int, stride: int = 1):
        super().__init__()
        self.conv3x3 = nn.Sequential(
            Conv(in_channels, features, 3, stride, 1), BatchNorm(features),
            nn.ReLU(), Conv(features, features, 3, 1, 1), BatchNorm(features))
        self.conv1x1 = (Conv(in_channels, features, 1, stride)
                        if stride == 2 or in_channels != features else None)

    def forward(self, x):
        skip = x if self.conv1x1 is None else self.conv1x1(x)
        return F.relu(self.conv3x3(x) + skip)


def _stage(in_channels: int, features: int, stride: int) -> nn.Sequential:
    return nn.Sequential(SRBasicBlock(in_channels, features, stride),
                         SRBasicBlock(features, features))


def _head(in_channels: int, features, out_channels: int) -> nn.Sequential:
    return nn.Sequential(SRBasicBlock(in_channels, features[0]),
                         SRBasicBlock(features[0], features[1]),
                         Conv(features[1], out_channels, 1))


class SRHandNet(nn.Module):
    """SRhandNet.py:82-137. ``out_channels`` defaults to the reference's
    21; the region-map configs set 24."""

    def __init__(self, out_channels: int = 21):
        super().__init__()
        K = out_channels
        self.stem = SRStem()
        self.block1 = _stage(63, 128, 2)
        self.block2 = _stage(128, 256, 2)
        self.block3 = _stage(256, 512, 2)
        self.block4 = _head(512, (256, 128), K)
        self.block5 = _head(512 + K, (256, 128), K)
        self.block6 = _head(256 + K, (256, 128), K)
        self.block7 = _head(128 + K, (128, 128), K)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "SRHandNet":
        del deploy  # no Rep modules in this family
        return cls(out_channels=cfg.MODEL.get("output_channel", 21))

    def forward(self, x):
        x = self.stem(x)
        b1 = self.block1(x)
        b2 = self.block2(b1)
        b3 = self.block3(b2)
        out1 = self.block4(b3)
        out2 = self.block5(torch.cat([b3, out1], dim=1))
        h, w = out2.shape[2:]
        out3 = self.block6(torch.cat(
            [b2, resize_nearest(out2, (2 * h, 2 * w))], dim=1))
        h, w = out3.shape[2:]
        out4 = self.block7(torch.cat(
            [b1, resize_nearest(out3, (2 * h, 2 * w))], dim=1))
        return tuple(head_output(o) for o in (out1, out2, out3, out4))
