"""Plain reference of the litehandnet repository's SimpleBaseline with a
ResNet-50 backbone (``SimpleBaseline/resnet.py`` and ``deconv_head.py``):
the design of Xiao, Wu and Wei, "Simple Baselines for Human Pose
Estimation and Tracking", ECCV 2018, at the repository's narrower widths.

Stem: 7x7 s2 conv (no bias) + BatchNorm + ReLU6, 3x3 s2 max pool (padding
1). Four stages of (3, 4, 6, 3) bottlenecks, strides (1, 2, 2, 2), output
widths 256, 512, 1024, 2048: biased 1x1 -> 3x3 -> 1x1 convs each with
BatchNorm, ReLU between, whose middle width is a quarter of the block's
input width (the repository's rule), a 1x1 conv + BatchNorm projection on
the first block of a stage, ReLU after the sum. Head: three 4x4 s2
transposed convs of 256 (no bias) + BatchNorm + ReLU, then a biased 1x1
conv to the joints.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.common import BN, Conv, ConvT


class CBL(nn.Module):
    def __init__(self, cin, cout, k, stride, padding):
        super().__init__()
        self.conv = nn.Sequential(Conv(cin, cout, k, stride, padding,
                                       bias=False), BN(cout), nn.ReLU6())

    def forward(self, x):
        return self.conv(x)


class Bottleneck(nn.Module):
    def __init__(self, cin, cout, stride, project):
        super().__init__()
        mid = cin // 4
        self.conv = nn.Sequential(
            Conv(cin, mid, 1), BN(mid), nn.ReLU(),
            Conv(mid, mid, 3, stride, 1), BN(mid), nn.ReLU(),
            Conv(mid, cout, 1), BN(cout))
        self.downsample = (nn.Sequential(Conv(cin, cout, 1, stride, bias=False),
                                         BN(cout)) if project else None)

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        return F.relu(skip + self.conv(x))


class DeconvHead(nn.Module):
    def __init__(self, cin, joints, filters):
        super().__init__()
        layers = []
        for f in filters:
            layers += [ConvT(cin, f, 4, 2, 1), BN(f), nn.ReLU()]
            cin = f
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = Conv(cin, joints, 1)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class PoseResNet50(nn.Module):
    def __init__(self, joints, stage_blocks=(3, 4, 6, 3),
                 strides=(1, 2, 2, 2), filters=(256, 256, 256)):
        super().__init__()
        self.stem = CBL(3, 64, 7, 2, 3)
        cin, cout = 64, 256
        stages = []
        for n, stride in zip(stage_blocks, strides):
            blocks = []
            for b in range(n):
                s = stride if b == 0 else 1
                blocks.append(Bottleneck(cin, cout, s,
                                         b == 0 and (s != 1 or cin != cout)))
                cin = cout
            stages.append(nn.Sequential(*blocks))
            cout *= 2
        self.res_layers = nn.ModuleList(stages)
        self.out_head = DeconvHead(cin, joints, filters)

    def forward(self, x):
        x = F.max_pool2d(self.stem(x), 3, 2, 1)
        for stage in self.res_layers:
            x = stage(x)
        y = self.out_head(x)
        return y.to(torch.promote_types(y.dtype, torch.float32))


def build(model: dict) -> PoseResNet50:
    """The reference from the configuration file's ``model`` entry."""
    if model["depth"] != 50:
        raise ValueError("the reference is ResNet-50")
    return PoseResNet50(model["output_channel"])
