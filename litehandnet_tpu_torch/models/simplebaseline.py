"""SimpleBaseline: a ResNet or MobileNetV2 backbone and the deconv head
(port of ``litehandnet_tpu/models/simplebaseline.py``; reference
``SimpleBaseline/{resnet.py, mobilenetv2.py, deconv_head.py}``, "Simple
Baselines for Human Pose Estimation", Xiao et al.).

Backbone -> 3 x (4x4 stride-2 ConvTranspose + BN + ReLU) -> 1x1 head.
Submodule names are the reference torch names that
``utils/torch_import.py`` encodes (``RULES['resnet']`` :242-270,
``RULES['mobilenetv2']`` :275-294, ``_DECONV_HEAD``): ``stem.conv.{0,1}``,
``res_layers.{s}.{b}.conv.{k}`` and ``downsample``, ``conv1``,
``layer{i}.{b}.conv.{k}.conv.{0,1}``, ``conv2``,
``out_head.deconv_layers.{k}`` and ``out_head.final_layer``.
"""

from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import BatchNorm, Conv, head_output


class CBL(nn.Module):
    """Biasless conv + BN + ReLU6 (resnet.py:5-16), as ``conv.{0,1,2}``."""

    def __init__(self, in_channels, features, kernel=1, stride=1, padding=0,
                 groups=1):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(in_channels, features, kernel, stride, padding,
                 groups=groups, bias=False),
            BatchNorm(features), nn.ReLU6())

    def forward(self, x):
        return self.conv(x)


class _ResBlock(nn.Module):
    """``relu(skip + conv(x))``; the skip is a biasless 1x1 conv + BN
    (``downsample``) where the block projects."""

    def __init__(self, conv: nn.Sequential, in_channels, features, stride,
                 project):
        super().__init__()
        self.conv = conv
        self.downsample = (
            nn.Sequential(Conv(in_channels, features, 1, stride, bias=False),
                          BatchNorm(features))
            if project else None)

    def forward(self, x):
        skip = x if self.downsample is None else self.downsample(x)
        return F.relu(skip + self.conv(x))


class ResBasicBlock(_ResBlock):
    """Biased 3x3 conv pair (resnet.py:37-49)."""

    expansion = 1

    def __init__(self, in_channels, features, stride=1, project=False):
        super().__init__(nn.Sequential(
            Conv(in_channels, features, 3, stride, 1), BatchNorm(features),
            nn.ReLU(), Conv(features, features, 3, 1, 1), BatchNorm(features)),
            in_channels, features, stride, project)


class ResBottleneck(_ResBlock):
    """1x1 -> 3x3 -> 1x1 with biased convs and in / 4 mid channels
    (resnet.py:19-34): the reference derives the mid width from the block's
    input, not its output."""

    expansion = 4

    def __init__(self, in_channels, features, stride=1, project=False):
        mid = in_channels // 4
        super().__init__(nn.Sequential(
            Conv(in_channels, mid, 1), BatchNorm(mid), nn.ReLU(),
            Conv(mid, mid, 3, stride, 1), BatchNorm(mid), nn.ReLU(),
            Conv(mid, features, 1), BatchNorm(features)),
            in_channels, features, stride, project)


class DeconvHead(nn.Module):
    """3 x (4x4 stride-2 ConvTranspose + BN + ReLU), then a biased conv
    (deconv_head.py:19-129). Torch's ``ConvTranspose2d(4, 2, 1)`` is flax's
    ``ConvTranspose(padding="SAME")`` with the kernel flipped in both spatial
    axes; ``utils.weights`` flips it on load."""

    def __init__(self, in_channels, out_channels,
                 num_deconv_filters: Sequence[int] = (256, 256, 256),
                 final_conv_kernel: int = 1):
        super().__init__()
        layers = []
        for f in num_deconv_filters:
            layers += [nn.ConvTranspose2d(in_channels, f, 4, 2, 1, bias=False),
                       BatchNorm(f), nn.ReLU()]
            in_channels = f
        self.deconv_layers = nn.Sequential(*layers)
        self.final_layer = Conv(in_channels, out_channels, final_conv_kernel,
                                1, (final_conv_kernel - 1) // 2)

    def forward(self, x):
        return self.final_layer(self.deconv_layers(x))


class PoseResNet(nn.Module):
    """ResNet-{18,34,50,101,152} + DeconvHead (resnet.py:86-171)."""

    ARCH = {
        18: (ResBasicBlock, (2, 2, 2, 2)),
        34: (ResBasicBlock, (3, 4, 6, 3)),
        50: (ResBottleneck, (3, 4, 6, 3)),
        101: (ResBottleneck, (3, 4, 23, 3)),
        152: (ResBottleneck, (3, 8, 36, 3)),
    }

    def __init__(self, depth=50, num_joints=21, stem_channels=64,
                 base_channels=64, strides: Sequence[int] = (1, 2, 2, 2),
                 deep_stem=False, num_stages=4):
        super().__init__()
        block, stage_blocks = self.ARCH[depth]
        if deep_stem:
            half = stem_channels // 2
            self.stem = nn.Sequential(CBL(3, half, 3, 2, 1),
                                      CBL(half, half, 3, 1, 1),
                                      CBL(half, stem_channels, 3, 1, 1))
        else:
            self.stem = CBL(3, stem_channels, 7, 2, 3)
        # the JAX stem pads the max pool with -inf (simplebaseline.py:186)
        self.maxpool = nn.MaxPool2d(3, 2, 1)
        in_ch, out_ch = stem_channels, base_channels * block.expansion
        stages = []
        for stage in range(num_stages):
            blocks = []
            for b in range(stage_blocks[stage]):
                stride = strides[stage] if b == 0 else 1
                project = b == 0 and (stride != 1 or in_ch != out_ch)
                blocks.append(block(in_ch, out_ch, stride, project))
                in_ch = out_ch
            stages.append(nn.Sequential(*blocks))
            out_ch *= 2
        self.res_layers = nn.ModuleList(stages)
        self.out_head = DeconvHead(in_ch, num_joints)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "PoseResNet":
        del deploy  # no Rep modules in this family
        m = cfg.MODEL
        return cls(
            depth=m.get("depth", 50),
            num_joints=m.get("output_channel", cfg.DATASET.num_joints),
            stem_channels=m.get("stem_channels", 64),
            base_channels=m.get("base_channels", 64),
            strides=tuple(m.get("strides", (1, 2, 2, 2))),
            deep_stem=m.get("deep_stem", False),
            num_stages=m.get("num_stages", 4),
        )

    def forward(self, x):
        x = self.maxpool(self.stem(x))
        for stage in self.res_layers:
            x = stage(x)
        return head_output(self.out_head(x))


def make_divisible(value, divisor, min_value=None, min_ratio=0.9):
    """Channel rounding (mobilenetv2.py:6-29)."""
    if min_value is None:
        min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < min_ratio * value:
        new_value += divisor
    return new_value


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual (mobilenetv2.py:45-71): expand (when
    ``expand_ratio`` != 1), depthwise, project, each a CBL, as ``conv``."""

    def __init__(self, in_channels, features, stride, expand_ratio):
        super().__init__()
        hidden = int(round(in_channels * expand_ratio))
        layers = [] if expand_ratio == 1 else [CBL(in_channels, hidden)]
        layers += [CBL(hidden, hidden, 3, stride, 1, groups=hidden),
                   CBL(hidden, features)]
        self.conv = nn.Sequential(*layers)
        self.use_res = stride == 1 and in_channels == features

    def forward(self, x):
        out = self.conv(x)
        return x + out if self.use_res else out


class PoseMobileNetV2(nn.Module):
    """MobileNetV2 + DeconvHead (mobilenetv2.py:74-189)."""

    # (expand ratio, channels, blocks, stride) of layer1..layer7
    ARCH = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, num_joints=21, widen_factor=1.0):
        super().__init__()
        in_ch = make_divisible(32 * widen_factor, 8)
        self.conv1 = CBL(3, in_ch, 3, 2, 1)
        for i, (expand, channels, blocks, stride) in enumerate(self.ARCH):
            out_ch = make_divisible(channels * widen_factor, 8)
            layer = []
            for b in range(blocks):
                layer.append(InvertedResidual(in_ch, out_ch,
                                              stride if b == 0 else 1, expand))
                in_ch = out_ch
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
        out_ch = int(1280 * max(widen_factor, 1.0))
        self.conv2 = CBL(in_ch, out_ch)
        self.out_head = DeconvHead(out_ch, num_joints)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "PoseMobileNetV2":
        del deploy  # no Rep modules in this family
        m = cfg.MODEL
        return cls(num_joints=m.get("output_channel", cfg.DATASET.num_joints),
                   widen_factor=m.get("widen_factor", 1.0))

    def forward(self, x):
        x = self.conv1(x)
        for i in range(len(self.ARCH)):
            x = getattr(self, f"layer{i + 1}")(x)
        return head_output(self.out_head(self.conv2(x)))
