"""LiteHandNet, the flagship lightweight hourglass (port of
``litehandnet_tpu/models/litehandnet.py``; reference ``liteHandNet.py``).

Stem (RepBlock 3x3-s2 + 7x7 depthwise, dual-branch downsample) -> one
encoder-decoder hourglass with MSAB blocks at entry and exit -> BottleNeck
features -> 1x1 head. Input ``[B, 3, H, W]`` -> heatmaps
``[B, K, H/4, W/4]`` float32. Submodule names are the reference torch names
(``pre``, ``hgs``, ``features``, ``out_layer``).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    Activation,
    ChannelAttention,
    Conv,
    RepBlock,
    RepConv,
    SEBlock,
    adaptive_avg_pool,
    get_activation,
    leaky_relu,
    max_pool2,
    repconv_act,
    resize_nearest,
)


class DWConv(nn.Module):
    """Depthwise-separable conv from RepConvs (reference liteHandNet.py:8-21)."""

    def __init__(self, in_channels, features, stride=1, padding=1, dilation=1,
                 act: Activation = leaky_relu, deploy=False):
        super().__init__()
        act = repconv_act(act, inplace=False)  # liteHandNet.py:14-17
        self.depthwise_conv = RepConv(
            in_channels, in_channels, 3, stride, padding, dilation,
            groups=in_channels, act=act, deploy=deploy,
        )
        self.pointwise_conv = RepConv(in_channels, features, 1, act=act,
                                      deploy=deploy)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class BottleNeck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual bottleneck (reference liteHandNet.py:23-37)."""

    def __init__(self, features, reduction=4, act: Activation = leaky_relu,
                 deploy=False):
        super().__init__()
        mid = features // reduction
        a = repconv_act(act, inplace=True)  # liteHandNet.py:28-33
        self.act = act
        self.conv = nn.Sequential(
            RepConv(features, mid, 1, act=a, deploy=deploy),
            RepConv(mid, mid, 3, 1, 1, act=a, deploy=deploy),
            RepConv(mid, features, 1, act=None, deploy=deploy),
        )

    def forward(self, x):
        return self.act(x + self.conv(x))


class BasicBlock(nn.Module):
    """3x3 pair + projection skip (reference liteHandNet.py:39-54)."""

    def __init__(self, in_channels, features, stride=1,
                 act: Activation = leaky_relu, deploy=False):
        super().__init__()
        self.act = act
        self.conv = nn.Sequential(
            RepConv(in_channels, features, 3, stride, 1,
                    act=repconv_act(act, inplace=True),  # liteHandNet.py:42-47
                    deploy=deploy),
            RepConv(features, features, 3, 1, 1, act=None, deploy=deploy),
        )
        if stride == 2 or in_channels != features:
            self.skip_layer = RepConv(in_channels, features, 1, stride, 0,
                                      act=None, deploy=deploy)
        else:
            self.skip_layer = None

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return self.act(skip + self.conv(x))


class Residual(nn.Module):
    """BasicBlock + BottleNeck stack (reference liteHandNet.py:57-68)."""

    def __init__(self, in_channels, features, stride=2, num_block=2,
                 reduction=2, act: Activation = leaky_relu, deploy=False):
        super().__init__()
        self.conv1 = BasicBlock(in_channels, features, stride, act, deploy)
        self.blocks = nn.Sequential(*[
            BottleNeck(features, reduction, act, deploy)
            for _ in range(num_block)
        ])

    def forward(self, x):
        return self.blocks(self.conv1(x))


class MSAB(nn.Module):
    """Multi-scale attention block: split-channel dual-dilation DWConv paths,
    two rounds, residual, channel attention (reference liteHandNet.py:116-166).
    """

    def __init__(self, in_channels, features, ca_type="ca",
                 act: Activation = leaky_relu, deploy=False):
        super().__init__()
        mid_c = in_channels // 2
        msab_act = repconv_act(act, inplace=True)  # liteHandNet.py:124,145
        self.conv1 = RepConv(in_channels, mid_c, 1, act=msab_act,
                             deploy=deploy)
        mid1, mid2 = [], []
        c_in = mid_c
        for i in range(2):
            c_out = mid_c // 2 if i == 0 else mid_c
            # path 1: plain DWConv pair; path 2: dilated DWConv then plain
            mid1.append(nn.Sequential(
                DWConv(c_in, c_out, act=act, deploy=deploy),
                DWConv(c_out, c_out, act=act, deploy=deploy),
            ))
            mid2.append(nn.Sequential(
                DWConv(c_in, c_out, dilation=2, padding=2, act=act,
                       deploy=deploy),
                DWConv(c_out, c_out, act=act, deploy=deploy),
            ))
            c_in = 2 * c_out
        self.mid1_conv = nn.ModuleList(mid1)
        self.mid2_conv = nn.ModuleList(mid2)
        self.conv2 = RepConv(in_channels, features, 1, act=msab_act,
                             deploy=deploy)
        if ca_type == "se":
            self.ca = SEBlock(features, max(features // 16, 1))
        elif ca_type == "ca":
            self.ca = ChannelAttention(features, deploy=deploy)
        else:
            self.ca = None

    def forward(self, x):
        m = self.conv1(x)
        for p1, p2 in zip(self.mid1_conv, self.mid2_conv):
            m = torch.cat([p1(m), p2(m)], dim=1)
        out = self.conv2(m + x)
        return out if self.ca is None else self.ca(out)


class Stem(nn.Module):
    """Stride-4 stem with dual-branch downsample (reference
    liteHandNet.py:169-193)."""

    def __init__(self, in_channels=3, features=256, min_mid=32,
                 act: Activation = leaky_relu, deploy=False):
        super().__init__()
        mid = max(features // 4, min_mid)
        self.conv1 = nn.Sequential(
            RepBlock(in_channels, mid, 3, 2, 1, act=act, deploy=deploy),
            RepBlock(mid, mid, 7, 1, 3, groups=mid, act=act, deploy=deploy),
        )
        b_act = repconv_act(act, inplace=True)  # liteHandNet.py:181-184
        self.branch1 = nn.Sequential(
            RepConv(mid, mid, 1, 1, 0, act=b_act, deploy=deploy),
            RepConv(mid, mid, 3, 2, 1, act=b_act, deploy=deploy),
        )
        self.conv1x1 = Conv(2 * mid, features, 1)

    def forward(self, x):
        x = self.conv1(x)
        out = torch.cat([self.branch1(x), max_pool2(x)], dim=1)
        return self.conv1x1(out)


class EncoderDecoder(nn.Module):
    """One hourglass with MSAB at entry and exit and an average-pooled
    shortcut into the bottleneck (reference liteHandNet.py:71-113)."""

    def __init__(self, num_levels=4, features=128, num_blocks=(2, 2, 2),
                 ca_type="ca", reduction=2, act: Activation = leaky_relu,
                 deploy=False):
        super().__init__()
        if len(num_blocks) != num_levels - 1:
            raise ValueError(
                f"num_block needs {num_levels - 1} entries, got {num_blocks}"
            )
        f = features
        self.num_levels = num_levels
        self.encoder = nn.ModuleList(
            [MSAB(f, f, ca_type, act, deploy)]
            + [Residual(f, f, 2, num_blocks[i], reduction, act, deploy)
               for i in range(num_levels - 1)]
        )
        self.decoder = nn.ModuleList(
            [Residual(f, f, 1, num_blocks[i], reduction, act, deploy)
             for i in range(num_levels - 1)]
            + [MSAB(f, f, ca_type, act, deploy)]
        )

    def forward(self, x):
        out_encoder = []
        for layer in self.encoder:
            x = layer(x)
            out_encoder.append(x)
        shortcut = adaptive_avg_pool(out_encoder[0], out_encoder[-1].shape[2:])
        for i, layer in enumerate(self.decoder):
            counterpart = out_encoder[self.num_levels - 1 - i]
            if i == 0:
                x = layer(counterpart) + shortcut
            else:
                x = resize_nearest(layer(x), counterpart.shape[2:]) + counterpart
        return x


class LiteHandNet(nn.Module):
    """Flagship model (reference liteHandNet.py:196-244).

    Config keys (``cfg.MODEL``): num_stage, input_channel, output_channel,
    num_block, ca_type in {ca, se, none}, reduction in {2, 4}, activation.
    """

    def __init__(self, num_joints=21, num_stage=4, features=128,
                 num_blocks: Sequence[int] = (2, 2, 2), ca_type="ca",
                 reduction=2, activation="leakyrelu", deploy=False):
        super().__init__()
        act = get_activation(activation)
        self.deploy = deploy
        self.pre = Stem(3, features, act=act, deploy=deploy)
        self.hgs = EncoderDecoder(num_stage, features, tuple(num_blocks),
                                  ca_type, reduction, act, deploy)
        self.features = nn.Sequential(
            BottleNeck(features, 2, act, deploy),
            RepConv(features, features, 1, 1, 0,
                    act=repconv_act(act, inplace=True),  # liteHandNet.py:224
                    deploy=deploy),
        )
        self.out_layer = Conv(features, num_joints, 1)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "LiteHandNet":
        m = cfg.MODEL
        return cls(
            num_joints=m.get("output_channel", cfg.DATASET.num_joints),
            num_stage=m.get("num_stage", 4),
            features=m.get("input_channel", 128),
            num_blocks=tuple(m.get("num_block", [2, 2, 2])),
            ca_type=m.get("ca_type", "ca"),
            reduction=m.get("reduction", 2),
            activation=m.get("activation", "leakyrelu"),
            deploy=deploy,
        )

    def forward(self, imgs):
        x = self.hgs(self.pre(imgs))
        return self.out_layer(self.features(x)).float()
