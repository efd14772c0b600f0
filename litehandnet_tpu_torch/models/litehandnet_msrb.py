"""LiteHandNet MSRB, the alternative flagship (port of
``litehandnet_tpu/models/litehandnet_msrb.py``; reference
``liteHandNet/litehourglass.py:13-237`` and ``repblocks.py:239-295``).

Shuffle stem -> a max-pool encoder / nearest-resize decoder of MSRB blocks
(split-channel dual-dilation depthwise RepConvs with a channel attention on
the residual) and RepBasicUnits (ShuffleNetV2 split units) -> two RBU neck
units -> 1x1 head. Input ``[B, 3, H, W]`` -> heatmaps ``[B, K, H/4, W/4]``
float32. Every conv but the head is a RepConv, so ``reparam.fuse_params``
gives the deploy graph. Submodule names are the reference torch names that
``utils/torch_import.py`` encodes (``_litehandnet_msrb_rules`` :800-838):
``stem.{conv1,branch1,conv2}``, ``backone.{encoder,decoder}.{i}.{0,1}``
(the reference's spelling), ``neck.{0,1}`` and ``head``.
"""

from __future__ import annotations

import torch
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    Activation,
    ChannelAttention,
    Conv,
    RepConv,
    SEBlock,
    adaptive_avg_pool,
    channel_shuffle,
    head_output,
    max_pool2,
    relu,
    resize_nearest,
)


def _ca(ca_type: str, channels: int, deploy: bool):
    """The channel attention of an MSRB or RBU (``litehandnet_msrb.py:31``):
    ``se``, ``ca`` or none."""
    if ca_type == "se":
        return SEBlock(channels, max(channels // 16, 1))
    if ca_type == "ca":
        return ChannelAttention(channels, deploy=deploy)
    return None


class MSRB(nn.Module):
    """Split-channel dual-dilation rep block (reference
    litehourglass.py:13-50): two rounds of {plain depthwise | dilation-2
    depthwise} RepConvs over the channel halves with a channel attention on
    the residual, then a 1x1 ReLU RepConv ``conv`` of ``out + x``."""

    def __init__(self, in_channels, features, ca_type="none", deploy=False):
        super().__init__()
        half = in_channels // 2
        rest = in_channels - half
        self.half = half
        self.branch1 = nn.ModuleList(
            RepConv(half, half, 3, 1, 1, groups=half, act=None, deploy=deploy)
            for _ in range(2))
        self.branch2 = nn.ModuleList(
            RepConv(rest, rest, 3, 1, 2, dilation=2, groups=rest, act=None,
                    deploy=deploy)
            for _ in range(2))
        cas = [_ca(ca_type, in_channels, deploy) for _ in range(2)]
        self.ca = nn.ModuleList(cas) if cas[0] is not None else None
        # default act -> effective ReLU (repblocks.py:30)
        self.conv = RepConv(in_channels, features, 1, 1, 0, act=relu,
                            deploy=deploy)

    def forward(self, x):
        out = x
        for i in range(2):
            left, right = out[:, :self.half], out[:, self.half:]
            merged = torch.cat([self.branch1[i](left), self.branch2[i](right)],
                               dim=1)
            if self.ca is not None:
                merged = self.ca[i](merged)
            out = out + merged
        return self.conv(out + x)


class RepBasicUnit(nn.Module):
    """ShuffleNetV2-style split unit with channel attention (reference
    litehourglass.py:52-79, repblocks.py:239-272): the left half passes,
    the right half goes through a 1x1 and a depthwise 3x3 ReLU RepConv
    (``conv.{0,1}``); then ``ca`` on the concatenation."""

    def __init__(self, in_channels, features, ca_type="ca", deploy=False):
        super().__init__()
        self.left_part = in_channels // 2
        right_out = features - self.left_part
        self.conv = nn.Sequential(
            RepConv(in_channels - self.left_part, right_out, 1, act=relu,
                    deploy=deploy),
            RepConv(right_out, right_out, 3, 1, 1, groups=right_out, act=relu,
                    deploy=deploy),
        )
        self.ca = _ca(ca_type, features, deploy)

    def forward(self, x):
        left, right = x[:, :self.left_part], x[:, self.left_part:]
        out = torch.cat([left, self.conv(right)], dim=1)
        return out if self.ca is None else self.ca(out)


class RepDownsampleUnit(nn.Module):
    """ShuffleNetV2 downsample unit (reference repblocks.py:274-295): a
    1x1 -> depthwise 3x3 stride 2 -> 1x1 right branch (``r1``-``r3``) and a
    depthwise 3x3 stride 2 -> 1x1 left branch (``l1``, ``l2``), channel
    shuffled. The default activation is exact ReLU, as in the reference."""

    def __init__(self, channels, act: Activation = relu, deploy=False):
        super().__init__()
        C = channels
        self.r1 = RepConv(C, C, 1, 1, 0, act=act, deploy=deploy)
        self.r2 = RepConv(C, C, 3, 2, 1, groups=C, act=None, deploy=deploy)
        self.r3 = RepConv(C, C, 1, 1, 0, act=act, deploy=deploy)
        self.l1 = RepConv(C, C, 3, 2, 1, groups=C, act=None, deploy=deploy)
        self.l2 = RepConv(C, C, 1, 1, 0, act=act, deploy=deploy)

    def forward(self, x):
        r = self.r3(self.r2(self.r1(x)))
        left = self.l2(self.l1(x))
        return channel_shuffle(torch.cat([r, left], dim=1), 2)


class DWConvELAN(nn.Module):
    """ELAN-style rep block (reference litehourglass.py:81-106): two chains
    of depthwise 3x3 / 1x1 ReLU RepConvs (``c1a``-``c1d``, ``c2a``-``c2d``)
    over the first half, the input and both chains concatenated into a 1x1
    biased ``proj``, channel shuffled."""

    def __init__(self, in_channels, features, deploy=False):
        super().__init__()
        mid = in_channels // 2
        self.mid = mid
        for name in ("c1", "c2"):
            self.add_module(f"{name}a", RepConv(mid, mid, 3, 1, 1, groups=mid,
                                                act=None, deploy=deploy))
            self.add_module(f"{name}b", RepConv(mid, mid, 1, act=relu,
                                                deploy=deploy))
            self.add_module(f"{name}c", RepConv(mid, mid, 3, 1, 1, groups=mid,
                                                act=None, deploy=deploy))
            self.add_module(f"{name}d", RepConv(mid, mid, 1, act=relu,
                                                deploy=deploy))
        self.proj = Conv(in_channels + 2 * mid, features, 1)

    def _chain(self, z, name):
        for k in "abcd":
            z = getattr(self, f"{name}{k}")(z)
        return z

    def forward(self, x):
        out1 = self._chain(x[:, :self.mid], "c1")
        out2 = self._chain(out1, "c2")
        return channel_shuffle(self.proj(torch.cat([x, out1, out2], dim=1)), 2)


class Stem(nn.Module):
    """Stride-4 shuffle stem (reference litehourglass.py:166-190):
    ``conv1`` (3x3 s2, depthwise 3x3), ``branch1`` (1x1, depthwise 3x3 s2,
    1x1) beside a 2x2 max pool, then ``conv2`` (1x1 projection and two
    RBUs whose attention is always ``ca``)."""

    def __init__(self, features, deploy=False):
        super().__init__()
        mid = max(features // 4, 32)
        self.conv1 = nn.Sequential(
            RepConv(3, mid, 3, 2, 1, act=relu, deploy=deploy),
            RepConv(mid, mid, 3, 1, 1, groups=mid, act=relu, deploy=deploy),
        )
        self.branch1 = nn.Sequential(
            RepConv(mid, mid, 1, act=relu, deploy=deploy),
            RepConv(mid, mid, 3, 2, 1, groups=mid, act=None, deploy=deploy),
            RepConv(mid, mid, 1, act=relu, deploy=deploy),
        )
        # the stem RBUs hard-code ca (litehourglass.py:182-186)
        self.conv2 = nn.Sequential(
            RepConv(2 * mid, features, 1, act=relu, deploy=deploy),
            RepBasicUnit(features, features, "ca", deploy),
            RepBasicUnit(features, features, "ca", deploy),
        )

    def forward(self, x):
        x = self.conv1(x)
        return self.conv2(torch.cat([self.branch1(x), max_pool2(x)], dim=1))


def _stage(i, features, msrb_ca, rbu_ca, deploy) -> nn.Sequential:
    """Level ``i`` of the encoder or decoder: MSRB + RBU at level 0, two
    RBUs elsewhere (litehourglass.py:108-163)."""
    C = features
    if i == 0:
        return nn.Sequential(MSRB(C, C, msrb_ca, deploy),
                             RepBasicUnit(C, C, rbu_ca, deploy))
    return nn.Sequential(RepBasicUnit(C, C, rbu_ca, deploy),
                         RepBasicUnit(C, C, rbu_ca, deploy))


class Backbone(nn.Module):
    """The max-pool encoder and nearest-resize decoder (reference
    litehourglass.py:108-163), the reference's ``backone``."""

    def __init__(self, num_stage, features, msrb_ca, rbu_ca, deploy=False):
        super().__init__()
        self.encoder = nn.ModuleList(
            _stage(i, features, msrb_ca, rbu_ca, deploy)
            for i in range(num_stage))
        self.decoder = nn.ModuleList(
            _stage(i, features, msrb_ca, rbu_ca, deploy)
            for i in range(num_stage))

    def forward(self, x):
        n = len(self.encoder)
        out_encoder = []
        for i, stage in enumerate(self.encoder):
            x = stage(x)
            out_encoder.append(x)
            if i != n - 1:
                x = max_pool2(x)
        x = self.decoder[n - 1](out_encoder[-1]) + adaptive_avg_pool(
            out_encoder[0], out_encoder[-1].shape[2:])
        for i in range(n - 2, -1, -1):
            counterpart = out_encoder[i]
            x = self.decoder[i](resize_nearest(x, counterpart.shape[2:])
                                + counterpart)
        return x


class LiteHandNetMSRB(nn.Module):
    """Alternative LiteHandNet (reference litehourglass.py:196-237).

    Config keys (``cfg.MODEL``): num_stage, input_channel (the reference's
    default 256), output_channel, msrb_ca and rbu_ca in {ca, se, none}.
    """

    def __init__(self, num_joints=21, num_stage=4, features=128,
                 msrb_ca="ca", rbu_ca="ca", deploy=False):
        super().__init__()
        self.deploy = deploy
        self.stem = Stem(features, deploy)
        self.backone = Backbone(num_stage, features, msrb_ca, rbu_ca, deploy)
        self.neck = nn.Sequential(
            RepBasicUnit(features, features, "ca", deploy),
            RepBasicUnit(features, features, "ca", deploy),
        )
        self.head = Conv(features, num_joints, 1)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "LiteHandNetMSRB":
        m = cfg.MODEL
        return cls(
            num_joints=m.get("output_channel", cfg.DATASET.num_joints),
            num_stage=m.get("num_stage", 4),
            features=m.get("input_channel", 256),  # litehourglass.py:202
            msrb_ca=m.get("msrb_ca", "ca"),
            rbu_ca=m.get("rbu_ca", "ca"),
            deploy=deploy,
        )

    def forward(self, x):
        x = self.neck(self.backone(self.stem(x)))
        return head_output(self.head(x))
