"""MultiScaleAttentionHourglass, registry name ``mynet`` (port of
``litehandnet_tpu/models/ms_att_hourglass.py``; reference
``pose_hg_ms_att.py:225-257``).

Pelee-style stride-4 stem -> one encoder-decoder hourglass with ME_att
multi-scale attention blocks at entry and exit and plain-conv residual
towers inside -> BottleNeck features -> 1x1 head. Input ``[B, 3, H, W]`` ->
heatmaps ``[B, K, H/4, W/4]`` float32. No Rep modules: the served graph is
the train graph in eval mode. Submodule names are the reference torch names
that ``utils/torch_import.py::_mynet_rules`` (:523-588) encodes: Sequential
indices for conv / BN / activation triples (``pre.conv1.0/1/3/4``,
``blocks.j.conv.0/1/3/4/6/7``), ``depthwise_conv`` / ``pointwise_conv``,
BRC's ``bn`` and ``conv``, the ME_att gate ``att.1/3/6``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    Dropout,
    adaptive_avg_pool,
    head_output,
    leaky_relu,
    max_pool2,
    resize_nearest,
)


class PlainDWConv(nn.Module):
    """Depthwise 3x3 + pointwise 1x1, each conv -> BN -> ReLU
    (pose_hg_ms_att.py:7-23)."""

    def __init__(self, in_channels, features, stride=1, padding=1, dilation=1):
        super().__init__()
        self.depthwise_conv = nn.Sequential(
            Conv(in_channels, in_channels, 3, stride, padding, dilation,
                 groups=in_channels, bias=False),
            BatchNorm(in_channels),
            nn.ReLU(),
        )
        self.pointwise_conv = nn.Sequential(
            Conv(in_channels, features, 1, bias=False),
            BatchNorm(features),
            nn.ReLU(),
        )

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class PlainBottleNeck(nn.Module):
    """1x1 -> 3x3 -> 1x1 residual at channels / 4 (pose_hg_ms_att.py:25-40)."""

    def __init__(self, channels):
        super().__init__()
        mid = channels // 4
        self.conv = nn.Sequential(
            Conv(channels, mid, 1), BatchNorm(mid), nn.ReLU(),
            Conv(mid, mid, 3, 1, 1), BatchNorm(mid), nn.ReLU(),
            Conv(mid, channels, 1), BatchNorm(channels),
        )

    def forward(self, x):
        return F.relu(x + self.conv(x))


class PlainBasicBlock(nn.Module):
    """3x3 pair with a projection skip (pose_hg_ms_att.py:43-63)."""

    def __init__(self, in_channels, features, stride=1):
        super().__init__()
        self.conv = nn.Sequential(
            Conv(in_channels, features, 3, stride, 1), BatchNorm(features),
            nn.ReLU(),
            Conv(features, features, 3, 1, 1), BatchNorm(features),
        )
        if stride == 2 or in_channels != features:
            self.skip_layer = nn.Sequential(
                Conv(in_channels, features, 1, stride, 0), BatchNorm(features))
        else:
            self.skip_layer = None

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return F.relu(skip + self.conv(x))


class PlainResidual(nn.Module):
    """BasicBlock + BottleNecks (pose_hg_ms_att.py:65-74)."""

    def __init__(self, in_channels, features, stride=1, num_block=2):
        super().__init__()
        self.conv1 = PlainBasicBlock(in_channels, features, stride)
        self.blocks = nn.Sequential(*[PlainBottleNeck(features)
                                      for _ in range(num_block)])

    def forward(self, x):
        return self.blocks(self.conv1(x))


class BRC(nn.Module):
    """BN -> activation (SiLU by default) -> conv (pose_hg_ms_att.py:76-90)."""

    def __init__(self, in_channels, features, kernel=3, stride=1, padding=1,
                 bias=False, act=F.silu):
        super().__init__()
        self.act = act
        self.bn = BatchNorm(in_channels)
        self.conv = Conv(in_channels, features, kernel, stride, padding,
                         bias=bias)

    def forward(self, x):
        return self.conv(self.act(self.bn(x)))


class RCAGate(nn.Sequential):
    """3x3-pooled gate: BN -> ReLU -> depthwise 3x3 to 1x1 -> dropout (0.3,
    element-wise) -> Linear -> sigmoid, times the input. ME_att's gate
    (``att_bn``/``att_conv``/``att_fc`` in JAX) and JAX
    ``hourglass_ablation.RCAGate`` (:33-53); Sequential indices 1, 3, 6 are
    the reference's ``att.1/3/6``."""

    def __init__(self, features):
        super().__init__(
            nn.AdaptiveAvgPool2d((3, 3)),
            BatchNorm(features),
            nn.ReLU(),
            Conv(features, features, 3, 1, 0, groups=features),
            nn.Flatten(),
            Dropout(0.3),
            nn.Linear(features, features),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return x * super().forward(x)[:, :, None, None]


class MEAttBody(nn.Module):
    """The trunk of ME_att shared by ``MEAtt`` and the ablation's variant:
    BRC 1x1 to half width, two rounds of a plain and a dilated DWConv pair
    concatenated, residual, BRC 1x1 (pose_hg_ms_att.py:135-168). ``act`` is
    the BRCs' activation."""

    def __init__(self, in_channels, features, act=F.silu):
        super().__init__()
        mid_c = in_channels // 2
        self.conv1 = BRC(in_channels, mid_c, 1, 1, 0, act=act)
        mid1, mid2 = [], []
        c_in = mid_c
        for i in range(2):
            c_out = mid_c // 2 if i == 0 else mid_c
            mid1.append(nn.Sequential(PlainDWConv(c_in, c_out),
                                      PlainDWConv(c_out, c_out)))
            mid2.append(nn.Sequential(
                PlainDWConv(c_in, c_out, dilation=2, padding=2),
                PlainDWConv(c_out, c_out)))
            c_in = 2 * c_out
        self.mid1_conv = nn.ModuleList(mid1)
        self.mid2_conv = nn.ModuleList(mid2)
        self.conv2 = BRC(in_channels, features, 1, 1, 0, act=act)

    def trunk(self, x):
        m = self.conv1(x)
        for p1, p2 in zip(self.mid1_conv, self.mid2_conv):
            m = torch.cat([p1(m), p2(m)], dim=1)
        return self.conv2(m + x)


class MEAtt(MEAttBody):
    """Multi-scale attention block with the 3x3-pooled gate
    (pose_hg_ms_att.py:135-187)."""

    def __init__(self, in_channels, features):
        super().__init__(in_channels, features)
        self.att = RCAGate(features)

    def forward(self, x):
        return self.att(self.trunk(x))


class PeleeStem(nn.Module):
    """Stride-4 stem (pose_hg_ms_att.py:190-222)."""

    def __init__(self, in_channels=3, features=256, min_mid=32):
        super().__init__()
        mid = max(features // 4, min_mid)
        self.conv1 = nn.Sequential(
            Conv(in_channels, mid, 3, 2, 1, bias=False), BatchNorm(mid),
            nn.LeakyReLU(),
            Conv(mid, mid, 3, 1, 1, groups=mid, bias=False), BatchNorm(mid),
            nn.LeakyReLU(),
        )
        self.branch1 = nn.Sequential(
            Conv(mid, mid, 1), BatchNorm(mid), nn.ReLU(),
            Conv(mid, mid, 3, 2, 1), BatchNorm(mid), nn.ReLU(),
        )
        self.conv1x1 = Conv(2 * mid, features, 1)

    def forward(self, x):
        x = self.conv1(x)
        return self.conv1x1(torch.cat([self.branch1(x), max_pool2(x)], dim=1))


def hourglass_forward(encoder, decoder, x):
    """The encoder-decoder pass of mynet and the ablation: encoder outputs
    kept, the first one average-pooled into the bottleneck as a shortcut,
    each decoder output resized up and added to its counterpart. Returns the
    decoder outputs."""
    out_encoder = []
    for layer in encoder:
        x = layer(x)
        out_encoder.append(x)
    shortcut = adaptive_avg_pool(out_encoder[0], out_encoder[-1].shape[2:])
    out_decoder = []
    for i, layer in enumerate(decoder):
        counterpart = out_encoder[len(encoder) - 1 - i]
        if i == 0:
            x = layer(counterpart) + shortcut
        else:
            x = resize_nearest(layer(x), counterpart.shape[2:]) + counterpart
        out_decoder.append(x)
    return tuple(out_decoder)


class MSAttEncoderDecoder(nn.Module):
    """Hourglass with ME_att entry and exit (pose_hg_ms_att.py:93-132)."""

    def __init__(self, num_levels=4, features=128,
                 num_blocks: Sequence[int] = (2, 2, 2)):
        super().__init__()
        if len(num_blocks) != num_levels - 1:
            raise ValueError(
                f"num_block needs {num_levels - 1} entries, got {num_blocks}")
        f = features
        self.encoder = nn.ModuleList(
            [MEAtt(f, f)]
            + [PlainResidual(f, f, 2, num_blocks[i])
               for i in range(num_levels - 1)])
        self.decoder = nn.ModuleList(
            [PlainResidual(f, f, 1, 2) for _ in range(num_levels - 1)]
            + [MEAtt(f, f)])

    def forward(self, x):
        return hourglass_forward(self.encoder, self.decoder, x)


def features_head(features: int) -> nn.Sequential:
    """BottleNeck -> 1x1 conv -> BN -> leaky ReLU (``features.0/1/2``)."""
    return nn.Sequential(PlainBottleNeck(features), Conv(features, features, 1),
                         BatchNorm(features), nn.LeakyReLU())


class MSAttHourglass(nn.Module):
    """Single-stage mynet (pose_hg_ms_att.py:225-257).

    Config keys (``cfg.MODEL``): num_stage, input_channel, output_channel,
    num_block, and ``output_acitivation`` (the reference's spelling, read as
    JAX reads it): a leaky ReLU of slope 0.5 on the heatmaps.
    """

    def __init__(self, num_joints=21, num_stage=4, features=128,
                 num_blocks: Sequence[int] = (2, 2, 2),
                 with_activation=False):
        super().__init__()
        self.with_activation = with_activation
        self.pre = PeleeStem(3, features)
        self.hgs = MSAttEncoderDecoder(num_stage, features, tuple(num_blocks))
        self.features = features_head(features)
        self.outs = Conv(features, num_joints, 1)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "MSAttHourglass":
        del deploy  # no Rep modules: one graph
        m = cfg.MODEL
        return cls(
            num_joints=m.get("output_channel", cfg.DATASET.num_joints),
            num_stage=m.get("num_stage", 4),
            features=m.get("input_channel", 128),
            num_blocks=tuple(m.get("num_block", [2, 2, 2])),
            with_activation=m.get("output_acitivation", False),
        )

    def forward(self, imgs):
        x = self.hgs(self.pre(imgs))[-1]
        preds = head_output(self.outs(self.features(x)))
        return leaky_relu(preds, 0.5) if self.with_activation else preds
