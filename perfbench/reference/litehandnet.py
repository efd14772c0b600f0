"""Plain reference of LiteHandNet (Runki2018/litehandnet, ``liteHandNet.py``),
the train graph: RepBlocks and RepConvs as conv + BatchNorm branches, never
fused. In eval mode it computes what the deploy-fused graph computes, from
the train graph's weights.

Stem (RepBlock 3x3 s2, depthwise RepBlock 7x7, a 1x1 -> 3x3 s2 branch beside
a 2x2 max pool, 1x1 conv) -> one encoder-decoder hourglass (MSAB at entry
and exit, Residual stages, an average-pooled shortcut) -> BottleNeck + 1x1
RepConv -> 1x1 head. Activations as the reference builds them: LeakyReLU
(slope 0.01) after RepBlocks, residual sums and inside the channel gate;
none after the 1x1 / 3x3 RepConvs that pass ``inplace=True`` as the slope
(slope 1); ReLU inside DWConv (``inplace=False``, slope 0).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from perfbench.reference.common import BN, ChannelDropout, Conv


def leaky(x):
    return F.leaky_relu(x, 0.01)


class ConvBN(nn.Module):
    def __init__(self, cin, cout, k, stride=1, padding=0, dilation=1,
                 groups=1):
        super().__init__()
        self.conv = Conv(cin, cout, k, stride, padding, dilation, groups,
                         bias=False)
        self.bn = BN(cout)

    def forward(self, x):
        return self.bn(self.conv(x))


class RepConv(nn.Module):
    def __init__(self, cin, cout, k=1, stride=1, padding=0, dilation=1,
                 groups=1, act=None):
        super().__init__()
        self.conv = ConvBN(cin, cout, k, stride, padding, dilation, groups)
        self.act = act

    def forward(self, x):
        y = self.conv(x)
        return y if self.act is None else self.act(y)


class RepBlock(nn.Module):
    def __init__(self, cin, cout, k, stride, padding, groups=1):
        super().__init__()
        self.rbr_dense = ConvBN(cin, cout, k, stride, padding, 1, groups)
        self.rbr_1x1 = ConvBN(cin, cout, 1, stride, 0, 1, groups)
        self.rbr_identity = BN(cin) if cin == cout and stride == 1 else None

    def forward(self, x):
        y = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            y = y + self.rbr_identity(x)
        return leaky(y)


class DWConv(nn.Module):
    def __init__(self, cin, cout, padding=1, dilation=1):
        super().__init__()
        self.depthwise_conv = RepConv(cin, cin, 3, 1, padding, dilation,
                                      groups=cin, act=F.relu)
        self.pointwise_conv = RepConv(cin, cout, 1, act=F.relu)

    def forward(self, x):
        return self.pointwise_conv(self.depthwise_conv(x))


class BottleNeck(nn.Module):
    def __init__(self, c, reduction):
        super().__init__()
        mid = c // reduction
        self.conv = nn.Sequential(RepConv(c, mid, 1), RepConv(mid, mid, 3, 1, 1),
                                  RepConv(mid, c, 1))

    def forward(self, x):
        return leaky(x + self.conv(x))


class BasicBlock(nn.Module):
    def __init__(self, cin, cout, stride):
        super().__init__()
        self.conv = nn.Sequential(RepConv(cin, cout, 3, stride, 1),
                                  RepConv(cout, cout, 3, 1, 1))
        self.skip_layer = (RepConv(cin, cout, 1, stride, 0)
                           if stride == 2 or cin != cout else None)

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return leaky(skip + self.conv(x))


class Residual(nn.Module):
    def __init__(self, cin, cout, stride, num_block, reduction):
        super().__init__()
        self.conv1 = BasicBlock(cin, cout, stride)
        self.blocks = nn.Sequential(*[BottleNeck(cout, reduction)
                                      for _ in range(num_block)])

    def forward(self, x):
        return self.blocks(self.conv1(x))


class ChannelAttention(nn.Module):
    """x * sigmoid(MLP(BN(depthwise 3x3 conv(adaptive_avg_pool(x, 3)))));
    the MLP starts with channel dropout at p = 0.3."""

    def __init__(self, c):
        super().__init__()
        self.conv3x3 = ConvBN(c, c, 3, 1, 0, groups=c)
        self.conv1x1 = nn.Sequential(ChannelDropout(0.3), Conv(c, c // 2, 1),
                                     nn.LeakyReLU(0.01), Conv(c // 2, c, 1))

    def forward(self, x):
        att = self.conv3x3(F.adaptive_avg_pool2d(x, (3, 3)))
        return x * torch.sigmoid(self.conv1x1(att))


class MSAB(nn.Module):
    def __init__(self, c):
        super().__init__()
        mid = c // 2
        self.conv1 = RepConv(c, mid, 1)
        mid1, mid2 = [], []
        cin = mid
        for i in range(2):
            cout = mid // 2 if i == 0 else mid
            mid1.append(nn.Sequential(DWConv(cin, cout), DWConv(cout, cout)))
            mid2.append(nn.Sequential(DWConv(cin, cout, padding=2, dilation=2),
                                      DWConv(cout, cout)))
            cin = 2 * cout
        self.mid1_conv = nn.ModuleList(mid1)
        self.mid2_conv = nn.ModuleList(mid2)
        self.conv2 = RepConv(c, c, 1)
        self.ca = ChannelAttention(c)

    def forward(self, x):
        m = self.conv1(x)
        for p1, p2 in zip(self.mid1_conv, self.mid2_conv):
            m = torch.cat([p1(m), p2(m)], dim=1)
        return self.ca(self.conv2(m + x))


class Stem(nn.Module):
    def __init__(self, c):
        super().__init__()
        mid = max(c // 4, 32)
        self.conv1 = nn.Sequential(RepBlock(3, mid, 3, 2, 1),
                                   RepBlock(mid, mid, 7, 1, 3, groups=mid))
        self.branch1 = nn.Sequential(RepConv(mid, mid, 1),
                                     RepConv(mid, mid, 3, 2, 1))
        self.conv1x1 = Conv(2 * mid, c, 1)

    def forward(self, x):
        x = self.conv1(x)
        pooled = F.max_pool2d(x, 2, 2, ceil_mode=True)
        return self.conv1x1(torch.cat([self.branch1(x), pooled], dim=1))


def upsample_to(x, size):
    """Nearest resize by pixel repeat (the hourglass only doubles)."""
    fy, fx = size[0] // x.shape[2], size[1] // x.shape[3]
    if (fy * x.shape[2], fx * x.shape[3]) != tuple(size):
        raise ValueError(f"{tuple(x.shape[2:])} does not divide {size}")
    return x.repeat_interleave(fy, dim=2).repeat_interleave(fx, dim=3)


class EncoderDecoder(nn.Module):
    def __init__(self, levels, c, num_blocks, reduction):
        super().__init__()
        self.levels = levels
        self.encoder = nn.ModuleList(
            [MSAB(c)] + [Residual(c, c, 2, num_blocks[i], reduction)
                         for i in range(levels - 1)])
        self.decoder = nn.ModuleList(
            [Residual(c, c, 1, num_blocks[i], reduction)
             for i in range(levels - 1)] + [MSAB(c)])

    def forward(self, x):
        outs = []
        for layer in self.encoder:
            x = layer(x)
            outs.append(x)
        shortcut = F.adaptive_avg_pool2d(outs[0], outs[-1].shape[2:])
        for i, layer in enumerate(self.decoder):
            skip = outs[self.levels - 1 - i]
            if i == 0:
                x = layer(skip) + shortcut
            else:
                x = upsample_to(layer(x), skip.shape[2:]) + skip
        return x


class LiteHandNet(nn.Module):
    def __init__(self, joints, levels, c, num_blocks, reduction):
        super().__init__()
        self.pre = Stem(c)
        self.hgs = EncoderDecoder(levels, c, num_blocks, reduction)
        self.features = nn.Sequential(BottleNeck(c, 2), RepConv(c, c, 1))
        self.out_layer = Conv(c, joints, 1)

    def forward(self, x):
        y = self.out_layer(self.features(self.hgs(self.pre(x))))
        return y.to(torch.promote_types(y.dtype, torch.float32))


def build(model: dict) -> LiteHandNet:
    """The reference from the configuration file's ``model`` entry (the
    channel gate must be ``ca``, the activation LeakyReLU)."""
    if model["ca_type"] != "ca" or model["activation"] != "leakyrelu":
        raise ValueError("the reference covers ca_type 'ca' with LeakyReLU")
    return LiteHandNet(model["output_channel"], model["num_stage"],
                       model["input_channel"], tuple(model["num_block"]),
                       model["reduction"])
