"""Shared building blocks: re-parameterizable convolutions and channel
attention (port of ``litehandnet_tpu/models/layers.py``).

Layout is NCHW (run in ``channels_last`` memory by the caller); conv weights
are OIHW. Submodule names follow the reference torch code
(``repblocks.py``, ``common.py``) so checkpoints and the JAX package's
``utils/torch_import.py`` rules apply unchanged:

* ``RepConv``: train graph ``conv.conv`` + ``conv.bn``; deploy ``rep``.
* ``RepBlock``: ``rbr_dense``, ``rbr_1x1``, ``rbr_identity``; deploy ``rep``.
* ``ChannelAttention``: ``conv3x3`` (deploy ``att_rep``) and the gate MLP
  ``conv1x1.{1,3}``.
* ``SEBlock``: ``down``, ``up``.

BatchNorm is ``nn.BatchNorm2d(eps=1e-5, momentum=0.1)``; the serve path runs
it in eval mode only.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]

leaky_relu = F.leaky_relu  # slope 0.01
relu = F.relu


def get_activation(name: str | None) -> Activation:
    if name is None:
        return None
    return {
        "leakyrelu": leaky_relu,
        "leaky_relu": leaky_relu,
        "relu": relu,
        "silu": F.silu,
        "mish": F.mish,
        "sigmoid": torch.sigmoid,
        "none": None,
        "identity": None,
    }[name.lower()]


def repconv_act(act: Activation, inplace: bool) -> Activation:
    """Effective activation of a reference RepConv.

    The reference builds ``activation(inplace)`` positionally, so for
    LeakyReLU the bool lands in ``negative_slope``: ``inplace=True`` gives
    slope 1 (identity), ``inplace=False`` slope 0 (exact ReLU). Other
    activations take ``inplace`` as their first argument and are unchanged.
    RepBlock passes it by keyword and is unaffected.
    """
    if act is leaky_relu:
        return None if inplace else relu
    return act


def Conv(in_channels: int, features: int, kernel: int = 1, stride: int = 1,
         padding: int = 0, dilation: int = 1, groups: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """Conv with torch-style integer padding."""
    return nn.Conv2d(in_channels, features, kernel, stride, padding,
                     dilation, groups, bias=bias)


def BatchNorm(channels: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(channels, eps=1e-5, momentum=0.1)


class ConvBN(nn.Module):
    """Bias-free conv followed by BatchNorm (reference ``conv_bn``)."""

    def __init__(self, in_channels, features, kernel, stride=1, padding=0,
                 dilation=1, groups=1):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride, padding,
                         dilation, groups, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return self.bn(self.conv(x))


class RepConv(nn.Module):
    """Conv+BN that fuses to one biased conv at deploy time
    (reference ``repblocks.py:23-73``)."""

    def __init__(self, in_channels, features, kernel=1, stride=1, padding=0,
                 dilation=1, groups=1, act: Activation = leaky_relu,
                 deploy=False):
        super().__init__()
        self.act = act
        self.deploy = deploy
        if deploy:
            self.rep = Conv(in_channels, features, kernel, stride, padding,
                            dilation, groups, bias=True)
        else:
            self.conv = ConvBN(in_channels, features, kernel, stride, padding,
                               dilation, groups)

    def forward(self, x):
        out = self.rep(x) if self.deploy else self.conv(x)
        return out if self.act is None else self.act(out)


class RepBlock(nn.Module):
    """RepVGG block: kxk + 1x1 + identity-BN branches, fused at deploy
    (reference ``repblocks.py:76-236``)."""

    def __init__(self, in_channels, features, kernel=3, stride=1, padding=1,
                 dilation=1, groups=1, act: Activation = leaky_relu,
                 deploy=False):
        super().__init__()
        self.act = act
        self.deploy = deploy
        if deploy:
            self.rep = Conv(in_channels, features, kernel, stride, padding,
                            dilation, groups, bias=True)
            return
        self.rbr_dense = ConvBN(in_channels, features, kernel, stride,
                                padding, dilation, groups)
        self.rbr_1x1 = ConvBN(in_channels, features, 1, stride, 0, 1, groups)
        if in_channels == features and stride == 1:
            self.rbr_identity = BatchNorm(in_channels)
        else:
            self.rbr_identity = None

    def forward(self, x):
        if self.deploy:
            out = self.rep(x)
        else:
            out = self.rbr_dense(x) + self.rbr_1x1(x)
            if self.rbr_identity is not None:
                out = out + self.rbr_identity(x)
        return out if self.act is None else self.act(out)


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """Adaptive average pooling; region i spans
    ``[floor(i*S/O), ceil((i+1)*S/O))``, the JAX package's rule."""
    return F.adaptive_avg_pool2d(x, output_size)


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate (reference ``common.py:23-37``)."""

    def __init__(self, channels, internal):
        super().__init__()
        self.down = Conv(channels, internal, 1)
        self.up = Conv(internal, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.up(F.relu(self.down(s)))
        return x * torch.sigmoid(s)


class ChannelAttention(nn.Module):
    """3x3-pooled depthwise gate (reference ``common.py:40-90``). Deploy
    fuses ``conv3x3`` (conv+BN) into ``att_rep``."""

    def __init__(self, channels, deploy=False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.att_rep = Conv(channels, channels, 3, 1, 0, groups=channels)
        else:
            self.conv3x3 = ConvBN(channels, channels, 3, 1, 0, groups=channels)
        self.conv1x1 = nn.Sequential(
            nn.Dropout2d(0.3),  # identity in eval mode
            Conv(channels, channels // 2, 1),
            nn.LeakyReLU(),
            Conv(channels // 2, channels, 1),
        )

    def forward(self, x):
        y = adaptive_avg_pool(x, (3, 3))
        att = self.att_rep(y) if self.deploy else self.conv3x3(y)
        return x * torch.sigmoid(self.conv1x1(att))


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize to ``(h, w)``: pixel repeat for integer factors, the
    half-pixel rule otherwise (both as ``jax.image.resize``)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool in ceil mode."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)
