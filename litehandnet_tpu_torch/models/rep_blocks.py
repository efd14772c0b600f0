"""YOLOv5-style block library (port of
``litehandnet_tpu/models/rep_blocks.py``; reference
``models/rep_pose_hg_ms_att.py:6-63``, dead code there: nothing imports it
and it calls an ``autopad`` it never defines).

``Conv`` (conv, BN, SiLU; a ``forward_fuse`` deploy path) is
``layers.ConvBnAct``, which YOLOv6's SimConv shares; here ``DWConv``
(groups = gcd(c1, c2)), ``Bottleneck``, ``CrossConv`` and ``Focus``, with
the reference's parameter names (``conv``, ``bn``, ``cv1``, ``cv2``), and
:func:`fuse_conv_bn`, the deploy transform over a state dict, which folds
with ``reparam.fold_bn`` as ``fuse_params`` does. No model of the zoo uses
the blocks.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Union

import torch
from torch import nn

from litehandnet_tpu_torch.models.layers import ConvBnAct, autopad  # noqa: F401
from litehandnet_tpu_torch.models.reparam import fold_bn


def dw_conv(c1: int, c2: int, k=1, s=1, act=True, **kw) -> ConvBnAct:
    """Reference ``DWConv`` (rep_pose_hg_ms_att.py:20-24): a grouped conv
    with groups = gcd(c1, c2)."""
    return ConvBnAct(c1, c2, k, s, groups=math.gcd(c1, c2), act=act, **kw)


class Bottleneck(nn.Module):
    """Reference ``Bottleneck`` (rep_pose_hg_ms_att.py:27-38): 1x1 reduce
    ``cv1``, 3x3 grouped ``cv2``, residual add iff ``shortcut`` and the
    channels match."""

    def __init__(self, in_channels, features, shortcut=True, groups=1,
                 expansion=0.5, deploy=False):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBnAct(in_channels, hidden, 1, 1, deploy=deploy)
        self.cv2 = ConvBnAct(hidden, features, 3, 1, groups=groups,
                             deploy=deploy)
        self.add = shortcut and in_channels == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class CrossConv(nn.Module):
    """Reference ``CrossConv`` (rep_pose_hg_ms_att.py:41-52): a (1, k)
    stride (1, s) conv, then a (k, 1) stride (s, 1) grouped conv, with an
    optional residual."""

    def __init__(self, in_channels, features, kernel=3, stride=1, groups=1,
                 expansion=1.0, shortcut=False, deploy=False):
        super().__init__()
        hidden = int(features * expansion)
        self.cv1 = ConvBnAct(in_channels, hidden, (1, kernel), (1, stride),
                             deploy=deploy)
        self.cv2 = ConvBnAct(hidden, features, (kernel, 1), (stride, 1),
                             groups=groups, deploy=deploy)
        self.add = shortcut and in_channels == features

    def forward(self, x):
        y = self.cv2(self.cv1(x))
        return x + y if self.add else y


class Focus(nn.Module):
    """Reference ``Focus`` (rep_pose_hg_ms_att.py:55-63): 2x2
    space-to-depth (slices [even, even], [odd, even], [even, odd],
    [odd, odd] over (h, w), concatenated slice-major), then ``conv``."""

    def __init__(self, in_channels, features, kernel=1, stride=1,
                 padding=None, groups=1,
                 act: Union[bool, Callable, None] = True, deploy=False):
        super().__init__()
        self.conv = ConvBnAct(4 * in_channels, features, kernel, stride,
                              padding, groups, act, deploy)

    def forward(self, x):
        return self.conv(torch.cat(
            [x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
             x[..., 1::2, 1::2]], dim=1))


@torch.no_grad()
def fuse_conv_bn(state: Union[nn.Module, Mapping[str, torch.Tensor]]
                 ) -> Dict[str, torch.Tensor]:
    """The deploy transform (reference ``forward_fuse``): every module with
    a ``conv`` and a ``bn`` child in a train graph's state dict (or the
    module's) becomes one biased ``conv``,

        t = gamma / sqrt(var + eps),  W' = W * t,  b' = beta + (b - mean) * t

    (b the conv's bias, 0 without one). Returns the ``state_dict`` of the
    ``deploy=True`` graph. Every other entry passes unchanged, siblings of a
    fused pair included.

    Raises:
        ValueError: a fused module's BatchNorm lacks its running statistics
            (named in the message).
    """
    sd = state.state_dict() if isinstance(state, nn.Module) else dict(state)
    pairs = sorted({key[:-len("conv.weight")] for key in sd
                    if (key == "conv.weight" or key.endswith(".conv.weight"))
                    and f"{key[:-len('conv.weight')]}bn.weight" in sd})
    out = dict(sd)
    for prefix in pairs:
        bn = {leaf: sd.get(f"{prefix}bn.{leaf}")
              for leaf in ("weight", "bias", "running_mean", "running_var")}
        missing = [leaf for leaf, v in bn.items() if v is None]
        if missing:
            raise ValueError(f"fuse_conv_bn: {prefix.rstrip('.') or 'the model'}"
                             f" has no BatchNorm {', '.join(missing)}")
        out[f"{prefix}conv.weight"], out[f"{prefix}conv.bias"] = fold_bn(
            sd[f"{prefix}conv.weight"], bn["weight"], bn["bias"],
            bn["running_mean"], bn["running_var"], sd.get(f"{prefix}conv.bias"))
        for key in [k for k in out if k.startswith(f"{prefix}bn.")]:
            del out[key]
    return out
