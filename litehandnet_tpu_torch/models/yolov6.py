"""YOLOv6 hand detector: EfficientRep backbone, Rep-PAN neck and the
anchor-free efficient decoupled head (port of
``litehandnet_tpu/models/yolov6.py``; reference
``object_detection/yolov6/{common,efficientrep,reppan,effidehead,yolo}.py``).

* reference ``RepVGGBlock`` (common.py:135-258) -> ``layers.RepBlock``
  (3x3 + 1x1 + identity-BN branches, ReLU), fused at deploy;
* reference ``RepBlock`` n-stack (common.py:119-132) -> :class:`RepStage`
  (``conv1`` and ``block.{k}``);
* reference ``SimConv``/``Conv`` (common.py:19-64) -> ``layers.ConvBnAct``
  (``conv``, ``bn``; ReLU or SiLU), fused to a biased ``conv`` at deploy;
* reference ``Transpose`` (common.py:85-98) -> ``ConvTranspose2d`` 2x2
  stride 2 with bias (``upsample{i}.upsample_transpose``);
  ``upsample='nearest'`` repeats pixels instead and has no weights.

Channels and repeats scale as yolo.py:57-71. The head (effidehead.py:57-88,
one anchor per cell) returns in train mode the raw per-scale maps
``[B, 5 + nc, ny, nx]`` (channels reg4, obj, cls); in eval mode the rows
``[B, N, 5 + nc]`` (cx, cy, w, h, obj, cls...) over strides 8, 16 and 32,
with ``(xy + grid) * stride``, ``exp(clip(wh, -30, 30)) * stride`` and
sigmoid obj and cls, in float32. Submodule names are the reference torch
names of ``utils/torch_import.py``'s ``_yolov6_rules`` (:841-885).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    ConvBnAct,
    RepBlock,
    head_output,
    relu,
    resize_nearest,
)

# yolo.py defaults for the n-scale model (configs/yolov6n.py upstream):
# backbone and neck channel and repeat bases before width / depth scaling
_BACKBONE_CHANNELS = (64, 128, 256, 512, 1024)
_BACKBONE_REPEATS = (1, 6, 12, 18, 6)
_NECK_CHANNELS = (256, 128, 128, 256, 256, 512)
_NECK_REPEATS = (12, 12, 12, 12)
# cls / obj prediction biases start at -log((1 - p) / p), p = 0.01
# (initialize_biases, effidehead.py:47-55)
PRIOR_BIAS = -math.log((1 - 1e-2) / 1e-2)


def make_divisible(x: float, divisor: int = 8) -> int:
    """yolo.py:57-59."""
    return int(math.ceil(x / divisor) * divisor)


def scaled_channels(width: float) -> tuple:
    """The backbone and neck channel lists, width-scaled (yolo.py:71)."""
    return tuple(make_divisible(c * width, 8)
                 for c in _BACKBONE_CHANNELS + _NECK_CHANNELS)


def scaled_repeats(depth: float) -> tuple:
    """The repeats, depth-scaled (yolo.py:70)."""
    return tuple((max(round(n * depth), 1) if n > 1 else n)
                 for n in _BACKBONE_REPEATS + _NECK_REPEATS)


def _rep(in_channels, features, stride=1, deploy=False) -> RepBlock:
    return RepBlock(in_channels, features, 3, stride, 1, act=relu,
                    deploy=deploy)


class RepStage(nn.Module):
    """Reference RepBlock n-stack (common.py:119-132): ``conv1`` then n - 1
    RepVGG blocks ``block.{k}``."""

    def __init__(self, in_channels, features, n=1, deploy=False):
        super().__init__()
        self.conv1 = _rep(in_channels, features, deploy=deploy)
        self.block = (nn.Sequential(*[_rep(features, features, deploy=deploy)
                                      for _ in range(n - 1)])
                      if n > 1 else None)

    def forward(self, x):
        x = self.conv1(x)
        return x if self.block is None else self.block(x)


class SimSPPF(nn.Module):
    """Simplified SPPF (common.py:67-82): 1x1 reduce ``cv1``, three chained
    5x5 stride-1 max pools, concatenation, 1x1 expand ``cv2``; ReLU."""

    def __init__(self, in_channels, features, deploy=False):
        super().__init__()
        mid = in_channels // 2
        self.cv1 = ConvBnAct(in_channels, mid, 1, act=relu, deploy=deploy)
        self.cv2 = ConvBnAct(4 * mid, features, 1, act=relu, deploy=deploy)

    def forward(self, x):
        x = self.cv1(x)
        y1 = F.max_pool2d(x, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        return self.cv2(torch.cat([x, y1, y2, F.max_pool2d(y2, 5, 1, 2)], 1))


class EfficientRep(nn.Module):
    """Backbone (efficientrep.py:5-102): a RepVGG ``stem`` and four
    ``ERBlock_{i}`` (stride-2 RepVGG block, RepStage, and SimSPPF closing
    ERBlock_5); returns the features at strides 8, 16 and 32."""

    def __init__(self, channels: Sequence[int], repeats: Sequence[int],
                 deploy=False):
        super().__init__()
        c, r = channels, repeats
        self.stem = _rep(3, c[0], 2, deploy)
        for i in (2, 3, 4, 5):
            blocks = [_rep(c[i - 2], c[i - 1], 2, deploy),
                      RepStage(c[i - 1], c[i - 1], r[i - 1], deploy)]
            if i == 5:
                blocks.append(SimSPPF(c[4], c[4], deploy))
            self.add_module(f"ERBlock_{i}", nn.Sequential(*blocks))

    def forward(self, x):
        x = self.stem(x)
        outs = []
        for i in (2, 3, 4, 5):
            x = getattr(self, f"ERBlock_{i}")(x)
            if i >= 3:
                outs.append(x)
        return outs


class Transpose(nn.Module):
    """Learnable 2x upsampling (common.py:85-98)."""

    def __init__(self, in_channels, features):
        super().__init__()
        self.upsample_transpose = nn.ConvTranspose2d(in_channels, features, 2,
                                                     2, bias=True)

    def forward(self, x):
        return self.upsample_transpose(x)


class RepPANNeck(nn.Module):
    """PAN neck (reppan.py:6-108): SimConv reduce and downsample layers,
    ConvTranspose upsamplers (or the weightless pixel repeat with
    ``upsample='nearest'``), RepStage fusion stacks."""

    def __init__(self, channels: Sequence[int], repeats: Sequence[int],
                 upsample="deconv", deploy=False):
        super().__init__()
        c, r = channels, repeats
        self.upsample = upsample
        self.reduce_layer0 = ConvBnAct(c[4], c[5], 1, act=relu, deploy=deploy)
        self.Rep_p4 = RepStage(c[5] + c[3], c[5], r[5], deploy)
        self.reduce_layer1 = ConvBnAct(c[5], c[6], 1, act=relu, deploy=deploy)
        self.Rep_p3 = RepStage(c[6] + c[2], c[6], r[6], deploy)
        self.downsample2 = ConvBnAct(c[6], c[7], 3, 2, 1, act=relu,
                                     deploy=deploy)
        self.Rep_n3 = RepStage(c[7] + c[6], c[8], r[7], deploy)
        self.downsample1 = ConvBnAct(c[8], c[9], 3, 2, 1, act=relu,
                                     deploy=deploy)
        self.Rep_n4 = RepStage(c[9] + c[5], c[10], r[8], deploy)
        if upsample != "nearest":
            self.upsample0 = Transpose(c[5], c[5])
            self.upsample1 = Transpose(c[6], c[6])

    def _up(self, z, i):
        if self.upsample == "nearest":
            return resize_nearest(z, (z.shape[2] * 2, z.shape[3] * 2))
        return getattr(self, f"upsample{i}")(z)

    def forward(self, feats):
        x2, x1, x0 = feats  # strides 8, 16, 32
        fpn_out0 = self.reduce_layer0(x0)
        f_out0 = self.Rep_p4(torch.cat([self._up(fpn_out0, 0), x1], 1))
        fpn_out1 = self.reduce_layer1(f_out0)
        pan_out2 = self.Rep_p3(torch.cat([self._up(fpn_out1, 1), x2], 1))
        x = torch.cat([self.downsample2(pan_out2), fpn_out1], 1)
        pan_out1 = self.Rep_n3(x)
        x = torch.cat([self.downsample1(pan_out1), fpn_out0], 1)
        pan_out0 = self.Rep_n4(x)
        return [pan_out2, pan_out1, pan_out0]


class Detect(nn.Module):
    """Efficient decoupled head (effidehead.py:7-88, anchor-free): per
    scale a 1x1 SiLU ``stems.{i}``, 3x3 SiLU ``cls_convs.{i}`` and
    ``reg_convs.{i}``, and 1x1 biased ``cls_preds``, ``reg_preds`` and
    ``obj_preds``."""

    def __init__(self, channels: Sequence[int], num_classes=1,
                 strides: Sequence[int] = (8, 16, 32), deploy=False):
        super().__init__()
        self.num_classes = num_classes
        self.strides = tuple(strides)

        def towers(k, p):
            return nn.ModuleList(ConvBnAct(C, C, k, 1, p, act=F.silu,
                                           deploy=deploy) for C in channels)

        self.stems = towers(1, 0)
        self.cls_convs = towers(3, 1)
        self.reg_convs = towers(3, 1)
        self.cls_preds = nn.ModuleList(nn.Conv2d(C, num_classes, 1)
                                       for C in channels)
        self.reg_preds = nn.ModuleList(nn.Conv2d(C, 4, 1) for C in channels)
        self.obj_preds = nn.ModuleList(nn.Conv2d(C, 1, 1) for C in channels)
        with torch.no_grad():
            for conv in (*self.cls_preds, *self.obj_preds):
                conv.bias.fill_(PRIOR_BIAS)

    def forward(self, feats):
        raw, rows = [], []
        for i, (x, stride) in enumerate(zip(feats, self.strides)):
            s = self.stems[i](x)
            cls = self.cls_preds[i](self.cls_convs[i](s))
            reg = self.reg_convs[i](s)
            box, obj = self.reg_preds[i](reg), self.obj_preds[i](reg)
            if self.training:
                # raw maps, channels reg / obj / cls (effidehead.py:69-71)
                raw.append(torch.cat([box, obj, cls], 1))
                continue
            B, _, H, W = box.shape
            gy, gx = torch.meshgrid(torch.arange(H, device=box.device),
                                    torch.arange(W, device=box.device),
                                    indexing="ij")
            grid = torch.stack([gx, gy]).to(box.dtype)
            cxcy = (box[:, :2] + grid) * stride
            # exp clipped for random weights; inactive in the reference's
            # operating range (|wh| < 8)
            wh = torch.exp(torch.clamp(box[:, 2:4], -30, 30)) * stride
            row = torch.cat([cxcy, wh, torch.sigmoid(obj), torch.sigmoid(cls)],
                            1)
            rows.append(row.permute(0, 2, 3, 1).reshape(
                B, H * W, 5 + self.num_classes))
        if self.training:
            return raw
        return head_output(torch.cat(rows, 1))


class YOLOv6(nn.Module):
    """The detector (yolo.py:11-93). Config keys (``cfg.MODEL``):
    num_classes, width_multiple, depth_multiple, upsample in {deconv,
    nearest}."""

    def __init__(self, num_classes=1, width=0.25, depth=0.33,
                 upsample="deconv", deploy=False):
        super().__init__()
        c = scaled_channels(width)
        r = scaled_repeats(depth)
        self.deploy = deploy
        self.backbone = EfficientRep(c[:5], r[:5], deploy)
        self.neck = RepPANNeck(c, r, upsample, deploy)
        self.detect = Detect((c[6], c[8], c[10]), num_classes, deploy=deploy)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "YOLOv6":
        m = cfg.MODEL
        return cls(num_classes=m.get("num_classes", 1),
                   width=m.get("width_multiple", 0.25),
                   depth=m.get("depth_multiple", 0.33),
                   upsample=m.get("upsample", "deconv"),
                   deploy=deploy)

    def forward(self, x):
        return self.detect(self.neck(self.backbone(x)))
