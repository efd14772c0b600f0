"""Stacked MultiScaleAttentionHourglass, registry name ``mynet_stacked``
(port of ``litehandnet_tpu/models/ms_att_hourglass_stacked.py``; reference
``pose_hg_ms_att.py:68-265``), the Gen-1 multi-hand model.

Pelee stem with a BN + ReLU projection -> ``nstack`` recursive hourglasses
(multi-scale attention blocks at the top level, pre-activation residuals
inside) with intermediate supervision through ``merge_preds`` /
``merge_features`` -> K + 3 output maps per stack (K joints, then the center,
width and height region maps) -> SimDR heads ``pred_x`` / ``pred_y`` on the
last stack's joint maps. Input ``[B, 3, H, W]``; output ``(list of float32
[B, K + 3, H/4, W/4] per stack, pred_x [B, K, W*k], pred_y [B, K, H*k])``
with SimDR, else the list.

Submodule names are the reference torch names that
``utils/torch_import.py::_mynet_stacked_rules`` (:591-660) encodes:
``pre.conv1.{0,1,3,4}``, ``pre.branch1.{0,1,3,4}``, ``pre.conv1x1.{0,1}``;
``hgs.N.up1 ... low3`` with the attention blocks' ``conv{1,2}.{conv,bn}``,
``mid{1,2}_conv.i.j.{depthwise,pointwise}_conv.{0,1}``, ``att.{1,3,6}`` and
the pre-activation residuals' ``conv.{0,2,3,5,6,8}``; the heads
``features.N.{0,1,3}``, ``outs.N``, ``merge_features.N``, ``merge_preds.N``,
``pred_x``, ``pred_y``.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    BatchNorm,
    Conv,
    head_output,
    max_pool2,
    resize_nearest,
)
from litehandnet_tpu_torch.models.ms_att_hourglass import (
    MEAttBody,
    PeleeStem,
    RCAGate,
)


class PreActResidual(nn.Module):
    """BN-ReLU bottleneck residual (pose_hg_ms_att.py:26-49): ``conv`` is
    BN, ReLU, 1x1 to half width, BN, ReLU, 3x3, BN, ReLU, 1x1; the skip is
    the input, or a 1x1 ``skip_layer`` when the widths differ."""

    def __init__(self, in_channels, features):
        super().__init__()
        half = features // 2
        self.conv = nn.Sequential(
            BatchNorm(in_channels), nn.ReLU(), Conv(in_channels, half, 1),
            BatchNorm(half), nn.ReLU(), Conv(half, half, 3, 1, 1),
            BatchNorm(half), nn.ReLU(), Conv(half, features, 1),
        )
        self.skip_layer = (None if in_channels == features
                           else Conv(in_channels, features, 1))

    def forward(self, x):
        skip = x if self.skip_layer is None else self.skip_layer(x)
        return skip + self.conv(x)


class MSAttBlock(MEAttBody):
    """MultiScaleAttentionBlock (pose_hg_ms_att.py:96-148): the ME_att trunk
    with ReLU BRCs and the 3x3-pooled gate ``att`` (element-wise dropout
    0.3 before its Linear)."""

    def __init__(self, in_channels, features):
        super().__init__(in_channels, features, act=F.relu)
        self.att = RCAGate(features)

    def forward(self, x):
        return self.att(self.trunk(x))


class RecursiveHourglass(nn.Module):
    """One hourglass level (pose_hg_ms_att.py:68-94): ``up1`` at this
    resolution; ``low1``, ``low2`` (the next level, or a block at the
    bottom) and ``low3`` on the max-pooled input; their sum after a nearest
    resize. Blocks are attention blocks at the top level only."""

    def __init__(self, depth, features, increase=0, top_attention=True):
        super().__init__()
        nf = features + increase
        Block = MSAttBlock if top_attention else PreActResidual
        self.up1 = Block(features, features)
        self.low1 = Block(features, nf)
        self.low2 = (RecursiveHourglass(depth - 1, nf, 0, top_attention=False)
                     if depth > 1 else Block(nf, nf))
        self.low3 = Block(nf, features)

    def forward(self, x):
        up1 = self.up1(x)
        low = self.low3(self.low2(self.low1(max_pool2(x))))
        return up1 + resize_nearest(low, up1.shape[2:])


class StackedPeleeStem(PeleeStem):
    """The Pelee stem with a BN + ReLU after its projection
    (pose_hg_ms_att.py:150-186)."""

    def __init__(self, in_channels=3, features=128, min_mid=32):
        super().__init__(in_channels, features, min_mid)
        mid = max(features // 4, min_mid)
        self.conv1x1 = nn.Sequential(Conv(2 * mid, features, 1),
                                     BatchNorm(features), nn.ReLU())


class MSAttHourglassStacked(nn.Module):
    """``mynet_stacked`` (pose_hg_ms_att.py:188-265).

    Config keys: ``MODEL.hm_loss_factor`` (one entry per stack),
    ``main_channels`` (else ``input_channel``), ``hg_depth``, ``increase``,
    ``with_region_map`` (K + 3 output channels), ``simdr_split_ratio``
    (else ``PIPELINE.simdr_split_ratio``; 0 drops the SimDR heads) and
    ``DATASET.image_size``, which sizes the SimDR heads: a smaller input
    (the half-resolution cycle-detection pass) has its joint maps resized to
    ``image_size // 4`` before them.
    """

    def __init__(self, num_joints=21, nstack=2, features=128, hg_depth=4,
                 increase=0, with_region_map=True, simdr_split_ratio=2.0,
                 image_size: Sequence[int] = (256, 256)):
        super().__init__()
        self.num_joints = num_joints
        self.nstack = nstack
        self.simdr_split_ratio = simdr_split_ratio
        self.image_size = tuple(int(v) for v in image_size)
        oup_dim = num_joints + 3 if with_region_map else num_joints
        self.pre = StackedPeleeStem(3, features)
        self.hgs = nn.ModuleList(
            [RecursiveHourglass(hg_depth, features, increase)
             for _ in range(nstack)])
        self.features = nn.ModuleList(
            [nn.Sequential(PreActResidual(features, features),
                           BatchNorm(features), nn.ReLU(),
                           Conv(features, features, 1))
             for _ in range(nstack)])
        self.outs = nn.ModuleList(
            [Conv(features, oup_dim, 1) for _ in range(nstack)])
        self.merge_features = nn.ModuleList(
            [Conv(features, features, 1) for _ in range(nstack - 1)])
        self.merge_preds = nn.ModuleList(
            [Conv(oup_dim, features, 1) for _ in range(nstack - 1)])
        if simdr_split_ratio > 0:
            hm_w, hm_h = self.image_size[0] // 4, self.image_size[1] // 4
            self.pred_x = nn.Linear(hm_w * hm_h,
                                    int(self.image_size[0] * simdr_split_ratio))
            self.pred_y = nn.Linear(hm_w * hm_h,
                                    int(self.image_size[1] * simdr_split_ratio))

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "MSAttHourglassStacked":
        del deploy  # no Rep modules: one graph
        m = cfg.MODEL
        pipeline = cfg.get("PIPELINE", {})
        return cls(
            num_joints=cfg.DATASET.num_joints,
            nstack=len(m.get("hm_loss_factor", [1.0, 1.0])),
            features=m.get("main_channels", m.get("input_channel", 128)),
            hg_depth=m.get("hg_depth", 4),
            increase=m.get("increase", 0),
            with_region_map=m.get("with_region_map", True),
            simdr_split_ratio=m.get(
                "simdr_split_ratio", pipeline.get("simdr_split_ratio", 2)),
            image_size=tuple(cfg.DATASET.image_size),
        )

    def forward(self, imgs):
        x = self.pre(imgs)
        hm_preds = []
        for i in range(self.nstack):
            feature = self.features[i](self.hgs[i](x))
            preds = self.outs[i](feature)
            hm_preds.append(head_output(preds))
            if i < self.nstack - 1:
                x = (x + self.merge_preds[i](preds)
                     + self.merge_features[i](feature))
        if self.simdr_split_ratio <= 0:
            return hm_preds
        kpts = hm_preds[-1][:, :self.num_joints]  # drop the region maps
        hm_size = (self.image_size[1] // 4, self.image_size[0] // 4)
        kpts = resize_nearest(kpts, hm_size)
        # row-major over H, W, as JAX flattens [B, K, H, W]
        flat = kpts.reshape(kpts.shape[0], kpts.shape[1], -1).to(
            self.pred_x.weight.dtype)
        return hm_preds, self.pred_x(flat), self.pred_y(flat)
