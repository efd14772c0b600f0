"""Heatmap, region and SimDR losses (port of
``litehandnet_tpu/losses/losses.py``: ``distance_loss`` :38-94,
``joints_distance_loss`` :97, ``kl_focal_loss`` :119, ``focal_loss`` :139,
``mask_loss`` :171, ``region_loss`` :187, ``kl_discret_loss`` :226,
``KLDiscretLoss`` :246, ``SimDRLoss`` :253, ``TopdownHeatmapLoss`` :281-346,
``SRHandNetLoss`` :349-408, ``centernet_focal_loss`` :411, ``reg_l1_loss``
:424 and ``CenterSimdrLoss`` :432).

Heatmap outputs and targets are ``[B, K, H, W]`` (the port's layout),
target weights ``[B, K]``, SimDR vectors ``[B, K, D]``.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn


def _l2(x, y):
    return (x - y) ** 2


def _l1(x, y):
    return torch.abs(x - y)


def _smooth_l1(x, y):
    """torch.nn.SmoothL1Loss (beta=1), elementwise."""
    d = torch.abs(x - y)
    return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)


_CRITERIA = {"l2": _l2, "mse": _l2, "l1": _l1, "mae": _l1,
             "smoothl1": _smooth_l1}


def distance_loss(
    output: torch.Tensor,
    target: torch.Tensor,
    target_weight: torch.Tensor,
    loss_type: str = "L2",
    balance: bool = True,
    value: float = 0.5,
    reduction: str = "mean",
) -> torch.Tensor:
    """Weighted distance loss with positive/negative balancing
    (reference heatmapLoss.py:228-265).

    Positive pixels (target > value) are scaled by numel / (n_pos + 1) * 0.1
    and negatives by numel / (n_neg + 1), over the whole batch.

    Args:
        output/target: ``[B, K, H, W]`` heatmaps, ``[B, S, K, H, W]``
            stacked outputs (a ``[B, K, H, W]`` target is shared by every
            stack), or ``[B, K, D]`` coordinates.
        target_weight: ``[B, K]``.
    """
    crit = _CRITERIA[loss_type.lower()]
    if output.dim() == 5 and target.dim() == 4:
        target = target[:, None]
    loss = crit(output, target)
    if loss.dim() == 5:
        w = target_weight[:, None, :, None, None]
    elif loss.dim() == 4:
        w = target_weight[:, :, None, None]
    else:
        w = target_weight[..., None]
    loss = loss * w

    if balance:
        pos = torch.broadcast_to(target, loss.shape) > value
        numel = float(loss.numel())
        n_pos = pos.sum().to(loss.dtype)
        pos_factor = numel / (n_pos + 1.0) * 0.1
        neg_factor = numel / (loss.numel() - n_pos + 1.0)
        loss = torch.where(pos, loss * pos_factor, loss * neg_factor)

    if reduction == "mean":
        return loss.mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def joints_distance_loss(output: torch.Tensor, target: torch.Tensor,
                         target_weight: Optional[torch.Tensor] = None,
                         loss_type: str = "mse") -> torch.Tensor:
    """HRNet-style per-joint loss (reference heatmapLoss.py:175-225): per
    joint 0.5 * mean(crit(pred * w, gt * w)), averaged over joints."""
    crit = _CRITERIA[loss_type.lower()]
    B, K = output.shape[:2]
    pred = output.reshape(B, K, -1)
    gt = target.reshape(B, K, -1)
    if target_weight is not None:
        w = target_weight[:, :, None]
        pred, gt = pred * w, gt * w
    return (0.5 * crit(pred, gt).mean(dim=(0, 2))).mean()


def kl_focal_loss(output: torch.Tensor, target: torch.Tensor,
                  target_weight: Optional[torch.Tensor] = None) -> torch.Tensor:
    """KL divergence between per-map softmaxes over the pixels (reference
    heatmapLoss.py:5-44)."""
    B, K = output.shape[:2]
    gt = target.reshape(B, K, -1)
    log_p = torch.log_softmax(output.reshape(B, K, -1), dim=2)
    kl = (torch.softmax(gt, dim=2) * (torch.log_softmax(gt, dim=2) - log_p)
          ).sum(dim=2)  # [B, K]
    if target_weight is not None:
        kl = kl * target_weight
    return kl.mean()


def focal_loss(output: torch.Tensor, target: torch.Tensor,
               target_weight: Optional[torch.Tensor] = None,
               alpha: float = 2.0, ratio: float = 0.25,
               thr: float = 0.4) -> torch.Tensor:
    """CornerNet-derived focal loss (reference heatmapLoss.py:48-108), per
    (b, k) map: the positive and negative log terms over the map, divided by
    the positives where there are any; summed over the maps whose weight is
    nonzero."""
    pos = target > thr
    distance = (target - output) ** alpha
    pos_term = ratio * torch.log(output.clamp(1e-30, 1.0)) * distance
    neg_term = (1.0 - ratio) * torch.log((1.0 - output).clamp(1e-30, 1.0)) * distance
    zero = torch.zeros((), dtype=output.dtype, device=output.device)
    pos_sum = torch.where(pos, pos_term, zero).sum(dim=(2, 3))
    neg_sum = torch.where(pos, zero, neg_term).sum(dim=(2, 3))
    n_pos = pos.sum(dim=(2, 3)).to(output.dtype)
    per_bk = torch.where(n_pos == 0, -neg_sum,
                         -(pos_sum + neg_sum) / n_pos.clamp(min=1.0))
    if target_weight is not None:
        per_bk = per_bk * (target_weight != 0)
    return per_bk.sum()


def mask_loss(output: torch.Tensor, target: torch.Tensor, a: float = 0.5,
              thr: float = 0.2) -> torch.Tensor:
    """Cross-entropy-style mask loss (reference heatmapLoss.py:111-136)."""
    pos = target > thr
    zero = torch.zeros((), dtype=output.dtype, device=output.device)
    pos_loss = torch.where(
        pos, torch.log((output + 1.0 - target).clamp(1e-30, 1.0)), zero).sum()
    neg_loss = torch.where(
        pos, zero,
        (1.0 - target) * torch.log((1.0 - output).clamp(1e-30, 1.0))).sum()
    return -1.0 * (pos_loss + a * neg_loss) / pos.sum().clamp(min=1)


def region_loss(output: torch.Tensor, target: torch.Tensor, a: float = 0.5,
                thr: float = 0.0) -> torch.Tensor:
    """Width/height region-map loss with sqrt size weighting and a CIoU-like
    aspect-ratio term over the positive pixels (reference
    heatmapLoss.py:139-171); 0 without positives.

    Args:
        output/target: ``[B, 2, H, W]`` (width ratio, height ratio).
    """
    const = 4.0 / (3.14159 ** 2)
    pos = target > thr
    n_pos = pos.sum()
    zero = torch.zeros((), dtype=output.dtype, device=output.device)
    pos_pred = output.clamp(1e-30, 1.0)
    neg_pred = (1.0 - output).clamp(1e-30, 1.0)
    safe_t = torch.where(pos, target, torch.ones_like(target))
    pos_term = (torch.sqrt(safe_t) - torch.sqrt(pos_pred)) * torch.log(
        pos_pred / safe_t)
    pos_loss = torch.where(pos, pos_term, zero).sum()
    neg_loss = torch.where(pos, zero, torch.log(neg_pred)).sum()
    loss = -1.0 * (pos_loss + a * neg_loss) / n_pos.clamp(min=1)
    # the two channels' masks coincide: both are painted from one patch
    m = pos[:, 0]
    pred_ratio = output[:, 0] / (output[:, 1] + 1e-6)
    gt_ratio = target[:, 0] / (target[:, 1] + 1e-6)
    aspect = const * (torch.atan(pred_ratio) - torch.atan(gt_ratio)) ** 2
    aspect_mean = torch.where(m, aspect, zero).sum() / m.sum().clamp(min=1)
    return torch.where(n_pos == 0, zero, loss + aspect_mean)


def kl_discret_loss(pred_x: torch.Tensor, pred_y: torch.Tensor,
                    target_x: torch.Tensor, target_y: torch.Tensor,
                    target_weight: torch.Tensor) -> torch.Tensor:
    """Per-joint SimDR vector loss (reference centernet_simdr_loss.py:6-39):
    SmoothL1 reduced to a scalar per joint, times the joint's mean weight
    over the batch, summed and divided by K."""
    K = pred_x.shape[1]
    lx = _smooth_l1(pred_x, target_x).mean(dim=(0, 2))  # [K]
    ly = _smooth_l1(pred_y, target_y).mean(dim=(0, 2))
    w_mean = target_weight.mean(dim=0)  # [K]
    return ((lx + ly) * w_mean).sum() / K


class KLDiscretLoss:
    """Functional alias matching the reference class name."""

    def __call__(self, px, py, tx, ty, w):
        return kl_discret_loss(px, py, tx, ty, w)


class SimDRLoss(nn.Module):
    """SimDR supervision with its own linear decoders (reference
    centernet_simdr_loss.py:42-69): heatmaps ``[B, K, H, W]`` are flattened
    to ``[B, K, H*W]`` (row-major over H, W) and projected to 1-D x and y
    vectors by the trainable ``x_decoder`` and ``y_decoder``."""

    def __init__(self, simdr_width: int, simdr_height: int, in_features: int):
        super().__init__()
        self.x_decoder = nn.Linear(in_features, simdr_width)
        self.y_decoder = nn.Linear(in_features, simdr_height)

    @classmethod
    def from_config(cls, cfg) -> "SimDRLoss":
        k = cfg.PIPELINE.simdr_split_ratio
        hw, hh = cfg.DATASET.heatmap_size
        return cls(int(k * cfg.DATASET.image_size[0]),
                   int(k * cfg.DATASET.image_size[1]), int(hw) * int(hh))

    def forward(self, heatmap, simdr_x, simdr_y, target_weight):
        B, K = heatmap.shape[:2]
        # reshape, not view: a channels_last map is not contiguous in this
        # order, and the flatten must be JAX's row-major H, W
        flat = heatmap.reshape(B, K, -1)
        return kl_discret_loss(self.x_decoder(flat), self.y_decoder(flat),
                               simdr_x, simdr_y, target_weight)


class TopdownHeatmapLoss(nn.Module):
    """Balanced heatmap distance loss, plus SimDR supervision when
    ``simdr`` is given (reference loss/loss.py:69-114); ``loss_weight[i]``
    scales the i-th term (heatmap, then SimDR).

    ``auto_weight`` applies homoscedastic-uncertainty weighting,
    ``loss_i / (2 p_i^2) + log(1 + p_i^2)``, with the trainable ``mtl_p``
    (ones at init), as the JAX package does.
    """

    def __init__(self, loss_type: str = "L2", balance: bool = True,
                 loss_weight: Sequence[float] = (1.0, 0.1),
                 auto_weight: bool = False,
                 simdr: Optional[SimDRLoss] = None):
        super().__init__()
        self.loss_type = loss_type
        self.balance = balance
        self.loss_weight = tuple(loss_weight)
        self.auto_weight = auto_weight
        if auto_weight:
            self.mtl_p = nn.Parameter(torch.ones(len(self.loss_weight)))
        self.simdr = simdr

    @classmethod
    def from_config(cls, cfg) -> "TopdownHeatmapLoss":
        simdr = (SimDRLoss.from_config(cfg)
                 if cfg.PIPELINE.get("simdr_split_ratio", 0) else None)
        return cls(
            loss_type=cfg.LOSS.get("dl_type", "L2"),
            balance=cfg.MODEL.name != "atthandnet",
            loss_weight=tuple(cfg.LOSS.loss_weight),
            auto_weight=cfg.LOSS.get("auto_weight", False),
            simdr=simdr,
        )

    def forward(self, output, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        loss_dict = {"heatmap": distance_loss(
            output, batch["target"], batch["target_weight"],
            loss_type=self.loss_type, balance=self.balance)}
        if self.simdr is not None:
            loss_dict["simdr"] = self.simdr(
                output, batch["simdr_x"], batch["simdr_y"],
                batch["target_weight"])
        names = list(loss_dict)
        for i, k in enumerate(names):
            loss_dict[k] = self.loss_weight[i] * loss_dict[k]
        total = 0.0
        for i, k in enumerate(names):
            if self.auto_weight:
                p = self.mtl_p[i]
                total = total + loss_dict[k] / (2.0 * p ** 2) + torch.log(
                    1.0 + p ** 2)
            else:
                total = total + loss_dict[k]
        return total, loss_dict


class SRHandNetLoss(nn.Module):
    """Multi-scale loss over SRHandNet's 4 outputs (reference
    loss/loss.py:7-66): with region channels, a balanced L2 term on the 21 +
    1 keypoint and center channels plus a second balanced term on the 2 w/h
    channels; without, one balanced L2 term per scale. Scale i is weighted
    by ``loss_weight[i]``. ``target`` is a list per scale, ``target_weight``
    one ``[B, C]`` or a list per scale.

    The reference's quirk is kept: its ``smoothl1_loss`` is a
    ``DistanceLoss`` left at the ``'L2'`` default (loss/loss.py:16,
    heatmapLoss.py:229), so the w/h branch is L2 (JAX :352-360,
    PARITY.md). No trainable parameters.
    """

    def __init__(self, loss_weight: Sequence[float] = (0.1, 0.2, 0.3, 0.4),
                 with_region: bool = True, num_kpt_channels: int = 22):
        super().__init__()
        self.loss_weight = tuple(loss_weight)
        self.with_region = with_region
        self.num_kpt_channels = num_kpt_channels

    @classmethod
    def from_config(cls, cfg) -> "SRHandNetLoss":
        out_c = cfg.MODEL.get("output_channel", 24)
        pred_bbox = cfg.MODEL.get("pred_bbox", False)
        return cls(loss_weight=tuple(cfg.LOSS.loss_weight),
                   with_region=bool(pred_bbox and out_c == 24))

    def forward(self, outputs, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        targets, weights = batch["target"], batch["target_weight"]
        if len(outputs) != len(self.loss_weight):
            raise ValueError(f"{len(outputs)} outputs, "
                             f"{len(self.loss_weight)} loss weights")
        if not isinstance(weights, (list, tuple)):
            weights = [weights] * len(outputs)
        nk = self.num_kpt_channels
        kpt_loss = wh_loss = 0.0
        for out, t, w, lw in zip(outputs, targets, weights, self.loss_weight):
            if self.with_region:
                kpt_loss = kpt_loss + distance_loss(
                    out[:, :nk], t[:, :nk], w[:, :nk], "L2") * lw
                # the reference's "smoothl1" term: L2 (see the docstring)
                wh_loss = wh_loss + distance_loss(
                    out[:, nk:], t[:, nk:], w[:, nk:], "L2") * lw
            else:
                kpt_loss = kpt_loss + distance_loss(out, t, w, "L2") * lw
        if not self.with_region:
            return kpt_loss, {"kpt_loss": kpt_loss}
        return kpt_loss + wh_loss, {"kpt_loss": kpt_loss, "wh_loss": wh_loss}


def centernet_focal_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """CenterNet center-heatmap focal loss (reference
    centernet_simdr_loss.py:73-107)."""
    pos = (target == 1.0).to(pred.dtype)
    neg = (target < 1.0).to(pred.dtype)
    neg_weights = (1.0 - target) ** 4
    p = pred.clamp(1e-6, 1.0 - 1e-6)
    pos_loss = (torch.log(p) * (1.0 - p) ** 2 * pos).sum()
    neg_loss = (torch.log(1.0 - p) * p ** 2 * neg_weights * neg).sum()
    n_pos = pos.sum()
    return torch.where(n_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / n_pos.clamp(min=1.0))


def reg_l1_loss(pred: torch.Tensor, target: torch.Tensor,
                mask: torch.Tensor) -> torch.Tensor:
    """Masked L1 for w/h and offset maps (reference
    centernet_simdr_loss.py:110-123)."""
    loss = torch.abs(pred * mask - target * mask).sum()
    return loss / (mask.sum() + 1e-4)


class CenterSimdrLoss(nn.Module):
    """The Gen-1 criterion of the stacked center-map + SimDR workflow
    (reference train_distributed_center_simdr_freihand.py:196): per stack,
    a balanced L2 term on the K joint channels and the center channel plus a
    balanced SmoothL1 term on the w/h channels, weighted by
    ``hm_loss_factor``; plus ``simdr_weight`` times the SimDR vector loss on
    the model's own ``pred_x`` / ``pred_y``, when the batch has SimDR
    targets (the half-resolution cycle-detection batch has none). No
    trainable parameters.

    ``outputs`` is ``(list of [B, K + 3, h, w] per stack, pred_x, pred_y)``;
    the batch holds ``target`` ``[B, K + 3, h, w]`` and ``target_weight``
    ``[B, K + 3]``.
    """

    def __init__(self, hm_loss_factor: Sequence[float] = (1.0, 1.0),
                 num_joints: int = 21, simdr_weight: float = 1.0):
        super().__init__()
        self.hm_loss_factor = tuple(hm_loss_factor)
        self.num_joints = num_joints
        self.simdr_weight = simdr_weight

    @classmethod
    def from_config(cls, cfg) -> "CenterSimdrLoss":
        return cls(
            hm_loss_factor=tuple(cfg.MODEL.get("hm_loss_factor", [1.0, 1.0])),
            num_joints=int(cfg.DATASET.num_joints),
            simdr_weight=float(cfg.LOSS.get("simdr_weight", 1.0)),
        )

    def forward(self, outputs, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        hm_preds, pred_x, pred_y = outputs
        target, weight = batch["target"], batch["target_weight"]
        c = self.num_joints + 1
        hm_loss = 0.0
        for hm, factor in zip(hm_preds, self.hm_loss_factor):
            kpt = distance_loss(hm[:, :c], target[:, :c], weight[:, :c], "L2")
            wh = distance_loss(hm[:, c:], target[:, c:], weight[:, c:],
                               "SmoothL1")
            hm_loss = hm_loss + (kpt + wh) * factor
        loss_dict = {"heatmap": hm_loss}
        if pred_x is not None and "simdr_x" in batch:
            loss_dict["simdr"] = self.simdr_weight * kl_discret_loss(
                pred_x, pred_y, batch["simdr_x"], batch["simdr_y"],
                weight[:, :self.num_joints])
        return sum(loss_dict.values()), loss_dict
