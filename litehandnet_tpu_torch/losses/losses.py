"""Heatmap losses (port of ``litehandnet_tpu/losses/losses.py``:
``distance_loss`` :38-94 and ``TopdownHeatmapLoss`` :281-346).

Heatmap outputs and targets are ``[B, K, H, W]`` (the port's layout),
target weights ``[B, K]``.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

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


class TopdownHeatmapLoss(nn.Module):
    """Balanced heatmap distance loss (reference loss/loss.py:69-114).

    ``auto_weight`` applies homoscedastic-uncertainty weighting,
    ``loss_i / (2 p_i^2) + log(1 + p_i^2)``, with the trainable ``mtl_p``
    (ones at init), as the JAX package does. SimDR supervision is not ported
    yet.
    """

    def __init__(self, loss_type: str = "L2", balance: bool = True,
                 loss_weight: Sequence[float] = (1.0, 0.1),
                 auto_weight: bool = False):
        super().__init__()
        self.loss_type = loss_type
        self.balance = balance
        self.loss_weight = tuple(loss_weight)
        self.auto_weight = auto_weight
        if auto_weight:
            self.mtl_p = nn.Parameter(torch.ones(len(self.loss_weight)))

    @classmethod
    def from_config(cls, cfg) -> "TopdownHeatmapLoss":
        if cfg.PIPELINE.get("simdr_split_ratio", 0):
            raise KeyError("TopdownHeatmapLoss with SimDR supervision "
                           "(PIPELINE.simdr_split_ratio > 0) is not ported yet")
        return cls(
            loss_type=cfg.LOSS.get("dl_type", "L2"),
            balance=cfg.MODEL.name != "atthandnet",
            loss_weight=tuple(cfg.LOSS.loss_weight),
            auto_weight=cfg.LOSS.get("auto_weight", False),
        )

    def forward(self, output, batch) -> Tuple[torch.Tensor,
                                              Dict[str, torch.Tensor]]:
        loss_dict = {"heatmap": distance_loss(
            output, batch["target"], batch["target_weight"],
            loss_type=self.loss_type, balance=self.balance)}
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
