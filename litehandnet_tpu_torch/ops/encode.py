"""Gaussian heatmap targets (port of ``litehandnet_tpu/ops/encode.py``:
``msra_heatmaps``, biased and unbiased-DARK, :30-103), batched over B.

The reference paints per-joint Gaussian windows in Python loops
(generateTarget.py:74-159); here one broadcast expression gives the same
values. Targets are ``[B, K, H, W]``, the port's heatmap layout. Coordinate
quantization uses ``torch.trunc`` to reproduce Python's ``int()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def msra_heatmaps(
    joints: torch.Tensor,
    visibility: torch.Tensor,
    image_size,
    heatmap_size,
    sigma: float = 2.0,
    unbiased: bool = False,
    joint_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """MSRA Gaussian heatmap targets.

    Args:
        joints: ``[B, K, 2]`` keypoints in input-image pixels (x, y); extra
            trailing columns are ignored.
        visibility: ``[B, K]`` visibility flags (0/1).
        image_size: (w, h) input size.
        heatmap_size: (w, h) heatmap size.
        sigma: Gaussian sigma in heatmap pixels.
        unbiased: DARK encoding, a full-map Gaussian at the exact center.
        joint_weights: optional ``[K]`` per-joint loss weights.

    Returns:
        (target ``[B, K, H, W]`` float32, weight ``[B, K]`` float32). A joint
        whose window lies outside the map gets weight 0 and an empty map.
    """
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    joints = torch.as_tensor(joints, dtype=torch.float32)[..., :2]
    dev = joints.device
    vis = torch.as_tensor(visibility, dtype=torch.float32, device=dev)
    vis = vis.reshape(joints.shape[:2])
    stride = torch.tensor([image_size[0] / W, image_size[1] / H],
                          dtype=torch.float32, device=dev)
    tmp_size = sigma * 3.0

    mu_exact = joints / stride  # [B, K, 2]
    mu = mu_exact if unbiased else torch.trunc(mu_exact + 0.5)
    ul = mu - tmp_size
    br = mu + tmp_size + 1.0
    if not unbiased:
        ul = torch.trunc(ul)
        br = torch.trunc(br)
    in_bounds = ((ul[..., 0] < W) & (ul[..., 1] < H)
                 & (br[..., 0] >= 0) & (br[..., 1] >= 0))
    weight = vis * in_bounds.float()

    xs = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, 1, W)
    ys = torch.arange(H, dtype=torch.float32, device=dev).view(1, 1, H, 1)
    cx = mu[..., 0, None, None]  # [B, K, 1, 1]
    cy = mu[..., 1, None, None]
    g = torch.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma ** 2))
    if not unbiased:
        win = ((xs >= ul[..., 0, None, None]) & (xs < br[..., 0, None, None])
               & (ys >= ul[..., 1, None, None]) & (ys < br[..., 1, None, None]))
        g = torch.where(win, g, torch.zeros_like(g))
    target = g * (weight > 0.5).float()[..., None, None]
    if joint_weights is not None:
        weight = weight * torch.as_tensor(joint_weights, dtype=torch.float32,
                                          device=dev).reshape(1, -1)
    return target, weight
