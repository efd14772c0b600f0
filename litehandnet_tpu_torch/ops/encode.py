"""Target encoding (port of ``litehandnet_tpu/ops/encode.py``): Gaussian
heatmaps (MSRA, unbiased-DARK and UDP), SimDR 1-D vectors and SRHandNet
region maps, each batched over a leading dimension B.

The reference paints per-joint Gaussian windows in Python loops
(generateTarget.py:74-366, generate_simder.py:9-31); here one broadcast
expression gives the same values. Targets are ``[B, K, H, W]``, the port's
heatmap layout. Coordinate quantization uses ``torch.trunc`` to reproduce
Python's ``int()``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def _div_xy(xy: torch.Tensor, sx: float, sy: float) -> torch.Tensor:
    """``xy / [sx, sy]`` over the last dimension, with python-float
    divisors (a device tensor made from host values would wait for the
    card)."""
    return torch.stack([xy[..., 0] / sx, xy[..., 1] / sy], dim=-1)


def _grids(height: int, width: int, device):
    """Pixel coordinates broadcastable against ``[B, K, H, W]``."""
    xs = torch.arange(width, dtype=torch.float32, device=device)
    ys = torch.arange(height, dtype=torch.float32, device=device)
    return xs.view(1, 1, 1, width), ys.view(1, 1, height, 1)


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
    tmp_size = sigma * 3.0

    # python-float strides: no host-to-device copy
    mu_exact = _div_xy(joints, image_size[0] / W, image_size[1] / H)
    mu = mu_exact if unbiased else torch.trunc(mu_exact + 0.5)
    ul = mu - tmp_size
    br = mu + tmp_size + 1.0
    if not unbiased:
        ul = torch.trunc(ul)
        br = torch.trunc(br)
    in_bounds = ((ul[..., 0] < W) & (ul[..., 1] < H)
                 & (br[..., 0] >= 0) & (br[..., 1] >= 0))
    weight = vis * in_bounds.float()

    xs, ys = _grids(H, W, dev)
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


def udp_heatmaps(
    joints: torch.Tensor,
    visibility: torch.Tensor,
    image_size,
    heatmap_size,
    sigma: float = 2.0,
    joint_weights: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """UDP Gaussian heatmaps (reference generateTarget.py:162-243): stride
    ``(image - 1) / (heatmap - 1)``, the Gaussian at the exact sub-pixel
    location and the paint window anchored at the quantized center.

    Args and returns as :func:`msra_heatmaps`.
    """
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    joints = torch.as_tensor(joints, dtype=torch.float32)[..., :2]
    dev = joints.device
    vis = torch.as_tensor(visibility, dtype=torch.float32, device=dev)
    vis = vis.reshape(joints.shape[:2])
    tmp_size = sigma * 3.0

    mu_exact = _div_xy(joints, (image_size[0] - 1.0) / (W - 1.0),
                       (image_size[1] - 1.0) / (H - 1.0))
    mu = torch.trunc(mu_exact + 0.5)
    ul = torch.trunc(mu - tmp_size)
    br = torch.trunc(mu + tmp_size + 1.0)
    in_bounds = ((ul[..., 0] < W) & (ul[..., 1] < H)
                 & (br[..., 0] >= 0) & (br[..., 1] >= 0))
    weight = vis * in_bounds.float()

    xs, ys = _grids(H, W, dev)
    cx = mu_exact[..., 0, None, None]
    cy = mu_exact[..., 1, None, None]
    g = torch.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / (2.0 * sigma ** 2))
    win = ((xs >= ul[..., 0, None, None]) & (xs < br[..., 0, None, None])
           & (ys >= ul[..., 1, None, None]) & (ys < br[..., 1, None, None]))
    g = torch.where(win, g, torch.zeros_like(g))
    target = g * (weight > 0.5).float()[..., None, None]
    if joint_weights is not None:
        weight = weight * torch.as_tensor(joint_weights, dtype=torch.float32,
                                          device=dev).reshape(1, -1)
    return target, weight


def simdr_targets(
    joints: torch.Tensor,
    weight: torch.Tensor,
    image_size,
    split_ratio: int = 2,
    sigma: float = 2.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SimDR 1-D classification targets (reference generate_simder.py:9-31).

    Args:
        joints: ``[B, K, 2]`` keypoints in input-image pixels.
        weight: ``[B, K]`` target weights (painted where > 0).
        image_size: (w, h) input size.
        split_ratio: the SimDR upsampling factor k.
        sigma: 1-D Gaussian sigma in split units (not scaled by k).

    Returns:
        (target_x ``[B, K, W*k]``, target_y ``[B, K, H*k]``) float32.
    """
    k = int(split_ratio)
    Wk, Hk = int(image_size[0] * k), int(image_size[1] * k)
    joints = torch.as_tensor(joints, dtype=torch.float32)[..., :2]
    dev = joints.device
    w = (torch.as_tensor(weight, dtype=torch.float32, device=dev)
         .reshape(joints.shape[:2]) > 0).float()[..., None]
    mu = joints * k
    x = torch.arange(Wk, dtype=torch.float32, device=dev)
    y = torch.arange(Hk, dtype=torch.float32, device=dev)
    tx = torch.exp(-((x - mu[..., 0:1]) ** 2) / (2.0 * sigma ** 2)) * w
    ty = torch.exp(-((y - mu[..., 1:2]) ** 2) / (2.0 * sigma ** 2)) * w
    return tx, ty


def region_map(
    bbox: torch.Tensor,
    image_size,
    heatmap_size,
    sigma: float = 2.0,
    encoding: str = "MSRA",
    patch: str = "srhandnet",
) -> torch.Tensor:
    """SRHandNet 3-channel region map (reference generateTarget.py:321-366).

    Channel 0 is a Gaussian at the bbox center; channels 1 and 2 are a patch
    at the center holding the ratios w/img_w and h/img_h. ``patch`` picks
    its extent: ``"srhandnet"`` paints the Gen-2 5x5 square
    (generateTarget.py:358), ``"gen1"`` the Gen-1 +-3*sigma window
    (data/handset/dataset_function.py:199-207).

    Args:
        bbox: ``[B, 4]`` (x, y, w, h) in input-image pixels.
        image_size: (w, h) input size.
        heatmap_size: (w, h) heatmap size.

    Returns:
        ``[B, 3, H, W]`` float32.
    """
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    bbox = torch.as_tensor(bbox, dtype=torch.float32)
    dev = bbox.device
    center = bbox[:, :2] + bbox[:, 2:] / 2.0
    wh = bbox[:, 2:]
    ones = torch.ones(bbox.shape[0], 1, device=dev)
    encode = msra_heatmaps if encoding.upper() == "MSRA" else udp_heatmaps
    center_hm, _ = encode(center[:, None, :], ones, image_size, heatmap_size,
                          sigma)  # [B, 1, H, W]

    gamma = torch.clamp(_div_xy(wh, float(image_size[0]),
                                float(image_size[1])), 0.0, 1.0)
    cxy = torch.stack([center[:, 0] * float(W / image_size[0]),
                       center[:, 1] * float(H / image_size[1])], dim=-1)
    # the 5x5 SRHandNet patch, or the Gen-1 +-3*sigma window
    tmp = 2.0 if patch == "srhandnet" else 3.0 * float(sigma)
    ul = torch.trunc(cxy - tmp)[:, :, None, None]
    br = torch.trunc(cxy + tmp + 1.0)[:, :, None, None]
    xs, ys = _grids(H, W, dev)
    inside = ((xs >= ul[:, 0:1]) & (xs < br[:, 0:1])
              & (ys >= ul[:, 1:2]) & (ys < br[:, 1:2])).float()  # [B,1,H,W]
    wx = inside * gamma[:, 0, None, None, None]
    hy = inside * gamma[:, 1, None, None, None]
    return torch.cat([center_hm, wx, hy], dim=1)
