"""CenterNet-style utilities: letterbox, pooled NMS, bbox decode, Gaussian
targets (port of ``litehandnet_tpu/utils/centermap.py``; reference
utils/utils_centermap.py:8-234).

``pool_nms`` and ``decode_bbox`` take channels-last ``[B, H, W, C]`` tensors
and run on the tensor's own device; ``letterbox``, ``gaussian_radius`` and
``draw_gaussian`` are host numpy.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.ops.detect import top_k


def letterbox(image: np.ndarray, size) -> np.ndarray:
    """Resize keeping the aspect ratio (PIL bicubic), pad with gray 128
    (reference :8-30)."""
    from PIL import Image

    w, h = size
    ih, iw = image.shape[:2]
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    resized = np.asarray(
        Image.fromarray(image).resize((nw, nh), Image.BICUBIC)
    )
    canvas = np.full((h, w, 3), 128, np.uint8)
    dx, dy = (w - nw) // 2, (h - nh) // 2
    canvas[dy:dy + nh, dx:dx + nw] = resized
    return canvas


def pool_nms(heat: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Max-pool peak NMS of ``[B, H, W, C]`` (reference :33-37): a cell that
    is not the maximum of its window (padded with -inf) becomes 0."""
    pad = (kernel - 1) // 2
    hmax = F.max_pool2d(heat.permute(0, 3, 1, 2), kernel, 1, pad)
    return torch.where(hmax.permute(0, 2, 3, 1) == heat, heat,
                       torch.zeros_like(heat))


def decode_bbox(center_heat: torch.Tensor, wh_map: torch.Tensor,
                offset_map: torch.Tensor, confidence: float = 0.3,
                max_out: int = 100) -> torch.Tensor:
    """CenterNet bbox decode (reference :40-100): peak NMS -> top-k centers
    (ties to the lower index, as ``jax.lax.top_k``) -> wh and offset reads ->
    normalized (x1, y1, x2, y2, conf), fixed size ``[B, max_out, 5]``.

    Args:
        center_heat: ``[B, H, W, 1]``; wh_map, offset_map: ``[B, H, W, 2]``.
    """
    B, H, W, _ = center_heat.shape
    heat = pool_nms(center_heat)[..., 0].reshape(B, H * W)
    top_val, top_idx = top_k(heat, max_out)
    xs = (top_idx % W).float()
    ys = (top_idx // W).float()
    idx = top_idx[..., None].expand(-1, -1, 2)
    wh = torch.gather(wh_map.reshape(B, H * W, 2), 1, idx)
    off = torch.gather(offset_map.reshape(B, H * W, 2), 1, idx)
    cx = (xs + off[..., 0]) / W
    cy = (ys + off[..., 1]) / H
    w = wh[..., 0] / W
    h = wh[..., 1] / H
    conf = torch.where(top_val > confidence, top_val,
                       torch.zeros_like(top_val))
    return torch.stack(
        [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2, conf], dim=-1)


def gaussian_radius(det_size, min_overlap=0.7) -> int:
    """Least Gaussian radius keeping IoU >= min_overlap (reference
    :211-234, with its max(0, int(...)) truncation: ``draw_gaussian`` takes
    an integer radius)."""
    height, width = det_size
    a1 = 1
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + np.sqrt(b1**2 - 4 * a1 * c1)) / 2

    a2 = 4
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + np.sqrt(b2**2 - 4 * a2 * c2)) / 2

    a3 = 4 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + np.sqrt(b3**2 - 4 * a3 * c3)) / 2
    return max(0, int(min(r1, r2, r3)))


def draw_gaussian(heatmap: np.ndarray, center, radius: int, k: float = 1.0):
    """Paint a clipped Gaussian into ``heatmap`` in place (reference
    :174-210)."""
    diameter = 2 * radius + 1
    sigma = diameter / 6
    y, x = np.ogrid[-radius:radius + 1, -radius:radius + 1]
    gaussian = np.exp(-(x * x + y * y) / (2 * sigma * sigma))
    gaussian[gaussian < np.finfo(gaussian.dtype).eps * gaussian.max()] = 0

    cx, cy = int(center[0]), int(center[1])
    H, W = heatmap.shape
    left, right = min(cx, radius), min(W - cx, radius + 1)
    top, bottom = min(cy, radius), min(H - cy, radius + 1)
    masked_hm = heatmap[cy - top:cy + bottom, cx - left:cx + right]
    masked_g = gaussian[radius - top:radius + bottom,
                        radius - left:radius + right]
    if min(masked_g.shape) > 0 and min(masked_hm.shape) > 0:
        np.maximum(masked_hm, masked_g * k, out=masked_hm)
    return heatmap
