"""Bottom-up heatmap parsing with tag-based grouping, the Gen-1 lineage (port
of ``litehandnet_tpu/eval/heatmap_parser.py``; reference
utils/HeatmapParser.py:14-223 and utils/SPheatmapParser.py:12-240).

Center-map candidate boxes, then per box and joint the top-k peaks inside the
box window, grouped by associative-embedding tag (the least |tag - center
tag|), plus the ±0.25 offset adjustment.

The per-box Python loops of the reference are one batched program on the
parser's device: a masked top-k over the full map per (box, joint) pair.
Outputs are fixed size, ``[B, max_boxes, K, 4]`` (x, y, conf, tag). Top-k
ties (the zero plateaus of peak-NMS'ed maps) go to the lower flat index and
``argmin`` ties to the first slot, as in JAX. The parse launches no
hand-written kernel: the candidate boxes are read at their raw cells
(``refine="none"``), so ``blur_log`` does not run.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import pcfg
from litehandnet_tpu_torch.eval.result_parser import to_numpy
from litehandnet_tpu_torch.ops.detect import (
    candidate_bboxes,
    heatmap_nms,
    masked_nms,
    top_k,
)


def _group_by_tags(heatmaps: torch.Tensor, tag_maps: torch.Tensor,
                   boxes: torch.Tensor, bbox_factor: float,
                   feature_stride: float, bbox_k: int = 8) -> torch.Tensor:
    """Per-box, per-joint tag grouping (reference HeatmapParser.py:88-195).

    Args:
        heatmaps: ``[B, H, W, K]`` peak-NMS'ed joint heatmaps.
        tag_maps: ``[B, H, W, K]`` tag embeddings, or ``[B, H, W, 1]``
            shared by every joint.
        boxes: ``[B, M, 5]`` (cx, cy, w, h, conf) in image pixels.

    Returns:
        ``[B, M, K, 4]`` (x, y, conf, tag) in heatmap cells; 0 for a box of
        confidence <= 0.
    """
    B, H, W, K = heatmaps.shape
    M = boxes.shape[1]
    dev = heatmaps.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)
    ys = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    tag_maps = tag_maps.expand(B, H, W, K)
    bx = boxes[..., None, None]                                # [B, M, 1, 1]
    cx = bx[:, :, 0] / feature_stride
    cy = bx[:, :, 1] / feature_stride
    w = bx[:, :, 2] * bbox_factor / feature_stride
    h = bx[:, :, 3] * bbox_factor / feature_stride
    mask = ((xs >= cx - w / 2) & (xs <= cx + w / 2)
            & (ys >= cy - h / 2) & (ys <= cy + h / 2))        # [B, M, H, W]
    flat = heatmaps.permute(0, 3, 1, 2).reshape(B, 1, K, H * W)
    masked = torch.where(mask.reshape(B, M, 1, H * W), flat,
                         torch.full_like(flat, -torch.inf))    # [B, M, K, HW]
    val_k, idx_k = top_k(masked, bbox_k)                       # [B, M, K, k]
    tag_flat = tag_maps.permute(0, 3, 1, 2).reshape(B, 1, K, H * W)
    tag_k = torch.gather(tag_flat.expand(B, M, K, H * W), 3, idx_k)

    cxi = torch.trunc(cx[..., 0, 0] + 0.5).long().clamp(0, W - 1)  # [B, M]
    cyi = torch.trunc(cy[..., 0, 0] + 0.5).long().clamp(0, H - 1)
    center_tag = torch.gather(tag_maps[..., 0].reshape(B, H * W), 1,
                              cyi * W + cxi)                  # [B, M]
    # filler slots (a window smaller than bbox_k) hold -inf at cells outside
    # the window; their tags must not compete in the match
    dist = torch.where(torch.isfinite(val_k),
                       (tag_k - center_tag[..., None, None]).abs(),
                       torch.full_like(tag_k, torch.inf))
    pick = torch.argmin(dist, dim=-1, keepdim=True)            # [B, M, K, 1]
    idx = torch.gather(idx_k, 3, pick)[..., 0]
    conf = torch.gather(val_k, 3, pick)[..., 0]
    tag = torch.gather(tag_k, 3, pick)[..., 0]
    out = torch.stack([(idx % W).float(), (idx // W).float(),
                       torch.where(torch.isfinite(conf), conf,
                                   torch.zeros_like(conf)), tag], dim=-1)
    return out * (boxes[..., 4] > 0)[..., None, None]


def _adjust_quarter(keypoints: torch.Tensor,
                    heatmaps: torch.Tensor) -> torch.Tensor:
    """±0.25 shift toward the larger neighbour (reference
    HeatmapParser.py:197-223): strict ``>`` between the clamped neighbours,
    at the borders too, applied only where conf > 0.

    Args:
        keypoints: ``[B, M, K, 4]``; heatmaps: ``[B, H, W, K]``.
    """
    B, H, W, K = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, K)
    xc = torch.trunc(keypoints[..., 0]).long().clamp(0, W - 1)  # [B, M, K]
    yc = torch.trunc(keypoints[..., 1]).long().clamp(0, H - 1)

    def v(dx, dy):
        ii = (yc + dy).clamp(0, H - 1) * W + (xc + dx).clamp(0, W - 1)
        return torch.gather(flat, 1, ii)

    dx = torch.where(v(1, 0) > v(-1, 0), 0.25, -0.25)
    dy = torch.where(v(0, 1) > v(0, -1), 0.25, -0.25)
    valid = (keypoints[..., 2] > 0).float()
    shift = torch.stack([dx * valid, dy * valid], dim=-1)
    return torch.cat([keypoints[..., :2] + shift, keypoints[..., 2:]], dim=-1)


class HeatmapParser:
    """Multi-hand bottom-up parser (reference utils/HeatmapParser.py).

    Args:
        cfg: experiment config (``DATASET.image_size``, ``heatmap_size``).
        device: where the parse runs.

    The other arguments override ``pcfg``'s values.

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """

    def __init__(self, cfg, num_candidates: Optional[int] = None,
                 bbox_k: Optional[int] = None,
                 max_num_bbox: Optional[int] = None, device="cuda"):
        self.device = resolve_device(device)
        self.image_size = tuple(int(v) for v in cfg.DATASET.image_size)
        self.heatmap_size = tuple(int(v) for v in cfg.DATASET.heatmap_size)
        self.feature_stride = self.image_size[0] / self.heatmap_size[0]

        def pick(value, default):
            return int(default if value is None else value)

        self.num_candidates = pick(num_candidates, pcfg.num_candidates)
        self.bbox_k = pick(bbox_k, pcfg.bbox_k)
        self.max_num_bbox = pick(max_num_bbox, pcfg.max_num_bbox)
        self.bbox_factor = float(pcfg.bbox_factor)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def parse_tensors(self, center_maps, size_maps, joint_heatmaps, tag_maps,
                      adjust: bool = True):
        """``parse`` with its results left on the parser's device."""
        joint_heatmaps = self._tensor(joint_heatmaps)
        center = heatmap_nms(self._tensor(center_maps), int(pcfg.nms_kernel))
        cands = candidate_bboxes(
            center, self._tensor(size_maps), self.num_candidates,
            self.feature_stride, wh_scale=self.image_size,
            # HeatmapParser.py:52-86: raw argmax centers, ratios clipped
            refine="none", wh_clip=(0.0, 0.99))
        boxes = masked_nms(cands, float(pcfg.iou_threshold),
                           float(pcfg.detection_threshold), self.max_num_bbox)
        peaks = heatmap_nms(joint_heatmaps, 3)
        kpts = _group_by_tags(peaks, self._tensor(tag_maps), boxes,
                              self.bbox_factor, self.feature_stride,
                              bbox_k=self.bbox_k)
        if adjust:
            kpts = _adjust_quarter(kpts, joint_heatmaps)
        return boxes, kpts

    def parse(self, center_maps, size_maps, joint_heatmaps, tag_maps,
              adjust: bool = True):
        """Full bottom-up parse.

        Args:
            center_maps: ``[B, H, W, 1]``; size_maps: ``[B, H, W, 2]``;
                joint_heatmaps: ``[B, H, W, K]``; tag_maps:
                ``[B, H, W, K or 1]``. Arrays or tensors on any device.

        Returns:
            numpy (boxes ``[B, max_num_bbox, 5]`` in image pixels,
            keypoints ``[B, max_num_bbox, K, 4]`` in heatmap cells).
        """
        boxes, kpts = self.parse_tensors(center_maps, size_maps,
                                         joint_heatmaps, tag_maps, adjust)
        return to_numpy(boxes), to_numpy(kpts)


class HeatmapParserSH(HeatmapParser):
    """Single-hand variant (reference utils/SPheatmapParser.py:12-240): no
    box detection, one group spanning the whole map."""

    def parse_single(self, joint_heatmaps, adjust: bool = True) -> np.ndarray:
        """Keypoints ``[B, K, 4]`` (x, y, conf, tag) in heatmap cells, as
        numpy."""
        joint_heatmaps = self._tensor(joint_heatmaps)
        B = joint_heatmaps.shape[0]
        w, h = self.image_size
        full = self._tensor([w / 2, h / 2, w, h, 1.0]).expand(B, 1, 5)
        peaks = heatmap_nms(joint_heatmaps, 3)
        kpts = _group_by_tags(peaks, torch.ones_like(peaks[..., :1]), full,
                              1.0, self.feature_stride, bbox_k=1)
        if adjust:
            kpts = _adjust_quarter(kpts, joint_heatmaps)
        return to_numpy(kpts[:, 0])
