"""Center-map box detection: peak NMS, top-k candidates, IoU math and a
fixed-size greedy NMS (port of ``litehandnet_tpu/ops/detect.py``; reference
utils/evaluation.py:94-211 and utils/result_parser.py:131-229).

Every stage has a static shape: boxes come out padded, with validity in the
confidence column. Maps are channels-last ``[B, H, W, C]``, as in JAX.

Ties: ``jax.lax.top_k`` and ``jnp.argsort`` put the lower index first among
equal values (most cells of a peak-NMS'ed center map are 0). ``torch.topk``
promises no order, so ``top_k`` and the NMS sort stably.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels.blur_log import blur_log
from litehandnet_tpu_torch.ops.decode import dark_step, refine_offset_gen1


def top_k(x: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the ``k`` largest values and
    their indices, ties in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def heatmap_nms(heatmaps: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Max-pool peak NMS of ``[B, H, W, C]`` maps: cells that are not the
    maximum of their ``kernel`` window become 0 (reference result_parser.py
    heatmap_nms, HeatmapParser.py:41-50)."""
    pad = (kernel - 1) // 2
    maxima = F.max_pool2d(heatmaps.permute(0, 3, 1, 2), kernel, 1, pad)
    return torch.where(maxima.permute(0, 2, 3, 1) == heatmaps, heatmaps,
                       torch.zeros_like(heatmaps))


def vector_nms(vectors: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """1-D peak NMS over the last axis of ``[B, K, D]`` (reference
    result_parser.py:61-74)."""
    pad = (kernel - 1) // 2
    B, K, D = vectors.shape
    maxima = F.max_pool1d(vectors.reshape(B * K, 1, D), kernel, 1, pad)
    return torch.where(maxima.reshape(B, K, D) == vectors, vectors,
                       torch.zeros_like(vectors))


def smooth_avg_pool(x: torch.Tensor, kernel: int = 3) -> torch.Tensor:
    """Size-preserving average pooling of ``[B, H, W, C]`` that divides by
    kernel² everywhere (torch ``AvgPool2d``'s ``count_include_pad``, which
    the reference relies on, result_parser.py:20-23)."""
    pad = (kernel - 1) // 2
    out = F.avg_pool2d(x.permute(0, 3, 1, 2), kernel, 1, pad,
                       count_include_pad=True)
    return out.permute(0, 2, 3, 1)


def candidate_bboxes(center_maps: torch.Tensor, size_maps: torch.Tensor,
                     num_candidates: int = 20, feature_stride: float = 4.0,
                     wh_scale=None, refine: str = "offset", kernel: int = 19,
                     wh_clip=None) -> torch.Tensor:
    """Top-k candidate boxes from center and size maps (reference
    result_parser.py:131-172, HeatmapParser.py:52-86).

    w/h are read at the raw integer top-k cell of the 3x3-averaged size
    maps, before the center is refined, as the reference orders it.

    Args:
        center_maps: ``[B, H, W, 1]`` peak-NMS'ed center map.
        size_maps: ``[B, H, W, 2]`` width/height maps; their unit times
            ``wh_scale`` (a scalar or (w, h); ``feature_stride`` when None)
            is input pixels.
        refine: 'dark' (blur + log + Newton step, through ``blur_log``),
            'offset' (clamped ±0.25 + 0.5) or 'none' (the raw cell).
        kernel: DARK blur kernel (the reference's pcfg['blue_kernel'] = 19).
        wh_clip: optional (lo, hi) clip of the w/h read.

    Returns:
        ``[B, k, 5]`` (cx, cy, w, h, conf) in input pixels.

    JAX refines the k candidates on k broadcast copies of the one center
    map. Here the DARK branch blurs that map once (one ``blur_log`` launch
    on ``[B, H, W, 1]``) and reads every candidate's Newton step from it
    through a stride-0 view: the same numbers.
    """
    B, H, W, _ = center_maps.shape
    top_val, top_idx = top_k(center_maps[..., 0].reshape(B, H * W),
                             num_candidates)
    x = (top_idx % W).float()
    y = (top_idx // W).float()
    flat_wh = smooth_avg_pool(size_maps, 3).reshape(B, H * W, 2)
    wh = torch.gather(flat_wh, 1, top_idx[..., None].expand(-1, -1, 2))
    if wh_clip is not None:
        wh = wh.clamp(wh_clip[0], wh_clip[1])

    if refine != "none":
        preds = torch.stack([x, y], dim=-1)  # [B, k, 2]
        if refine == "dark":
            log_map = blur_log(center_maps.contiguous(), kernel)
            preds = dark_step(log_map.expand(B, H, W, num_candidates), preds)
        else:
            preds = refine_offset_gen1(
                center_maps.expand(B, H, W, num_candidates), preds)
        x, y = preds[..., 0], preds[..., 1]

    if wh_scale is None:
        wh_scale = (feature_stride, feature_stride)
    elif not isinstance(wh_scale, (tuple, list, torch.Tensor)):
        wh_scale = (wh_scale, wh_scale)
    return torch.stack([x * feature_stride, y * feature_stride,
                        wh[..., 0] * wh_scale[0], wh[..., 1] * wh_scale[1],
                        top_val], dim=-1)


def xywh2xyxy(boxes: torch.Tensor) -> torch.Tensor:
    """(cx, cy, w, h) -> (x1, y1, x2, y2) (reference bbox_metric.py)."""
    cx, cy, w, h = boxes.unbind(-1)[:4]
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], -1)


def xyxy2xywh(boxes: torch.Tensor) -> torch.Tensor:
    """(x1, y1, x2, y2) -> (cx, cy, w, h) (reference bbox_metric.py)."""
    x1, y1, x2, y2 = boxes.unbind(-1)[:4]
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], -1)


def bbox_iou(box1: torch.Tensor, boxes2: torch.Tensor, xyxy: bool = False,
             giou: bool = False, diou: bool = False, ciou: bool = False,
             eps: float = 1e-9) -> torch.Tensor:
    """IoU (or GIoU / DIoU / CIoU) of ``box1`` against ``boxes2``,
    broadcast over leading axes (reference utils/bbox_metric.py:76-133)."""
    b1, b2 = (box1, boxes2) if xyxy else (xywh2xyxy(box1), xywh2xyxy(boxes2))
    inter = ((torch.minimum(b1[..., 2], b2[..., 2])
              - torch.maximum(b1[..., 0], b2[..., 0])).clamp(min=0)
             * (torch.minimum(b1[..., 3], b2[..., 3])
                - torch.maximum(b1[..., 1], b2[..., 1])).clamp(min=0))
    area1 = (b1[..., 2] - b1[..., 0]) * (b1[..., 3] - b1[..., 1])
    area2 = (b2[..., 2] - b2[..., 0]) * (b2[..., 3] - b2[..., 1])
    union = area1 + area2 - inter + eps
    iou = inter / union
    if not (giou or diou or ciou):
        return iou
    cw = torch.maximum(b1[..., 2], b2[..., 2]) - torch.minimum(b1[..., 0], b2[..., 0])
    ch = torch.maximum(b1[..., 3], b2[..., 3]) - torch.minimum(b1[..., 1], b2[..., 1])
    if giou:
        c_area = cw * ch + eps
        return iou - (c_area - union) / c_area
    c2 = cw ** 2 + ch ** 2 + eps
    rho2 = (((b2[..., 0] + b2[..., 2]) - (b1[..., 0] + b1[..., 2])) ** 2
            + ((b2[..., 1] + b2[..., 3]) - (b1[..., 1] + b1[..., 3])) ** 2) / 4.0
    if diou:
        return iou - rho2 / c2
    w1, h1 = b1[..., 2] - b1[..., 0], b1[..., 3] - b1[..., 1]
    w2, h2 = b2[..., 2] - b2[..., 0], b2[..., 3] - b2[..., 1]
    v = (4 / math.pi ** 2) * (torch.atan(w2 / (h2 + eps))
                              - torch.atan(w1 / (h1 + eps))) ** 2
    alpha = v / (v - iou + (1 + eps))
    return iou - (rho2 / c2 + v * alpha)


def masked_nms(candidates: torch.Tensor, iou_threshold: float = 0.6,
               conf_threshold: float = 0.1, max_out: int = 10,
               min_wh: float = 2.0, max_wh: float = 4096.0) -> torch.Tensor:
    """Fixed-size greedy IoU NMS (reference result_parser.py:174-214,
    evaluation.py:166-211, which return ragged lists): candidates
    ``[B, k, 5]`` (cx, cy, w, h, conf) in any order -> ``[B, min(k,
    max_out), 5]``, kept boxes by falling confidence, then the suppressed
    and invalid ones at confidence 0."""
    conf = candidates[..., 4]
    w, h = candidates[..., 2], candidates[..., 3]
    valid = ((conf > conf_threshold) & (w > min_wh) & (w < max_wh)
             & (h > min_wh) & (h < max_wh))
    conf = torch.where(valid, conf, torch.zeros_like(conf))
    k = candidates.shape[1]
    order = torch.argsort(-conf, dim=1, stable=True)
    boxes = torch.gather(candidates, 1, order[..., None].expand(-1, -1, 5))
    conf = torch.gather(conf, 1, order)
    alive = conf > 0
    later = torch.arange(k, device=conf.device)
    for i in range(k):
        keep_i = alive[:, i] & (conf[:, i] > 0)
        ious = bbox_iou(boxes[:, i:i + 1, :4], boxes[..., :4])  # [B, k]
        suppress = (ious > iou_threshold) & keep_i[:, None] & (later > i)
        alive = alive & ~suppress
    final = torch.where(alive, conf, torch.zeros_like(conf))
    out_order = torch.argsort(-final, dim=1, stable=True)[:, :max_out]
    out = torch.gather(boxes, 1, out_order[..., None].expand(-1, -1, 5))
    return torch.cat([out[..., :4], torch.gather(final, 1, out_order)[..., None]],
                     dim=-1)


def clip_boxes(boxes: torch.Tensor, width: float, height: float) -> torch.Tensor:
    """Clip xyxy boxes to the image (reference bbox_transform.py)."""
    x1, y1, x2, y2 = boxes.unbind(-1)[:4]
    return torch.stack([x1.clamp(0, width), y1.clamp(0, height),
                        x2.clamp(0, width), y2.clamp(0, height)], -1)


def rescale_boxes(boxes: torch.Tensor, scale: float) -> torch.Tensor:
    """Scale box coordinates (reference bbox_transform.py)."""
    return boxes * scale


def flip_boxes(boxes: torch.Tensor, width: float) -> torch.Tensor:
    """Horizontal flip of xyxy boxes (reference bbox_transform.py)."""
    x1, y1, x2, y2 = boxes.unbind(-1)[:4]
    return torch.stack([width - x2, y1, width - x1, y2], -1)
