"""Gen-1 evaluation helpers (port of ``litehandnet_tpu/eval/legacy_eval.py``;
reference utils/evaluation.py), the metrics of the Gen-1 trainers:

* ``heatmap_pck``         <- ``evaluate_pck``  (evaluation.py:10-59)
* ``cs_from_region_map``  <- same name         (evaluation.py:94-163)
* ``non_max_suppression`` <- same name         (evaluation.py:166-211)
* ``evaluate_ap``         <- same name         (evaluation.py:214-238)

This lineage reads w/h as the mean of a ±3σ window of the raw maps scaled by
the feature stride, where ``eval.result_parser`` average-pools at the top-k
cell and scales by the image size; the reference has both and both are kept.
The candidate extraction is one batched tensor program on the maps' device;
the NMS and AP bookkeeping is host numpy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import torch

from litehandnet_tpu_torch.config import pcfg
from litehandnet_tpu_torch.eval.ap import count_ap
from litehandnet_tpu_torch.ops.detect import top_k


def heatmap_pck(pred_heatmaps, gt_heatmaps, bbox, image_size=256,
                target_weight=None, thr=0.2) -> float:
    """Heatmap-space PCK (reference ``evaluate_pck``, evaluation.py:10-59):
    argmax coordinates of both maps, scaled to image space, within ``thr *
    max(w, h)`` of each sample's first box. Kept quirks: coordinates are 0
    where the map's max is <= 0, and a sample's score divides by the
    duplicated weight sum, then multiplies by 2.

    Args:
        pred_heatmaps / gt_heatmaps: ``[B, H, W, K]`` numpy.
        bbox: ``[B, M, 4]`` (cx, cy, w, h); only box 0 is used.
        image_size: scalar or (w, h) of the model input.
        target_weight: optional ``[B, K, 1]`` visibility weights.
    """
    pred_heatmaps = np.asarray(pred_heatmaps)
    gt_heatmaps = np.asarray(gt_heatmaps)
    bbox = np.asarray(bbox, np.float32)[:, 0]
    B, H, W, K = pred_heatmaps.shape

    def coords(hm):
        flat = hm.reshape(B, H * W, K)
        idx = flat.argmax(axis=1)
        val = flat.max(axis=1)
        c = np.stack([(idx % W), (idx // W)], axis=-1).astype(np.float32)
        return c * (val > 0)[..., None]

    factor = np.broadcast_to(np.asarray(image_size, np.float32), (2,)
                             ) / np.array([W, H], np.float32)
    pred = coords(pred_heatmaps) * factor
    target = coords(gt_heatmaps) * factor
    max_wh = bbox[:, 2:4].max(axis=-1)
    if target_weight is None:
        tw = np.ones((B, K, 2), np.float32)
    else:
        tw = np.repeat(np.asarray(target_weight, np.float32), 2, axis=-1)
    pcks = []
    for i in range(B):
        vis = tw[i, :, 0] == 1
        dist = np.linalg.norm(pred[i][vis] - target[i][vis], axis=-1)
        dist = dist / max_wh[i]
        pcks.append(float((dist < thr).sum() / tw[i].sum() * 2))
    return float(np.mean(pcks))


def cs_from_region_map(region_maps, image_size=256.0, k=20, thr=0.8,
                       heatmap_sigma=2) -> torch.Tensor:
    """Top-k candidate boxes from raw region maps (reference
    evaluation.py:94-163: no peak NMS before the top-k; w/h the mean of a
    ±3σ window, scaled by the feature stride).

    Args:
        region_maps: ``[B, H, W, 3]`` (center, w, h), a tensor (computed on
            its device) or numpy (on the CPU).

    Returns:
        ``[B, k, 5]`` (cx, cy, w, h, conf) in input pixels; cx, cy, w, h are
        0 where conf <= thr.
    """
    region_maps = torch.as_tensor(region_maps, dtype=torch.float32)
    B, H, W, _ = region_maps.shape
    dev = region_maps.device
    top_val, top_idx = top_k(region_maps[..., 0].reshape(B, H * W), k)
    cx, cy = top_idx % W, top_idx // W
    # the window [c - 3σ, c + 3σ + 1) with the reference's clip: both ends
    # clip to size - 1, so the last row and column never count
    t = int(heatmap_sigma) * 3
    x1, x2 = (cx - t).clamp(0, W - 1), (cx + t + 1).clamp(0, W - 1)
    y1, y2 = (cy - t).clamp(0, H - 1), (cy + t + 1).clamp(0, H - 1)
    xs = torch.arange(W, device=dev)
    ys = torch.arange(H, device=dev)
    mx = (xs >= x1[..., None]) & (xs < x2[..., None])   # [B, k, W]
    my = (ys >= y1[..., None]) & (ys < y2[..., None])   # [B, k, H]
    win = (my[..., :, None] & mx[..., None, :]).float()
    cnt = win.sum((-1, -2)).clamp(min=1.0)
    gx = (region_maps[..., 1][:, None] * win).sum((-1, -2)) / cnt
    gy = (region_maps[..., 2][:, None] * win).sum((-1, -2)) / cnt
    # the reference takes the stride from the last axis (square maps)
    stride = torch.tensor(float(image_size), dtype=torch.float32) / W
    flag = (top_val > thr).float()
    return torch.stack([cx.float() * stride * flag, cy.float() * stride * flag,
                        gx * stride * flag, gy * stride * flag, top_val], -1)


def _xywh2xyxy(x):
    y = np.zeros_like(x)
    y[:, 0] = x[:, 0] - x[:, 2] / 2
    y[:, 1] = x[:, 1] - x[:, 3] / 2
    y[:, 2] = x[:, 0] + x[:, 2] / 2
    y[:, 3] = x[:, 1] + x[:, 3] / 2
    return y


def non_max_suppression(prediction, iou_threshold=0.8, conf_threshold=0.8,
                        max_num=100):
    """Greedy NMS over candidate rows (reference evaluation.py:166-211):
    strict confidence and size gates, and torchvision-nms semantics (a box
    goes when its IoU with a kept, higher-scoring box is strictly above the
    threshold).

    Args:
        prediction: ``[B, k, 5]`` (cx, cy, w, h, conf).

    Returns:
        per image a list of kept rows, or None when nothing survives.
    """
    prediction = np.asarray(prediction, np.float32)
    min_wh, max_wh = 2, 4096
    output = [None] * prediction.shape[0]
    for i, x in enumerate(prediction):
        x = x[x[:, 4] > conf_threshold]
        x = x[((x[:, 2:4] > min_wh) & (x[:, 2:4] < max_wh)).all(1)]
        if not x.shape[0]:
            continue
        boxes = _xywh2xyxy(x[:, :4])
        order = np.argsort(-x[:, 4], kind="stable")
        areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
        keep, suppressed = [], np.zeros(len(order), bool)
        for oi in order:
            if suppressed[oi]:
                continue
            keep.append(oi)
            ix1 = np.maximum(boxes[oi, 0], boxes[:, 0])
            iy1 = np.maximum(boxes[oi, 1], boxes[:, 1])
            ix2 = np.minimum(boxes[oi, 2], boxes[:, 2])
            iy2 = np.minimum(boxes[oi, 3], boxes[:, 3])
            inter = (np.clip(ix2 - ix1, 0, None)
                     * np.clip(iy2 - iy1, 0, None))
            iou = inter / np.maximum(areas[oi] + areas - inter, 1e-12)
            suppressed |= iou > iou_threshold
        output[i] = x[keep[:max_num]].tolist()
    return output


def evaluate_ap(region_maps, gt_boxes, image_size=256, k=20, iou_thr=None):
    """Region maps -> NMS'ed boxes -> AP (reference evaluation.py:214-238;
    thresholds and the kept-box cap from ``pcfg``, as upstream).

    Args:
        region_maps: ``[B, H, W, 3]``, a tensor or numpy.
        gt_boxes: per image a list of (cx, cy, w, h) rows.

    Returns:
        (AP50, mean AP, the kept boxes per image)
    """
    candidates = cs_from_region_map(region_maps, float(image_size), k,
                                    float(pcfg.detection_threshold))
    pred_bboxes = non_max_suppression(
        candidates.cpu().numpy(), float(pcfg.iou_threshold),
        float(pcfg.detection_threshold), int(pcfg.max_num_bbox))
    if isinstance(gt_boxes, np.ndarray):
        gt_boxes = gt_boxes.tolist()
    ap50, ap = count_ap(pred_bboxes, gt_boxes, iou_thr)
    return float(ap50), float(ap), pred_bboxes
