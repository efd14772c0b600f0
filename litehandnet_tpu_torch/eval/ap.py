"""Detection AP for center-map box predictions (port of
``litehandnet_tpu/eval/ap.py``; reference utils/evaluation.py:241-337,
``count_ap``): VOC2010-style PR-curve AP over IoU 0.5:0.05:0.95, greedy
per-image matching by confidence, each ground-truth box matched at most
once. Host-side numpy over fixed-size padded predictions (rows of
confidence 0 are padding).
"""

from __future__ import annotations

import numpy as np


def _iou_xywh(box, boxes):
    """IoU of one (cx, cy, w, h) box vs [N, 4]."""
    boxes = np.asarray(boxes, np.float32)
    b1 = np.array([
        box[0] - box[2] / 2, box[1] - box[3] / 2,
        box[0] + box[2] / 2, box[1] + box[3] / 2,
    ])
    b2 = np.stack([
        boxes[:, 0] - boxes[:, 2] / 2, boxes[:, 1] - boxes[:, 3] / 2,
        boxes[:, 0] + boxes[:, 2] / 2, boxes[:, 1] + boxes[:, 3] / 2,
    ], axis=1)
    ix1 = np.maximum(b1[0], b2[:, 0])
    iy1 = np.maximum(b1[1], b2[:, 1])
    ix2 = np.minimum(b1[2], b2[:, 2])
    iy2 = np.minimum(b1[3], b2[:, 3])
    inter = np.clip(ix2 - ix1, 0, None) * np.clip(iy2 - iy1, 0, None)
    a1 = (b1[2] - b1[0]) * (b1[3] - b1[1])
    a2 = (b2[:, 2] - b2[:, 0]) * (b2[:, 3] - b2[:, 1])
    return inter / np.maximum(a1 + a2 - inter, 1e-9)


def count_ap(pred_boxes, gt_boxes, iou_threshold=None):
    """AP50 and mean AP (reference semantics, evaluation.py:241-337).

    Args:
        pred_boxes: per image, either None or an array/list of
            (cx, cy, w, h, conf) rows (conf==0 rows are padding).
        gt_boxes: per image, list of (cx, cy, w, h[, ...]) rows.
        iou_threshold: None -> 0.5:0.05:0.95; or scalar / list.

    Returns:
        (AP50, mean AP)
    """
    preds = []
    for img_id, boxes in enumerate(pred_boxes):
        if boxes is None:
            continue
        for b in np.asarray(boxes, np.float32):
            if b[4] > 0:
                preds.append((img_id, b))
    if not preds:
        return 0.0, 0.0
    n_gt = sum(len(g) for g in gt_boxes)
    if n_gt == 0:
        return 0.0, 0.0

    if iou_threshold is None:
        thresholds = np.linspace(0.5, 0.95, 10)
    elif isinstance(iou_threshold, (list, tuple, np.ndarray)):
        thresholds = list(iou_threshold)
    else:
        thresholds = [iou_threshold]

    preds.sort(key=lambda p: -p[1][4])
    aps = []
    for thr in thresholds:
        matched = {i: np.zeros(len(g), bool) for i, g in enumerate(gt_boxes)}
        hits = np.zeros(len(preds))
        for pi, (img_id, box) in enumerate(preds):
            gts = gt_boxes[img_id]
            if len(gts) == 0:
                continue
            ious = _iou_xywh(box[:4], np.asarray(gts)[:, :4])
            j = int(np.argmax(ious))
            if ious[j] >= thr and not matched[img_id][j]:
                hits[pi] = 1
                matched[img_id][j] = True
        tp = np.cumsum(hits)
        precision = tp / (np.arange(len(preds)) + 1)
        recall = tp / n_gt
        # step integration (no envelope), as in the reference :325-333
        area, r_old = 0.0, 0.0
        for p, r in zip(precision, recall):
            if r == r_old:
                continue
            area += p * (r - r_old)
            r_old = r
        aps.append(area)
    return float(aps[0]), float(np.mean(aps))
