"""NMS suite: bbox IoU NMS, OKS-based NMS (hard and soft); a copy of
``litehandnet_tpu/eval/nms.py``.

Reference: utils/post_processing/nms.py:9-207 (standard mmpose/COCO
implementations). Host-side numpy, used by dataset evaluation
(``data/body.py``).
"""

from __future__ import annotations

import numpy as np


def nms(dets: np.ndarray, thr: float):
    """Greedy IoU NMS over [x1, y1, x2, y2, score] rows."""
    x1, y1, x2, y2 = dets[:, 0], dets[:, 1], dets[:, 2], dets[:, 3]
    scores = dets[:, 4]
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        w = np.maximum(0.0, xx2 - xx1 + 1)
        h = np.maximum(0.0, yy2 - yy1 + 1)
        inter = w * h
        ovr = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[np.where(ovr <= thr)[0] + 1]
    return keep


def oks_iou(g, d, a_g, a_d, sigmas=None, vis_thr=None):
    """Object-keypoint-similarity between one GT and N detections."""
    if sigmas is None:
        sigmas = (
            np.array([
                0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62,
                0.62, 1.07, 1.07, 0.87, 0.87, 0.89, 0.89,
            ]) / 10.0
        )
    vars_ = (sigmas * 2) ** 2
    xg, yg, vg = g[0::3], g[1::3], g[2::3]
    ious = np.zeros(len(d), dtype=np.float32)
    for n_d in range(len(d)):
        xd, yd, vd = d[n_d, 0::3], d[n_d, 1::3], d[n_d, 2::3]
        dx, dy = xd - xg, yd - yg
        e = (dx**2 + dy**2) / vars_ / ((a_g + a_d[n_d]) / 2 + 1e-9) / 2
        if vis_thr is not None:
            ind = (vg > vis_thr) & (vd > vis_thr)
            e = e[ind]
        ious[n_d] = np.sum(np.exp(-e)) / len(e) if len(e) else 0.0
    return ious


def oks_nms(kpts_db, thr, sigmas=None, vis_thr=None):
    """Hard OKS NMS: suppress poses with OKS > thr to a kept pose."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(i)
        oks = oks_iou(
            kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas,
            vis_thr,
        )
        order = order[np.where(oks <= thr)[0] + 1]
    return keep


def _rescore(overlap, scores, thr, type_="gaussian"):
    if type_ == "linear":
        inds = np.where(overlap >= thr)[0]
        scores = scores.copy()
        scores[inds] = scores[inds] * (1 - overlap[inds])
    else:
        scores = scores * np.exp(-(overlap**2) / thr)
    return scores


def soft_oks_nms(kpts_db, thr, max_dets=20, sigmas=None, vis_thr=None):
    """Soft OKS NMS with gaussian rescoring."""
    if len(kpts_db) == 0:
        return []
    scores = np.array([k["score"] for k in kpts_db])
    kpts = np.array([np.asarray(k["keypoints"]).flatten() for k in kpts_db])
    areas = np.array([k["area"] for k in kpts_db])
    order = scores.argsort()[::-1]
    scores = scores[order]
    keep = np.zeros(max_dets, dtype=np.intp)
    keep_cnt = 0
    while order.size > 0 and keep_cnt < max_dets:
        i = order[0]
        oks = oks_iou(
            kpts[i], kpts[order[1:]], areas[i], areas[order[1:]], sigmas,
            vis_thr,
        )
        order = order[1:]
        scores = _rescore(oks, scores[1:], thr)
        tmp = scores.argsort()[::-1]
        order = order[tmp]
        scores = scores[tmp]
        keep[keep_cnt] = i
        keep_cnt += 1
    return keep[:keep_cnt].tolist()
