"""Exact COCO keypoint evaluation (101-point interpolated AP, maxDets, area
ranges) to numeric parity with pycocotools' COCOeval; a copy of
``litehandnet_tpu/eval/cocoeval.py`` (host-side numpy).

The full COCO protocol the reference vendors
(utils/post_processing/evaluation/myeval_hand.py:14-501 and
utils/post_processing/coco_wholebody_evaluation/*): greedy per-image OKS
matching with crowd/ignore semantics, per-area-range and per-maxDets
accumulation onto the 101-point recall grid, and the standard keypoint stat
summary, as vectorized numpy.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional, Sequence

import numpy as np

#: OKS sigmas for 21-keypoint hands (the reference hardcodes these in
#: myeval_hand.py:178-179)
HAND_SIGMAS = np.array([
    0.29, 0.22, 0.35, 0.37, 0.47, 0.26, 0.25, 0.24, 0.35, 0.18, 0.24,
    0.22, 0.26, 0.17, 0.21, 0.21, 0.32, 0.20, 0.19, 0.22, 0.31,
]) / 10.0


class KptParams:
    """COCO keypoint evaluation parameters (myeval_hand.py:490-499)."""

    def __init__(self, sigmas=HAND_SIGMAS):
        self.iou_thrs = np.linspace(0.5, 0.95, 10, endpoint=True)
        self.rec_thrs = np.linspace(0.0, 1.00, 101, endpoint=True)
        self.max_dets = [20]
        self.area_rng = [[0.0, 1e10], [32.0**2, 96.0**2], [96.0**2, 1e10]]
        self.area_lbl = ["all", "medium", "large"]
        self.sigmas = np.asarray(sigmas, np.float64)


def compute_oks(gts, dts, sigmas, kpt_key="keypoints"):
    """OKS matrix [n_dt, n_gt] between sorted detections and ground truths
    in one image (protocol of myeval_hand.py:165-214), vectorized over dts.
    """
    n_d, n_g = len(dts), len(gts)
    ious = np.zeros((n_d, n_g))
    if n_d == 0 or n_g == 0:
        return ious
    var = (sigmas * 2.0) ** 2
    k = len(sigmas)
    D = np.asarray([d[kpt_key] for d in dts], np.float64).reshape(n_d, k, 3)
    xd, yd = D[:, :, 0], D[:, :, 1]
    for j, gt in enumerate(gts):
        g = np.asarray(gt[kpt_key], np.float64).reshape(k, 3)
        xg, yg, vg = g[:, 0], g[:, 1], g[:, 2]
        k1 = int(np.count_nonzero(vg > 0))
        if k1 > 0:
            dx = xd - xg
            dy = yd - yg
        else:
            # no labeled keypoints: distance to the doubled-bbox ignore zone
            bb = gt["bbox"]
            x0, x1 = bb[0] - bb[2], bb[0] + bb[2] * 2
            y0, y1 = bb[1] - bb[3], bb[1] + bb[3] * 2
            dx = np.maximum(0.0, x0 - xd) + np.maximum(0.0, xd - x1)
            dy = np.maximum(0.0, y0 - yd) + np.maximum(0.0, yd - y1)
        e = (dx**2 + dy**2) / var / (gt["area"] + np.spacing(1)) / 2.0
        if k1 > 0:
            e = e[:, vg > 0]
        ious[:, j] = np.sum(np.exp(-e), axis=1) / e.shape[1]
    return ious


class KeypointCOCOeval:
    """COCO keypoint evaluator over a GT index and a list of detections.

    Args:
        coco_gt: litehandnet_tpu_torch.data.coco.COCO (or API-compatible) GT index.
        detections: list of dicts with image_id, keypoints (flat x,y,score
            triplets), score; 'area'/'bbox' are derived from the keypoint
            extent when absent (pycocotools loadRes semantics).
        sigmas: per-keypoint OKS sigmas.
        kpt_key / score_key: field names (the wholebody evaluators use
            lefthand_kpts / righthand_kpts etc., myeval_hand.py:14-45).
    """

    def __init__(self, coco_gt, detections, sigmas=HAND_SIGMAS,
                 kpt_key="keypoints", score_key="score",
                 img_ids: Optional[Sequence] = None):
        self.params = KptParams(sigmas)
        self._kpt_keys = (
            list(kpt_key) if isinstance(kpt_key, (list, tuple)) else None
        )
        self.kpt_key = "_kpts" if self._kpt_keys else kpt_key
        self.score_key = score_key
        self.img_ids = (
            sorted(img_ids) if img_ids is not None
            else sorted(coco_gt.getImgIds())
        )
        k3 = len(self.params.sigmas) * 3

        def kpts_of(rec):
            """Fetch (and for the wholebody evaluator, concatenate) the
            keypoint fields, truncated to len(sigmas) points — the
            reference's body evaluator slices dt['keypoints'][:17*3]
            (myeval_body.py:181)."""
            if self._kpt_keys:
                flat = [v for key in self._kpt_keys for v in rec[key]]
            else:
                flat = list(rec[self.kpt_key])
            return flat[:k3]

        self._gts = defaultdict(list)
        for ann in coco_gt.loadAnns(coco_gt.getAnnIds()):
            g = dict(ann)
            g[self.kpt_key] = kpts_of(ann)
            kpts = np.asarray(g[self.kpt_key], np.float64)
            k1 = int(np.count_nonzero(kpts[2::3] > 0))
            # reference semantics (myeval_hand.py:69-78): the explicit
            # 'ignore' field is OVERWRITTEN — a gt is ignored iff it is a
            # crowd or has no visible keypoints
            g["_ignore_base"] = bool(g.get("iscrowd", 0)) or k1 == 0
            if "area" not in g:
                g["area"] = float(g["bbox"][2] * g["bbox"][3])
            self._gts[g["image_id"]].append(g)
        self._dts = defaultdict(list)
        for det in detections:
            d = dict(det)
            d[self.kpt_key] = kpts_of(det)
            kpts = np.asarray(d[self.kpt_key], np.float64)
            if int(np.count_nonzero(kpts[2::3] > 0)) == 0:
                # reference drops all-invisible detections (myeval_hand.py:86-89)
                continue
            if "area" not in d or "bbox" not in d:
                # area/bbox derive from the FULL 'keypoints' extent even for
                # part evaluators (xtcocotools loadRes semantics)
                base = np.asarray(
                    det.get("keypoints", d[self.kpt_key]), np.float64
                )
                x, y = base[0::3], base[1::3]
                x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
                d.setdefault("area", float((x1 - x0) * (y1 - y0)))
                d.setdefault(
                    "bbox", [float(x0), float(y0), float(x1 - x0),
                             float(y1 - y0)]
                )
            if self.score_key not in d:
                d[self.score_key] = d.get("score", 0.0)
            d.setdefault("id", sum(map(len, self._dts.values())) + 1)
            self._dts[d["image_id"]].append(d)
        self.eval = None
        self.stats = None

    # -- per-image evaluation -------------------------------------------
    def _evaluate_img(self, gts, dts, ious, area_rng, max_det):
        p = self.params
        if not gts and not dts:
            return None
        T = len(p.iou_thrs)
        gt_ig_base = np.array([
            1 if (g["_ignore_base"] or g["area"] < area_rng[0]
                  or g["area"] > area_rng[1]) else 0
            for g in gts
        ], np.int32)
        # ignored gts sort last (stable)
        gt_order = np.argsort(gt_ig_base, kind="mergesort")
        gts = [gts[i] for i in gt_order]
        gt_ig = gt_ig_base[gt_order]
        iscrowd = [int(g.get("iscrowd", 0)) for g in gts]
        dts = dts[:max_det]
        ious_s = (
            ious[:, gt_order][: len(dts)] if len(ious) else ious
        )

        G, D = len(gts), len(dts)
        gtm = np.zeros((T, G), np.int64)
        dtm = np.zeros((T, D), np.int64)
        dt_ig = np.zeros((T, D), np.int32)
        if len(ious_s):
            for t, thr in enumerate(p.iou_thrs):
                for d in range(D):
                    best = min(thr, 1.0 - 1e-10)
                    m = -1
                    for g in range(G):
                        if gtm[t, g] > 0 and not iscrowd[g]:
                            continue
                        # dts are score-sorted; once we hit ignored gts,
                        # stop if a real match is already in hand
                        if m > -1 and gt_ig[m] == 0 and gt_ig[g] == 1:
                            break
                        if ious_s[d, g] < best:
                            continue
                        best = ious_s[d, g]
                        m = g
                    if m == -1:
                        continue
                    dt_ig[t, d] = gt_ig[m]
                    # store 1-based indices, not raw ids: annotation id 0 is
                    # legal in COCO json and would read as "unmatched"
                    dtm[t, d] = m + 1
                    gtm[t, m] = d + 1
        # unmatched detections outside the area range are ignored
        a = np.array([
            d["area"] < area_rng[0] or d["area"] > area_rng[1] for d in dts
        ]).reshape(1, D)
        dt_ig = np.logical_or(
            dt_ig, np.logical_and(dtm == 0, np.repeat(a, T, axis=0))
        )
        return {
            "dtMatches": dtm,
            "dtScores": [d[self.score_key] for d in dts],
            "gtIgnore": gt_ig,
            "dtIgnore": dt_ig,
        }

    # -- the protocol ----------------------------------------------------
    def evaluate(self):
        p = self.params
        self._sorted_dts = {}
        self.ious = {}
        for img_id in self.img_ids:
            dts = self._dts.get(img_id, [])
            inds = np.argsort(
                [-d[self.score_key] for d in dts], kind="mergesort"
            )
            dts = [dts[i] for i in inds][: p.max_dets[-1]]
            self._sorted_dts[img_id] = dts
            self.ious[img_id] = compute_oks(
                self._gts.get(img_id, []), dts, p.sigmas, self.kpt_key
            )
        self.eval_imgs = [
            [
                self._evaluate_img(
                    self._gts.get(img_id, []), self._sorted_dts[img_id],
                    self.ious[img_id], rng, max_det,
                )
                for img_id in self.img_ids
            ]
            for rng in p.area_rng
            for max_det in [p.max_dets[-1]]
        ]
        return self

    def accumulate(self):
        p = self.params
        T, R = len(p.iou_thrs), len(p.rec_thrs)
        A, M = len(p.area_rng), len(p.max_dets)
        precision = -np.ones((T, R, 1, A, M))
        recall = -np.ones((T, 1, A, M))
        scores = -np.ones((T, R, 1, A, M))
        for a in range(A):
            imgs = [e for e in self.eval_imgs[a] if e is not None]
            if not imgs:
                continue
            for m, max_det in enumerate(p.max_dets):
                dt_scores = np.concatenate(
                    [np.asarray(e["dtScores"])[:max_det] for e in imgs]
                )
                inds = np.argsort(-dt_scores, kind="mergesort")
                dt_scores_sorted = dt_scores[inds]
                dtm = np.concatenate(
                    [e["dtMatches"][:, :max_det] for e in imgs], axis=1
                )[:, inds]
                dt_ig = np.concatenate(
                    [e["dtIgnore"][:, :max_det] for e in imgs], axis=1
                )[:, inds]
                gt_ig = np.concatenate([e["gtIgnore"] for e in imgs])
                npig = int(np.count_nonzero(gt_ig == 0))
                if npig == 0:
                    continue
                tps = np.logical_and(dtm, np.logical_not(dt_ig))
                fps = np.logical_and(
                    np.logical_not(dtm), np.logical_not(dt_ig)
                )
                tp_sum = np.cumsum(tps, axis=1).astype(np.float64)
                fp_sum = np.cumsum(fps, axis=1).astype(np.float64)
                for t in range(T):
                    tp, fp = tp_sum[t], fp_sum[t]
                    nd = len(tp)
                    rc = tp / npig
                    pr = tp / (fp + tp + np.spacing(1))
                    recall[t, 0, a, m] = rc[-1] if nd else 0
                    pr = pr.tolist()
                    # right-to-left envelope, then sample at the 101-point
                    # recall grid (the COCO interpolation)
                    for i in range(nd - 1, 0, -1):
                        if pr[i] > pr[i - 1]:
                            pr[i - 1] = pr[i]
                    q = np.zeros(R)
                    s = np.zeros(R)
                    inds_r = np.searchsorted(rc, p.rec_thrs, side="left")
                    for ri, pi in enumerate(inds_r):
                        if pi < nd:
                            q[ri] = pr[pi]
                            s[ri] = dt_scores_sorted[pi]
                    precision[t, :, 0, a, m] = q
                    scores[t, :, 0, a, m] = s
        self.eval = {
            "precision": precision,
            "recall": recall,
            "scores": scores,
        }
        return self

    def _summarize(self, ap=1, iou_thr=None, area="all", max_dets=20):
        p = self.params
        aind = p.area_lbl.index(area)
        mind = p.max_dets.index(max_dets)
        if ap == 1:
            s = self.eval["precision"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
            s = s[:, :, :, aind, mind]
        else:
            s = self.eval["recall"]
            if iou_thr is not None:
                s = s[np.where(np.isclose(p.iou_thrs, iou_thr))[0]]
            s = s[:, :, aind, mind]
        valid = s[s > -1]
        return float(np.mean(valid)) if valid.size else -1.0

    def summarize(self):
        """The 10 keypoint stats: AP, AP.5, AP.75, AP(M), AP(L), AR, AR.5,
        AR.75, AR(M), AR(L) at maxDets=20 (myeval_hand.py summarize)."""
        md = self.params.max_dets[-1]
        self.stats = np.array([
            self._summarize(1, max_dets=md),
            self._summarize(1, iou_thr=0.5, max_dets=md),
            self._summarize(1, iou_thr=0.75, max_dets=md),
            self._summarize(1, area="medium", max_dets=md),
            self._summarize(1, area="large", max_dets=md),
            self._summarize(0, max_dets=md),
            self._summarize(0, iou_thr=0.5, max_dets=md),
            self._summarize(0, iou_thr=0.75, max_dets=md),
            self._summarize(0, area="medium", max_dets=md),
            self._summarize(0, area="large", max_dets=md),
        ])
        return self.stats

    def run(self):
        self.evaluate()
        self.accumulate()
        return self.summarize()


STAT_NAMES = ["AP", "AP .5", "AP .75", "AP (M)", "AP (L)",
              "AR", "AR .5", "AR .75", "AR (M)", "AR (L)"]
