"""COCO-WholeBody per-part evaluation suite (port of
``litehandnet_tpu/eval/wholebody.py``, host numpy).

Mirrors the reference's vendored evaluators
(utils/post_processing/coco_wholebody_evaluation/{myeval_body, myeval_foot,
myeval_face, myeval_lefthand, myeval_righthand, myeval_wholebody}.py and
evaluation_wholebody.py): the same COCO keypoint protocol run once per body
part, each with its own keypoint field, OKS sigmas, and score key (falling
back to the global 'score' when the part score is absent —
evaluation_wholebody.py:91-98).
"""

from __future__ import annotations

from collections import OrderedDict

import numpy as np

from litehandnet_tpu_torch.eval.cocoeval import (
    HAND_SIGMAS,
    STAT_NAMES,
    KeypointCOCOeval,
)

BODY_SIGMAS = np.array([
    .26, .25, .25, .35, .35, .79, .79, .72, .72, .62, .62, 1.07, 1.07,
    .87, .87, .89, .89,
]) / 10.0
FOOT_SIGMAS = np.array([0.68, 0.66, 0.66, 0.92, 0.94, 0.94]) / 10.0
FACE_SIGMAS = np.array([
    0.42, 0.43, 0.44, 0.43, 0.40, 0.35, 0.31, 0.25, 0.20, 0.23, 0.29,
    0.32, 0.37, 0.38, 0.43, 0.41, 0.45, 0.13, 0.12, 0.11, 0.11, 0.12,
    0.12, 0.11, 0.11, 0.13, 0.15, 0.09, 0.07, 0.07, 0.07, 0.12, 0.09,
    0.08, 0.16, 0.10, 0.17, 0.11, 0.09, 0.11, 0.09, 0.07, 0.13, 0.08,
    0.11, 0.12, 0.10, 0.34, 0.08, 0.08, 0.09, 0.08, 0.08, 0.07, 0.10,
    0.08, 0.09, 0.09, 0.09, 0.07, 0.07, 0.08, 0.11, 0.08, 0.08, 0.08,
    0.10, 0.08,
]) / 10.0
WHOLEBODY_SIGMAS = np.concatenate([
    BODY_SIGMAS, FOOT_SIGMAS, FACE_SIGMAS, HAND_SIGMAS, HAND_SIGMAS,
])

#: part -> (kpt field(s), sigmas) per the reference evaluators
PARTS = {
    "body": ("keypoints", BODY_SIGMAS),
    "foot": ("foot_kpts", FOOT_SIGMAS),
    "face": ("face_kpts", FACE_SIGMAS),
    "lefthand": ("lefthand_kpts", HAND_SIGMAS),
    "righthand": ("righthand_kpts", HAND_SIGMAS),
    "wholebody": (
        ["keypoints", "foot_kpts", "face_kpts", "lefthand_kpts",
         "righthand_kpts"],
        WHOLEBODY_SIGMAS,
    ),
}


def _ensure_part_score(detections, part):
    """'{part}_score' falls back to 'score' (evaluation_wholebody.py:91-98)."""
    key = f"{part}_score"
    out = []
    for d in detections:
        d = dict(d)
        d.setdefault(key, d.get("score", 0.0))
        out.append(d)
    return out


def evaluate_part(coco_gt, detections, part, img_ids=None):
    """Run the COCO keypoint protocol for one body part.

    Returns the 10-stat array (AP, AP.5, AP.75, AP(M), AP(L), AR...).
    """
    kpt_key, sigmas = PARTS[part]
    score_key = "score" if part in ("body", "wholebody") else f"{part}_score"
    if score_key != "score":
        detections = _ensure_part_score(detections, part)
    return KeypointCOCOeval(
        coco_gt, detections, sigmas=sigmas, kpt_key=kpt_key,
        score_key=score_key, img_ids=img_ids,
    ).run()


def evaluate_wholebody(coco_gt, detections, parts=None, img_ids=None):
    """All-part evaluation (evaluation_wholebody.py:101-118).

    Returns OrderedDict mapping '<part> <stat>' -> value, plus the plain
    per-part AP under '<part> mAP'.
    """
    results = OrderedDict()
    for part in (parts or PARTS):
        stats = evaluate_part(coco_gt, detections, part, img_ids=img_ids)
        for name, value in zip(STAT_NAMES, stats):
            results[f"{part} {name}"] = float(value)
        results[f"{part} mAP"] = float(stats[0])
    return results
