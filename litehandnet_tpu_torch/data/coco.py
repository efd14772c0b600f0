"""Minimal COCO-format annotation index (a copy of
``litehandnet_tpu/data/coco.py``; replaces xtcocotools for the subset
of the API the datasets use: getImgIds / getAnnIds / loadAnns / loadImgs /
getCatIds / loadCats / imgs).

Reference dependency surface: datasets/base_dataset.py:89-107.
"""

from __future__ import annotations

import json
from collections import defaultdict


class COCO:
    def __init__(self, annotation_file=None, dataset: dict = None):
        if dataset is None:
            with open(annotation_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.anns = {}
        self.imgs = {}
        self.cats = {}
        self.img_to_anns = defaultdict(list)
        for img in self.dataset.get("images", []):
            self.imgs[img["id"]] = img
        for i, ann in enumerate(self.dataset.get("annotations", [])):
            ann_id = ann.get("id", i)
            self.anns[ann_id] = ann
            self.img_to_anns[ann["image_id"]].append(ann_id)
        for cat in self.dataset.get("categories", []):
            self.cats[cat["id"]] = cat

    def getImgIds(self):
        return sorted(self.imgs)

    def getCatIds(self):
        return sorted(self.cats)

    def loadCats(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.cats[i] for i in ids]

    def getAnnIds(self, imgIds=None, catIds=None, iscrowd=None):
        if imgIds is None:
            ids = sorted(self.anns)
        else:
            if not isinstance(imgIds, (list, tuple)):
                imgIds = [imgIds]
            ids = [a for i in imgIds for a in self.img_to_anns[i]]
        if catIds is not None:
            if not isinstance(catIds, (list, tuple)):
                catIds = [catIds]
            ids = [
                a for a in ids
                if self.anns[a].get("category_id") in catIds
            ]
        if iscrowd is not None:
            ids = [
                a for a in ids
                if bool(self.anns[a].get("iscrowd", 0)) == bool(iscrowd)
            ]
        return ids

    def loadAnns(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.anns[i] for i in ids]

    def loadImgs(self, ids):
        if not isinstance(ids, (list, tuple)):
            ids = [ids]
        return [self.imgs[i] for i in ids]

    @classmethod
    def from_dict(cls, dataset: dict) -> "COCO":
        return cls(dataset=dataset)

    def loadRes(self, results) -> "COCO":
        """Detection-results index (xtcocotools COCO.loadRes surface): wraps
        a list of result dicts; keypoint results get bbox/area derived from
        the keypoint extent."""
        import numpy as np

        anns = []
        for i, r in enumerate(results):
            r = dict(r)
            r.setdefault("id", i + 1)
            r.setdefault("category_id", 1)
            r.setdefault("iscrowd", 0)
            if "keypoints" in r and ("area" not in r or "bbox" not in r):
                k = np.asarray(r["keypoints"], np.float64)
                x, y = k[0::3], k[1::3]
                x0, x1, y0, y1 = x.min(), x.max(), y.min(), y.max()
                r.setdefault("area", float((x1 - x0) * (y1 - y0)))
                r.setdefault("bbox", [float(x0), float(y0),
                                      float(x1 - x0), float(y1 - y0)])
            anns.append(r)
        return COCO.from_dict(dict(
            images=self.dataset.get("images", []),
            categories=self.dataset.get("categories", []),
            annotations=anns,
        ))
