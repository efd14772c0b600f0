"""Hand object-detection datasets, the reference's OD side branch (port of
``litehandnet_tpu/data/od_dataset.py``, host numpy).

Reference: datasets/datasets/hand_od/{od_dataset.py:16-363,
CWB_hand_dataset.py} — an mmdet-style CustomDataset over middle-format
annotations plus a COCO-WholeBody hand-box variant feeding the YOLOv6
models.
"""

from __future__ import annotations

import json
import os.path as osp

import numpy as np

from litehandnet_tpu_torch.data.coco import COCO
from litehandnet_tpu_torch.eval.ap import count_ap


class CustomDataset:
    """mmdet middle-format OD dataset (reference: od_dataset.py:16-363).

    Annotation file: json list of
    ``{filename, width, height, ann: {bboxes [N,4] xyxy, labels [N]}}``.
    Outside ``test_mode`` an image without boxes is dropped; ``min_size``
    is read by ``CWBHandDataset``, as in the reference.
    """

    CLASSES = ("hand",)

    def __init__(self, ann_file: str, img_prefix: str = "",
                 test_mode: bool = False, min_size: int = 2):
        self.ann_file = ann_file
        self.img_prefix = img_prefix
        self.test_mode = test_mode
        self.min_size = min_size
        self.data_infos = self.load_annotations(ann_file)
        if not test_mode:
            self.data_infos = [
                info for info in self.data_infos
                if len(self.get_ann_info_raw(info)["bboxes"]) > 0
            ]

    def load_annotations(self, ann_file):
        with open(ann_file) as f:
            return json.load(f)

    @staticmethod
    def get_ann_info_raw(info):
        ann = info.get("ann", {})
        return {
            "bboxes": np.asarray(
                ann.get("bboxes", []), np.float32
            ).reshape(-1, 4),
            "labels": np.asarray(ann.get("labels", []), np.int64).reshape(-1),
        }

    def get_ann_info(self, idx):
        return self.get_ann_info_raw(self.data_infos[idx])

    def __len__(self):
        return len(self.data_infos)

    def __getitem__(self, idx):
        info = self.data_infos[idx]
        ann = self.get_ann_info(idx)
        return {
            "image_file": osp.join(self.img_prefix, info["filename"]),
            "width": info.get("width"),
            "height": info.get("height"),
            "bboxes": ann["bboxes"],
            "labels": ann["labels"],
        }

    def evaluate(self, pred_boxes, iou_thr=None):
        """Detection AP against the GT boxes (VOC2010 style)."""
        gts = []
        for info in self.data_infos:
            b = self.get_ann_info_raw(info)["bboxes"]
            # xyxy -> cxcywh
            cxy = (b[:, :2] + b[:, 2:]) / 2
            wh = b[:, 2:] - b[:, :2]
            gts.append(np.concatenate([cxy, wh], axis=1).tolist())
        return count_ap(pred_boxes, gts, iou_thr)


class CWBHandDataset(CustomDataset):
    """Hand boxes mined from COCO-WholeBody annotations
    (reference: CWB_hand_dataset.py)."""

    def load_annotations(self, ann_file):
        coco = COCO(ann_file)
        infos = []
        for img_id in coco.getImgIds():
            img = coco.loadImgs(img_id)[0]
            bboxes, labels = [], []
            for obj in coco.loadAnns(coco.getAnnIds(imgIds=img_id)):
                for side in ("left", "right"):
                    if not obj.get(f"{side}hand_valid", False):
                        continue
                    x, y, w, h = obj[f"{side}hand_box"]
                    if w < self.min_size or h < self.min_size:
                        continue
                    bboxes.append([x, y, x + w, y + h])
                    labels.append(0)
            infos.append({
                "filename": img["file_name"],
                "width": img.get("width"),
                "height": img.get("height"),
                "ann": {"bboxes": bboxes, "labels": labels},
            })
        return infos
