"""Hand datasets (port of ``litehandnet_tpu/data/hand.py``): FreiHAND, RHD,
OneHand10K, Panoptic, CocoWholeBodyHand, ZHHand (reference:
datasets/datasets/hand/*.py).

All are 21-keypoint top-down datasets over COCO-format json; they differ only
in how the bbox becomes (center, scale) and in the evaluation metric set
(Panoptic uses PCKh with per-record head_size; the rest PCK/AUC/EPE).
"""

from __future__ import annotations

import os.path as osp

import numpy as np

from litehandnet_tpu_torch.data import dataset_info as DI
from litehandnet_tpu_torch.data.base import Kpt2dDataset


class _HandDataset(Kpt2dDataset):
    """Shared _get_db for single-hand COCO-format datasets."""

    INFO = DI.freihand2d_info
    METRICS = ("PCK", "AUC", "EPE")

    def __init__(self, data_cfg, data_type="train", rng=None):
        super().__init__(data_cfg, data_type, dataset_info=self.INFO, rng=rng)
        self.ann_info["use_different_joint_weights"] = False
        self.image_size = data_cfg.image_size
        self.db = self._get_db()

    def _center_scale(self, obj):
        return self._xywh2cs(*obj["bbox"][:4], 1.25)

    def _extra_record_fields(self, obj):
        return {}

    def _get_db(self):
        gt_db = []
        bbox_id = 0
        num_joints = self.ann_info["num_joints"]
        for img_id in self.img_ids:
            ann_ids = self.coco.getAnnIds(imgIds=img_id, iscrowd=False)
            for obj in self.coco.loadAnns(ann_ids):
                if max(obj["keypoints"]) == 0:
                    continue
                joints_3d = np.zeros((num_joints, 3), dtype=np.float32)
                joints_3d_visible = np.zeros((num_joints, 3), dtype=np.float32)
                keypoints = np.array(obj["keypoints"]).reshape(-1, 3)
                joints_3d[:, :2] = keypoints[:, :2]
                joints_3d_visible[:, :2] = np.minimum(1, keypoints[:, 2:3])
                center, scale = self._center_scale(obj)
                record = {
                    "image_file": osp.join(
                        self.img_prefix, self.id2name[img_id]
                    ),
                    "center": center,
                    "scale": scale,
                    "rotation": 0,
                    "joints_3d": joints_3d,
                    "joints_3d_visible": joints_3d_visible,
                    "dataset": self.dataset_name,
                    "bbox": np.array(obj["bbox"], np.float32),
                    "bbox_score": 1,
                    "bbox_id": bbox_id,
                }
                record.update(self._extra_record_fields(obj))
                gt_db.append(record)
                bbox_id += 1
        return sorted(gt_db, key=lambda x: x["bbox_id"])

    def evaluate(self, results, res_folder=None, metric="PCK", **kwargs):
        metrics = metric if isinstance(metric, list) else [metric]
        for m in metrics:
            if m not in self.METRICS:
                raise KeyError(f"metric {m} is not supported")
        return self._evaluate_topdown(results, res_folder, metrics)


class FreiHandDataset(_HandDataset):
    """Whole image as the bbox (reference: freihand_dataset.py:91)."""

    INFO = DI.freihand2d_info

    def _center_scale(self, obj):
        return self._xywh2cs(
            0, 0, self.image_size[0], self.image_size[1], 1
        )


class RHD2dDataset(_HandDataset):
    INFO = DI.rhd2d_info


class OneHand10KDataset(_HandDataset):
    INFO = DI.onehand10k_info


class ZHHandDataset(_HandDataset):
    """Fixed 224 crop with 0.8 padding (reference: zhhand_dataset.py:97)."""

    INFO = DI.zhhand_info

    def _center_scale(self, obj):
        return self._xywh2cs(0, 0, 224, 224, 0.8)


class CocoWholeBodyHandDataset(_HandDataset):
    """Left/right hand boxes from COCO-WholeBody annotations
    (reference: coco_wholebody_hand_dataset.py:80-110)."""

    INFO = DI.coco_wholebody_hand_info

    def _get_db(self):
        gt_db = []
        bbox_id = 0
        num_joints = self.ann_info["num_joints"]
        for img_id in self.img_ids:
            ann_ids = self.coco.getAnnIds(imgIds=img_id, iscrowd=False)
            for obj in self.coco.loadAnns(ann_ids):
                for side in ("left", "right"):
                    if not obj.get(f"{side}hand_valid", False):
                        continue
                    kpts = np.array(obj[f"{side}hand_kpts"]).reshape(-1, 3)
                    if np.max(kpts) == 0:
                        continue
                    joints_3d = np.zeros((num_joints, 3), np.float32)
                    joints_3d_visible = np.zeros((num_joints, 3), np.float32)
                    joints_3d[:, :2] = kpts[:, :2]
                    joints_3d_visible[:, :2] = np.minimum(1, kpts[:, 2:3])
                    bbox = obj[f"{side}hand_box"]
                    center, scale = self._xywh2cs(*bbox[:4], 1.25)
                    gt_db.append({
                        "image_file": osp.join(
                            self.img_prefix, self.id2name[img_id]
                        ),
                        "center": center,
                        "scale": scale,
                        "rotation": 0,
                        "joints_3d": joints_3d,
                        "joints_3d_visible": joints_3d_visible,
                        "dataset": self.dataset_name,
                        "bbox": np.array(bbox, np.float32),
                        "bbox_score": 1,
                        "bbox_id": bbox_id,
                    })
                    bbox_id += 1
        return sorted(gt_db, key=lambda x: x["bbox_id"])


class PanopticDataset(_HandDataset):
    """CMU Panoptic hand: 1.76 bbox padding, per-record head_size, PCKh
    (reference: panoptic_hand2d_dataset.py:91-144)."""

    INFO = DI.panoptic_hand2d_info
    METRICS = ("PCKh", "AUC", "EPE")

    def _center_scale(self, obj):
        return self._xywh2cs(*obj["bbox"][:4], 1.76)

    def _extra_record_fields(self, obj):
        return {"head_size": obj["head_size"]}

    def evaluate(self, results, res_folder=None, metric="PCKh", **kwargs):
        metrics = metric if isinstance(metric, list) else [metric]
        for m in metrics:
            if m not in self.METRICS:
                raise KeyError(f"metric {m} is not supported")
        return self._evaluate_topdown(
            results, res_folder, metrics, pckh_thr=0.7
        )
