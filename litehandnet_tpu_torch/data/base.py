"""Base top-down 2D keypoint dataset (port of ``litehandnet_tpu/data/base.py``).

Reference: datasets/base_dataset.py:15-284. Loads a COCO-format annotation
index, converts bboxes to (center, scale) with PIXEL_STD=200 and 1.25 padding
(plus random center jitter in train mode), and provides `_report_metric`
computing PCK/PCKh/AUC/EPE from dumped result json.

Unlike the reference (whose __getitem__ runs a cv2/numpy transform pipeline
in torch DataLoader workers), here a dataset record is *raw metadata*: images
are decoded host-side by the loader, and all augmentation + target encoding
runs batched on the device (``data.device_pipeline``).
"""

from __future__ import annotations

import copy
import json
import os.path as osp
from abc import ABC, abstractmethod
from collections import OrderedDict
import tempfile

import numpy as np

from litehandnet_tpu_torch.data.coco import COCO
from litehandnet_tpu_torch.data.dataset_info import DatasetInfo
from litehandnet_tpu_torch.eval.metrics import (
    keypoint_auc,
    keypoint_epe,
    keypoint_pck_accuracy,
)

PIXEL_STD = 200.0


class Kpt2dDataset(ABC):
    def __init__(self, data_cfg, data_type="train", dataset_info=None,
                 rng=None):
        if data_type == "train":
            split = data_cfg.train
            self.test_mode = False
        elif data_type == "val":
            split = data_cfg.val
            self.test_mode = True
        elif data_type == "test":
            split = data_cfg.test
            self.test_mode = True
        else:
            raise ValueError(f"data_type={data_type!r}")
        self.ann_file = split.ann_file
        self.img_prefix = split.img_prefix
        self.data_type = data_type
        self.rng = rng or np.random.RandomState(0)

        info = DatasetInfo(dataset_info)
        self.ann_info = {
            "num_joints": data_cfg.num_joints,
            "image_size": np.array(data_cfg.image_size),
            "heatmap_size": np.array(data_cfg.heatmap_size),
            "use_different_joint_weights": data_cfg.get(
                "use_different_joint_weights", False
            ),
            "flip_pairs": info.flip_pairs,
            "flip_index": info.flip_index,
            "upper_body_ids": info.upper_body_ids,
            "lower_body_ids": info.lower_body_ids,
            "joint_weights": info.joint_weights,
            "skeleton": info.skeleton,
        }
        if data_cfg.num_joints != info.keypoint_num:
            raise ValueError(f"num_joints {data_cfg.num_joints} != the "
                             f"dataset's {info.keypoint_num} keypoints")
        self.sigmas = info.sigmas
        self.dataset_name = info.dataset_name
        self.pose_link_color = info.pose_link_color
        self.pose_kpt_color = info.pose_kpt_color
        self.pose_skeleton = info.skeleton

        self.coco = COCO(self.ann_file)
        self.img_ids = self.coco.getImgIds()
        self.num_images = len(self.img_ids)
        self.id2name = {i: img["file_name"] for i, img in self.coco.imgs.items()}
        self.name2id = {v: k for k, v in self.id2name.items()}
        self.db = []

    # -- geometry ---------------------------------------------------------
    def _xywh2cs(self, x, y, w, h, padding=1.25):
        """bbox -> (center, scale) with aspect-ratio fixing and train-time
        center jitter (reference: base_dataset.py:133-162)."""
        aspect_ratio = (
            self.ann_info["image_size"][0] / self.ann_info["image_size"][1]
        )
        center = np.array([x + w * 0.5, y + h * 0.5], dtype=np.float32)
        if (not self.test_mode) and self.rng.rand() < 0.3:
            center += 0.4 * (self.rng.rand(2) - 0.5) * [w, h]
        if w > aspect_ratio * h:
            h = w * 1.0 / aspect_ratio
        elif w < aspect_ratio * h:
            w = h * aspect_ratio
        scale = np.array([w / PIXEL_STD, h / PIXEL_STD], dtype=np.float32)
        return center, scale * padding

    # -- abstract ---------------------------------------------------------
    @abstractmethod
    def _get_db(self):
        ...

    @abstractmethod
    def evaluate(self, results, res_folder=None, metric="PCK", **kwargs):
        ...

    # -- evaluation plumbing ---------------------------------------------
    @staticmethod
    def _write_keypoint_results(keypoints, res_file):
        with open(res_file, "w") as f:
            json.dump(keypoints, f, sort_keys=True, indent=4)

    def _report_metric(self, res_file, metrics, pck_thr=0.2, pckh_thr=0.5,
                       auc_nor=30):
        """Reference: base_dataset.py:193-261."""
        info_str = []
        with open(res_file) as fin:
            preds = json.load(fin)
        assert len(preds) == len(self.db)

        outputs, gts, masks = [], [], []
        threshold_bbox, threshold_head_box = [], []
        for pred, item in zip(preds, self.db):
            outputs.append(np.array(pred["keypoints"])[:, :-1])
            gts.append(np.array(item["joints_3d"])[:, :-1])
            masks.append((np.array(item["joints_3d_visible"])[:, 0]) > 0)
            if "PCK" in metrics:
                bbox = np.array(item["bbox"])
                thr = np.max(bbox[2:])
                threshold_bbox.append(np.array([thr, thr]))
            if "PCKh" in metrics:
                thr = item["head_size"]
                threshold_head_box.append(np.array([thr, thr]))

        outputs = np.array(outputs)
        gts = np.array(gts)
        masks = np.array(masks)
        if "PCK" in metrics:
            _, pck, _ = keypoint_pck_accuracy(
                outputs, gts, masks, pck_thr, np.array(threshold_bbox)
            )
            info_str.append(("PCK", pck))
        if "PCKh" in metrics:
            _, pckh, _ = keypoint_pck_accuracy(
                outputs, gts, masks, pckh_thr, np.array(threshold_head_box)
            )
            info_str.append(("PCKh", pckh))
        if "AUC" in metrics:
            info_str.append(("AUC", keypoint_auc(outputs, gts, masks, auc_nor)))
        if "EPE" in metrics:
            info_str.append(("EPE", keypoint_epe(outputs, gts, masks)))
        return info_str

    def _evaluate_topdown(self, results, res_folder, metrics, **report_kw):
        """Shared evaluate() plumbing: gather -> dedup -> dump -> report
        (reference: freihand_dataset.py:147-183)."""
        if res_folder is not None:
            tmp_folder = None
            res_file = osp.join(res_folder, "result_keypoints.json")
        else:
            tmp_folder = tempfile.TemporaryDirectory()
            res_file = osp.join(tmp_folder.name, "result_keypoints.json")

        kpts = []
        for result in results:
            preds = result["preds"]
            boxes = result["boxes"]
            image_paths = result["image_paths"]
            bbox_ids = result["bbox_ids"]
            for i in range(len(image_paths)):
                path = image_paths[i]
                image_id = self.name2id.get(
                    path[len(self.img_prefix):] if path else "", -1
                )
                kpts.append({
                    "keypoints": np.asarray(preds[i]).tolist(),
                    "center": np.asarray(boxes[i][0:2]).tolist(),
                    "scale": np.asarray(boxes[i][2:4]).tolist(),
                    "area": float(boxes[i][4]),
                    "score": float(boxes[i][5]),
                    "image_id": image_id,
                    "bbox_id": int(bbox_ids[i]),
                })
        kpts = self._sort_and_unique_bboxes(kpts)
        self._write_keypoint_results(kpts, res_file)
        info_str = self._report_metric(res_file, metrics, **report_kw)
        if tmp_folder is not None:
            tmp_folder.cleanup()
        return OrderedDict(info_str)

    @staticmethod
    def _sort_and_unique_bboxes(kpts, key="bbox_id"):
        kpts = sorted(kpts, key=lambda x: x[key])
        for i in range(len(kpts) - 1, 0, -1):
            if kpts[i][key] == kpts[i - 1][key]:
                del kpts[i]
        return kpts

    # -- access -----------------------------------------------------------
    def __len__(self):
        return len(self.db)

    def __getitem__(self, idx):
        record = copy.deepcopy(self.db[idx])
        record["ann_info"] = self.ann_info
        return record
