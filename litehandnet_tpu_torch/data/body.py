"""Body datasets: COCO (mAP via OKS), MPII and MPII-action (PCKh); port of
``litehandnet_tpu/data/body.py`` (host-side numpy).

Reference: datasets/datasets/body/{topdown_coco_dataset.py,
topdown_mpii_dataset.py, topdown_mpii_action_dataset.py}.
"""

from __future__ import annotations

import json
import os.path as osp
from collections import OrderedDict, defaultdict

import numpy as np

from litehandnet_tpu_torch.data import dataset_info as DI
from litehandnet_tpu_torch.data.base import Kpt2dDataset
from litehandnet_tpu_torch.eval.cocoeval import STAT_NAMES, KeypointCOCOeval
from litehandnet_tpu_torch.eval.nms import oks_nms, soft_oks_nms


class TopDownCocoDataset(Kpt2dDataset):
    """COCO 17-keypoint top-down dataset; metric mAP via OKS
    (reference: topdown_coco_dataset.py:216-390)."""

    def __init__(self, data_cfg, data_type="train", rng=None):
        super().__init__(
            data_cfg, data_type, dataset_info=DI.coco_info, rng=rng
        )
        self.use_gt_bbox = data_cfg.get("use_gt_bbox", True)
        self.bbox_file = data_cfg.get("bbox_file", None)
        self.det_bbox_thr = data_cfg.get("det_bbox_thr", 0.0)
        self.use_nms = data_cfg.get("use_nms", True)
        self.soft_nms = data_cfg.get("soft_nms", False)
        self.nms_thr = data_cfg.get("nms_thr", 1.0)
        self.oks_thr = data_cfg.get("oks_thr", 0.9)
        self.vis_thr = data_cfg.get("vis_thr", 0.2)
        self.db = self._get_db()

    def _get_db(self):
        if (not self.test_mode) or self.use_gt_bbox:
            return self._load_gt_annotations()
        return self._load_detection_results()

    def _load_gt_annotations(self):
        gt_db = []
        bbox_id = 0
        num_joints = self.ann_info["num_joints"]
        for img_id in self.img_ids:
            img_ann = self.coco.loadImgs(img_id)[0]
            width, height = img_ann["width"], img_ann["height"]
            for obj in self.coco.loadAnns(
                self.coco.getAnnIds(imgIds=img_id, iscrowd=False)
            ):
                if "bbox" not in obj or max(obj.get("keypoints", [0])) == 0:
                    continue
                x, y, w, h = obj["bbox"]
                x1, y1 = max(0, x), max(0, y)
                x2 = min(width - 1, x1 + max(0, w - 1))
                y2 = min(height - 1, y1 + max(0, h - 1))
                if not (obj.get("area", 1) > 0 and x2 > x1 and y2 > y1):
                    continue
                clean_bbox = [x1, y1, x2 - x1, y2 - y1]
                joints_3d = np.zeros((num_joints, 3), np.float32)
                joints_3d_visible = np.zeros((num_joints, 3), np.float32)
                kpts = np.array(obj["keypoints"]).reshape(-1, 3)
                joints_3d[:, :2] = kpts[:, :2]
                joints_3d_visible[:, :2] = np.minimum(1, kpts[:, 2:3])
                center, scale = self._xywh2cs(*clean_bbox)
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
                    "bbox": np.array(clean_bbox, np.float32),
                    "bbox_score": 1,
                    "bbox_id": bbox_id,
                })
                bbox_id += 1
        return sorted(gt_db, key=lambda x: x["bbox_id"])

    def _load_detection_results(self):
        """Person detection boxes (reference: topdown_coco_dataset.py:166-214)."""
        with open(self.bbox_file) as f:
            all_boxes = json.load(f)
        gt_db = []
        bbox_id = 0
        num_joints = self.ann_info["num_joints"]
        for det in all_boxes:
            if det.get("category_id", 1) != 1:
                continue
            score = det.get("score", 1.0)
            if score < self.det_bbox_thr:
                continue
            center, scale = self._xywh2cs(*det["bbox"][:4])
            gt_db.append({
                "image_file": osp.join(
                    self.img_prefix, self.id2name[det["image_id"]]
                ),
                "center": center,
                "scale": scale,
                "rotation": 0,
                "joints_3d": np.zeros((num_joints, 3), np.float32),
                "joints_3d_visible": np.ones((num_joints, 3), np.float32),
                "dataset": self.dataset_name,
                "bbox": np.array(det["bbox"][:4], np.float32),
                "bbox_score": score,
                "bbox_id": bbox_id,
            })
            bbox_id += 1
        return sorted(gt_db, key=lambda x: x["bbox_id"])

    def evaluate(self, results, res_folder=None, metric="mAP", **kwargs):
        metrics = metric if isinstance(metric, list) else [metric]
        for m in metrics:
            if m != "mAP":
                raise KeyError(f"metric {m} is not supported")

        # gather per-image poses with rescored keypoints
        kpts = defaultdict(list)
        for result in results:
            preds = np.asarray(result["preds"])
            boxes = np.asarray(result["boxes"])
            image_paths = result["image_paths"]
            bbox_ids = result["bbox_ids"]
            for i in range(len(image_paths)):
                image_id = self.name2id[image_paths[i][len(self.img_prefix):]]
                kpts[image_id].append({
                    "keypoints": preds[i],
                    "center": boxes[i][0:2],
                    "scale": boxes[i][2:4],
                    "area": float(boxes[i][4]),
                    "score": float(boxes[i][5]),
                    "image_id": image_id,
                    "bbox_id": int(bbox_ids[i]),
                })

        # rescore + OKS NMS (reference: topdown_coco_dataset.py:282-311)
        valid_kpts = []
        for image_id, img_kpts in kpts.items():
            img_kpts = self._sort_and_unique_bboxes(img_kpts)
            for k in img_kpts:
                box_score = k["score"]
                kpt = np.asarray(k["keypoints"])
                kpt_score, valid_num = 0.0, 0
                for s in kpt[:, 2]:
                    if s > self.vis_thr:
                        kpt_score += s
                        valid_num += 1
                if valid_num:
                    kpt_score /= valid_num
                k["score"] = float(kpt_score * box_score)
            if self.use_nms:
                nms_fn = soft_oks_nms if self.soft_nms else oks_nms
                keep = nms_fn(img_kpts, self.oks_thr, sigmas=self.sigmas)
                img_kpts = [img_kpts[i] for i in keep]
            valid_kpts.extend(img_kpts)

        # exact COCO protocol (101-pt interpolation, maxDets, area ranges)
        detections = [
            dict(
                image_id=k["image_id"],
                keypoints=[float(v) for v in np.asarray(
                    k["keypoints"]).flatten()],
                score=float(k["score"]),
            )
            for k in valid_kpts
        ]
        coco_stats = KeypointCOCOeval(
            self.coco, detections, sigmas=self.sigmas
        ).run()
        stats = OrderedDict(zip(STAT_NAMES, map(float, coco_stats)))
        stats["mAP"] = stats["AP"]
        return stats


def _mpii_pckh(preds_2d, gt_file):
    """DHRNet-style PCKh against the MPII validation mat file
    (reference: topdown_mpii_dataset.py:182-250)."""
    from scipy.io import loadmat

    gt_dict = loadmat(gt_file)
    dataset_joints = gt_dict["dataset_joints"]
    jnt_missing = gt_dict["jnt_missing"]
    pos_gt_src = gt_dict["pos_gt_src"]
    headboxes_src = gt_dict["headboxes_src"]

    pos_pred_src = np.transpose(preds_2d, [1, 2, 0])

    def jid(name):
        return np.where(dataset_joints == name)[1][0]

    jnt_visible = 1 - jnt_missing
    uv_err = np.linalg.norm(pos_pred_src - pos_gt_src, axis=1)
    headsizes = headboxes_src[1, :, :] - headboxes_src[0, :, :]
    headsizes = np.linalg.norm(headsizes, axis=0) * 0.6  # SC_BIAS
    scale = headsizes * np.ones((len(uv_err), 1), np.float32)
    scaled_err = uv_err / scale * jnt_visible
    jnt_count = np.sum(jnt_visible, axis=1)
    pckh = 100.0 * np.sum((scaled_err <= 0.5) * jnt_visible, axis=1) / jnt_count
    pck01 = 100.0 * np.sum((scaled_err <= 0.1) * jnt_visible, axis=1) / jnt_count

    pckh = np.ma.array(pckh, mask=False)
    pckh.mask[6:8] = True
    jnt_count = np.ma.array(jnt_count, mask=False)
    jnt_count.mask[6:8] = True
    ratio = jnt_count / np.sum(jnt_count).astype(np.float64)
    return OrderedDict([
        ("Head", pckh[jid("head")]),
        ("Shoulder", 0.5 * (pckh[jid("lsho")] + pckh[jid("rsho")])),
        ("Elbow", 0.5 * (pckh[jid("lelb")] + pckh[jid("relb")])),
        ("Wrist", 0.5 * (pckh[jid("lwri")] + pckh[jid("rwri")])),
        ("Hip", 0.5 * (pckh[jid("lhip")] + pckh[jid("rhip")])),
        ("Knee", 0.5 * (pckh[jid("lkne")] + pckh[jid("rkne")])),
        ("Ankle", 0.5 * (pckh[jid("lank")] + pckh[jid("rank")])),
        ("PCKh", np.sum(pckh * ratio)),
        ("PCKh@0.1", np.sum(np.ma.array(pck01, mask=pckh.mask) * ratio)),
    ])


class TopDownMpiiDataset(Kpt2dDataset):
    """MPII json-list dataset, PCKh metric
    (reference: topdown_mpii_dataset.py:15-258).

    Annotations are the DHRNet-style json list (not COCO format).
    """

    def __init__(self, data_cfg, data_type="train", rng=None):
        # MPII ann format is a json list, so skip the COCO indexing path.
        self._init_without_coco(
            data_cfg, data_type, dataset_info=DI.mpii_info, rng=rng
        )
        self.db = self._get_db()
        self.image_set = set(x["image_file"] for x in self.db)
        self.num_images = len(self.image_set)

    def _init_without_coco(self, data_cfg, data_type, dataset_info, rng):
        split = getattr_split(data_cfg, data_type)
        self.ann_file = split.ann_file
        self.img_prefix = split.img_prefix
        self.test_mode = data_type != "train"
        self.data_type = data_type
        self.rng = rng or np.random.RandomState(0)
        info = DI.DatasetInfo(dataset_info)
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
        self.sigmas = info.sigmas
        self.dataset_name = info.dataset_name
        self.pose_link_color = info.pose_link_color
        self.pose_kpt_color = info.pose_kpt_color
        self.pose_skeleton = info.skeleton

    def _get_db(self):
        with open(self.ann_file) as f:
            anno = json.load(f)
        gt_db = []
        bbox_id = 0
        num_joints = self.ann_info["num_joints"]
        for a in anno:
            center = np.array(a["center"], dtype=np.float32)
            scale = np.array([a["scale"], a["scale"]], dtype=np.float32)
            if center[0] != -1:
                center[1] = center[1] + 15 * scale[1]
                scale = scale * 1.25
            center = center - 1  # matlab 1-based -> 0-based

            joints_3d = np.zeros((num_joints, 3), np.float32)
            joints_3d_visible = np.zeros((num_joints, 3), np.float32)
            if not self.test_mode:
                joints = np.array(a["joints"])
                joints_vis = np.array(a["joints_vis"])
                joints_3d[:, 0:2] = joints[:, 0:2] - 1
                joints_3d_visible[:, :2] = joints_vis[:, None]
            gt_db.append({
                "image_file": osp.join(self.img_prefix, a["image"]),
                "bbox_id": bbox_id,
                "center": center,
                "scale": scale,
                "rotation": 0,
                "joints_3d": joints_3d,
                "joints_3d_visible": joints_3d_visible,
                "dataset": self.dataset_name,
                "bbox_score": 1,
            })
            bbox_id += 1
        return sorted(gt_db, key=lambda x: x["bbox_id"])

    def evaluate(self, results, res_folder=None, metric="PCKh", **kwargs):
        metrics = metric if isinstance(metric, list) else [metric]
        for m in metrics:
            if m != "PCKh":
                raise KeyError(f"metric {m} is not supported")
        kpts = []
        for result in results:
            preds = result["preds"]
            bbox_ids = result["bbox_ids"]
            for i in range(len(bbox_ids)):
                kpts.append({
                    "keypoints": np.asarray(preds[i]),
                    "bbox_id": int(bbox_ids[i]),
                })
        kpts = self._sort_and_unique_bboxes(kpts)
        preds = np.stack([k["keypoints"] for k in kpts])[..., :2] + 1.0
        gt_file = osp.join(osp.dirname(self.ann_file), "mpii_gt_val.mat")
        return _mpii_pckh(preds, gt_file)


class TopDownMpiiActionDataset(TopDownMpiiDataset):
    """Custom MPII-action variant: identical loading/eval machinery
    (reference: topdown_mpii_action_dataset.py)."""

    def _init_without_coco(self, data_cfg, data_type, dataset_info, rng):
        super()._init_without_coco(
            data_cfg, data_type, DI.mpii_action_info, rng
        )


def getattr_split(data_cfg, data_type):
    if data_type == "train":
        return data_cfg.train
    if data_type == "val":
        return data_cfg.val
    if data_type == "test":
        return data_cfg.test
    raise ValueError(data_type)
