"""Dataset metadata (a copy of ``litehandnet_tpu/data/dataset_info.py``,
pure data): keypoint names, flip pairs, skeletons, OKS sigmas, joint
weights, visualization colors.

Replaces reference datasets/dataset_info/ (dataset_info.py:4-107 and the
per-dataset dicts under dataset_configs/). The hand-dataset metadata is
generated programmatically (all 21-keypoint hand datasets share the same
layout) rather than spelled out per dataset.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

# ---------------------------------------------------------------------------
# metadata construction helpers


def _hand21_info(name: str, sigmas: List[float] | None = None) -> dict:
    """21-keypoint single-hand metadata (wrist + 4 joints x 5 fingers),
    matching the reference layout (e.g. freihand_dataset.py:21-43)."""
    fingers = [
        ("thumb", [255, 128, 0]),
        ("forefinger", [255, 153, 255]),
        ("middle_finger", [102, 178, 255]),
        ("ring_finger", [255, 51, 51]),
        ("pinky_finger", [0, 255, 0]),
    ]
    keypoint_info = {
        0: dict(name="wrist", id=0, color=[255, 255, 255], swap="")
    }
    skeleton_info = {}
    kid, sid = 1, 0
    for finger, color in fingers:
        prev = "wrist"
        for j in range(1, 5):
            kname = f"{finger}{j}"
            keypoint_info[kid] = dict(name=kname, id=kid, color=color, swap="")
            skeleton_info[sid] = dict(link=(prev, kname), id=sid, color=color)
            prev = kname
            kid += 1
            sid += 1
    if sigmas is None:
        # COCO-WholeBody hand OKS sigmas
        sigmas = [
            0.029, 0.022, 0.035, 0.037, 0.047, 0.026, 0.025, 0.024, 0.035,
            0.018, 0.024, 0.022, 0.026, 0.017, 0.021, 0.021, 0.032, 0.02,
            0.019, 0.022, 0.031,
        ]
    return dict(
        dataset_name=name,
        paper_info={},
        keypoint_info=keypoint_info,
        skeleton_info=skeleton_info,
        joint_weights=[1.0] * 21,
        sigmas=sigmas,
    )


def _body_info(name, names, pairs, links, weights, sigmas, colors=None):
    keypoint_info = {}
    swap = {}
    for a, b in pairs:
        swap[a] = b
        swap[b] = a
    for i, n in enumerate(names):
        keypoint_info[i] = dict(
            name=n, id=i,
            color=(colors[i] if colors else [255, 128, 0]),
            swap=swap.get(n, ""),
        )
    skeleton_info = {
        i: dict(link=link, id=i, color=[255, 128, 0])
        for i, link in enumerate(links)
    }
    return dict(
        dataset_name=name,
        paper_info={},
        keypoint_info=keypoint_info,
        skeleton_info=skeleton_info,
        joint_weights=list(weights),
        sigmas=list(sigmas),
    )


# ---------------------------------------------------------------------------
# per-dataset metadata (same facts as reference dataset_configs/*)

freihand2d_info = _hand21_info("freihand")
rhd2d_info = _hand21_info("rhd2d")
onehand10k_info = _hand21_info("onehand10k")
panoptic_hand2d_info = _hand21_info("panoptic_hand2d")
coco_wholebody_hand_info = _hand21_info("coco_wholebody_hand")
zhhand_info = _hand21_info("zhhand")

_COCO_NAMES = [
    "nose", "left_eye", "right_eye", "left_ear", "right_ear",
    "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
    "left_wrist", "right_wrist", "left_hip", "right_hip", "left_knee",
    "right_knee", "left_ankle", "right_ankle",
]
_COCO_PAIRS = [
    ("left_eye", "right_eye"), ("left_ear", "right_ear"),
    ("left_shoulder", "right_shoulder"), ("left_elbow", "right_elbow"),
    ("left_wrist", "right_wrist"), ("left_hip", "right_hip"),
    ("left_knee", "right_knee"), ("left_ankle", "right_ankle"),
]
_COCO_LINKS = [
    ("left_ankle", "left_knee"), ("left_knee", "left_hip"),
    ("right_ankle", "right_knee"), ("right_knee", "right_hip"),
    ("left_hip", "right_hip"), ("left_shoulder", "left_hip"),
    ("right_shoulder", "right_hip"), ("left_shoulder", "right_shoulder"),
    ("left_shoulder", "left_elbow"), ("right_shoulder", "right_elbow"),
    ("left_elbow", "left_wrist"), ("right_elbow", "right_wrist"),
    ("left_eye", "right_eye"), ("nose", "left_eye"), ("nose", "right_eye"),
    ("left_eye", "left_ear"), ("right_eye", "right_ear"),
    ("left_ear", "left_shoulder"), ("right_ear", "right_shoulder"),
]
coco_info = _body_info(
    "coco", _COCO_NAMES, _COCO_PAIRS, _COCO_LINKS,
    weights=[
        1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.2, 1.2, 1.5, 1.5, 1.0, 1.0,
        1.2, 1.2, 1.5, 1.5,
    ],
    sigmas=[
        0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072, 0.072,
        0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089, 0.089,
    ],
)

_MPII_NAMES = [
    "right_ankle", "right_knee", "right_hip", "left_hip", "left_knee",
    "left_ankle", "pelvis", "thorax", "upper_neck", "head_top",
    "right_wrist", "right_elbow", "right_shoulder", "left_shoulder",
    "left_elbow", "left_wrist",
]
_MPII_PAIRS = [
    ("right_ankle", "left_ankle"), ("right_knee", "left_knee"),
    ("right_hip", "left_hip"), ("right_wrist", "left_wrist"),
    ("right_elbow", "left_elbow"), ("right_shoulder", "left_shoulder"),
]
_MPII_LINKS = [
    ("right_ankle", "right_knee"), ("right_knee", "right_hip"),
    ("right_hip", "pelvis"), ("pelvis", "left_hip"),
    ("left_hip", "left_knee"), ("left_knee", "left_ankle"),
    ("pelvis", "thorax"), ("thorax", "upper_neck"),
    ("upper_neck", "head_top"), ("right_wrist", "right_elbow"),
    ("right_elbow", "right_shoulder"), ("right_shoulder", "thorax"),
    ("thorax", "left_shoulder"), ("left_shoulder", "left_elbow"),
    ("left_elbow", "left_wrist"),
]
mpii_info = _body_info(
    "mpii", _MPII_NAMES, _MPII_PAIRS, _MPII_LINKS,
    weights=[
        1.5, 1.2, 1.0, 1.0, 1.2, 1.5, 1.0, 1.0, 1.0, 1.0, 1.5, 1.2, 1.0,
        1.0, 1.2, 1.5,
    ],
    sigmas=[
        0.089, 0.083, 0.107, 0.107, 0.083, 0.089, 0.026, 0.026, 0.026,
        0.026, 0.062, 0.072, 0.079, 0.079, 0.072, 0.062,
    ],
)
mpii_action_info = dict(mpii_info, dataset_name="mpii_action")


DATASET_INFOS: Dict[str, dict] = {
    "freihand": freihand2d_info,
    "rhd2d": rhd2d_info,
    # reference configs name this dataset 'rhd' (config/*/rhd2d/_*.py) while
    # the metadata dict is 'rhd2d' (dataset_configs); accept both
    "rhd": rhd2d_info,
    "onehand10k": onehand10k_info,
    "panoptic_hand2d": panoptic_hand2d_info,
    "coco_wholebody_hand": coco_wholebody_hand_info,
    "zhhand": zhhand_info,
    "coco": coco_info,
    "mpii": mpii_info,
    "mpii_action": mpii_action_info,
}


class DatasetInfo:
    """Parsed metadata (reference: dataset_info.py:4-107)."""

    def __init__(self, dataset_info: dict):
        self._dataset_info = dataset_info
        self.dataset_name = dataset_info["dataset_name"]
        self.paper_info = dataset_info.get("paper_info", {})
        self.keypoint_info = dataset_info["keypoint_info"]
        self.skeleton_info = dataset_info["skeleton_info"]
        self.joint_weights = np.array(
            dataset_info["joint_weights"], dtype=np.float32
        )[:, None]
        self.sigmas = np.array(dataset_info["sigmas"])
        self._parse_keypoint_info()
        self._parse_skeleton_info()

    def _parse_keypoint_info(self):
        self.keypoint_num = len(self.keypoint_info)
        self.keypoint_id2name = {}
        self.keypoint_name2id = {}
        self.pose_kpt_color = []
        self.upper_body_ids = []
        self.lower_body_ids = []
        self.flip_index_name = []
        self.flip_pairs_name = []

        for kid, info in self.keypoint_info.items():
            name = info["name"]
            self.keypoint_id2name[kid] = name
            self.keypoint_name2id[name] = kid
            self.pose_kpt_color.append(info.get("color", [255, 128, 0]))
            t = info.get("type", "")
            if t == "upper":
                self.upper_body_ids.append(kid)
            elif t == "lower":
                self.lower_body_ids.append(kid)
            swap = info.get("swap", "")
            if swap in ("", name):
                self.flip_index_name.append(name)
            else:
                self.flip_index_name.append(swap)
                if [swap, name] not in self.flip_pairs_name:
                    self.flip_pairs_name.append([name, swap])

        self.flip_pairs = [
            [self.keypoint_name2id[a], self.keypoint_name2id[b]]
            for a, b in self.flip_pairs_name
        ]
        self.flip_index = [
            self.keypoint_name2id[n] for n in self.flip_index_name
        ]
        self.pose_kpt_color = np.array(self.pose_kpt_color)

    def _parse_skeleton_info(self):
        self.link_num = len(self.skeleton_info)
        self.pose_link_color = []
        self.skeleton_name = []
        self.skeleton = []
        for sid, info in self.skeleton_info.items():
            link = info["link"]
            self.skeleton_name.append(link)
            self.skeleton.append([
                self.keypoint_name2id[link[0]],
                self.keypoint_name2id[link[1]],
            ])
            self.pose_link_color.append(info.get("color", [255, 128, 0]))
        self.pose_link_color = np.array(self.pose_link_color)
