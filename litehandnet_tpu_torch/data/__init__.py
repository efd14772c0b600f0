"""Data layer (port of ``litehandnet_tpu/data/__init__.py``): COCO-format
datasets, metadata, the host loader and the fused device pipeline.

The registry mirrors the reference name mapping
(datasets/datasets/__init__.py:1-17 + build_dataset.py:97-146): the hand
datasets and the body datasets (``coco``, ``mpii``, ``mpii_action``).
"""

from __future__ import annotations

import bisect
import importlib

from litehandnet_tpu_torch.data.dataset_info import DATASET_INFOS, DatasetInfo  # noqa: F401

_HAND = "litehandnet_tpu_torch.data.hand"
_BODY = "litehandnet_tpu_torch.data.body"
_DATASETS = {
    "freihand": (_HAND, "FreiHandDataset"),
    "rhd": (_HAND, "RHD2dDataset"),
    "rhd2d": (_HAND, "RHD2dDataset"),
    "onehand10k": (_HAND, "OneHand10KDataset"),
    "panoptic": (_HAND, "PanopticDataset"),
    "panoptic_hand2d": (_HAND, "PanopticDataset"),
    "coco_wholebody_hand": (_HAND, "CocoWholeBodyHandDataset"),
    "zhhand": (_HAND, "ZHHandDataset"),
    "coco": (_BODY, "TopDownCocoDataset"),
    "mpii": (_BODY, "TopDownMpiiDataset"),
    "mpii_action": (_BODY, "TopDownMpiiActionDataset"),
}


def dataset_names():
    return sorted(_DATASETS)


def get_dataset_class(name: str):
    """The dataset class registered under ``name``.

    Raises:
        KeyError: an unknown name.
    """
    if name not in _DATASETS:
        raise KeyError(f"unknown dataset {name!r}; available: {dataset_names()}")
    module, attr = _DATASETS[name]
    return getattr(importlib.import_module(module), attr)


def build_dataset(cfg, data_type: str = "train", rng=None):
    """Build a dataset from an experiment config (reference
    datasets/build_dataset.py:97-146)."""
    cls = get_dataset_class(cfg.DATASET.name.lower())
    return cls(cfg.DATASET, data_type=data_type, rng=rng)


class ConcatDataset:
    """Concatenation of datasets (reference: the vendored ConcatDataset at
    datasets/build_dataset.py:15-95, which the reference never uses)."""

    def __init__(self, datasets):
        if not datasets:
            raise ValueError("ConcatDataset needs at least one dataset")
        self.datasets = list(datasets)
        self.cumulative_sizes = []
        total = 0
        for d in self.datasets:
            total += len(d)
            self.cumulative_sizes.append(total)
        # shared surface with Kpt2dDataset
        self.ann_info = self.datasets[0].ann_info
        self.dataset_name = "+".join(d.dataset_name for d in self.datasets)

    def __len__(self):
        return self.cumulative_sizes[-1]

    def _locate(self, idx):
        if idx < 0:
            idx += len(self)
        di = bisect.bisect_right(self.cumulative_sizes, idx)
        start = 0 if di == 0 else self.cumulative_sizes[di - 1]
        return di, idx - start

    def __getitem__(self, idx):
        di, li = self._locate(idx)
        return self.datasets[di][li]

    @property
    def db(self):
        out = []
        for d in self.datasets:
            out.extend(d.db)
        return out


def build_concat_dataset(cfgs, data_type="train", rng=None):
    """Build a multi-dataset union from several experiment configs."""
    return ConcatDataset([build_dataset(c, data_type, rng=rng) for c in cfgs])
