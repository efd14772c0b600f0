"""Config system (port of ``litehandnet_tpu/config/__init__.py``).

``get_config(path_or_name)`` loads an experiment: a ``.py`` file exposing
``_get_cfg() -> dict``, or the name of one of the JAX package's experiment
files (``config/experiments/<family>/<stem>.py``), built from the port's
table of their ``make_cfg`` arguments (``config/experiments.py``). ``pcfg``
carries the global post-processing hyper-parameters of the decoders.
``litehandnet/freihand_256_dark_h4_ca_r4`` (exp 2) is the default config.
"""

from __future__ import annotations

import copy
import importlib.util
import os
from typing import Any

from litehandnet_tpu_torch.config.experiments import EXPERIMENTS
from litehandnet_tpu_torch.config.templates import make_cfg

__all__ = ["Config", "config_from_dict", "get_config", "pcfg",
           "DEFAULT_CONFIG", "experiment_names"]


class Config(dict):
    """Attribute-access dict: ``cfg.MODEL.name`` and ``cfg.get(k, d)`` work;
    a missing attribute raises AttributeError."""

    def __init__(self, *args: Any, **kwargs: Any) -> None:
        super().__init__(*args, **kwargs)
        for k, v in list(self.items()):
            self[k] = self._wrap(v)

    @classmethod
    def _wrap(cls, value: Any) -> Any:
        if isinstance(value, dict) and not isinstance(value, Config):
            return cls(value)
        if isinstance(value, (list, tuple)):
            return type(value)(cls._wrap(v) for v in value)
        return value

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = self._wrap(value)

    def __setitem__(self, name: str, value: Any) -> None:
        super().__setitem__(name, self._wrap(value))

    def to_dict(self) -> dict:
        """A plain nested dict (lists and tuples kept)."""
        out = {}
        for k, v in self.items():
            if isinstance(v, Config):
                out[k] = v.to_dict()
            elif isinstance(v, (list, tuple)):
                out[k] = type(v)(
                    x.to_dict() if isinstance(x, Config) else x for x in v)
            else:
                out[k] = v
        return out


#: Global post-processing hyper-parameters (reference config/__init__.py:4-24,
#: with the JAX package's key renames: blue_kernel -> dark_kernel, cd_iou ->
#: cycle_detection_diou, cd_ratio -> cycle_detection_area_ratio).
pcfg = Config(
    # center-map / bbox decoding
    nms_kernel=11,           # max-pool NMS kernel for center maps
    num_candidates=10,       # top-k center peaks considered before NMS
    max_num_bbox=1,          # boxes kept per image after NMS
    detection_threshold=0.1, # min center score to count as a detection
    iou_threshold=0.6,       # IoU-NMS threshold for candidate bboxes
    bbox_factor=1.3,         # bbox padding factor for keypoint windows
    # DARK sub-pixel refinement
    dark_kernel=19,          # Gaussian-blur kernel ('blue_kernel' upstream)
    # cycle detection (re-infer small/overlapping hands)
    cycle_detection_diou=0.3,
    cycle_detection_area_ratio=0.0,
    # SimDR decoding
    simdr_nms_kernel=5,
    # bottom-up tag grouping (Gen-1 HeatmapParser)
    tag_threshold=1.0,       # read but never used upstream (vestigial)
    use_detection_val=True,  # read but never used upstream (vestigial)
    ignore_too_much=True,    # read but never used upstream (vestigial)
    bbox_k=3,                # per-joint top-k candidates inside a bbox
    region_avg_kernel=3,
    region_avg_stride=1,
    # absent from the reference pcfg although HeatmapParser.py:31 reads it;
    # 1 = size-preserving for the 3x1 avg pool
    region_avg_padding=1,
)

DEFAULT_CONFIG = "litehandnet/freihand_256_dark_h4_ca_r4"


def config_from_dict(d: dict) -> Config:
    """Wrap a copy of a plain config dict, applying the reference loader's
    consistency rule (config/__init__.py:33-36): a model that predicts
    bboxes (region maps) trains without rotation, so ``rot_prob`` is 0."""
    cfg = Config(copy.deepcopy(d))
    if cfg.get("MODEL", {}).get("pred_bbox", False) and "PIPELINE" in cfg:
        cfg.PIPELINE["rot_prob"] = 0
    return cfg


def experiment_names() -> list:
    """The names ``get_config`` builds from the port's table."""
    return sorted(EXPERIMENTS)


def _experiment(name: str) -> dict:
    model, dataset, exp_id, image_size, overrides = EXPERIMENTS[name]
    return make_cfg(model, dataset, exp_id=exp_id, image_size=image_size,
                    **copy.deepcopy(overrides))


def get_config(cfg_path: str = DEFAULT_CONFIG) -> Config:
    """Load an experiment config: a path to a ``.py`` file exposing
    ``_get_cfg()``, or an experiment name, slash or dot separated (e.g.
    ``litehandnet/freihand_256_dark_h4_ca_r4``).

    Raises:
        KeyError: an unknown experiment name.
        ValueError: the file defines no ``_get_cfg()``, or a ``_<id>_...``
            file name disagrees with the config's ``ID``.
    """
    if os.path.isfile(cfg_path):
        stem = os.path.splitext(os.path.basename(cfg_path))[0]
        spec = importlib.util.spec_from_file_location("_exp_cfg", cfg_path)
        if spec is None or spec.loader is None:
            raise ValueError(f"config {cfg_path!r} is not a python file")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        if not hasattr(module, "_get_cfg"):
            raise ValueError(f"config {cfg_path!r} does not define _get_cfg()")
        cfg = config_from_dict(module._get_cfg())
    else:
        name = cfg_path.replace("/", ".").replace("\\", ".")
        if name.endswith(".py"):
            name = name[: -len(".py")]
        stem = name.rsplit(".", 1)[-1]
        key = name.replace(".", "/")
        if key not in EXPERIMENTS:
            raise KeyError(f"unknown config {cfg_path!r}; "
                           f"{len(EXPERIMENTS)} known, see experiment_names()")
        cfg = config_from_dict(_experiment(key))
    # reference cross-check (utils/misc.py:14-15): a `_<id>_...` file name
    # must agree with the config's ID
    parts = stem.split("_")
    if len(parts) > 1 and parts[0] == "" and parts[1].isdigit():
        file_id = int(parts[1])
        if cfg.get("ID") != file_id:
            raise ValueError(f"config file id {file_id} != cfg ID "
                             f"{cfg.get('ID')} ({cfg_path})")
    return cfg
