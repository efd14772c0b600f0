"""Config for the serve and train paths.

A copy of what the port reads from ``litehandnet_tpu.config``: the
attribute-access ``Config`` dict, ``config_from_dict``, and the FreiHAND 256²
experiments of the ported families as the template builds them
(``config/templates.py`` ``_MODELS`` :78-96 and ``make_cfg`` :105-200):
model, dataset, pipeline, and the CHECKPOINT, EVAL, TRAIN, OPTIMIZER and LOSS
sections. ``litehandnet/freihand_256_dark_h4_ca_r4`` (exp 2) is the default
config; ``mynet/freihand_256`` (exp 11) and
``hourglass_ablation/freihand_256_cbam`` (exp 48) are the other two.
"""

from __future__ import annotations

import copy
from typing import Any

__all__ = ["Config", "config_from_dict", "get_config", "DEFAULT_CONFIG"]


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


def config_from_dict(d: dict) -> Config:
    """Wrap a plain config dict (the ported keys need no consistency
    rules)."""
    return Config(copy.deepcopy(d))


_MODELS = {
    "litehandnet": dict(
        name="litehandnet", num_stage=4, num_block=[2, 2, 2],
        input_channel=128, ca_type="ca", reduction=4,
        activation="leakyrelu", pred_bbox=False,
    ),
    "mynet": dict(
        name="mynet", num_stage=4, num_block=[2, 2, 2], input_channel=128,
    ),
    "hourglass_ablation": dict(
        name="hourglass_ablation", num_stage=4, num_block=[2, 2, 2],
        input_channel=128, msrb=True, rca=False, ca_type="ca",
    ),
}


def _freihand(model: str, image_size: int, exp_id: int, **model_kw) -> dict:
    return dict(
        ID=exp_id,
        MODEL=dict(_MODELS[model], output_channel=21, **model_kw),
        DATASET=dict(
            name="freihand", num_joints=21,
            image_size=[image_size, image_size],
            heatmap_size=[image_size // 4, image_size // 4],
        ),
        PIPELINE=dict(
            use_udp=False, sigma=2, kernel=(11, 11), encoding="MSRA",
            unbiased_encoding=True, target_type="GaussianHeatmap",
            simdr_split_ratio=0,
        ),
        CHECKPOINT=dict(interval=10, resume=True, load_best=False,
                        save_root="checkpoints/"),
        EVAL=dict(interval=1, metric=["PCK", "AUC", "EPE"], save_best="PCK",
                  pck_threshold=0.2),
        TRAIN=dict(distributed=True, pin_memory=False, workers=4,
                   syncBN=True, total_epoches=210, batch_per_gpu=32),
        OPTIMIZER=dict(type="Adam", lr=5e-4, warmup_steps=400,
                       step_epoch=[170, 200], resume=False),
        LOSS=dict(type="TopdownHeatmapLoss", loss_weight=[1.0, 0.1],
                  auto_weight=False),
    )


_CONFIGS = {
    "litehandnet/freihand_256_dark_h4_ca_r4": _freihand("litehandnet", 256, 2),
    "mynet/freihand_256": _freihand("mynet", 256, 11),
    "hourglass_ablation/freihand_256_cbam": _freihand(
        "hourglass_ablation", 256, 48, ca_type="cbam"),
}

DEFAULT_CONFIG = "litehandnet/freihand_256_dark_h4_ca_r4"


def get_config(name: str = DEFAULT_CONFIG) -> Config:
    """A named config (slash or dot separated)."""
    key = name.replace(".", "/")
    if key not in _CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; ported: {sorted(_CONFIGS)}"
        )
    return config_from_dict(_CONFIGS[key])
