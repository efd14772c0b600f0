"""Config for the serve path.

A copy of what the serve slice reads from ``litehandnet_tpu.config``: the
attribute-access ``Config`` dict, ``config_from_dict``, and the LiteHandNet
model / FreiHAND dataset / pipeline keys of the experiment template
(``config/templates.py`` ``_MODELS['litehandnet']`` and ``make_cfg``).
``freihand_256_dark_h4_ca_r4`` is the default serve config.
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


def config_from_dict(d: dict) -> Config:
    """Wrap a plain config dict (the serve keys need no consistency rules)."""
    return Config(copy.deepcopy(d))


def _litehandnet_freihand(image_size: int, exp_id: int) -> dict:
    return dict(
        ID=exp_id,
        MODEL=dict(
            name="litehandnet", num_stage=4, num_block=[2, 2, 2],
            input_channel=128, ca_type="ca", reduction=4,
            activation="leakyrelu", pred_bbox=False, output_channel=21,
        ),
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
    )


_CONFIGS = {
    "litehandnet/freihand_256_dark_h4_ca_r4": _litehandnet_freihand(256, 2),
}

DEFAULT_CONFIG = "litehandnet/freihand_256_dark_h4_ca_r4"


def get_config(name: str = DEFAULT_CONFIG) -> Config:
    """A named serve config (slash or dot separated)."""
    key = name.replace(".", "/")
    if key not in _CONFIGS:
        raise KeyError(
            f"unknown config {name!r}; ported: {sorted(_CONFIGS)}"
        )
    return config_from_dict(_CONFIGS[key])
