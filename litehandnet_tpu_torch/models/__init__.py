"""Model registry (port of ``litehandnet_tpu/models/__init__.py``).

``get_model(cfg, ...)`` maps ``cfg.MODEL.name`` to an ``nn.Module``: every
family of the JAX registry (``model_names()``), and ``KeyError`` for any other
name. ``litehandnet``, ``litehandnet_msrb`` and ``yolov6`` have a deploy
graph (weights from ``fuse_params``); the others ignore ``deploy``, as in
JAX.
"""

from __future__ import annotations

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.models.atthandnet import AttHandNet
from litehandnet_tpu_torch.models.classifier import ImageClassifier
from litehandnet_tpu_torch.models.hourglass import HourglassNet
from litehandnet_tpu_torch.models.hourglass_ablation import HourglassAblation
from litehandnet_tpu_torch.models.litehandnet import LiteHandNet
from litehandnet_tpu_torch.models.litehandnet_msrb import LiteHandNetMSRB
from litehandnet_tpu_torch.models.litehrnet import LiteHRNet
from litehandnet_tpu_torch.models.ms_att_hourglass import MSAttHourglass
from litehandnet_tpu_torch.models.ms_att_hourglass_stacked import (
    MSAttHourglassStacked,
)
from litehandnet_tpu_torch.models.reparam import fuse_params
from litehandnet_tpu_torch.models.simplebaseline import (
    PoseMobileNetV2,
    PoseResNet,
)
from litehandnet_tpu_torch.models.srhandnet import SRHandNet
from litehandnet_tpu_torch.models.yolov6 import YOLOv6

__all__ = ["AttHandNet", "HourglassAblation", "HourglassNet",
           "ImageClassifier", "LiteHRNet", "LiteHandNet", "LiteHandNetMSRB",
           "MSAttHourglass", "MSAttHourglassStacked", "PoseMobileNetV2",
           "PoseResNet", "SRHandNet", "YOLOv6", "fuse_params", "get_model",
           "model_names"]

_REGISTRY = {
    "litehandnet": LiteHandNet.from_config,
    "mynet": MSAttHourglass.from_config,
    "mynet_stacked": MSAttHourglassStacked.from_config,
    "hourglass_ablation": HourglassAblation.from_config,
    "srhandnet": SRHandNet.from_config,
    "litehrnet": LiteHRNet.from_config,
    "resnet": PoseResNet.from_config,
    "mobilenetv2": PoseMobileNetV2.from_config,
    "hourglass": HourglassNet.from_config,
    "atthandnet": AttHandNet.from_config,
    "classifier": ImageClassifier.from_config,
    "yolov6": YOLOv6.from_config,
    "litehandnet_msrb": LiteHandNetMSRB.from_config,
}


def model_names():
    return sorted(_REGISTRY)


def get_model(cfg, deploy: bool = False, device="cuda",
              dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """Build the model named by ``cfg.MODEL.name`` in eval mode.

    Args:
        cfg: experiment config.
        deploy: build the re-parameterized inference graph (weights come
            from ``fuse_params`` over a train-graph model); ignored by the
            families without Rep modules.
        device: where the parameters live; CUDA unless ``"cpu"`` is asked.
        dtype: parameter dtype.
    """
    name = cfg.MODEL.name.lower()
    if name not in _REGISTRY:
        raise KeyError(f"unknown model {name!r}; available: {model_names()}")
    model = _REGISTRY[name](cfg, deploy=deploy)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
