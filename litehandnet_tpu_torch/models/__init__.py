"""Model registry (port of ``litehandnet_tpu/models/__init__.py``).

``get_model(cfg, ...)`` maps ``cfg.MODEL.name`` to an ``nn.Module``. Ported:
``litehandnet``, ``mynet``, ``mynet_stacked``, ``hourglass_ablation``,
``srhandnet``, ``litehrnet``, ``resnet``, ``mobilenetv2`` and ``hourglass``;
other families
raise ``KeyError``. Only ``litehandnet`` has a deploy graph; the others
ignore ``deploy``, as in JAX.
"""

from __future__ import annotations

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.models.hourglass import HourglassNet
from litehandnet_tpu_torch.models.hourglass_ablation import HourglassAblation
from litehandnet_tpu_torch.models.litehandnet import LiteHandNet
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

__all__ = ["HourglassAblation", "HourglassNet", "LiteHRNet", "LiteHandNet",
           "MSAttHourglass", "MSAttHourglassStacked", "PoseMobileNetV2",
           "PoseResNet", "SRHandNet", "fuse_params", "get_model"]

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
}


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
        raise KeyError(f"model family {name!r} is not ported yet; "
                       f"ported: {sorted(_REGISTRY)}")
    model = _REGISTRY[name](cfg, deploy=deploy)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
