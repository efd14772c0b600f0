"""Model registry (port of ``litehandnet_tpu/models/__init__.py``).

``get_model(cfg, ...)`` maps ``cfg.MODEL.name`` to an ``nn.Module``. Only
``litehandnet`` is ported so far; other families raise ``KeyError``.
"""

from __future__ import annotations

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.models.litehandnet import LiteHandNet
from litehandnet_tpu_torch.models.reparam import fuse_params

__all__ = ["LiteHandNet", "fuse_params", "get_model"]

_REGISTRY = {"litehandnet": LiteHandNet.from_config}


def get_model(cfg, deploy: bool = False, device="cuda",
              dtype: torch.dtype = torch.float32) -> torch.nn.Module:
    """Build the model named by ``cfg.MODEL.name`` in eval mode.

    Args:
        cfg: experiment config.
        deploy: build the re-parameterized inference graph (weights come
            from ``fuse_params`` over a train-graph model).
        device: where the parameters live; CUDA unless ``"cpu"`` is asked.
        dtype: parameter dtype.
    """
    name = cfg.MODEL.name.lower()
    if name not in _REGISTRY:
        raise KeyError(f"model family {name!r} is not ported yet; "
                       f"ported: {sorted(_REGISTRY)}")
    model = _REGISTRY[name](cfg, deploy=deploy)
    return model.to(device=resolve_device(device), dtype=dtype).eval()
