"""The serve program: uint8 images -> ImageNet normalize -> forward -> DARK
decode -> image-space keypoints.

Port of the program ``bench.py`` times (``one_step``, bench.py:345-354) and
``tools/test.py`` builds through ``TopDownDecoder``. Only ``litehandnet`` is
served deploy-fused (``tools/test.py:125-128``); the other families serve
their train graph in eval mode. The forward runs under autocast in
``channels_last``; heatmaps are cast to float32 before decode.

A request is the span ``lhn.serve``, its input copy and normalize
``lhn.serve.input``, its forward ``lhn.serve.forward``
(``utils/profiling.span``: recorded only under ``torch.profiler``).
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.eval.decoder import decode_settings, unpack_outputs
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.utils.profiling import span
from litehandnet_tpu_torch.utils.weights import (
    load_jax_variables,
    randomize_,
    rules_for,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

# the families served deploy-fused (tools/test.py:125-128)
FUSED_FAMILIES = ("litehandnet",)


def deploy_model(cfg, variables: Optional[Mapping] = None, seed: int = 0,
                 device="cuda") -> torch.nn.Module:
    """The served model in eval mode, float32, ``channels_last``: for
    ``litehandnet`` the deploy-fused graph, for the other families the train
    graph.

    Args:
        cfg: experiment config.
        variables: JAX variables as numpy arrays: the train graph
            (``{'params', 'batch_stats'}``), fused here for ``litehandnet``,
            or its deploy graph (``{'params'}``, the JAX ``fuse_params``
            output). ``None`` draws train-graph weights from ``seed``
            (``randomize_``).
        seed: seed of the random weights when ``variables`` is None.
        device: where the model runs.
    """
    device = resolve_device(device)
    fused = cfg.MODEL.name.lower() in FUSED_FAMILIES
    if fused and variables is not None and "batch_stats" not in variables:
        model = get_model(cfg, deploy=True, device="cpu")
        load_jax_variables(model, variables,
                           rules_for(cfg.MODEL.name, deploy=True))
    else:
        model = get_model(cfg, device="cpu")
        if variables is None:
            randomize_(model, torch.Generator().manual_seed(seed))
        else:
            load_jax_variables(model, variables, rules_for(cfg.MODEL.name))
        if fused:
            train, model = model, get_model(cfg, deploy=True, device="cpu")
            model.load_state_dict(fuse_params(train))
    return model.to(device=device, memory_format=torch.channels_last)


class Predictor:
    """Keypoints from uint8 images, on one device.

    ``Predictor(cfg)(images_u8 [B, H, W, 3], center [B, 2], scale [B, 2])``
    returns ``(preds [B, K, 2], maxvals [B, K, 1])`` in image coordinates.
    """

    def __init__(self, cfg=None, variables: Optional[Mapping] = None,
                 device="cuda", dtype: torch.dtype = torch.bfloat16,
                 seed: int = 0):
        self.cfg = get_config() if cfg is None else cfg
        self.device = resolve_device(device)
        self.dtype = dtype
        self.model = deploy_model(self.cfg, variables, seed, self.device)
        self.mean = torch.tensor(IMAGENET_MEAN, device=self.device).view(1, 3, 1, 1) * 255.0
        self.std = torch.tensor(IMAGENET_STD, device=self.device).view(1, 3, 1, 1) * 255.0
        self.decode = decode_settings(self.cfg)
        self.num_joints = int(self.cfg.DATASET.num_joints)

    @torch.no_grad()
    def heatmaps(self, images: torch.Tensor) -> torch.Tensor:
        """uint8 ``[B, H, W, 3]`` -> float32 heatmaps ``[B, H/4, W/4, K]``,
        K-innermost and contiguous: the finest scale of a multi-scale model,
        the last stack of a stacked one, without region channels
        (``eval.decoder.unpack_outputs``, the rule ``tools/test`` uses)."""
        if images.dtype != torch.uint8 or images.dim() != 4 or images.shape[-1] != 3:
            raise ValueError(
                f"expected uint8 [B, H, W, 3], got {images.dtype} "
                f"{tuple(images.shape)}"
            )
        with span("lhn.serve.input", self.device):
            # NHWC memory seen as NCHW is already channels_last
            x = images.to(self.device, non_blocking=True).permute(0, 3, 1, 2)
            x = (x.float() - self.mean) / self.std
        with span("lhn.serve.forward", self.device):
            with torch.autocast(self.device.type, dtype=self.dtype,
                                enabled=self.dtype != torch.float32):
                out = self.model(x)
            return unpack_outputs(out, self.num_joints)[0]

    @torch.no_grad()
    def __call__(self, images: torch.Tensor, center, scale):
        with span("lhn.serve", self.device):
            center = torch.as_tensor(center, dtype=torch.float32,
                                     device=self.device)
            scale = torch.as_tensor(scale, dtype=torch.float32,
                                    device=self.device)
            _, preds, maxvals = keypoints_from_heatmaps(
                self.heatmaps(images), center, scale, **self.decode)
            return preds, maxvals
