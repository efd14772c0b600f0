"""Loss registry (port of ``litehandnet_tpu/losses/__init__.py``).

``get_loss(cfg)`` builds the criterion named by ``cfg.LOSS.type``: an
``nn.Module`` with ``criterion(outputs, batch) -> (loss, {name: loss})``
whose own parameters (``mtl_p``, the SimDR decoders) train with the model.
``TopdownHeatmapLoss`` (with or without SimDR), ``SRHandNetLoss`` and
``CenterSimdrLoss``, with the loss functions JAX's registry exports.
"""

from litehandnet_tpu_torch.losses.losses import (  # noqa: F401
    CenterSimdrLoss,
    KLDiscretLoss,
    SimDRLoss,
    SRHandNetLoss,
    TopdownHeatmapLoss,
    centernet_focal_loss,
    distance_loss,
    focal_loss,
    joints_distance_loss,
    kl_discret_loss,
    kl_focal_loss,
    mask_loss,
    reg_l1_loss,
    region_loss,
)

_REGISTRY = {"topdownheatmaploss": TopdownHeatmapLoss.from_config,
             "srhandnetloss": SRHandNetLoss.from_config,
             "centersimdrloss": CenterSimdrLoss.from_config}


def get_loss(cfg):
    """Build the criterion named by ``cfg.LOSS.type``.

    Raises:
        KeyError: an unknown loss.
    """
    name = cfg.LOSS.type.lower()
    if name not in _REGISTRY:
        raise KeyError(f"loss {cfg.LOSS.type!r} is not ported yet; ported: "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](cfg)
