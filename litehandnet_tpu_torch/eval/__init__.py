"""Evaluation-side decode (result dicts) and height-sharded serving."""

from litehandnet_tpu_torch.eval.decoder import served_map  # noqa: F401
from litehandnet_tpu_torch.eval.spatial_serving import (  # noqa: F401
    make_spatial_serve,
    spatial_model,
    spatial_spec,
)
