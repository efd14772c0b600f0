"""Heatmap -> image coordinates (port of ``transform_preds`` and
``PIXEL_STD`` from ``litehandnet_tpu/ops/affine.py``).

The bbox "scale" is normalized by ``PIXEL_STD`` = 200 as in the reference
(base_dataset.py:133-162).
"""

from __future__ import annotations

import torch

PIXEL_STD = 200.0


def transform_preds(
    coords: torch.Tensor,
    center: torch.Tensor,
    scale: torch.Tensor,
    output_size,
    use_udp: bool = False,
) -> torch.Tensor:
    """Map heatmap-space coords back to source-image pixels
    (reference post_transforms.py:6-48).

    Args:
        coords: [..., K, 2] predicted coords in heatmap space.
        center: [..., 2] bbox centers.
        scale: [..., 2] bbox scales (w, h) / PIXEL_STD.
        output_size: (w, h) heatmap size.
        use_udp: unbiased data processing (stride = (s-1)/(o-1)).

    Returns:
        [..., K, 2] float32 coords in source-image pixels.
    """
    coords = coords.float()
    center = torch.as_tensor(center, dtype=torch.float32, device=coords.device)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=coords.device) * PIXEL_STD
    # python-float divisors keep the call free of host-to-device copies
    w, h = (float(s) - 1.0 if use_udp else float(s) for s in output_size)
    scale_xy = torch.stack([scale[..., 0] / w, scale[..., 1] / h], dim=-1)
    return (coords * scale_xy[..., None, :] + center[..., None, :]
            - scale[..., None, :] * 0.5)
