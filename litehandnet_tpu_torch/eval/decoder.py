"""TopDownDecoder: batch decode of model outputs into result dicts (port of
``litehandnet_tpu/eval/decoder.py``).

Reference surface: utils/post_processing/decoder.py:9-107. The numeric work
(argmax, DARK/UDP refinement, unwarp) runs on the decoder's device through
``ops.decode``; only the final dict assembly is on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.ops.decode import (
    keypoints_from_heatmaps,
    keypoints_from_simdr,
)


def decode_settings(cfg) -> dict:
    """``keypoints_from_heatmaps`` keywords from ``cfg.PIPELINE``."""
    pipeline = cfg.get("PIPELINE", {})
    kernel = pipeline.get("kernel", (11, 11))
    return dict(
        post_process=(
            "unbiased" if pipeline.get("unbiased_encoding", False)
            else "default"
        ),
        kernel=int(kernel[0] if isinstance(kernel, (list, tuple)) else kernel),
        use_udp=bool(pipeline.get("use_udp", False)),
    )


def _boxes(center: np.ndarray, scale: np.ndarray, meta) -> np.ndarray:
    N = center.shape[0]
    boxes = np.zeros((N, 6), np.float32)
    boxes[:, 0:2] = center
    boxes[:, 2:4] = scale
    boxes[:, 4] = np.prod(scale * 200.0, axis=1)
    boxes[:, 5] = np.asarray(meta.get("bbox_score", np.ones(N)))
    return boxes


class TopDownDecoder:
    def __init__(self, cfg, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.settings = decode_settings(cfg)
        self.simdr_split_ratio = cfg.get("PIPELINE", {}).get(
            "simdr_split_ratio", 0)

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def decode(self, meta, outputs):
        """Decode heatmap outputs.

        Args:
            meta: dict with 'center' [N, 2], 'scale' [N, 2], and optionally
                'image_file', 'bbox_id', 'bbox_score'.
            outputs: [N, H, W, K] heatmaps (channels-last), a tensor or a
                numpy array.

        Returns:
            dict(preds [N, K, 3], hm_preds [N, K, 2], boxes [N, 6],
                 image_paths, bbox_ids, output_heatmap), numpy on the host.
        """
        center = np.asarray(meta["center"], np.float32)
        scale = np.asarray(meta["scale"], np.float32)
        hm = self._tensor(outputs)
        hm_preds, preds, maxvals = keypoints_from_heatmaps(
            hm, self._tensor(center), self._tensor(scale), **self.settings)
        preds = torch.cat([preds, maxvals], dim=-1).cpu().numpy()
        N = preds.shape[0]
        return {
            "preds": preds,
            "hm_preds": hm_preds.cpu().numpy(),
            "boxes": _boxes(center, scale, meta),
            "image_paths": list(meta.get("image_file", [""] * N)),
            "bbox_ids": list(np.asarray(meta.get("bbox_id", np.arange(N)))),
            "output_heatmap": hm.cpu().numpy(),
        }

    def decode_simdr(self, meta, pred_x, pred_y):
        """Decode SimDR 1-D vectors (reference decoder.py:73-107)."""
        center = np.asarray(meta["center"], np.float32)
        scale = np.asarray(meta["scale"], np.float32)
        preds = keypoints_from_simdr(
            self._tensor(pred_x), self._tensor(pred_y), self._tensor(center),
            self._tensor(scale), split_ratio=int(self.simdr_split_ratio),
        ).cpu().numpy()
        N = preds.shape[0]
        return {
            "preds": preds,
            "boxes": _boxes(center, scale, meta),
            "image_paths": list(meta.get("image_file", [""] * N)),
            "bbox_ids": list(np.asarray(meta.get("bbox_id", np.arange(N)))),
        }
