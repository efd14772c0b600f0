"""ResultParser: multi-hand center-map decoding with cycle detection (port of
``litehandnet_tpu/eval/result_parser.py``; reference
utils/result_parser.py:14-399).

Center map -> candidate boxes -> NMS -> per-box keypoints inside a 1.3x
window -> cycle detection (small or overlapping hands are cropped from the
input, re-inferred at a reduced size and decoded again) -> multi-hand PCK by
center matching.

Box decode and NMS are one fixed-size batched program on the parser's device
(``ops.detect``). The per-box keypoints mask the full map outside each box
and decode all B x M masked maps in one batch, so each of the two DARK
refinements (the candidate centers and the keypoints) is one ``blur_log``
launch at ``pcfg.dark_kernel`` = 19 taps (its general path). The cycle
detection and the metrics are host numpy, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import pcfg
from litehandnet_tpu_torch.eval.ap import count_ap
from litehandnet_tpu_torch.ops.decode import (
    argmax_coords,
    refine_dark,
    refine_offset_gen1,
)
from litehandnet_tpu_torch.ops.detect import (
    bbox_iou,
    candidate_bboxes,
    heatmap_nms,
    masked_nms,
    vector_nms,
)


def to_numpy(a) -> np.ndarray:
    """A tensor on any device, or an array, as numpy."""
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def _masked_keypoints(heatmaps: torch.Tensor, boxes: torch.Tensor,
                      bbox_factor: float, feature_stride: float,
                      use_dark: bool = True, kernel: int = 19) -> torch.Tensor:
    """Keypoints per box: the map masked outside the padded box, decoded
    (the batched reference _get_first_result, result_parser.py:296-320).

    Args:
        heatmaps: ``[B, H, W, K]``.
        boxes: ``[B, M, 5]`` (cx, cy, w, h, conf) in input pixels.

    Returns:
        ``[B, M, K, 3]`` (x, y, score) in input pixels; 0 for a box of
        confidence 0. A box whose window holds no cell decodes the whole
        map.
    """
    B, H, W, K = heatmaps.shape
    M = boxes.shape[1]
    xs = torch.arange(W, dtype=torch.float32, device=heatmaps.device)
    ys = torch.arange(H, dtype=torch.float32, device=heatmaps.device)[:, None]
    cx, cy, w, h, conf = (c[..., None, None] for c in boxes.unbind(-1))
    w = w * bbox_factor / feature_stride
    h = h * bbox_factor / feature_stride
    cx = cx / feature_stride
    cy = cy / feature_stride
    mask = ((xs >= cx - w / 2) & (xs <= cx + w / 2)
            & (ys >= cy - h / 2) & (ys <= cy + h / 2))        # [B, M, H, W]
    mask = mask | ~mask.any(dim=(2, 3), keepdim=True)
    masked = (heatmaps[:, None] * mask[..., None]).reshape(B * M, H, W, K)
    preds, maxvals = argmax_coords(masked)
    if use_dark:
        # reference get_pred_kpt -> adjust_keypoints_by_DARK with
        # pcfg['blue_kernel'] = 19 (heatmap_post_processing.py:35-54)
        preds = refine_dark(masked, preds, kernel=kernel)
    else:
        preds = refine_offset_gen1(masked, preds)
    kpt = torch.cat([preds * feature_stride, maxvals], dim=-1)
    return kpt.reshape(B, M, K, 3) * (conf[..., 0] > 0)[..., None]


class ResultParser:
    """Decode multi-hand results from heatmaps and region maps (+ SimDR).

    Args:
        cfg: experiment config (``DATASET.image_size``, ``heatmap_size``,
            ``PIPELINE.unbiased_encoding``, ``simdr_split_ratio``).
        model_fn: optional ``model_fn(crops [N, h, w, 3]) -> heatmaps
            [N, h', w', K]`` for the cycle-detection re-inference.
        device: where the decode runs.

    The other arguments override ``pcfg``'s values.

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """

    def __init__(self, cfg, model_fn: Optional[Callable] = None,
                 num_candidates: Optional[int] = None,
                 max_num_bbox: Optional[int] = None,
                 cd_iou: Optional[float] = None,
                 cd_ratio: Optional[float] = None,
                 cd_enabled: bool = True, cd_reduction: int = 2,
                 device="cuda"):
        self.device = resolve_device(device)
        self.image_size = tuple(int(v) for v in cfg.DATASET.image_size)
        hm = cfg.DATASET.heatmap_size
        if hm and isinstance(hm[0], (list, tuple)):
            hm = hm[-1]  # multi-scale (SRHandNet): parse at the finest scale
        self.heatmap_size = tuple(int(v) for v in hm)
        self.feature_stride = self.image_size[0] / self.heatmap_size[0]

        def pick(value, default):
            return default if value is None else value

        self.num_candidates = int(pick(num_candidates, pcfg.num_candidates))
        self.max_num_bbox = int(pick(max_num_bbox, pcfg.max_num_bbox))
        self.cd_iou = float(pick(cd_iou, pcfg.cycle_detection_diou))
        self.cd_ratio = float(pick(cd_ratio, pcfg.cycle_detection_area_ratio))
        self.detection_threshold = float(pcfg.detection_threshold)
        self.iou_threshold = float(pcfg.iou_threshold)
        self.bbox_factor = float(pcfg.bbox_factor)
        self.kernel = int(pcfg.dark_kernel)
        pipeline = cfg.get("PIPELINE", {})
        self.use_dark = bool(pipeline.get("unbiased_encoding", True))
        self.simdr_split_ratio = int(pipeline.get("simdr_split_ratio", 0) or 0)
        self.model_fn = model_fn
        self.cd_enabled = cd_enabled and model_fn is not None
        self.cd_reduction = cd_reduction
        self.image_area = self.image_size[0] * self.image_size[1]

    def _tensor(self, a) -> torch.Tensor:
        return torch.as_tensor(a, dtype=torch.float32, device=self.device)

    def _keypoints(self, heatmaps, boxes) -> np.ndarray:
        return to_numpy(_masked_keypoints(
            self._tensor(heatmaps), self._tensor(boxes), self.bbox_factor,
            self.feature_stride, self.use_dark, self.kernel))

    # -- box decoding -----------------------------------------------------
    def get_pred_bbox(self, region_maps) -> np.ndarray:
        """Region maps ``[B, H, W, 3]`` (center, w, h) -> padded boxes
        ``[B, max_num_bbox, 5]`` (cx, cy, w, h, conf), input pixels."""
        region_maps = self._tensor(region_maps)
        center = heatmap_nms(region_maps[..., :1], int(pcfg.nms_kernel))
        cands = candidate_bboxes(
            center, region_maps[..., 1:3], self.num_candidates,
            self.feature_stride, wh_scale=self.image_size,
            # centers refine as keypoints do (result_parser.py:158-163)
            refine="dark" if self.use_dark else "offset", kernel=self.kernel)
        return to_numpy(masked_nms(cands, self.iou_threshold,
                                   self.detection_threshold,
                                   self.max_num_bbox))

    # -- keypoints --------------------------------------------------------
    def get_group_keypoints(self, images, heatmaps, boxes) -> np.ndarray:
        """Per-box keypoints with cycle detection (reference
        result_parser.py:251-348).

        Args:
            images: ``[B, H_img, W_img, 3]`` normalized inputs (read only
                for the re-crops).
            heatmaps: ``[B, H, W, K]`` keypoint maps.
            boxes: ``[B, M, 5]`` from ``get_pred_bbox``.

        Returns:
            ``[B, M, K, 3]`` keypoints in input pixels.
        """
        kpts = self._keypoints(heatmaps, boxes)
        if not self.cd_enabled:
            return kpts
        boxes = to_numpy(boxes)
        B, M = boxes.shape[:2]
        flagged = []
        for b in range(B):
            valid = boxes[b][boxes[b][:, 4] > 0]
            for m in range(M):
                if boxes[b, m, 4] > 0 and self._is_cycle_detection(
                        boxes[b, m], valid):
                    flagged.append((b, m))
        if not flagged:
            return kpts
        W_img, H_img = self.image_size
        size = (H_img // self.cd_reduction, W_img // self.cd_reduction)
        images = to_numpy(images)
        crops, metas = [], []
        for b, m in flagged:
            cx, cy, w, h = boxes[b, m, :4]
            w2, h2 = w * self.bbox_factor, h * self.bbox_factor
            x1 = max(0, int(cx - w2 / 2 + 0.5))
            y1 = max(0, int(cy - h2 / 2 + 0.5))
            x2 = min(W_img, int(cx + w2 / 2 + 0.5))
            y2 = min(H_img, int(cy + h2 / 2 + 0.5))
            if x2 <= x1 or y2 <= y1:
                continue
            crops.append(_resize_nearest_np(images[b, y1:y2, x1:x2], size))
            metas.append((b, m, x1, y1, x2 - x1, y2 - y1))
        if not crops:
            return kpts
        hm = self.model_fn(np.stack(crops))
        whole = np.tile(np.array([[0, 0, 1e6, 1e6, 1.0]], np.float32),
                        (len(metas), 1))[:, None, :]
        kpt2 = self._keypoints(hm, whole)[:, 0]  # [N, K, 3]
        for i, (b, m, x1, y1, w, h) in enumerate(metas):
            k = kpt2[i].copy()
            k[:, 0] = k[:, 0] * (w / size[1]) + x1
            k[:, 1] = k[:, 1] * (h / size[0]) + y1
            kpts[b, m] = k
        return kpts

    def _is_cycle_detection(self, box, boxes, iou_thr=None, ratio=None):
        """Reference result_parser.py:276-294: a small box, or one that
        overlaps another (DIoU) above the threshold."""
        iou_thr = self.cd_iou if iou_thr is None else iou_thr
        ratio = self.cd_ratio if ratio is None else ratio
        area = box[2] * box[3]
        if area != 0 and area / self.image_area <= ratio:
            return True
        ious = bbox_iou(torch.from_numpy(np.array(box[:4])),
                        torch.from_numpy(np.array(boxes[:, :4])), diou=True)
        return int((ious > iou_thr).sum()) > 1

    # -- SimDR ------------------------------------------------------------
    def get_kpts_from_vectors(self, x_vectors, y_vectors, boxes) -> np.ndarray:
        """SimDR vector decode inside box windows (reference
        result_parser.py:93-129).

        Args:
            x_vectors: ``[B, K, W*k]``; y_vectors: ``[B, K, H*k]``.
            boxes: ``[B, M, 5]`` boxes in input pixels.

        Returns:
            ``[B, M, K, 3]``.
        """
        k = max(self.simdr_split_ratio, 1)
        xv = to_numpy(vector_nms(self._tensor(x_vectors)))
        yv = to_numpy(vector_nms(self._tensor(y_vectors)))
        B, K, Wv = xv.shape
        Hv = yv.shape[-1]
        boxes = to_numpy(boxes)
        M = boxes.shape[1]
        out = np.zeros((B, M, K, 3), np.float32)
        xs, ys = np.arange(Wv), np.arange(Hv)
        for b in range(B):
            for m in range(M):
                if boxes[b, m, 4] <= 0:
                    continue
                box = boxes[b, m] * k
                x1 = max(int(box[0] - box[2] / 2), 0)
                x2 = min(int(box[0] + box[2] / 2), Wv)
                y1 = max(int(box[1] - box[3] / 2), 0)
                y2 = min(int(box[1] + box[3] / 2), Hv)
                sxv = xv[b] * ((xs >= x1) & (xs < x2))
                syv = yv[b] * ((ys >= y1) & (ys < y2))
                xi, yi = sxv.argmax(axis=1), syv.argmax(axis=1)
                out[b, m, :, 0] = xi / k
                out[b, m, :, 1] = yi / k
                out[b, m, :, 2] = (sxv[np.arange(K), xi]
                                   + syv[np.arange(K), yi]) / 2.0
        return out

    # -- metrics ----------------------------------------------------------
    @staticmethod
    def evaluate_ap(pred_bboxes, gt_bboxes, iou_thr=None):
        return count_ap(pred_bboxes, gt_bboxes, iou_thr)

    def evaluate_pck(self, pred_kpts, gt_kpts, gt_bboxes, thr=0.2):
        """Multi-hand PCK by center matching (reference
        result_parser.py:356-399).

        Args:
            pred_kpts: ``[B, M, K, 3]`` (x, y, score).
            gt_kpts: ``[B, M, K, 3]`` (x, y, vis).
            gt_bboxes: ``[B, N, 4]`` (cx, cy, w, h).
        """
        pred_kpts, gt_kpts, gt_bboxes = map(to_numpy, (pred_kpts, gt_kpts,
                                                       gt_bboxes))
        pcks = []
        for pk, gk, boxes in zip(pred_kpts, gt_kpts, gt_bboxes):
            live = (pk[:, :, 2] > 0).sum(axis=1) > 0
            for pred in pk[live]:
                vis_mask = pred[:, 2] > 0
                if vis_mask.sum() == 0:
                    continue
                # the reference's quirk, kept: the center sums ALL joints'
                # coordinates but divides by the VISIBLE count
                # (result_parser.py:372)
                center = pred[:, :2].sum(axis=0) / vis_mask.sum()
                j = int(np.argmin(((boxes[:, :2] - center) ** 2).sum(axis=1)))
                gt = gk[j]
                gt_vis = gt[:, 2] > 0
                if gt_vis.sum() == 0:
                    continue
                norm = np.max(boxes[j, :2])
                dist = np.linalg.norm(gt[gt_vis, :2] - pred[gt_vis, :2], axis=1)
                pcks.append(float((dist / norm < thr).mean()))
        return float(np.mean(pcks)) if pcks else 0.0


def _resize_nearest_np(img: np.ndarray, size) -> np.ndarray:
    h, w = size
    H, W = img.shape[:2]
    yi = (np.arange(h) * H // h).clip(0, H - 1)
    xi = (np.arange(w) * W // w).clip(0, W - 1)
    return img[yi][:, xi]
