"""SRHandNet's two-stage multi-hand inference on full frames (port of
``litehandnet_tpu/eval/srhandnet_pyramid.py``; reference
models/pose_estimation/SRHandNet/official_code.py:28-213).

Stage 1 (``detect_bbox``): the frame is resized into the net input keeping
its aspect (top-left aligned, zero pad) and run once; the last three
channels of the finest output are the region map; peaks of its center
channel (5x5 max-pool NMS above a threshold) give up to ``max_hands``
candidates, sized by the 5x5 mean of the w/h ratio channels around each
peak and mapped back to frame coordinates.
Stage 2 (``detect_hands``): every candidate box is cropped from the frame by
a bilinear gather under its own affine (the reference's cv2 crop and resize,
batched), one forward over all of them; each keypoint channel's peak above
``hand_thr`` maps back to the frame. Hands with more than 5 keypoints
missing are dropped (official_code.py:149-157).

Everything is a fixed-size batched program on the device; the outputs are
padded arrays with masks. No kernel of the port runs here.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.ops.detect import top_k


def _nms_peaks(hm: torch.Tensor, k: int, threshold: float):
    """Top-k local maxima of each map ``[..., H, W]`` (5x5 max-pool NMS,
    skimage ``peak_local_max(min_distance=2)``, official_code.py:52): a peak
    is its window's maximum, strictly above ``threshold`` and at least two
    cells from the border. Returns (values, ys, xs), each ``[..., k]``;
    missing peaks have value -inf."""
    lead, (H, W) = hm.shape[:-2], hm.shape[-2:]
    flat = hm.reshape(-1, 1, H, W)
    pooled = F.max_pool2d(flat, 5, 1, 2)
    border = torch.zeros(H, W, dtype=torch.bool, device=hm.device)
    border[2:-2, 2:-2] = True
    keep = (flat >= pooled) & (flat > threshold) & border
    scores = torch.where(keep, flat, torch.full_like(flat, -float("inf")))
    vals, idx = top_k(scores.reshape(*lead, H * W), k)
    return vals, idx // W, idx % W


def _resize_into(frame: torch.Tensor, rects: torch.Tensor,
                 out_hw: Tuple[int, int]):
    """Aspect-preserving, top-left aligned resizes of frame regions into a
    fixed canvas by a bilinear gather (the reference's transform_net_input:
    ratio = min(H / h, W / w), zero beyond the region).

    Args:
        frame: ``[H0, W0, 3]`` float32.
        rects: ``[N, 4]`` (x0, y0, w, h) float32.

    Returns:
        (canvases ``[N, H, W, 3]``, ratios ``[N]``)
    """
    H, W = out_hw
    H0, W0 = frame.shape[:2]
    x0, y0, w, h = rects.unbind(-1)
    ratio = torch.minimum(H / h.clamp(min=1e-6), W / w.clamp(min=1e-6))
    dev = frame.device
    ys = torch.arange(H, dtype=torch.float32, device=dev) / ratio[:, None] + y0[:, None]
    xs = torch.arange(W, dtype=torch.float32, device=dev) / ratio[:, None] + x0[:, None]
    yf = ys.clamp(0.0, H0 - 1.0)
    xf = xs.clamp(0.0, W0 - 1.0)
    yi0 = torch.floor(yf).long()
    xi0 = torch.floor(xf).long()
    yi1 = (yi0 + 1).clamp(max=H0 - 1)
    xi1 = (xi0 + 1).clamp(max=W0 - 1)
    dy = (yf - yi0)[:, :, None, None]
    dx = (xf - xi0)[:, None, :, None]

    def tap(yi, xi):
        return frame[yi[:, :, None], xi[:, None, :]]   # [N, H, W, 3]

    top = tap(yi0, xi0) * (1 - dx) + tap(yi0, xi1) * dx
    bot = tap(yi1, xi0) * (1 - dx) + tap(yi1, xi1) * dx
    out = top * (1 - dy) + bot * dy
    valid_y = (ys < (y0 + h)[:, None]) & (ys < H0)
    valid_x = (xs < (x0 + w)[:, None]) & (xs < W0)
    out = out * valid_y[:, :, None, None] * valid_x[:, None, :, None]
    return out, ratio


class SRHandNetPyramid:
    """Two-stage multi-hand inference.

    Args:
        model: the SRHandNet module (its eval-mode forward: NCHW images ->
            a tuple of 4 scales of K + 3 maps, the finest last), or any
            callable of that contract.
        input_hw: net input (H, W); the reference trains at 256x256.
        max_hands: candidates per frame.
        det_thr: center-peak threshold (reference LABEL_MIN).
        hand_thr: keypoint-peak threshold (reference LABEL_HAND_MIN).
        device: where it runs.

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """

    def __init__(self, model, input_hw=(256, 256), max_hands=4, det_thr=0.25,
                 hand_thr=0.2, num_joints=21, device="cuda"):
        self.device = resolve_device(device)
        self.model = model
        self.input_hw = tuple(input_hw)
        self.max_hands = int(max_hands)
        self.det_thr = float(det_thr)
        self.hand_thr = float(hand_thr)
        self.K = int(num_joints)

    def _forward(self, img: torch.Tensor) -> torch.Tensor:
        """``[N, H, W, 3]`` -> the finest output ``[N, h, w, C]``."""
        out = self.model(img.permute(0, 3, 1, 2))
        out = out[-1] if isinstance(out, (tuple, list)) else out
        return out.float().permute(0, 2, 3, 1)

    def _frame(self, frame_u8) -> torch.Tensor:
        frame = torch.from_numpy(np.array(frame_u8)).to(self.device)
        return frame.float() / 255.0 - 0.5

    # stage 1 -------------------------------------------------------------
    def detect_bbox(self, frame: torch.Tensor):
        """(rects ``[max_hands, 4]`` (x, y, w, h) in frame coords, valid
        ``[max_hands]``, peak values)."""
        H, W = self.input_hw
        H0, W0 = frame.shape[:2]
        whole = torch.tensor([[0.0, 0.0, W0, H0]], device=frame.device)
        net_in, ratio_in = _resize_into(frame, whole, (H, W))
        hm = self._forward(net_in)[0]                  # [h, w, K + 3]
        hh, ww = hm.shape[:2]
        ratio_down = H / hh
        vals, ys, xs = _nms_peaks(hm[..., self.K], self.max_hands, self.det_thr)

        # 5x5 window means of the w/h ratio channels, over the cells inside
        # the map (official_code.py:93-101)
        off = torch.arange(5, device=frame.device)
        wy = (ys[:, None] + off - 2)[:, :, None]
        wx = (xs[:, None] + off - 2)[:, None, :]
        inside = (wy >= 0) & (wy < hh) & (wx >= 0) & (wx < ww)
        cy_, cx_ = wy.clamp(0, hh - 1), wx.clamp(0, ww - 1)

        def mean5(m):
            win = torch.where(inside, m[cy_, cx_], torch.zeros_like(m[cy_, cx_]))
            return win.sum((1, 2)) / inside.sum((1, 2)).clamp(min=1).float()

        rw = mean5(hm[..., self.K + 1]).clamp(0.0, 1.0)
        rh = mean5(hm[..., self.K + 2]).clamp(0.0, 1.0)
        ratio = ratio_down / ratio_in
        cy = ys.float() * ratio
        cx = xs.float() * ratio
        rect_w = rw * W / ratio_in
        rect_h = rh * H / ratio_in
        left = (cx - rect_w / 2.0).clamp(0.0, W0 - 1.0)
        top = (cy - rect_h / 2.0).clamp(0.0, H0 - 1.0)
        right = (cx + rect_w / 2.0).clamp(0.0, W0 - 1.0)
        bottom = (cy + rect_h / 2.0).clamp(0.0, H0 - 1.0)
        rects = torch.stack([left, top, right - left, bottom - top], dim=1)
        valid = (torch.isfinite(vals) & (vals >= self.det_thr)
                 & (rects[:, 2] > 1) & (rects[:, 3] > 1))
        return rects, valid, vals

    # stage 2 -------------------------------------------------------------
    def detect_hands(self, frame: torch.Tensor, rects: torch.Tensor):
        """(keypoints ``[N, K, 2]`` in frame coords, found ``[N, K]``)."""
        H, W = self.input_hw
        crops, ratios = _resize_into(frame, rects, (H, W))
        hms = self._forward(crops)[..., :self.K]       # [N, h, w, K]
        ratio_down = H / hms.shape[1]
        vals, ys, xs = _nms_peaks(hms.permute(0, 3, 1, 2), 1, self.hand_thr)
        scale = (ratio_down / ratios)[:, None]
        x = xs[..., 0].float() * scale + rects[:, :1]
        y = ys[..., 0].float() * scale + rects[:, 1:2]
        scores = vals[..., 0]
        found = torch.isfinite(scores) & (scores >= self.hand_thr)
        return torch.stack([x, y], dim=-1), found

    @torch.no_grad()
    def __call__(self, frame_u8):
        """Both stages on one frame ``[H0, W0, 3]`` uint8.

        Returns numpy: keypoints ``[max_hands, K, 2]`` (x, y in frame
        coords), kpt_found ``[max_hands, K]``, rects ``[max_hands, 4]``
        (x, y, w, h), hand_valid ``[max_hands]`` (detected, and at most 5
        keypoints missing, official_code.py:149-157).
        """
        frame = self._frame(frame_u8)
        rects, valid, _ = self.detect_bbox(frame)
        coords, found = self.detect_hands(frame, rects)
        found = found & valid[:, None]
        hand_valid = valid & ((~found).sum(dim=1) <= 5)
        return tuple(t.cpu().numpy() for t in (coords, found, rects,
                                               hand_valid))
