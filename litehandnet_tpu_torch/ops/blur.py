"""cv2-compatible Gaussian blur as a separable sum of shifted slices (port of
``litehandnet_tpu/ops/blur.py``).

DARK decoding modulates heatmaps with ``cv2.GaussianBlur(ksize, sigmaX=0)``:

* sigma for ``sigmaX=0`` is ``0.3*((ksize-1)*0.5 - 1) + 0.8`` (OpenCV rule);
* ksize in {1, 3, 5, 7} uses OpenCV's fixed binomial tables;
* the classic DARK path zero-pads by (ksize-1)//2, blurs, then rescales each
  map so its max matches the pre-blur max;
* the UDP path uses OpenCV's default BORDER_REFLECT_101 padding.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

# OpenCV small_gaussian_tab (fixed kernels used when sigma <= 0).
_SMALL_GAUSSIAN_TAB = {
    1: np.array([1.0], np.float32),
    3: np.array([0.25, 0.5, 0.25], np.float32),
    5: np.array([0.0625, 0.25, 0.375, 0.25, 0.0625], np.float32),
    7: np.array(
        [0.03125, 0.109375, 0.21875, 0.28125, 0.21875, 0.109375, 0.03125],
        np.float32,
    ),
}


@functools.lru_cache(maxsize=None)
def cv2_gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    """1-D Gaussian kernel matching ``cv2.getGaussianKernel(ksize, sigma)``.

    The cached array is shared between callers: do not write to it.
    """
    if ksize % 2 != 1:
        raise ValueError(f"kernel size must be odd, got {ksize}")
    if sigma <= 0 and ksize in _SMALL_GAUSSIAN_TAB:
        return _SMALL_GAUSSIAN_TAB[ksize]
    if sigma <= 0:
        sigma = 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) * 0.5
    k = np.exp(-(x**2) / (2.0 * sigma**2))
    return (k / k.sum()).astype(np.float32)


def separable_blur(maps: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Valid-mode separable blur of padded maps ``[N, H, W]``: a horizontal
    then a vertical pass, each a sum of shifted slices with the taps in
    ascending order (``csrc/blur_log.cu``'s order).

    Each step is one rounded multiply and one rounded add, so the result has
    the same bits in every process, whatever conv backend torch would pick,
    and is exactly 0 where every tap reads a 0.
    """
    k = len(taps)
    w = maps.shape[2] - k + 1
    h = maps[:, :, 0:w] * float(taps[0])
    for t in range(1, k):
        h = h + maps[:, :, t:t + w] * float(taps[t])
    n = maps.shape[1] - k + 1
    out = h[:, 0:n] * float(taps[0])
    for t in range(1, k):
        out = out + h[:, t:t + n] * float(taps[t])
    return out


def gaussian_blur(
    heatmaps: torch.Tensor,
    kernel: int = 11,
    border: str = "constant",
    preserve_max: bool = False,
) -> torch.Tensor:
    """Blur heatmaps ``[B, H, W, K]`` with a cv2-compatible Gaussian.

    Args:
        heatmaps: [B, H, W, K].
        kernel: odd Gaussian kernel size (sigma from the OpenCV rule).
        border: 'constant' (zero pad, classic DARK) or 'reflect'
            (BORDER_REFLECT_101, UDP DARK).
        preserve_max: rescale each (B, K) map to its pre-blur max.
    """
    if kernel == 1:
        return heatmaps
    B, H, W, K = heatmaps.shape
    pad = (kernel - 1) // 2
    maps = heatmaps.permute(0, 3, 1, 2).reshape(B * K, H, W)
    mode = "reflect" if border == "reflect" else "constant"
    padded = F.pad(maps[:, None], (pad, pad, pad, pad), mode=mode)[:, 0]
    blurred = separable_blur(padded, cv2_gaussian_kernel(kernel, 0.0))
    if preserve_max:
        orig_max = maps.amax(dim=(1, 2), keepdim=True)
        new_max = blurred.amax(dim=(1, 2), keepdim=True)
        blurred = blurred * (orig_max / torch.clamp(new_max, min=1e-20))
    return blurred.reshape(B, K, H, W).permute(0, 2, 3, 1)
