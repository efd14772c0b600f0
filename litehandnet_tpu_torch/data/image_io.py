"""Image decode into a fixed canvas (the host side of JAX
``litehandnet_tpu/data/loader.py``: ``_load_image``, ``_decode_image``,
``_resize_u8``).

numpy with cv2 or PIL only: the decode worker processes of
``data/mp_decode.py`` import this module, and a worker must not import
torch, let alone start CUDA.
"""

from __future__ import annotations

import numpy as np


def _load_image(path: str, canvas_hw, center=None, scale=None, margin=1.1):
    """Decode an image into a zero-padded uint8 canvas [H0, W0, 3] (RGB).

    Sources larger than the canvas keep their ROI (reference semantics:
    full-image decode, datasets/loading.py:6-89): first a window around the
    bbox, sized to cover the crop box under maximum scale jitter and any
    rotation (half-diagonal bound), is sliced out; if that window still
    exceeds the canvas it is downscaled to fit (bilinear).

    Returns:
        (canvas, offset_xy, scale_xy): source-image coords map to canvas
        coords as ``(p - offset_xy) * scale_xy``.
    """
    H0, W0 = canvas_hw
    canvas = np.zeros((H0, W0, 3), np.uint8)
    offset = np.zeros(2, np.float32)
    fscale = np.ones(2, np.float32)
    arr = _decode_image(path)
    if arr is None:
        return canvas, offset, fscale
    h, w = arr.shape[:2]
    if (h > H0 or w > W0) and center is not None and scale is not None:
        wx, wy = np.asarray(scale, np.float32) * 200.0 * float(margin)
        half = float(np.hypot(wx, wy)) / 2.0 + 4.0
        x0 = max(int(np.floor(center[0] - half)), 0)
        y0 = max(int(np.floor(center[1] - half)), 0)
        x1 = min(int(np.ceil(center[0] + half)), w)
        y1 = min(int(np.ceil(center[1] + half)), h)
        if x1 > x0 and y1 > y0:
            arr = arr[y0:y1, x0:x1]
            offset = np.float32([x0, y0])
            h, w = arr.shape[:2]
    if h > H0 or w > W0:
        f = min(H0 / h, W0 / w)
        nw, nh = max(int(w * f), 1), max(int(h * f), 1)
        arr = _resize_u8(arr, nw, nh)
        fscale = np.float32([nw / w, nh / h])
        h, w = nh, nw
    canvas[:h, :w] = arr
    return canvas, offset, fscale


def _decode_image(path: str):
    """Decode RGB uint8 in stored-pixel orientation (the reference decodes
    with cv2.imdecode, which ignores the EXIF Orientation tag, and its
    annotations are in stored-pixel space); cv2 when available, PIL
    otherwise. None for a missing or unreadable file."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_COLOR | cv2.IMREAD_IGNORE_ORIENTATION)
        return None if img is None else cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    from PIL import Image

    try:
        with Image.open(path) as im:
            return np.asarray(im.convert("RGB"), np.uint8)
    except (FileNotFoundError, OSError):
        return None


def _resize_u8(arr, nw: int, nh: int):
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        return cv2.resize(arr, (nw, nh), interpolation=cv2.INTER_LINEAR)
    from PIL import Image

    return np.asarray(Image.fromarray(arr).resize((nw, nh), Image.BILINEAR),
                      np.uint8)
