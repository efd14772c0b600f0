"""Bytes and operations of ``blur_log`` (DARK's blur, max-preserving
rescale and log) over maps ``[B, H, W, K]`` with an 11-tap Gaussian.

Bytes: every input element read once and every output element written
once. Operations, per element: 11 multiply-adds in each of the two passes
(44), the rescale's multiply and the log (counted as 1 each), and the two
comparisons of the maxima: 48.
"""

import math

TAPS = 11


def bytes_moved(shape, dtype_bytes: int = 4) -> int:
    return 2 * math.prod(shape) * dtype_bytes


def operations(shape) -> int:
    return (4 * TAPS + 4) * math.prod(shape)
