"""Bytes and operations of ``moments`` (BatchNorm's per-channel mean and
biased variance) over ``[N, C, H, W]``.

Bytes: the input read once, and the two float32 statistics of each channel
written. Operations: the two-pass statistics take an add for the mean and a
subtract, multiply and add for the variance of each element: 4.
"""

import math


def bytes_moved(shape, dtype_bytes: int = 4) -> int:
    return math.prod(shape) * dtype_bytes + 2 * shape[1] * 4


def operations(shape) -> int:
    return 4 * math.prod(shape)
