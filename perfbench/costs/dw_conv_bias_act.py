"""Bytes and operations of ``dw_conv_bias_act`` (a "same" stride-1
depthwise convolution with its bias and activation) for x ``[N, C, H, W]``
and taps ``[C, 1, k, k]``, the shape given as ``(N, C, H, W, k,
dilation)``.

Bytes: every element of x read once and of y written once in the
activations' dtype, the float32 taps and bias read once. Operations, per
output element: a multiply and an add for each of the k^2 taps, the bias
add and the activation (counted as 1): 2 k^2 + 2.
"""

import math


def bytes_moved(shape, dtype_bytes: int = 2) -> int:
    N, C, H, W, k, _ = shape
    return 2 * N * C * H * W * dtype_bytes + C * (k * k + 1) * 4


def operations(shape) -> int:
    k = shape[4]
    return (2 * k * k + 2) * math.prod(shape[:4])
