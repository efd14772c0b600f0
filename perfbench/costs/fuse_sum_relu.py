"""Bytes and operations of ``fuse_sum_relu`` (one row of Lite-HRNet's
cross-resolution fuse: ``relu(((2 t_0 + up(t_1)) + ...) + up(t_{n-1}))``)
for a launch as the wrapper's ``shapes`` counter keys it: ``((N, C, H, W,
the outputs' item size), ((C, H_j, W_j, item size) of each term), whether
the pre-ReLU sum is written)``.

Bytes: every term read once at its own resolution and item size, the ReLU's
output written once and the sum once more where it is written. Operations
per output element: the doubling, one add per further term and the ReLU,
n + 1. The item sizes are in the shape, so ``dtype_bytes`` is not read.
"""


def bytes_moved(shape, dtype_bytes=None) -> int:
    (N, C, H, W, out_size), terms, write_sum = shape
    read = sum(N * c * h * w * size for c, h, w, size in terms)
    return read + N * C * H * W * out_size * (2 if write_sum else 1)


def operations(shape) -> int:
    (N, C, H, W, _), terms, _ = shape
    return (len(terms) + 1) * N * C * H * W
