"""Depthwise "same" convolution with its bias and activation in the
epilogue.

Replaces no TPU kernel: the JAX package's deploy graph leaves its depthwise
convolutions to XLA. The hand-written CUDA C++ kernel
``csrc/dw_conv_bias_act.cu`` for Hopper (``sm_90a``), built with ``nvcc`` at
first use and bound through ctypes, was added because cuDNN's grouped direct
kernel runs the deploy graph's depthwise convolutions at about 10% of their
memory bound on the H100, and PyTorch adds a convolution's bias and its
activation afterwards as two more passes over the output.

For ``x`` ``[N, C, H, W]`` (bfloat16 or float32) with its channels innermost
(channels_last memory), taps ``[C, 1, k, k]`` with k in (3, 5, 7), dilation
d in 1..4 and a bias ``[C]`` it gives, in x's dtype and channels_last,

    act(F.conv2d(x, w, b, padding=d * (k // 2), dilation=d, groups=C))

with ``act`` none, ``"relu"`` or ``"leaky_relu"`` (of ``slope``). Taps, bias
and sums are float32, rounded once at the store: one rounding fewer than
cuDNN under autocast, which rounds the convolution and then the bias sum.

Bound: memory for k = 3 (each element of x read once and of y written once:
the 16 depthwise 3 x 3 convolutions of a LiteHandNet batch of 128 move 1.17
GB in bfloat16, 0.35 ms at 3.35 TB/s), the FP32 pipes for k = 7 in bfloat16
(2 k^2 + 2 operations per output: the stem's ``[128, 32, 128, 128]`` takes
0.100 ms at 67 TFLOP/s, its bytes 0.080 ms). ``plan`` cuts the output into
16 d x 32 tiles of one channel group (64 bytes of a pixel for k = 3, 32 for
k = 5 and 7), one block per SM walking the tiles, each tile and its halo
brought into shared memory by ``cp.async`` into a ring of up to three
buffers; a thread keeps 8 (k = 3) or 16 output rows of its channels in
registers, so each input row loaded is reused k times. The plan declines
(None) what the kernel does not tile: another k or dilation, C not a
multiple of 8, channels not innermost, unaligned memory, a halo that does
not fit shared memory.

``dw_conv_bias_act`` launches the kernel for a CUDA tensor (and raises where
``plan`` declines) and uses the plain version, ``dw_conv_bias_act_reference``,
only for a CPU tensor. It counts launches in ``dw_conv_bias_act.launches``
and their shapes ``(N, C, H, W, k, dilation, itemsize)`` in
``dw_conv_bias_act.shapes``. The launch synchronises nothing and allocates
only the output, on the current stream. The deploy graph's ``RepConv`` and
``RepBlock`` route to it (``models.layers.dw_kernel_route``).
"""

from __future__ import annotations

import collections
import ctypes
from typing import Dict, Optional, Sequence

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels import _device
from litehandnet_tpu_torch.kernels._device import (
    DTYPES,
    MAX_SMEM_BYTES,
    blocks_for,
)
from litehandnet_tpu_torch.utils.profiling import register_counters

ACTS = {"none": 0, "relu": 1, "leaky_relu": 2}
KERNEL_SIZES = (3, 5, 7)
MAX_DILATION = 4
THREADS = 256            # threads per block (csrc kThreads)
TILE_W = 32              # output columns of a tile
MAX_STAGES = 3           # ring buffers at most
# by kernel size: bytes of a pixel's channel group, threads across a
# group, output rows a thread keeps, threads' rows stacked in a tile
GROUP_BYTES = {3: 64, 5: 32, 7: 32}
LANES = {3: 4, 5: 8, 7: 8}
ROWS = {3: 8, 5: 16, 7: 16}
SEGS = {3: 2, 5: 1, 7: 1}


def tile_rows(dilation: int) -> int:
    """Output rows of a tile: each thread's ROWS rows lie ``dilation``
    apart, and a tile holds every residue."""
    return 16 * dilation


def stage_bytes(kernel: int, dilation: int) -> int:
    """Shared memory of one ring buffer: a tile, its halo, one group."""
    pad = dilation * (kernel // 2)
    return ((tile_rows(dilation) + 2 * pad) * (TILE_W + 2 * pad)
            * GROUP_BYTES[kernel])


def plan(shape: Sequence[int], dtype: torch.dtype, strides: Sequence[int],
         kernel: int, dilation: int, sm_count: int,
         aligned: bool = True) -> Optional[Dict[str, int]]:
    """The launch of ``csrc/dw_conv_bias_act.cu`` for ``x`` of this shape,
    dtype and element strides, a ``kernel`` x ``kernel`` depthwise conv at
    ``dilation``, on a card of ``sm_count`` SMs; ``aligned``: whether x
    starts on a 16-byte boundary. None where the kernel does not take it.

    ``items`` = N x ``tiles_y`` x ``tiles_x`` output tiles of ``tile_h`` x
    TILE_W; ``groups`` channel groups of ``group`` channels make grid.y and
    ``grid_x`` blocks per group walk the items; ``stages`` ring buffers of
    ``stage_bytes`` (as many as fit, up to MAX_STAGES). A thread takes
    ``vec`` channels of one column and ROWS rows ``dilation`` apart.
    """
    if (dtype not in DTYPES or kernel not in KERNEL_SIZES
            or not isinstance(dilation, int)
            or not 1 <= dilation <= MAX_DILATION):
        return None
    N, C, H, W = shape
    sn, sc, sh, sw = strides
    chunk = 16 // dtype.itemsize
    if (min(shape) < 1 or C % 8 or not aligned or (sc != 1 and C > 1)
            or any(s % chunk for n, s in ((N, sn), (H, sh), (W, sw))
                   if n > 1)):
        return None
    sb = stage_bytes(kernel, dilation)
    stages = min(MAX_STAGES, MAX_SMEM_BYTES // sb)
    if stages < 1:
        return None
    group = GROUP_BYTES[kernel] // dtype.itemsize
    groups = -(-C // group)
    tile_h = tile_rows(dilation)
    tiles_y, tiles_x = -(-H // tile_h), -(-W // TILE_W)
    items = N * tiles_y * tiles_x
    return dict(dtype=DTYPES[dtype], k=kernel, d=dilation, N=N, C=C, H=H,
                W=W, xn=sn, xh=sh, xw=sw,
                grid_x=blocks_for(items, max(1, sm_count // groups)),
                groups=groups, stages=stages, stage_bytes=sb,
                smem_bytes=stages * sb, group=group,
                vec=GROUP_BYTES[kernel] // LANES[kernel] // dtype.itemsize,
                tile_h=tile_h, tiles_y=tiles_y, tiles_x=tiles_x, items=items)


def _activate(y: torch.Tensor, act: str, slope: float) -> torch.Tensor:
    if act == "relu":
        return F.relu(y)
    if act == "leaky_relu":
        return F.leaky_relu(y, slope)
    return y


def dw_conv_bias_act_reference(x: torch.Tensor, weight: torch.Tensor,
                               bias: torch.Tensor, dilation: int = 1,
                               act: str = "none",
                               slope: float = 0.01) -> torch.Tensor:
    """Plain PyTorch version: the depthwise ``F.conv2d`` and the bias in
    float32 (float64 for a float64 x), the activation, one cast to x's
    dtype; autocast off."""
    acc = torch.promote_types(x.dtype, torch.float32)
    pad = dilation * (weight.shape[-1] // 2)
    with torch.autocast(x.device.type, enabled=False):
        y = F.conv2d(x.to(acc), weight.to(acc), padding=pad,
                     dilation=dilation, groups=x.shape[1])
        y = _activate(y + bias.to(acc).view(1, -1, 1, 1), act, slope)
    return y.to(x.dtype)


# The plan as ``lhn_dw_conv_bias_act`` reads it: one int64 each, in this
# order (csrc/dw_conv_bias_act.cu ``enum Plan``).
PLAN_FIELDS = ("dtype", "k", "d", "N", "C", "H", "W", "xn", "xh", "xw",
               "grid_x", "groups", "stages", "stage_bytes")

_KERNEL = _device.Kernel(
    "dw_conv_bias_act", "lhn_dw_conv_bias_act", "lhn_dwba_plan_fields",
    PLAN_FIELDS, (_device.PTR,) * 4 + (_device.PLAN, ctypes.c_int,
                                       ctypes.c_float, _device.PTR),
    lambda x, dtype, aligned, kernel, dilation: plan(
        x.shape, dtype, x.stride(), kernel, dilation,
        _device.sm_count(x.device), aligned),
    [("lhn_dwba_stage_bytes", ctypes.c_int, (k, d), stage_bytes(k, d))
     for k in KERNEL_SIZES for d in range(1, MAX_DILATION + 1)])
# the cached plan of x, None where ``plan`` declines it (``Kernel.plan``)
launch_plan = _KERNEL.plan


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
           dilation: int, act: str) -> int:
    """The kernel size; raises ValueError or TypeError for what the kernel
    does not take."""
    if x.dim() != 4:
        raise ValueError(f"expected [N, C, H, W], got {tuple(x.shape)}")
    C, k = x.shape[1], weight.shape[-1]
    if tuple(weight.shape) != (C, 1, k, k) or k not in KERNEL_SIZES:
        raise ValueError(f"expected taps [{C}, 1, k, k] with k in "
                         f"{KERNEL_SIZES}, got {tuple(weight.shape)}")
    if tuple(bias.shape) != (C,):
        raise ValueError(f"expected a bias [{C}], got {tuple(bias.shape)}")
    if not isinstance(dilation, int) or not 1 <= dilation <= MAX_DILATION:
        raise ValueError(f"dilation must be an int from 1 to "
                         f"{MAX_DILATION}, got {dilation}")
    if act not in ACTS:
        raise ValueError(f"act must be one of {sorted(ACTS)}, got {act!r}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dw_conv_bias_act takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if (x.device.type not in ("cpu", "cuda") or weight.device != x.device
            or bias.device != x.device):
        raise TypeError(f"x on {x.device}, taps on {weight.device}, bias on "
                        f"{bias.device}: all must be on the CPU or on one "
                        "CUDA device")
    return k


def dw_conv_bias_act(x: torch.Tensor, weight: torch.Tensor,
                     bias: torch.Tensor, dilation: int = 1,
                     act: str = "none", slope: float = 0.01) -> torch.Tensor:
    """``act(depthwise_conv(x, weight) + bias)``, 'same' padding, stride 1.

    Args:
        x: ``[N, C, H, W]`` float32 or bfloat16; on CUDA with its channels
            innermost (channels_last), as ``plan`` takes it.
        weight: taps ``[C, 1, k, k]``, k in (3, 5, 7); float32 contiguous
            taps are read in place, others are converted first.
        bias: ``[C]``, the same.
        dilation: 1 to 4.
        act: ``"none"``, ``"relu"`` or ``"leaky_relu"``.
        slope: the leaky ReLU's negative slope.

    Returns:
        y ``[N, C, H, W]`` in x's dtype, channels_last on CUDA.

    Raises:
        ValueError: a shape, dilation or activation the kernel does not
            take, or a CUDA tensor ``plan`` declines.
        TypeError: a dtype or device it does not take.
        RuntimeError: the launch failed.
    """
    k = _check(x, weight, bias, dilation, act)
    if x.device.type == "cpu":
        return dw_conv_bias_act_reference(x, weight, bias, dilation, act,
                                          slope)
    planned = launch_plan(x, k, dilation)
    if planned is None:
        raise ValueError(f"dw_conv_bias_act does not tile x {tuple(x.shape)} "
                         f"{x.dtype} strides {x.stride()} at k={k} "
                         f"dilation={dilation} (kernels/dw_conv_bias_act.py "
                         "plan)")
    if weight.dtype != torch.float32 or not weight.is_contiguous():
        weight = weight.detach().float().contiguous()
    if bias.dtype != torch.float32 or not bias.is_contiguous():
        bias = bias.detach().float().contiguous()
    y = torch.empty_like(x, memory_format=torch.channels_last)
    index = x.get_device()
    _KERNEL.launch(index, x.data_ptr(), weight.data_ptr(), bias.data_ptr(),
                   y.data_ptr(), planned[0], ACTS[act], slope,
                   _device.current_stream(index))
    dw_conv_bias_act.launches += 1
    N, C, H, W = x.shape
    dw_conv_bias_act.shapes[(N, C, H, W, k, dilation, x.element_size())] += 1
    return y


dw_conv_bias_act.launches = 0
dw_conv_bias_act.shapes = collections.Counter()
register_counters(dw_conv_bias_act, "launches", "shapes")
