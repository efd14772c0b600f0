"""Depthwise 3x3 convolution fused with its BatchNorm statistics.

Replaces the Pallas TPU kernel ``litehandnet_tpu/ops/fused_bn.py::
dw_conv3x3_stats`` (:296, ``_pallas_dw_stats`` :256, body
``_dw_stats_kernel`` :210) with the hand-written CUDA C++ kernel
``csrc/dw_conv3x3_stats.cu`` for Hopper (``sm_90a``), built with ``nvcc`` at
first use and bound through ctypes.

For ``x`` ``[N, C, H, W]`` (float32 or bfloat16) and the port's OIHW weight
``[C, 1, 3, 3]`` it gives the 'SAME' stride-1 depthwise conv with dilation d
(``F.conv2d(x, w, padding=d, dilation=d, groups=C)``), y in x's dtype, and
the float32 per-channel mean and biased variance of the float32
accumulators, so BatchNorm never re-reads y. Each thread's exact two-pass
statistics fold by Chan's update; blocks merge in a fixed order inside the
one launch (``csrc/stats_merge.cuh``).

Bound: memory. At ``[32, 64, 64, 64]`` float32 it reads 33.6 MB and writes
33.6 MB, 20.0 us at 3.35 TB/s, against 18 FP32 operations per output.
``plan`` cuts the work into 16 x 32 output tiles of 16-channel groups, sizes
the grid to the SM count and picks the vector path (16-byte ``cp.async``
into a 2-stage ring, 16-byte stores) or the scalar path (any strides, the
same tiles and arithmetic). Measured (``chip_smoke.py``, NVIDIA H100 80GB
HBM3 at 700 W, float32 channels_last, device time per call): 35.1 / 35.5 us
at ``[32, 64, 64, 64]`` d = 1 / 2, 9.9 to 18.6 us at the smaller sites;
22 to 42 us of host time per call. Per site: ``PERF.md`` section 6.

``dw_conv3x3_stats`` launches the kernel for a CUDA tensor and uses the
plain version, ``dw_conv3x3_stats_reference``, only for a CPU tensor. It
counts launches in ``dw_conv3x3_stats.launches``. The differentiable entry
point the port's RepConv calls is ``ops.fused_bn.dw_conv3x3_stats``.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels import _device
from litehandnet_tpu_torch.kernels._device import (
    DTYPES,
    MAX_SMEM_BYTES,
    blocks_for,
    scratch_layout,
)
from litehandnet_tpu_torch.kernels.moments import THREADS, moments_reference
from litehandnet_tpu_torch.utils.profiling import register_counters

TILE_H, TILE_W = 16, 32  # output rows and columns of a work item
SEG_ROWS = 8             # output rows per thread
GROUP = 16               # channels per group (grid.y)
# blocks the plan aims at per SM: one measured faster than two (each block
# walks twice the items, so less of its first copy is exposed; PERF.md
# section 6); the kernel still fits two
BLOCKS_PER_SM = 1
# the block's static shared memory: the merge's THREADS doubles and
# 2 x THREADS x 4 floats, and a flag
MERGE_SMEM_BYTES = THREADS * 8 + 2 * THREADS * 4 * 4 + 16
# Dilations the wrapper takes. The model zoo uses 1 and 2; up to 15 the
# halo of one tile fits a block's shared memory with room to spare.
MAX_DILATION = 15


def stage_bytes(dilation: int, itemsize: int) -> int:
    """Shared memory of one ring buffer: a tile and its halo, one group."""
    return ((TILE_H + 2 * dilation) * (TILE_W + 2 * dilation) * GROUP
            * itemsize)


def dilation_supported(dilation) -> bool:
    """An int from 1 to ``MAX_DILATION``."""
    return (isinstance(dilation, int) and 1 <= dilation <= MAX_DILATION
            and stage_bytes(dilation, 4) + MERGE_SMEM_BYTES <= MAX_SMEM_BYTES)


def plan(shape: Sequence[int], dtype: torch.dtype, strides: Sequence[int],
         dilation: int, sm_count: int, aligned: bool = True) -> Dict[str, int]:
    """The launch of ``csrc/dw_conv3x3_stats.cu`` for ``x`` of this shape,
    dtype and element strides at ``dilation`` on a card of ``sm_count`` SMs;
    ``aligned``: whether x starts on a 16-byte boundary.

    ``items`` = N x ``tiles_y`` x ``tiles_x`` output tiles of TILE_H x
    TILE_W;
    ``groups`` channel groups of GROUP make grid.y and ``grid_x`` blocks per
    group walk the items; ``stages`` ring buffers of ``stage_bytes`` (2 where
    two fit beside the merge's shared memory). ``vector`` picks the
    ``cp.async`` path; nothing else depends on the strides, so both paths
    compute the same tiles.
    """
    N, C, H, W = shape
    vec = 16 // dtype.itemsize
    groups = -(-C // GROUP)
    tiles_y, tiles_x = -(-H // TILE_H), -(-W // TILE_W)
    items = N * tiles_y * tiles_x
    grid_x = blocks_for(items, max(1, BLOCKS_PER_SM * sm_count // groups))
    sb = stage_bytes(dilation, dtype.itemsize)
    stages = 2 if 2 * sb + MERGE_SMEM_BYTES <= MAX_SMEM_BYTES else 1
    sn, sc, sh, sw = strides
    vector = (C % vec == 0 and (sc == 1 or C == 1) and aligned
              and all(s % vec == 0 for s in (sn, sh, sw)))
    # y: channels_last, as the wrapper allocates it
    return dict(dtype=DTYPES[dtype], N=N, C=C, H=H, W=W, dilation=dilation,
                xn=sn, xc=sc, xh=sh, xw=sw, yn=H * W * C, yc=1, yh=W * C, yw=C,
                vec=vec, groups=groups, tiles_y=tiles_y, tiles_x=tiles_x,
                items=items, grid_x=grid_x, stages=stages, stage_bytes=sb,
                smem_bytes=stages * sb + MERGE_SMEM_BYTES, vector=int(vector),
                **{f"scratch_{k}": v for k, v in
                   scratch_layout(groups, grid_x, GROUP).items()})


def dw_conv3x3_stats_reference(x: torch.Tensor, w: torch.Tensor,
                               dilation: int = 1):
    """Plain PyTorch version: float32 depthwise ``F.conv2d``, two-pass
    statistics of its float32 output, y cast to x's dtype."""
    y = F.conv2d(x.float(), w.float(), padding=dilation, dilation=dilation,
                 groups=x.shape[1])
    mean, var = moments_reference(y)
    return y.to(x.dtype), mean, var


# The plan as ``lhn_dw_conv3x3_stats`` reads it: one int64 each, in this
# order (csrc/dw_conv3x3_stats.cu ``enum Plan``).
PLAN_FIELDS = ("dtype", "vector", "N", "C", "H", "W", "dilation", "xn", "xc",
               "xh", "xw", "yn", "yc", "yh", "yw", "grid_x", "groups",
               "stages", "stage_bytes", "scratch_n", "scratch_mean",
               "scratch_m2")

_KERNEL = _device.Kernel(
    "dw_conv3x3_stats", "lhn_dw_conv3x3_stats", "lhn_dw_plan_fields",
    PLAN_FIELDS, (_device.PTR,) * 3 + (_device.PLAN,) + (_device.PTR,) * 3,
    lambda x, dtype, aligned, dilation: plan(
        x.shape, dtype, x.stride(), dilation, _device.sm_count(x.device),
        aligned),
    [("lhn_dw_stage_bytes", ctypes.c_int, (d, 4), stage_bytes(d, 4))
     for d in (1, 2, MAX_DILATION)])


def _check_input(x: torch.Tensor, w: torch.Tensor, dilation: int) -> None:
    """Raises ValueError or TypeError for what the kernel does not take."""
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"expected a non-empty [N, C, H, W], got "
                         f"{tuple(x.shape)}")
    C = x.shape[1]
    if tuple(w.shape) != (C, 1, 3, 3):
        raise ValueError(f"expected weight [{C}, 1, 3, 3], got "
                         f"{tuple(w.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"dw_conv3x3_stats takes float32 or bfloat16, got "
                        f"{x.dtype}")
    if x.device.type not in ("cpu", "cuda") or w.device != x.device:
        raise TypeError(f"x on {x.device} and w on {w.device}: both must be "
                        "on the CPU or on one CUDA device")
    if not dilation_supported(dilation):
        raise ValueError(f"dilation must be an int from 1 to {MAX_DILATION}, "
                         f"got {dilation}")


def dw_conv3x3_stats(x: torch.Tensor, w: torch.Tensor, dilation: int = 1
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Depthwise 3x3 conv and its per-channel mean and biased variance.

    Returns ``(y, mean, var)``: y ``[N, C, H, W]`` in x's dtype
    (channels_last memory on CUDA), mean and var ``[C]`` float32.

    Raises:
        ValueError: a shape or dilation the kernel does not take.
        TypeError: a dtype or device it does not take.
        RuntimeError: the launch failed.
    """
    _check_input(x, w, dilation)
    if x.device.type == "cpu":
        return dw_conv3x3_stats_reference(x, w, dilation)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    # one allocation: mean and var are its two rows
    stats = x.new_empty((2, x.shape[1]), dtype=torch.float32)
    taps = w if w.dtype == torch.float32 and w.is_contiguous() else (
        w.detach().float().contiguous())
    packed, p = _KERNEL.plan(x, dilation)
    index = x.get_device()
    stream, scratch = _device.stream_and_scratch(index, p["scratch_nbytes"])
    _KERNEL.launch(index, x.data_ptr(), taps.data_ptr(), y.data_ptr(), packed,
                   scratch, stats.data_ptr(), stream)
    dw_conv3x3_stats.launches += 1
    mean, var = stats.unbind(0)
    return y, mean, var


dw_conv3x3_stats.launches = 0
register_counters(dw_conv3x3_stats, "launches")
