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
accumulators, so BatchNorm never re-reads y. Tiles' exact two-pass
statistics merge by Chan's update in a fixed order.

Bound: memory. At ``[32, 64, 64, 64]`` float32 it reads 34 MB and writes
34 MB, about 20 us at 3.35 TB/s, against 18 FP32 operations per output.

``dw_conv3x3_stats`` launches the kernel for a CUDA tensor and uses the
plain version, ``dw_conv3x3_stats_reference``, only for a CPU tensor. It
counts launches in ``dw_conv3x3_stats.launches``. The differentiable entry
point the port's RepConv calls is ``ops.fused_bn.dw_conv3x3_stats``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels import _build
from litehandnet_tpu_torch.kernels.moments import DTYPES, moments_reference

# shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
TILE_H, TILE_W, LANES = 8, 16, 32   # csrc/dw_conv3x3_stats.cu


def smem_bytes(dilation: int) -> int:
    """Shared memory one block needs: the tile and its halo, 32 channels."""
    return (TILE_H + 2 * dilation) * (TILE_W + 2 * dilation) * LANES * 4


def dilation_supported(dilation) -> bool:
    """An int from 1 up to what one block's shared memory holds (15)."""
    return (isinstance(dilation, int) and dilation >= 1
            and smem_bytes(dilation) <= MAX_SMEM_BYTES)


def dw_conv3x3_stats_reference(x: torch.Tensor, w: torch.Tensor,
                               dilation: int = 1):
    """Plain PyTorch version: float32 depthwise ``F.conv2d``, two-pass
    statistics of its float32 output, y cast to x's dtype."""
    y = F.conv2d(x.float(), w.float(), padding=dilation, dilation=dilation,
                 groups=x.shape[1])
    mean, var = moments_reference(y)
    return y.to(x.dtype), mean, var


def _library() -> ctypes.CDLL:
    lib = _build.load("dw_conv3x3_stats")
    fn = lib.lhn_dw_conv3x3_stats
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, i, p, p] + [i] * 5 + [ll] * 8 + [p] * 6
        fn.restype = i
        lib.lhn_dw_smem_bytes.argtypes = [i]
        lib.lhn_dw_smem_bytes.restype = ll
    return lib


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
        raise ValueError(f"dilation must be an int from 1 up to what one "
                         f"block's shared memory holds, got {dilation}")


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
    N, C, H, W = x.shape
    lib = _library()
    smem = lib.lhn_dw_smem_bytes(dilation)
    if smem != smem_bytes(dilation):
        raise RuntimeError(f"csrc/dw_conv3x3_stats.cu needs {smem} bytes of "
                           f"shared memory, this wrapper computes "
                           f"{smem_bytes(dilation)}")
    tiles = N * math.ceil(H / TILE_H) * math.ceil(W / TILE_W)
    f32 = dict(device=x.device, dtype=torch.float32)
    y = torch.empty_like(x, memory_format=torch.channels_last)
    part_count = torch.empty(tiles, **f32)
    part = torch.empty((2, tiles, C), **f32)
    mean = torch.empty(C, **f32)
    var = torch.empty(C, **f32)
    taps = w.detach().float().contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lhn_dw_conv3x3_stats(
            x.data_ptr(), DTYPES[x.dtype], taps.data_ptr(), y.data_ptr(),
            N, C, H, W, dilation, *x.stride(), *y.stride(),
            part_count.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            mean.data_ptr(), var.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"dw_conv3x3_stats kernel launch failed: CUDA "
                           f"error {rc}")
    dw_conv3x3_stats.launches += 1
    return y, mean, var


dw_conv3x3_stats.launches = 0
