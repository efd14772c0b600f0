"""Per-channel BatchNorm batch statistics kernel.

Replaces the Pallas TPU kernel ``litehandnet_tpu/ops/fused_bn.py::moments``
(:129, ``_pallas_moments`` :82, body ``_moments_kernel`` :53) with the
hand-written CUDA C++ kernel ``csrc/moments.cu`` for Hopper (``sm_90a``),
built with ``nvcc`` at first use and bound through ctypes.

For ``x`` of shape ``[N, C, H, W]`` (float32 or bfloat16) it gives the
float32 per-channel mean and biased variance over N, H and W: the JAX
function over the NHWC view. Each tile's statistics are an exact two-pass;
tiles merge by Chan's update in a fixed order, never E[x^2] - E[x]^2.

Bound: memory. At the flagship's largest site, ``[32, 128, 64, 64]`` float32,
it reads 67 MB once, about 20 us at 3.35 TB/s, against about 4 FP32
operations per element. Any strides are read; a channels_last tensor is read
coalesced, 32 channels of a row per warp.

``moments`` launches the kernel for a CUDA tensor and uses the plain
version, ``moments_reference``, only for a CPU tensor. It counts launches in
``moments.launches``. The differentiable entry point the port's
BatchNorm calls is ``ops.fused_bn.moments``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from litehandnet_tpu_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def moments_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: float32 two-pass mean and biased variance over
    dims (0, 2, 3) of ``[N, C, H, W]``."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    return mean, var


def _library() -> ctypes.CDLL:
    lib = _build.load("moments")
    fn = lib.lhn_moments
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, i, i, i, i, i] + [ll] * 4 + [p] * 6
        fn.restype = i
        lib.lhn_moments_tile_rows.argtypes = []
        lib.lhn_moments_tile_rows.restype = i
    return lib


def _check_input(x: torch.Tensor) -> None:
    """Raises ValueError or TypeError for what the kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"expected [N, C, H, W], got shape {tuple(x.shape)}")
    if x.numel() == 0:
        raise ValueError(f"moments of an empty tensor {tuple(x.shape)}")
    if x.dtype not in DTYPES:
        raise TypeError(f"moments takes float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise TypeError(f"moments runs on CPU or CUDA, got {x.device}")


def moments(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and biased variance per channel of ``[N, C, H, W]``, float32.

    Raises:
        ValueError: not 4-D, or empty.
        TypeError: not float32 or bfloat16, or on a device other than CPU
            or CUDA.
        RuntimeError: the launch failed.
    """
    _check_input(x)
    if x.device.type == "cpu":
        return moments_reference(x)
    N, C, H, W = x.shape
    lib = _library()
    tiles = math.ceil(N * H * W / lib.lhn_moments_tile_rows())
    f32 = dict(device=x.device, dtype=torch.float32)
    part_count = torch.empty(tiles, **f32)
    part = torch.empty((2, tiles, C), **f32)
    mean = torch.empty(C, **f32)
    var = torch.empty(C, **f32)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lhn_moments(
            x.data_ptr(), DTYPES[x.dtype], N, C, H, W, *x.stride(),
            part_count.data_ptr(), part[0].data_ptr(), part[1].data_ptr(),
            mean.data_ptr(), var.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"moments kernel launch failed: CUDA error {rc}")
    moments.launches += 1
    return mean, var


moments.launches = 0
