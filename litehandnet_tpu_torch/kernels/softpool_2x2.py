"""SoftPool kernel: exp-weighted average pooling.

Replaces the Pallas TPU kernel ``litehandnet_tpu/ops/pallas_kernels.py::
softpool_2x2`` (:62, body ``_softpool_kernel`` :48) with the hand-written
CUDA C++ kernel ``csrc/softpool_2x2.cu`` for Hopper (``sm_90a``), built with
``nvcc`` at first use and bound through ctypes.

For ``x`` ``[B, C, H, W]`` (float32 or bfloat16, any strides) and each VALID
k x k window with stride s it gives ``sum(exp(x) * x) / sum(exp(x))`` with
the exp unshifted, in x's dtype: JAX ``models/attention.soft_pool``, whose
2 x 2 stride-2 case is the TPU kernel. Odd sizes floor. Sums are float32;
a bfloat16 result is rounded once.

Bound: memory. At ``[128, 128, 64, 64]`` float32 (k = s = 2) it reads 268 MB
and writes 67 MB, about 0.10 ms at 3.35 TB/s, against 4 FP32 operations and
one exp per input element. One thread per output element; for channels_last
memory neighbouring threads take neighbouring channels, so loads and stores
are coalesced.

``softpool_2x2`` launches the kernel for a CUDA tensor and uses the plain
version, ``softpool_2x2_reference``, only for a CPU tensor. It counts
launches in ``softpool_2x2.launches``. The differentiable entry point is
``models.attention.soft_pool``.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from litehandnet_tpu_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def output_size(H: int, W: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(Ho, Wo) of the VALID window; 0 where the window does not fit."""
    return ((H - kernel) // stride + 1 if H >= kernel else 0,
            (W - kernel) // stride + 1 if W >= kernel else 0)


def softpool_2x2_reference(x: torch.Tensor, kernel: int = 2,
                           stride: int = 2) -> torch.Tensor:
    """Plain PyTorch version: float32 ``exp``, ``exp(x) * x``, the window sums
    taken tap by tap in row-major order, one divide, cast to x's dtype.
    ``[B, C, H, W]`` with a window that fits -> ``[B, C, Ho, Wo]``."""
    H, W = x.shape[2:]
    Ho, Wo = output_size(H, W, kernel, stride)
    xf = x.float()
    e = torch.exp(xf)
    ex = e * xf
    num = den = 0.0
    for dy in range(kernel):
        for dx in range(kernel):
            window = (Ellipsis, slice(dy, dy + stride * (Ho - 1) + 1, stride),
                      slice(dx, dx + stride * (Wo - 1) + 1, stride))
            num = num + ex[window]
            den = den + e[window]
    return (num / den).to(x.dtype)


def _library() -> ctypes.CDLL:
    lib = _build.load("softpool_2x2")
    fn = lib.lhn_softpool
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, p] + [i] * 8 + [ll] * 8 + [p]
        fn.restype = i
    return lib


def softpool_2x2(x: torch.Tensor, kernel: int = 2,
                 stride: int = 2) -> torch.Tensor:
    """SoftPool of ``[B, C, H, W]`` over VALID ``kernel`` x ``kernel``
    windows with ``stride``, in x's dtype.

    The output is channels_last where x's channels are its innermost
    dimension, else contiguous. A window larger than the map gives an empty
    output, as in JAX.

    Raises:
        ValueError: not 4-D, or kernel or stride below 1.
        TypeError: not float32 or bfloat16, or on a device other than CPU
            or CUDA.
        RuntimeError: the launch failed.
    """
    if x.dim() != 4:
        raise ValueError(f"expected [B, C, H, W], got shape {tuple(x.shape)}")
    if kernel < 1 or stride < 1:
        raise ValueError(f"kernel and stride must be >= 1, got {kernel}, "
                         f"{stride}")
    if x.dtype not in DTYPES:
        raise TypeError(f"softpool takes float32 or bfloat16, got {x.dtype}")
    if x.device.type not in ("cpu", "cuda"):
        raise TypeError(f"softpool runs on CPU or CUDA, got {x.device}")
    B, C, H, W = x.shape
    Ho, Wo = output_size(H, W, kernel, stride)
    channels_fastest = x.stride(1) <= x.stride(3)
    fmt = torch.channels_last if channels_fastest else torch.contiguous_format
    if B * C * Ho * Wo == 0:
        return torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype,
                           memory_format=fmt)
    if x.device.type == "cpu":
        return softpool_2x2_reference(x, kernel, stride)
    y = torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype,
                    memory_format=fmt)
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lhn_softpool(
            x.data_ptr(), y.data_ptr(), DTYPES[x.dtype], B, C, H, W, kernel,
            stride, int(channels_fastest), *x.stride(), *y.stride(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"softpool kernel launch failed: CUDA error {rc}")
    softpool_2x2.launches += 1
    return y


softpool_2x2.launches = 0
