"""DARK modulation kernel: blur + max-preserving rescale + log.

Replaces the Pallas TPU kernel ``litehandnet_tpu/ops/pallas_kernels.py::
blur_log`` (:106, body ``_blur_log_kernel`` :82) with the hand-written CUDA
C++ kernel ``csrc/blur_log.cu`` for Hopper (``sm_90a``), built with ``nvcc``
at first use and bound through ctypes.

It computes, for each (b, k) map of a ``[B, H, W, K]`` float32 tensor,
``log(max(gaussian_blur(x, kernel, 'constant', preserve_max=True), 1e-10))``
with the cv2 taps of ``cv2_gaussian_kernel(kernel, 0)``.

Bound: memory. At the serve shape (B=128, 64x64x21) it reads 44 MB and
writes 44 MB, about 26 us at 3.35 TB/s, against about 0.5 GFLOP of FP32
work (about 8 us at 67 TFLOP/s). One thread block holds one map and its
horizontal-pass intermediate in shared memory, so only the input read and
the output write touch device memory. The TPU version's Toeplitz matmuls
existed only because Mosaic lacks lane-dim slices and are not carried over.

``blur_log`` launches the kernel for a CUDA tensor and uses the plain
version, ``blur_log_reference``, only for a CPU tensor. ``blur_log.launches``
counts kernel launches.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from litehandnet_tpu_torch.kernels import _build
from litehandnet_tpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur

# shared memory a block may use on Hopper (227 KB)
MAX_SMEM_BYTES = 232448
_THREADS = 256

_TAPS: Dict[Tuple[int, torch.device], torch.Tensor] = {}


def smem_bytes(H: int, W: int, kernel: int) -> int:
    """Shared memory one block needs; ``csrc/blur_log.cu`` computes the same."""
    return (2 * H * W + kernel + _THREADS // 32) * 4


def blur_log_reference(x: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Plain PyTorch version: zero ``F.pad``, two depthwise ``F.conv2d``
    passes, amax rescale, log. ``[B, H, W, K]`` -> ``[B, H, W, K]``."""
    B, H, W, K = x.shape
    pad = (kernel - 1) // 2
    maps = x.permute(0, 3, 1, 2).reshape(B * K, H, W)
    padded = torch.nn.functional.pad(maps, (pad, pad, pad, pad))
    blurred = separable_blur(padded, cv2_gaussian_kernel(kernel, 0.0))
    orig_max = maps.amax(dim=(1, 2), keepdim=True)
    new_max = blurred.amax(dim=(1, 2), keepdim=True)
    out = blurred * (orig_max / torch.clamp(new_max, min=1e-20))
    out = torch.log(torch.clamp(out, min=1e-10))
    return out.reshape(B, K, H, W).permute(0, 2, 3, 1)


def _library() -> ctypes.CDLL:
    lib = _build.load("blur_log")
    fn = lib.lhn_blur_log_f32
    if fn.argtypes is None:
        # without argtypes ctypes passes every int as a 32-bit C int and
        # cuts the pointers
        i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
        fn.argtypes = [p, p, p, i, i, i, i, i] + [ll] * 8 + [p]
        fn.restype = i
    return lib


def _taps(kernel: int, device: torch.device) -> torch.Tensor:
    key = (kernel, device)
    if key not in _TAPS:
        _TAPS[key] = torch.as_tensor(cv2_gaussian_kernel(kernel, 0.0),
                                     device=device).contiguous()
    return _TAPS[key]


def blur_log(x: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """DARK modulation of ``[B, H, W, K]`` float32 heatmaps.

    Any strides are accepted; the output is a new contiguous tensor.

    Raises:
        ValueError: even kernel size, not 4-D, or a map too large for one
            block's shared memory.
        TypeError: not float32, or on a device other than CPU or CUDA.
        RuntimeError: the launch failed.
    """
    if kernel < 1 or kernel % 2 != 1:
        raise ValueError(f"kernel size must be odd and positive, got {kernel}")
    if x.dim() != 4:
        raise ValueError(f"expected [B, H, W, K], got shape {tuple(x.shape)}")
    if x.dtype != torch.float32:
        raise TypeError(f"blur_log takes float32, got {x.dtype}")
    if x.device.type == "cpu":
        return blur_log_reference(x, kernel)
    if x.device.type != "cuda":
        raise TypeError(f"blur_log runs on CPU or CUDA, got {x.device}")
    B, H, W, K = x.shape
    smem = smem_bytes(H, W, kernel)
    if smem > MAX_SMEM_BYTES:
        raise ValueError(
            f"a {H}x{W} map needs {smem} bytes of shared memory; "
            f"one block has {MAX_SMEM_BYTES}"
        )
    y = torch.empty((B, H, W, K), device=x.device, dtype=torch.float32)
    if y.numel() == 0:
        return y
    lib = _library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lhn_blur_log_f32(
            x.data_ptr(), y.data_ptr(), _taps(kernel, x.device).data_ptr(),
            kernel, B, H, W, K, *x.stride(), *y.stride(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"blur_log kernel launch failed: CUDA error {rc}")
    blur_log.launches += 1
    return y


blur_log.launches = 0
