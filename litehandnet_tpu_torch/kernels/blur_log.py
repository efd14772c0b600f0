"""DARK modulation kernel: blur + max-preserving rescale + log.

Replaces the Pallas TPU kernel ``litehandnet_tpu/ops/pallas_kernels.py::
blur_log`` (:106, body ``_blur_log_kernel`` :82) with the hand-written CUDA
C++ kernel ``csrc/blur_log.cu`` for Hopper (``sm_90a``), built with ``nvcc``
at first use and bound through ctypes.

It computes, for each (b, k) map of a ``[B, H, W, K]`` float32 tensor,
``log(max(gaussian_blur(x, kernel, 'constant', preserve_max=True), 1e-10))``
with the cv2 taps of ``cv2_gaussian_kernel(kernel, 0)``.

Bound: memory. At the serve shape (B=128, 64x64x21) it reads 44 MB and
writes 44 MB, 26.3 us at 3.35 TB/s, against about 0.5 GFLOP of FP32 work
(7.7 us at 67 TFLOP/s). ``plan`` picks one of two paths:

- fast (the serve layout: K innermost, W * K rows contiguous and 16-byte
  aligned, kernel 11, H <= 64, W * K <= 1,536): a CTA owns ``rows`` output
  rows of one image for all maps and passes them in place; the ``cluster``
  CTAs of an image form a thread block cluster and read each other's
  horizontal-pass rows (the halo) and maxima over distributed shared
  memory; 16-byte copies in and stores out;
- general (any strides, any odd kernel, unaligned rows, tiles too large for
  one CTA): one block per map, as the first version of the kernel.

Both give the same bits. The TPU version's Toeplitz matmuls existed only
because Mosaic lacks lane-dim slices and are not carried over.

``blur_log`` launches the kernel for a CUDA tensor and uses the plain
version, ``blur_log_reference``, only for a CPU tensor. ``blur_log.launches``
counts kernel launches and ``blur_log.path_launches`` splits them by path,
so a run shows which path a caller took.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence

import torch

from litehandnet_tpu_torch.kernels import _device
from litehandnet_tpu_torch.kernels._device import MAX_SMEM_BYTES
from litehandnet_tpu_torch.ops.blur import cv2_gaussian_kernel, separable_blur
from litehandnet_tpu_torch.utils.profiling import register_counters

_THREADS = 256          # general path
FAST_KERNEL = 11        # the kernel size of the fast path (the serve decode's)
MAX_CLUSTER = 8         # CTAs of one image: the portable cluster size
MAX_ROWS = 8            # rows of a CTA, held in registers (csrc kRowChunk)
RUN = 32                # columns of a horizontal-pass task (csrc kRun)
FAST_MAX_THREADS = 384  # csrc/blur_log.cu kFastMaxThreads
PATHS = ("general", "fast")


def smem_bytes(H: int, W: int, kernel: int) -> int:
    """Shared memory one general-path block needs; ``csrc/blur_log.cu``
    computes the same."""
    return (2 * H * W + kernel + _THREADS // 32) * 4


def fast_smem_bytes(rows: int, W: int, K: int) -> int:
    """Shared memory one fast-path CTA needs: its rows (raw, then passed in
    place) and 3 K floats of maxima and scales."""
    return (rows * W * K + 3 * K) * 4


def plan(shape: Sequence[int], strides: Sequence[int], kernel: int = 11,
         aligned: bool = True) -> Dict[str, int]:
    """The launch of ``csrc/blur_log.cu`` for ``x`` of this shape and element
    strides; ``aligned``: whether x starts on a 16-byte boundary.

    ``path`` 1 (fast) where kernel is 11, K is innermost with each W * K row
    contiguous and the rows 16 bytes apart, and one CTA's ``threads`` cover
    both its horizontal-pass tasks (``rows`` x ceil(W / 32) x K) and the
    16-byte quads of a row (W * K / 4); then ``cluster`` = ceil(H / rows)
    <= 8 CTAs per image, ``rows`` <= 8, ``smem`` bytes a CTA. Otherwise
    ``path`` 0, one block per map.
    """
    B, H, W, K = shape
    sb, sh, sw, sk = strides
    WK = W * K
    cluster = min(MAX_CLUSTER, H)
    rows = -(-H // cluster)
    cluster = -(-H // rows)
    tasks = rows * -(-W // RUN) * K
    threads = max(32, -(-max(WK // 4, tasks) // 32) * 32)
    rows_contiguous = (K == 1 or sk == 1) and (W == 1 or sw == K)
    fast = (kernel == FAST_KERNEL and rows_contiguous and WK % 4 == 0
            and (H == 1 or sh % 4 == 0) and (B == 1 or sb % 4 == 0)
            and aligned and rows <= MAX_ROWS and threads <= FAST_MAX_THREADS)
    p = dict(path=int(fast), ksize=kernel, B=B, H=H, W=W, K=K,
             xb=sb, xh=sh, xw=sw, xk=sk,
             # y: contiguous, as the wrapper allocates it
             yb=H * WK, yh=WK, yw=K, yk=1)
    if fast:
        # the kernel reads only the image and row strides on this path
        p.update(xw=K, xk=1, rows=rows, cluster=cluster, threads=threads,
                 smem=fast_smem_bytes(rows, W, K))
    else:
        p.update(rows=0, cluster=0, threads=_THREADS,
                 smem=smem_bytes(H, W, kernel))
    return p


# The plan as ``lhn_blur_log`` reads it: one int64 each, in this order
# (csrc/blur_log.cu ``enum Plan``).
PLAN_FIELDS = ("path", "ksize", "B", "H", "W", "K", "xb", "xh", "xw", "xk",
               "yb", "yh", "yw", "yk", "rows", "cluster", "threads", "smem")


def blur_log_reference(x: torch.Tensor, kernel: int = 11) -> torch.Tensor:
    """Plain PyTorch version: zero ``F.pad``, ``ops.blur.separable_blur``
    (horizontal then vertical, taps in ascending order), amax rescale,
    log. ``[B, H, W, K]`` -> ``[B, H, W, K]``.

    The log is taken in float64 and rounded once: torch's float32 log on
    the CPU is not reproducible across processes (in some, one thread's
    chunk of a multi-threaded call came out up to 4e-5 off)."""
    B, H, W, K = x.shape
    pad = (kernel - 1) // 2
    maps = x.permute(0, 3, 1, 2).reshape(B * K, H, W)
    padded = torch.nn.functional.pad(maps, (pad, pad, pad, pad))
    blurred = separable_blur(padded, cv2_gaussian_kernel(kernel, 0.0))
    orig_max = maps.amax(dim=(1, 2), keepdim=True)
    new_max = blurred.amax(dim=(1, 2), keepdim=True)
    out = blurred * (orig_max / torch.clamp(new_max, min=1e-20))
    out = torch.log(torch.clamp(out, min=1e-10).double()).to(x.dtype)
    return out.reshape(B, K, H, W).permute(0, 2, 3, 1)


def _plan_with_taps(x: torch.Tensor, dtype, aligned: bool,
                    kernel: int) -> Dict[str, object]:
    """``plan`` and, as ``taps``, the taps' address on x's device and the
    taps on the host as a ctypes float array, the fast path's kernel
    parameter (``taps_on_device`` keeps the device copy)."""
    taps = cv2_gaussian_kernel(kernel, 0.0)
    on_device = torch.as_tensor(taps, device=x.device).contiguous()
    return dict(plan(x.shape, x.stride(), kernel, aligned),
                taps_on_device=on_device,
                taps=(on_device.data_ptr(),
                      (ctypes.c_float * len(taps))(*taps.tolist())))


_KERNEL = _device.Kernel(
    "blur_log", "lhn_blur_log", "lhn_blur_log_plan_fields", PLAN_FIELDS,
    (_device.PTR,) * 4 + (_device.PLAN, _device.PTR), _plan_with_taps,
    [("lhn_blur_log_fast_smem", ctypes.c_longlong, (8, 64, 21),
      fast_smem_bytes(8, 64, 21))])


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
    packed, p = _KERNEL.plan(x, kernel)
    index = x.get_device()
    _KERNEL.launch(index, x.data_ptr(), y.data_ptr(), *p["taps"], packed,
                   _device.current_stream(index))
    blur_log.launches += 1
    blur_log.path_launches[PATHS[p["path"]]] += 1
    return y


blur_log.launches = 0
blur_log.path_launches = dict.fromkeys(PATHS, 0)
register_counters(blur_log, "launches", "path_launches")
