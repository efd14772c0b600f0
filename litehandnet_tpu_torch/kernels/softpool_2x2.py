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
and writes 67 MB, 0.100 ms at 3.35 TB/s, against 4 FP32 operations and one
exp per input element. ``plan`` picks one of two paths with the same
arithmetic, so the same bits:

- fast (k = s = 2, channels_last memory, C x element size a multiple of 16
  bytes, 16-byte aligned): a thread takes 16 bytes of channels of two output
  pixels, all 8 tap loads in flight before the first exp, 16-byte stores;
  blocks walk output rows;
- general (any k and s, NCHW memory, ragged C, unaligned): one thread per
  output, indexed in 2-D.

``softpool_2x2`` launches the kernel for a CUDA tensor and uses the plain
version, ``softpool_2x2_reference``, only for a CPU tensor. It counts
launches in ``softpool_2x2.launches`` and by path in
``softpool_2x2.path_launches``. The differentiable entry point is
``models.attention.soft_pool``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from litehandnet_tpu_torch.kernels import _build, _device
from litehandnet_tpu_torch.kernels.moments import blocks_for

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256           # threads per block at most (csrc kThreads)
BLOCKS_PER_SM = 4       # csrc __launch_bounds__(256, 4)
MAX_LANES = 32          # threads across one pixel's channel vectors
PATHS = ("general", "fast")


def output_size(H: int, W: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(Ho, Wo) of the VALID window; 0 where the window does not fit."""
    return ((H - kernel) // stride + 1 if H >= kernel else 0,
            (W - kernel) // stride + 1 if W >= kernel else 0)


def channels_fastest(strides: Sequence[int]) -> bool:
    """Whether x's channels lie innermost (the output is then
    channels_last)."""
    return strides[1] <= strides[3]


def plan(shape: Sequence[int], dtype: torch.dtype, strides: Sequence[int],
         kernel: int, stride: int, sm_count: int,
         aligned: bool = True) -> Dict[str, int]:
    """The launch of ``csrc/softpool_2x2.cu`` for ``x`` of this shape, dtype
    and element strides with a ``kernel`` x ``kernel`` window of ``stride``
    on a card of ``sm_count`` SMs; ``aligned``: whether x starts on a
    16-byte boundary. The output has at least one element.

    ``path`` 1 (fast) for k = s = 2 on channels-innermost memory whose C and
    strides are whole 16-byte vectors; ``units`` output rows, walked by
    ``grid`` blocks of ``lanes`` x ``slots`` threads.
    """
    B, C, H, W = shape
    sb, sc, sh, sw = strides
    Ho, Wo = output_size(H, W, kernel, stride)
    vec = 16 // dtype.itemsize
    cl = channels_fastest(strides)
    fast = (kernel == 2 and stride == 2 and cl and sc == 1 and C % vec == 0
            and aligned
            and all(s % vec == 0 for n, s in ((B, sb), (H, sh), (W, sw))
                    if n > 1))
    if cl:
        # a block takes one output row (b, ho): threads across the channels
        # (16-byte vectors of them on the fast path) and the pixels
        lanes = min(C // vec if fast else C, MAX_LANES)
        units = B * Ho
        per_block = 1
    else:
        # a block takes `slots` output rows (b, c, ho): threads across the
        # columns
        lanes = min(THREADS, -(-Wo // 32) * 32)
        units = B * C * Ho
        per_block = THREADS // lanes
    slots = THREADS // lanes
    grid = blocks_for(-(-units // per_block), BLOCKS_PER_SM * sm_count)
    # y: channels_last where x's channels are innermost, else contiguous
    if cl:
        ys = (Ho * Wo * C, 1, Wo * C, C)
    else:
        ys = (C * Ho * Wo, Ho * Wo, Wo, 1)
    return dict(dtype=DTYPES[dtype], path=int(fast), C=C, Ho=Ho, Wo=Wo,
                k=kernel, s=stride,
                xb=sb, xc=sc, xh=sh, xw=sw,
                yb=ys[0], yc=ys[1], yh=ys[2], yw=ys[3],
                units=units, lanes=lanes, slots=slots, grid=grid,
                channels_fastest=int(cl))


# The plan as ``lhn_softpool`` reads it: one int64 each, in this order
# (csrc/softpool_2x2.cu ``enum Plan``).
PLAN_FIELDS = ("dtype", "path", "C", "Ho", "Wo", "k", "s", "xb", "xc", "xh",
               "xw", "yb", "yc", "yh", "yw", "units", "lanes", "slots",
               "grid", "channels_fastest")


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


@functools.cache
def _kernel():
    """``lhn_softpool`` of the built library, argument types declared."""
    lib = _build.load("softpool_2x2")
    if lib.lhn_softpool_plan_fields() != len(PLAN_FIELDS):
        raise RuntimeError("csrc/softpool_2x2.cu and kernels/softpool_2x2.py "
                           "disagree on the launch plan")
    fn = lib.lhn_softpool
    # without argtypes ctypes passes every int as a 32-bit C int and cuts
    # the pointers
    p = ctypes.c_void_p
    fn.argtypes = [p, p, ctypes.POINTER(ctypes.c_longlong), p]
    fn.restype = ctypes.c_int
    return fn


_PLANS: Dict[tuple, tuple] = {}


def _launch_plan(x: torch.Tensor, kernel: int, stride: int) -> tuple:
    """(the plan of ``x`` as a ctypes int64 array, its path's name), cached
    by shape, strides, dtype, window, device and alignment."""
    aligned = x.data_ptr() % 16 == 0
    key = (x.shape, x.stride(), x.dtype, kernel, stride, x.get_device(),
           aligned)
    packed = _PLANS.get(key)
    if packed is None:
        p = plan(x.shape, x.dtype, x.stride(), kernel, stride,
                 _device.sm_count(x.device), aligned)
        packed = _PLANS[key] = (
            (ctypes.c_longlong * len(PLAN_FIELDS))(*(p[k] for k in PLAN_FIELDS)),
            PATHS[p["path"]])
    return packed


def _launch(x: torch.Tensor, y: torch.Tensor, kernel: int,
            stride: int) -> tuple:
    packed, path = _launch_plan(x, kernel, stride)
    stream = _device.current_stream(x.get_device())
    return _kernel()(x.data_ptr(), y.data_ptr(), packed, stream), path


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
    fmt = (torch.channels_last if channels_fastest(x.stride())
           else torch.contiguous_format)
    if B * C * Ho * Wo == 0:
        return torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype,
                           memory_format=fmt)
    if x.device.type == "cpu":
        return softpool_2x2_reference(x, kernel, stride)
    y = torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype,
                    memory_format=fmt)
    if x.get_device() == torch.cuda.current_device():
        rc, path = _launch(x, y, kernel, stride)
    else:
        with torch.cuda.device(x.device):
            rc, path = _launch(x, y, kernel, stride)
    if rc != 0:
        raise RuntimeError(f"softpool kernel launch failed: CUDA error {rc}")
    softpool_2x2.launches += 1
    softpool_2x2.path_launches[path] += 1
    return y


softpool_2x2.launches = 0
softpool_2x2.path_launches = dict.fromkeys(PATHS, 0)
