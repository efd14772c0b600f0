"""Per-channel BatchNorm batch statistics kernel.

Replaces the Pallas TPU kernel ``litehandnet_tpu/ops/fused_bn.py::moments``
(:129, ``_pallas_moments`` :82, body ``_moments_kernel`` :53) with the
hand-written CUDA C++ kernel ``csrc/moments.cu`` for Hopper (``sm_90a``),
built with ``nvcc`` at first use and bound through ctypes.

For ``x`` of shape ``[N, C, H, W]`` (float32 or bfloat16) it gives the
float32 per-channel mean and biased variance over N, H and W: the JAX
function over the NHWC view. Each thread takes an exact two-pass over its
rows of a tile and folds it into running statistics by Chan's update; blocks
merge in a fixed order inside the one launch (``csrc/stats_merge.cuh``),
never E[x^2] - E[x]^2, and the same input gives the same bits.

Bound: memory. At the flagship's largest site, ``[32, 128, 64, 64]`` float32,
it reads 67.1 MB once, 20.0 us at 3.35 TB/s, against about 4 FP32 operations
per element; 28 of its 33 train-step sites read 4.2 MB or less, where the
launch and this wrapper's host time weigh more than the bytes. ``plan``
sizes the grid to the SM count and picks the vector path (16-byte loads,
channels_last) or the scalar path (any strides) with the same partition.
Measured (``chip_smoke.py``, NVIDIA H100 80GB HBM3 at 700 W, float32
channels_last, device time per call): 33.3 us at ``[32, 128, 64, 64]``, 12.7
/ 10.3 / 7.1 / 5.6 us at the 32^2 / 16^2 / 8^2 / 1^2 sites; 22 to 33 us of
host time per call. Per site and per train step: ``PERF.md`` section 6.

``moments`` launches the kernel for a CUDA tensor and uses the plain
version, ``moments_reference``, only for a CPU tensor. It counts launches in
``moments.launches``. The differentiable entry point the port's
BatchNorm calls is ``ops.fused_bn.moments``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Sequence, Tuple

import torch

from litehandnet_tpu_torch.kernels import _build, _device

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
THREADS = 256           # threads per block (csrc/stats_merge.cuh kThreads)
ROWS_PER_THREAD = 8     # rows a thread reads per tile (csrc/moments.cu)
MAX_LANES = 32          # channel vectors per block: one warp across a row
# blocks the plan aims at per SM: one measured faster than two (fewer
# partials for the last block to merge, PERF.md section 6)
BLOCKS_PER_SM = 1
ALIGN = 256             # scratch regions start on this many bytes


def moments_reference(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: float32 two-pass mean and biased variance over
    dims (0, 2, 3) of ``[N, C, H, W]``."""
    xf = x.float()
    mean = xf.mean(dim=(0, 2, 3))
    var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
    return mean, var


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def scratch_layout(groups: int, parts: int, width: int) -> Dict[str, int]:
    """Byte offsets of the merge's scratch (tickets, counts, means, M2s) and
    its size, for ``groups`` channel groups of ``width`` channels and
    ``parts`` blocks each; shared with ``dw_conv3x3_stats``."""
    n = _align(4 * groups)
    mean = _align(n + 8 * groups * parts)
    m2 = _align(mean + 4 * groups * parts * width)
    return dict(tickets=0, n=n, mean=mean, m2=m2,
                nbytes=m2 + 4 * groups * parts * width)


def blocks_for(tiles: int, target: int) -> int:
    """Blocks for ``tiles`` work items with about ``target`` blocks on the
    card: no more than the items, and as few as give each block the same
    number of rounds (a 2,048-tile grid of 264 blocks takes 8 rounds, as
    does one of 256)."""
    rounds = -(-tiles // max(1, target))
    return -(-tiles // rounds)


def row_stride(shape: Sequence[int], strides: Sequence[int]):
    """The element stride R with which row m = (n, h, w) of ``[N, C, H, W]``
    starts at m * R, or None where the rows are not evenly spaced."""
    N, C, H, W = shape
    sn, _, sh, sw = strides
    R = sw if W > 1 else sh if H > 1 else sn if N > 1 else C
    ok = ((W == 1 or sw == R) and (H == 1 or sh == W * R)
          and (N == 1 or sn == H * W * R))
    return R if ok else None


def plan(shape: Sequence[int], dtype: torch.dtype, strides: Sequence[int],
         sm_count: int, aligned: bool = True) -> Dict[str, int]:
    """The launch of ``csrc/moments.cu`` for ``x`` of this shape, dtype and
    element strides on a card of ``sm_count`` SMs; ``aligned``: whether x
    starts on a 16-byte boundary.

    A thread owns ``vec`` channels (16 bytes); ``lanes`` such vectors make a
    block's channel group, ``slots = 256 / lanes`` row slots read ``tile_rows
    = slots * ROWS_PER_THREAD`` rows per tile; ``grid_x`` blocks walk the
    ``tiles``, ``groups`` channel groups make grid.y. ``row_stride`` > 0 picks
    the vector path, 0 the scalar path; nothing else depends on the strides,
    so both paths read the same partition.
    """
    N, C, H, W = shape
    vec = 16 // dtype.itemsize
    vectors = -(-C // vec)
    lanes = min(MAX_LANES, 1 << (vectors - 1).bit_length())
    groups = -(-vectors // lanes)
    slots = THREADS // lanes
    tile_rows = slots * ROWS_PER_THREAD
    M = N * H * W
    tiles = -(-M // tile_rows)
    grid_x = blocks_for(tiles, BLOCKS_PER_SM * sm_count)
    R = row_stride(shape, strides)
    vector = (C % vec == 0 and (strides[1] == 1 or C == 1) and R is not None
              and R % vec == 0 and aligned)
    width = lanes * vec
    return dict(dtype=DTYPES[dtype], N=N, C=C, H=H, W=W,
                **dict(zip(("sn", "sc", "sh", "sw"), strides)),
                vec=vec, lanes=lanes, lanes_log2=lanes.bit_length() - 1,
                slots=slots, groups=groups, width=width, rows=M,
                tile_rows=tile_rows, tiles=tiles, grid_x=grid_x,
                row_stride=R if vector else 0,
                **{f"scratch_{k}": v for k, v in
                   scratch_layout(groups, grid_x, width).items()})


# The plan as ``lhn_moments`` reads it: one int64 each, in this order
# (csrc/moments.cu ``enum Plan``).
PLAN_FIELDS = ("dtype", "N", "C", "H", "W", "sn", "sc", "sh", "sw",
               "row_stride", "lanes_log2", "tiles", "grid_x", "groups",
               "scratch_n", "scratch_mean", "scratch_m2")

_PLANS: Dict[tuple, tuple] = {}


def _launch_plan(x: torch.Tensor) -> tuple:
    """(the plan of ``x`` as a ctypes int64 array, scratch bytes), cached by
    shape, strides, dtype, device and alignment."""
    aligned = x.data_ptr() % 16 == 0
    key = (x.shape, x.stride(), x.dtype, x.get_device(), aligned)
    packed = _PLANS.get(key)
    if packed is None:
        p = plan(x.shape, x.dtype, x.stride(), _device.sm_count(x.device),
                 aligned)
        packed = _PLANS[key] = (
            (ctypes.c_longlong * len(PLAN_FIELDS))(*(p[k] for k in PLAN_FIELDS)),
            p["scratch_nbytes"])
    return packed


@functools.cache
def _kernel():
    """``lhn_moments`` of the built library, argument types declared."""
    lib = _build.load("moments")
    if (lib.lhn_moments_rows_per_thread() != ROWS_PER_THREAD
            or lib.lhn_moments_plan_fields() != len(PLAN_FIELDS)):
        raise RuntimeError("csrc/moments.cu and kernels/moments.py disagree "
                           "on the launch plan")
    fn = lib.lhn_moments
    # without argtypes ctypes passes every int as a 32-bit C int and cuts
    # the pointers
    p = ctypes.c_void_p
    fn.argtypes = [p, ctypes.POINTER(ctypes.c_longlong), p, p, p]
    fn.restype = ctypes.c_int
    return fn


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


def _launch(x: torch.Tensor, stats: torch.Tensor) -> int:
    packed, nbytes = _launch_plan(x)
    stream, scratch = _device.stream_and_scratch(x.get_device(), nbytes)
    return _kernel()(x.data_ptr(), packed, scratch, stats.data_ptr(), stream)


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
    # one allocation: mean and var are its two rows
    stats = x.new_empty((2, x.shape[1]), dtype=torch.float32)
    if x.get_device() == torch.cuda.current_device():
        rc = _launch(x, stats)
    else:
        with torch.cuda.device(x.device):
            rc = _launch(x, stats)
    if rc != 0:
        raise RuntimeError(f"moments kernel launch failed: CUDA error {rc}")
    moments.launches += 1
    return stats.unbind(0)


moments.launches = 0
