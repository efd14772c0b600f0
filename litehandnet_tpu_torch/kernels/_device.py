"""Per-device facts, scratch memory and the launch protocol (``Kernel``)
shared by the kernel wrappers.

``sm_count`` reads a card's SM count once; ``current_stream`` gives the raw
handle of a device's current stream. ``stream_and_scratch`` gives the
current stream and one zero-initialised byte buffer per (device, stream),
grown when a launch needs more: the kernels that merge partials across
blocks in one launch keep their tickets in it and leave them at zero, so a
buffer is zeroed only when it is made. Launches on one stream run in order,
so they may share its buffer; another stream gets its own.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from litehandnet_tpu_torch.kernels import _build

_SM_COUNT: Dict[int, int] = {}
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # as the kernels read them
MAX_SMEM_BYTES = 232448  # shared memory a block may use on Hopper (227 KB)
ALIGN = 256             # scratch regions start on this many bytes
PTR = ctypes.c_void_p   # an entry point's pointer or stream argument
PLAN = ctypes.POINTER(ctypes.c_longlong)         # its packed plan


def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of the CUDA card ``device``."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    count = _SM_COUNT.get(index)
    if count is None:
        count = _SM_COUNT[index] = torch.cuda.get_device_properties(
            index).multi_processor_count
    return count


def current_stream(index: int) -> int:
    """The current stream of CUDA device ``index`` as a ``cudaStream_t``
    int."""
    # the raw handle: torch.cuda.current_stream() builds a Stream object,
    # several microseconds a call
    return torch._C._cuda_getCurrentRawStream(index)


def stream_and_scratch(index: int, nbytes: int) -> Tuple[int, int]:
    """(the current stream of CUDA device ``index`` as a ``cudaStream_t``
    int, the address of a zero-initialised buffer of at least ``nbytes`` for
    launches on it)."""
    stream = current_stream(index)
    key = (index, stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < nbytes:
        # the caching allocator hands the old block to this stream's later
        # work only, so a launch still reading it is safe
        buf = _SCRATCH[key] = torch.zeros(
            max(nbytes, 1 << 16), dtype=torch.uint8,
            device=torch.device("cuda", index))
    return stream, buf.data_ptr()


def blocks_for(tiles: int, target: int) -> int:
    """Blocks for ``tiles`` work items with about ``target`` blocks on the
    card: no more than the items, and as few as give each block the same
    number of rounds (a 2,048-tile grid of 264 blocks takes 8 rounds, as
    does one of 256)."""
    rounds = -(-tiles // max(1, target))
    return -(-tiles // rounds)


def _align(n: int) -> int:
    return -(-n // ALIGN) * ALIGN


def scratch_layout(groups: int, parts: int, width: int) -> Dict[str, int]:
    """Byte offsets of the cross-block merge's scratch (tickets, counts,
    means, M2s) and its size, for ``groups`` channel groups of ``width``
    channels and ``parts`` blocks each (``csrc/stats_merge.cuh``)."""
    n = _align(4 * groups)
    mean = _align(n + 8 * groups * parts)
    m2 = _align(mean + 4 * groups * parts * width)
    return dict(tickets=0, n=n, mean=mean, m2=m2,
                nbytes=m2 + 4 * groups * parts * width)


class Kernel:
    """The launch protocol of ``csrc/<name>.cu``'s entry point ``entry``,
    bound by ``_build.bind`` at the first launch, once the library's
    function ``fields`` counts ``plan_fields`` and every probe agrees.
    ``make(x, dtype, aligned, *extra)`` gives the plan of CUDA tensor ``x``:
    a dict holding ``plan_fields``, or None where the kernel does not take
    x."""

    def __init__(self, name: str, entry: str, fields: str,
                 plan_fields: Sequence[str], argtypes: Sequence,
                 make: Callable[..., Optional[dict]],
                 probes: Sequence[_build.Probe] = ()):
        self.name, self.entry, self.argtypes = name, entry, argtypes
        self.probes = [(fields, ctypes.c_int, (), len(plan_fields)), *probes]
        self.plan_fields, self.make = plan_fields, make
        self.plans: Dict[tuple, Optional[tuple]] = {}
        self.fn = None

    def plan(self, x: torch.Tensor, *extra, dtype=None) -> Optional[tuple]:
        """(the plan of ``x`` as a ctypes int64 array, the plan), or None
        where ``make`` declines it; cached by shape, strides, dtype, device,
        16-byte alignment and ``extra``. ``dtype``: that of a fresh cast of
        x with x's strides, where x is to be cast before the launch."""
        if dtype is None or dtype == x.dtype:
            dtype, aligned = x.dtype, x.data_ptr() % 16 == 0
        else:
            aligned = True
        key = (x.shape, x.stride(), dtype, x.get_device(), aligned, *extra)
        try:
            return self.plans[key]
        except KeyError:
            p = self.make(x, dtype, aligned, *extra)
        packed = self.plans[key] = None if p is None else (
            (ctypes.c_longlong * len(self.plan_fields))(
                *(p[k] for k in self.plan_fields)), p)
        return packed

    def launch(self, index: int, *args) -> None:
        """Call the entry point with ``args`` while CUDA device ``index`` is
        current. Raises RuntimeError where the library disagrees with the
        wrapper or the launch returns a CUDA error."""
        fn = self.fn
        if fn is None:
            fn = self.fn = _build.bind(self.name, self.entry, self.argtypes,
                                       self.probes)
        if index == torch.cuda.current_device():
            rc = fn(*args)
        else:
            with torch.cuda.device(index):
                rc = fn(*args)
        if rc != 0:
            raise RuntimeError(f"{self.name} kernel launch failed: CUDA "
                               f"error {rc}")
