"""Per-device facts and scratch memory shared by the kernel wrappers.

``sm_count`` reads a card's SM count once; ``current_stream`` gives the raw
handle of a device's current stream. ``stream_and_scratch`` gives the
current stream and one zero-initialised byte buffer per (device, stream),
grown when a launch needs more: the kernels that merge partials across
blocks in one launch keep their tickets in it and leave them at zero, so a
buffer is zeroed only when it is made. Launches on one stream run in order,
so they may share its buffer; another stream gets its own.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

_SM_COUNT: Dict[int, int] = {}
_SCRATCH: Dict[Tuple[int, int], torch.Tensor] = {}


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
