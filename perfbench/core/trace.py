"""Reading the device's timeline from ``torch.profiler``: kernels with their
device times, the busy time (the union of kernel intervals), and the idle
gaps labelled by what the host was doing (the top-level ``aten`` op running
at the gap's middle, under the benchmark's own span).
"""

from __future__ import annotations

import bisect
import time
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Tuple

import torch
from torch.autograd import DeviceType

COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")


@dataclass
class Trace:
    """One profiled stretch of ``calls`` calls of the timed path."""

    calls: int                          # in each of the two stretches
    window_s: float                     # host clock around the counted calls
    kernels: List[Tuple[str, float, float]]   # (name, start us, end us)
    copies: List[Tuple[str, float, float]]
    busy_s: float
    gaps: Dict[str, float] = field(default_factory=dict)

    def kernel_times(self, part: str) -> List[float]:
        """Device seconds of each kernel whose name holds ``part``."""
        return [(e - s) / 1e6 for n, s, e in self.kernels if part in n]

    def device_ops(self, top: int = 10) -> List[list]:
        total: Dict[str, float] = {}
        for n, s, e in self.kernels + self.copies:
            total[n[:160]] = total.get(n[:160], 0.0) + (e - s) / 1e6
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])
                [:top]]

    def idle_gaps(self, top: int = 10) -> List[list]:
        return [[n, t] for n, t in sorted(self.gaps.items(),
                                          key=lambda kv: -kv[1])[:top]]


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def _profiled(call: Callable[[int], None], first: int, calls: int, span: str,
              device: torch.device, activities):
    """``call(first + i)`` for i < ``calls`` under ``torch.profiler`` with
    ``activities``, each inside a ``record_function(span)``: (the events,
    the host seconds from the first call to the synchronize after the
    last)."""
    from torch.profiler import record_function

    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with torch.profiler.profile(activities=activities) as prof:
        t0 = time.perf_counter()
        for i in range(calls):
            with record_function(span):
                call(first + i)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        window_s = time.perf_counter() - t0
    return prof.events(), window_s


def _device_events(events, span: str):
    """(kernels, copies) of the device's timeline, each (name, start us,
    end us)."""
    kernels, copies = [], []
    for e in events:
        if e.device_type != DeviceType.CUDA:
            continue
        if e.name == span or getattr(e, "is_user_annotation", False):
            continue    # the span's own mark on the device's timeline
        (copies if e.name.startswith(COPY_PREFIXES) else kernels).append(
            (e.name, e.time_range.start, e.time_range.end))
    return kernels, copies


def profile(call: Callable[[int], None], calls: int, span: str,
            device: torch.device) -> Trace:
    """Two profiled stretches of ``calls`` calls each, ``call(i)`` then
    ``call(calls + i)``. The counted one records the device's activity
    alone (on a CUDA device): its kernels, busy time and window; it still
    slows a host-bound call (a batch-1 request on the H100 by a quarter to
    four fifths), so readers take a call's time from the unprofiled
    window. The labelled one records the host's ops as well, which slows
    such a call more: its idle gaps, labelled by what the host was doing,
    go into the breakdown and nowhere else."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    counted = [ProfilerActivity.CUDA] if cuda else [ProfilerActivity.CPU]
    labelled = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                         else [])
    events, window_s = _profiled(call, 0, calls, span, device, counted)
    kernels, copies = _device_events(events, span)
    busy = _union([(s, e) for _, s, e in kernels + copies])
    events, _ = _profiled(call, calls, calls, span, device, labelled)
    spans, host_ops = [], []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            continue
        start, end = e.time_range.start, e.time_range.end
        if e.name == span:
            spans.append((start, end))
        elif e.name.startswith("aten::"):
            parent = e.cpu_parent
            if parent is None or not parent.name.startswith("aten::"):
                host_ops.append((start, end, e.name))
    k2, c2 = _device_events(events, span)
    gaps = _label_gaps(_union([(s, e) for _, s, e in k2 + c2]), sorted(spans),
                       sorted(host_ops))
    return Trace(calls, window_s, kernels, copies,
                 sum(e - s for s, e in busy) / 1e6, gaps)


def _label_gaps(busy, spans, host_ops) -> Dict[str, float]:
    """Idle seconds between the device's busy intervals, inside the
    profiled calls, summed by ``<span>/<top-level aten op at the gap's
    middle>`` (``<span>/host`` where no op ran, ``between calls`` outside
    every span)."""
    if not spans:
        return {}
    lo, hi = spans[0][0], spans[-1][1]
    edges = [lo] + [t for s, e in busy for t in (s, e)] + [hi]
    span_starts = [s for s, _ in spans]
    op_starts = [s for s, _, _ in host_ops]
    gaps: Dict[str, float] = {}
    for a, b in zip(edges[0::2], edges[1::2]):
        a, b = max(a, lo), min(b, hi)
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        i = bisect.bisect_right(span_starts, mid) - 1
        if i < 0 or spans[i][1] < mid:
            label = "between calls"
        else:
            j = bisect.bisect_right(op_starts, mid) - 1
            op = (host_ops[j][2] if j >= 0 and host_ops[j][1] >= mid
                  else "host")
            label = f"call/{op}"
        gaps[label] = gaps.get(label, 0.0) + (b - a) / 1e6
    return gaps
