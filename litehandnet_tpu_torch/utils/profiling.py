"""Profiling and determinism helpers (port of
``litehandnet_tpu/utils/profiling.py``; the reference had thop/torchstat FPS
loops and the seed controls of utils/training_kits.py:12-31).

``trace`` records a ``torch.profiler`` trace (host and, where CUDA is
available, the card's kernels) and writes it as a Chrome/Perfetto json.

``span(name, device)`` marks a stretch of the program (the serve path's
``lhn.serve``, ``lhn.serve.input``, ``lhn.serve.forward``, ``lhn.decode``,
``lhn.decode.refine``). It records only while a ``torch.profiler`` session
records (``trace`` or any other): then it is a ``record_function`` on the
profiler's timeline, the host's clock at entry and exit, a pair of timing
events on a CUDA device's current stream, and the span open on the same
thread at entry; ``spans()`` returns what was recorded, ``trace`` forgets
what came before it. Otherwise a span is one read of the profiler's flag.
The benchmark's per-layer serve metrics read ``spans()`` after its profiled
requests: ``input_ms``, ``forward_ms``, ``decode_device_ms`` and
``refine_ms`` the device's busy time inside a span (its events placed on the
profiler's kernel timeline), ``forward_enqueue_ms`` a span's host time,
``request_gap_ms`` the time between two requests' events (each ``.serve``,
``perfbench/metrics/``). While a CUDA graph is captured (``cut_at_spans``,
``utils/cuda_graphs``) a span that does not record tells the capture where
it opens and closes, and the replay enters and exits it between the graphs.

``cost_analysis`` counts FLOPs with ``FlopCounterMode`` (2 per multiply-add
of the convolutions and matrix products), as ``tools/benchmark`` does; JAX
takes XLA's cost analysis, so the two counts are not expected to agree.
"""

from __future__ import annotations

import collections
import contextlib
import os
import random
import threading
import time
from dataclasses import dataclass
from typing import Deque, Dict, List, Mapping, Optional

import numpy as np
import torch

from litehandnet_tpu_torch.kernels._build import BUILD_DIR

DEFAULT_TRACE_DIR = str(BUILD_DIR / "trace")


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR):
    """Profile the block, the card's kernels too where CUDA is available;
    on exit write ``<log_dir>/trace.json``. The spans recorded before are
    forgotten, so ``spans()`` holds the block's.

    Yields:
        the ``torch.profiler.profile``; its ``events()`` and
        ``key_averages()`` hold the trace once the block has ended.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset()
    prof = profile(activities=activities)
    with prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@dataclass(frozen=True)
class Span:
    """One finished span.

    ``device_ms`` is the extent on the device's stream from the entry event
    to the exit event (``host_ms`` on the CPU, whose ops run synchronously);
    ``device_start_ms`` the entry on the same clock, in ms after the first
    span of that device recorded since the last ``reset``; ``device_gap_ms``,
    for a root span, the time from the previous root of the same name's
    exit to this one's entry (None for the first root and for nested
    spans)."""

    name: str
    parent: Optional[str]
    host_ms: float
    device_ms: float
    device_start_ms: float
    device_gap_ms: Optional[float]


class _Open:
    """A span as it is recorded: entered, and exited once ``t1`` is set."""

    __slots__ = ("name", "device", "parent", "clock", "stream", "mark", "t0",
                 "t1", "e0", "e1")

    def __init__(self, name: str, device):
        self.name, self.device = name, device
        self.t1 = self.e0 = self.e1 = None

    def __enter__(self):
        stack = getattr(_OPEN, "stack", None)
        if stack is None:
            stack = _OPEN.stack = []
        self.parent = stack[-1].name if stack else None
        stack.append(self)
        _RECORDED.append(self)
        self.clock = "host"
        if self.device is not None and torch.device(self.device).type == "cuda":
            self.stream = torch.cuda.current_stream(self.device)
            self.clock = str(self.stream.device)
            self.e0 = torch.cuda.Event(enable_timing=True)
            self.e1 = torch.cuda.Event(enable_timing=True)
        self.mark = torch.profiler.record_function(self.name)
        self.mark.__enter__()
        self.t0 = time.perf_counter_ns()
        if self.e0 is not None:
            self.e0.record(self.stream)
        return self

    def __exit__(self, *exc):
        if self.e1 is not None:
            self.e1.record(self.stream)
        self.t1 = time.perf_counter_ns()
        _OPEN.stack.remove(self)
        self.mark.__exit__(*exc)
        return False


class _Cut:
    """A span met while ``cut_at_spans`` is on: its entry and exit go to
    the callback, ``("enter", name, device)`` and ``("exit",)``."""

    __slots__ = ("name", "device", "callback")

    def __init__(self, name: str, device, callback):
        self.name, self.device, self.callback = name, device, callback

    def __enter__(self):
        self.callback(("enter", self.name, self.device))
        return self

    def __exit__(self, *exc):
        self.callback(("exit",))
        return False


# in the order the spans were entered; the oldest go first past the bound
_RECORDED: Deque[_Open] = collections.deque(maxlen=1 << 16)
_OPEN = threading.local()       # .stack: the spans open on this thread
_OFF = contextlib.nullcontext()
_profiler = torch.autograd.profiler
_cut = None     # (thread ident, callback) inside ``cut_at_spans``


def span(name: str, device=None):
    """A context manager marking the block as the span ``name``, on
    ``device`` (None: the host).

    Off unless a ``torch.profiler`` session records, and then the same
    shared no-op context every time. On, see the module's docstring; the
    span closes when the block raises too. Inside ``cut_at_spans`` and
    while no profiler records, the span tells that block's callback where
    it opens and closes."""
    if not _profiler._is_profiler_enabled:
        if _cut is None or _cut[0] != threading.get_ident():
            return _OFF
        return _Cut(name, device, _cut[1])
    return _Open(name, device)


@contextlib.contextmanager
def cut_at_spans(callback):
    """Inside the block, on this thread, each span that does not record
    calls ``callback(("enter", name, device))`` at its entry and
    ``callback(("exit",))`` at its exit. A CUDA graph capture cuts its
    graph there (``utils/cuda_graphs``), so that a replay can enter and
    exit the spans between the graphs."""
    global _cut
    if _cut is not None:
        raise RuntimeError("cut_at_spans is already on")
    _cut = (threading.get_ident(), callback)
    try:
        yield
    finally:
        _cut = None


def spans() -> List[Span]:
    """The finished spans since the last ``reset`` (the latest 65,536), in
    the order they were entered (a span's descendants follow it, before the
    next root), once the device has reached each span's exit."""
    out = []
    last = {}       # clock: (the last entry event or ns, its start ms)
    root_end = {}   # (clock, name): the last root's exit ms
    for rec in list(_RECORDED):
        if rec.t1 is None:
            continue
        host_ms = (rec.t1 - rec.t0) / 1e6
        prev = last.get(rec.clock)
        if rec.e0 is not None:
            rec.e1.synchronize()
            device_ms = rec.e0.elapsed_time(rec.e1)
            # chained entry to entry: each step short, so float32 ms stay fine
            start = 0.0 if prev is None else prev[1] + prev[0].elapsed_time(
                rec.e0)
            last[rec.clock] = (rec.e0, start)
        else:
            device_ms = host_ms
            start = 0.0 if prev is None else prev[1] + (rec.t0 - prev[0]) / 1e6
            last[rec.clock] = (rec.t0, start)
        gap = None
        if rec.parent is None:
            end = root_end.get((rec.clock, rec.name))
            gap = None if end is None else start - end
            root_end[(rec.clock, rec.name)] = start + device_ms
        out.append(Span(rec.name, rec.parent, host_ms, device_ms, start, gap))
    return out


def reset() -> None:
    """Forget every recorded span."""
    _RECORDED.clear()


def device_kernel_names(prof) -> list:
    """Names of the kernels a finished ``trace`` saw run on the card (not
    the spans' marks that the profiler projects onto the card's timeline)."""
    from torch.autograd import DeviceType

    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)]


def cost_analysis(fn, *args) -> dict:
    """FLOPs of one call ``fn(*args)``, in total (``flops``) and per
    operator (``flops_by_operator``), without gradients."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return dict(flops=float(counter.get_total_flops()),
                flops_by_operator=by_op)


def set_seeds(seed: int = 0, rank_offset: Optional[int] = None) -> int:
    """Seed python, numpy and torch with ``seed + 1 + rank_offset``
    (reference training_kits.py:12-31 and the per-rank offset of
    distributed_utils.py:23); ``rank_offset`` defaults to this process's
    ``torch.distributed`` rank, 0 outside a process group. Returns the
    seed used."""
    if rank_offset is None:
        dist = torch.distributed
        rank_offset = (dist.get_rank()
                       if dist.is_available() and dist.is_initialized() else 0)
    effective = seed + 1 + rank_offset
    random.seed(effective)
    np.random.seed(effective)
    torch.manual_seed(effective)
    return effective


def parameter_histograms(params: Mapping[str, torch.Tensor],
                         bins: int = 50) -> Dict[str, dict]:
    """Per parameter: a ``bins``-bin histogram (``hist``, ``edges``), its
    mean and its standard deviation (reference utils/weight_analysis.py), on
    the parameter's device. The edges are ``np.histogram``'s (an even split
    of [min, max] in the parameter's dtype); each value falls in the bin
    with ``edges[i] <= v < edges[i + 1]``, the last bin closed, as there."""
    out = {}
    for name, value in params.items():
        flat = value.detach().reshape(-1)
        ends = torch.stack([flat.min(), flat.max()]).cpu().numpy()
        edges = torch.from_numpy(np.histogram_bin_edges(ends, bins=bins))
        at = torch.bucketize(flat, edges.to(flat.device), right=True) - 1
        hist = torch.bincount(at.clamp_(0, bins - 1), minlength=bins)
        out[name] = dict(hist=hist.tolist(), edges=edges.tolist(),
                         mean=float(flat.double().mean()),
                         std=float(flat.double().std(unbiased=False)))
    return out
