"""What the per-layer readers (``metrics/<name>.py``) share. A reader takes
the run and returns a number, or None where the run has nothing for it to
read; the harness then leaves the metric out of the line."""

from __future__ import annotations

import json
import statistics
from typing import Optional

from perfbench.core import flops, peaks, spec
from perfbench.core.run_context import Run


def span_ms(run: Run, span: str) -> Optional[float]:
    """Mean milliseconds of the benchmark's span ``span`` (each closed by a
    synchronize)."""
    times = run.spans.get(span)
    return statistics.mean(times) * 1e3 if times else None


def kernels_per_call(run: Run) -> Optional[float]:
    """Device kernels (copies and sets left out) per profiled call."""
    t = run.traced
    if t is None or not t.kernels:
        return None
    return len(t.kernels) / t.calls


def idle_pct(run: Run) -> Optional[float]:
    """Share of a call's time with no kernel or copy running on the
    device: the profiled calls' busy time per call, over the unprofiled
    window's seconds per call (the profiler slows the host, not the
    device's work)."""
    t = run.traced
    if t is None or not t.kernels or not run.call_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.calls / run.call_s)


def mfu_pct(run: Run, mode: str) -> Optional[float]:
    """The reference's operations per image times the window's images a
    second, over the configuration's peak for ``mode`` (``serve`` or
    ``train``)."""
    if run.rate is None:
        return None
    cfg = run.cell.port_config(run.overrides)
    per_image = flops.per_image(
        run.cell.config["reference"],
        json.dumps(run.cell.model_spec(run.overrides), sort_keys=True),
        tuple(cfg.DATASET.image_size), mode == "train")
    return 100.0 * per_image * run.rate / run.cell.config[mode]["peak_flops"]


def roofline_pct(run: Run, kernel: str, part: str, shapes, dtype_bytes: int
                 ) -> Optional[float]:
    """The least time the H100 could take for ``kernel`` at each of
    ``shapes`` (one launch each, per call), from ``costs/<kernel>.py`` and
    the peaks, over the device time of the profiled launches whose names
    hold ``part``. None when the trace has not exactly one launch per shape
    and call."""
    t = run.traced
    if t is None:
        return None
    times = t.kernel_times(part)
    if not times or len(times) != len(shapes) * t.calls:
        return None
    cost = spec.module("costs", kernel)
    least = 0.0
    for shape in shapes:
        nbytes, ops = cost.bytes_moved(shape, dtype_bytes), cost.operations(shape)
        least += max(nbytes / peaks.HBM_BYTES_PER_S, ops / peaks.FLOPS["fp32"])
    return 100.0 * least * t.calls / sum(times)
