"""The program's own spans (``litehandnet_tpu_torch.utils.profiling``), as
the per-layer readers of the serve cells take them.

Spans record only under ``torch.profiler``. ``trace.profile`` runs two
stretches of ``run.traced.calls`` requests, the counted one (the device's
activity alone) and then the labelled one, and nothing after them records.
So the counted stretch's requests are the last ``2 calls`` ``lhn.serve``
roots but the last ``calls``, each followed by its descendants, whatever
the process recorded before. A program without spans, or a run without a
trace, gives None.

A span's device time (``busy_ms``) is the time the device ran kernels or
copies inside it: the counted stretch's kernels and copies
(``run.traced``), clipped to the span's entry and exit events. The events'
clock is put on the kernels' by one offset (``offset_us``). On the CPU,
whose ops run in turn, it is the span's extent.
"""

from __future__ import annotations

import statistics
from typing import List, Optional, Sequence, Tuple

import numpy as np

from perfbench.core.trace import _union

ROOT = "lhn.serve"
STEP_US = 0.25      # the grid the offset is searched on
SEARCH_US = 2000.0  # how far before the first op the first entry may lie
SLACK_US = 1.0      # an event this close to an op's edge is not inside it


def requests(run) -> Optional[List[list]]:
    """The counted stretch's requests, each its ``lhn.serve`` span and then
    the spans inside it; None unless both stretches recorded every
    request."""
    t = run.traced
    if t is None:
        return None
    from litehandnet_tpu_torch.utils import profiling

    recorded = getattr(profiling, "spans", None)
    if recorded is None:
        return None
    groups: List[list] = []
    current = None
    for s in recorded():
        if s.parent is None:
            current = [s] if s.name == ROOT else None
            if current is not None:
                groups.append(current)
        elif current is not None:
            current.append(s)
    if len(groups) < 2 * t.calls:
        return None
    return groups[-2 * t.calls:len(groups) - t.calls]


def mean_ms(run, name: str, clock: str = "device") -> Optional[float]:
    """Mean milliseconds of span ``name`` per counted request, its extent
    on the device's stream (``clock="device"``) or on the host's clock
    (``"host"``); None where no request recorded it."""
    groups = requests(run)
    if groups is None or not any(s.name == name for g in groups for s in g):
        return None
    field = f"{clock}_ms"
    return statistics.mean(sum(getattr(s, field) for s in g if s.name == name)
                           for g in groups)


def offset_us(marks: Sequence[float], starts: np.ndarray,
              ends: np.ndarray) -> float:
    """The offset that puts span events, at ``marks`` us on their own clock
    with the first entry at 0, on the timeline of ops ``starts``..``ends``
    (us, sorted by start).

    A stream runs its ops and events in turn, so no event lies inside an
    op; and the first op comes after the first entry. Of the offsets on a
    ``STEP_US`` grid up to ``starts[0]``, those that put the fewest
    microseconds of events inside ops (past ``SLACK_US`` of an edge) form
    bands; the middle of the latest band. Where the device runs behind the
    host, an event sits between two ops, so the band is as narrow as the
    gaps beside such events."""
    marks = np.asarray(marks, dtype=np.float64)
    top = np.maximum.accumulate(ends)
    tried = starts[0] - np.arange(0.0, SEARCH_US, STEP_US)
    at = tried[:, None] + marks[None, :]
    i = np.searchsorted(starts, at, side="right") - 1
    j = np.maximum(i, 0)
    depth = np.where(i >= 0, np.minimum(at - starts[j], top[j] - at), 0.0)
    inside = np.clip(depth - SLACK_US, 0.0, None).sum(axis=1)
    first = int(np.argmin(inside))
    band = inside[first:] == inside[first]
    width = band.size if band.all() else int(np.argmin(band))
    return float(0.5 * (tried[first] + tried[first + width - 1]))


def busy_in(groups: List[list], ops: List[Tuple[float, float]],
            name: str) -> float:
    """Mean device ms per request that ``ops`` (start, end us) run inside
    the spans ``name`` of ``groups``, placed by ``offset_us``."""
    origin = groups[0][0].device_start_ms
    marks = [1e3 * (s.device_start_ms - origin + d)
             for g in groups for s in g for d in (0.0, s.device_ms)]
    ops = sorted(ops)
    starts = np.array([s for s, _ in ops])
    ends = np.array([e for _, e in ops])
    c = offset_us(marks, starts, ends)
    busy = np.array(_union(ops)).reshape(-1, 2)
    per_request = []
    for g in groups:
        total = 0.0
        for s in g:
            if s.name != name:
                continue
            a = c + 1e3 * (s.device_start_ms - origin)
            b = a + 1e3 * s.device_ms
            total += np.clip(np.minimum(busy[:, 1], b)
                             - np.maximum(busy[:, 0], a), 0.0, None).sum()
        per_request.append(total / 1e3)
    return statistics.mean(per_request)


def busy_ms(run, name: str) -> Optional[float]:
    """Mean device ms per counted request that kernels and copies ran inside
    span ``name`` (its extent on the CPU); None where no request recorded
    it or the trace holds no op."""
    groups = requests(run)
    if groups is None or not any(s.name == name for g in groups for s in g):
        return None
    if run.device.type != "cuda":
        return mean_ms(run, name)
    t = run.traced
    ops = [(s, e) for _, s, e in t.kernels + t.copies]
    return busy_in(groups, ops, name) if ops else None


def request_gap_ms(run) -> Optional[float]:
    """Mean device milliseconds from one counted request's end to the next
    one's start (``device_gap_ms`` of the roots after the first)."""
    groups = requests(run)
    if groups is None:
        return None
    gaps = [g[0].device_gap_ms for g in groups[1:]
            if g[0].device_gap_ms is not None]
    return statistics.mean(gaps) if gaps else None
