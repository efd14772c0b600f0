"""The per-layer metrics read from the program's own spans and build
counters: a traced run reads each as a number, and a request's parts add up
to what the counted stretch's window gives a call; an untraced run records
no span; a program without them gives no reading and no error."""

import math
import random

import numpy as np
import pytest

from litehandnet_tpu_torch.kernels import _build
from litehandnet_tpu_torch.utils import profiling
from perfbench.core import result, spans, spec

from conftest import small_run

NEW = ["input_ms.serve", "forward_ms.serve", "forward_enqueue_ms.serve",
       "decode_device_ms.serve", "refine_ms.serve", "request_gap_ms.serve",
       "kernel_build_s.serve"]


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    """A traced run, after an earlier profiled session of the process left
    two empty ``lhn.serve`` roots behind."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span(spans.ROOT):
                pass
    r = small_run("litehandnet.serve_b128", tmp_path_factory.mktemp("spans"),
                  trace=True, mix={"trace_requests": 4})
    line = result.execute(r)
    yield r, {k: v["value"] for k, v in line["metrics"].items()}
    profiling.reset()


def test_a_traced_run_reads_every_new_metric(traced):
    r, got = traced
    assert {m["name"] for m in r.cell.per_layer} >= set(NEW)
    for name in NEW:
        assert math.isfinite(got[name]), name
        assert got[name] >= 0, name
    assert got["refine_ms.serve"] <= got["decode_device_ms.serve"]


def test_the_counted_requests_are_the_runs_own(traced):
    """The readers take the run's counted stretch, whatever the process
    recorded before it: each request holds the five serve spans."""
    r, _ = traced
    groups = spans.requests(r)
    assert len(groups) == r.traced.calls == 4
    for g in groups:
        assert [s.name for s in g] == ["lhn.serve", "lhn.serve.input",
                                       "lhn.serve.forward", "lhn.decode",
                                       "lhn.decode.refine"]


def _stream(seed: int, shift_us: float):
    """A simulated stream of six requests as the card runs them: the host
    launches ops and records each span's events in turn, the device runs
    each when it is free and the host has sent it, so the device is behind
    the host in the forward and waits for it in the decode and between
    requests. Returns (the requests' spans as the program records them,
    the ops as the trace holds them, ``shift_us`` later, and each span's
    busy ms a request)."""
    rng = random.Random(seed)
    clock = {"host": 0.0, "dev": 0.0}
    ops, open_, busy, records = [], [], {}, []

    def event():
        clock["dev"] = max(clock["dev"], clock["host"])
        return clock["dev"]

    def op(dur, launch):
        clock["host"] += launch
        start = max(clock["dev"], clock["host"])
        clock["dev"] = start + dur
        ops.append((start + shift_us, clock["dev"] + shift_us))
        for rec in open_:
            busy[rec[0]] = busy.get(rec[0], 0.0) + dur

    def enter(name):
        rec = [name, open_[-1][0] if open_ else None, event(), None]
        open_.append(rec)
        records.append(rec)

    def leave():
        open_.pop()[3] = event()

    for _ in range(6):
        enter("lhn.serve")
        op(2.0, 15.0)                                   # the bbox copies
        enter("lhn.serve.input")
        op(480.0, 6.0)
        op(rng.uniform(20, 40), 5.0)
        leave()
        enter("lhn.serve.forward")
        for _ in range(200):
            op(rng.uniform(5, 150), rng.uniform(50, 100))
        leave()
        enter("lhn.decode")
        op(rng.uniform(5, 20), rng.uniform(60, 120))
        enter("lhn.decode.refine")
        for _ in range(30):
            op(rng.uniform(2, 20), rng.uniform(60, 120))
        leave()
        op(rng.uniform(2, 20), rng.uniform(60, 120))
        leave()
        leave()
        op(3.0, 5.0)                                    # the answer's copy
        clock["host"] = clock["dev"] + rng.uniform(50, 150)
    origin = records[0][2]
    groups, end = [], None
    for name, parent, t0, t1 in records:
        gap = None
        if parent is None:
            gap = None if end is None else (t0 - end) / 1e3
            end = t1
            groups.append([])
        groups[-1].append(profiling.Span(name, parent, 0.0, (t1 - t0) / 1e3,
                                         (t0 - origin) / 1e3, gap))
    return groups, ops, {n: v / 6e3 for n, v in busy.items()}


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_busy_time_is_placed_on_the_kernels_timeline(seed):
    """Span events on the device's own clock are put on the trace's by the
    offset that leaves no event inside an op: each span then reads the
    device time of its own ops, however long the device waited inside it."""
    shift = 1.234567e6 + 1000 * seed
    groups, ops, want = _stream(seed, shift)
    first_op = min(s for s, _ in ops)
    starts = np.array(sorted(s for s, _ in ops))
    ends = np.array([e for _, e in sorted(ops)])
    marks = [1e3 * (s.device_start_ms + d) for g in groups for s in g
             for d in (0.0, s.device_ms)]
    assert spans.offset_us(marks, starts, ends) == pytest.approx(
        shift, abs=spans.STEP_US)
    assert first_op - shift > 10        # the first op came after the entry
    for name, ms in want.items():
        assert spans.busy_in(groups, ops, name) == pytest.approx(ms,
                                                                 abs=0.003)
    extent = np.mean([g[3].device_ms for g in groups])
    assert groups[0][3].name == "lhn.decode"
    assert extent > 1.5 * want["lhn.decode"]    # the device waited inside


def test_a_request_adds_up(traced):
    """The parts of a request fit in its ``lhn.serve`` span, and the span
    with the gap to the next one is the counted stretch's time a call."""
    r, got = traced
    serve = spans.mean_ms(r, "lhn.serve")
    parts = (got["input_ms.serve"] + got["forward_ms.serve"]
             + got["decode_device_ms.serve"])
    assert parts <= serve * 1.05
    per_call = 1e3 * r.traced.window_s / r.traced.calls
    assert serve + got["request_gap_ms.serve"] == pytest.approx(per_call,
                                                                rel=0.05)


def test_an_untraced_run_records_no_span(tmp_path):
    profiling.reset()
    r = small_run("litehandnet.serve_b128", tmp_path, trace=False)
    result.execute(r)
    assert profiling.spans() == []
    for name in NEW[:-1]:
        assert spec.module("metrics", name).read(r) is None


def test_a_program_without_spans_reads_nothing(traced, monkeypatch):
    r, _ = traced
    monkeypatch.delattr(profiling, "spans")
    monkeypatch.delattr(_build, "seconds")
    for name in NEW:
        assert spec.module("metrics", name).read(r) is None
