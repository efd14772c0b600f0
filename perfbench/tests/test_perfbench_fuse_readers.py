"""The readers of the ``fuse_sum_relu`` kernel's per-layer metrics,
``fuse_rows_per_batch.serve`` and ``fuse_sum_relu_roofline_pct.serve``, on a
synthetic run: the row counter over the batches served, and the least time
of the counted launches' shapes over their profiled device time; a program
without the kernel or the batch counter reads nothing and raises nothing;
and the bytes of the 42 rows of a Lite-HRNet-30 batch of 512 by hand."""

import sys
from collections import Counter

import pytest

import litehandnet_tpu_torch.kernels  # noqa: F401  (binds the submodules)
from litehandnet_tpu_torch.serve import Predictor
from perfbench.core import peaks, spec
from perfbench.core.trace import Trace

FSR = sys.modules["litehandnet_tpu_torch.kernels.fuse_sum_relu"]
NAME = ("void (anonymous namespace)::fuse_sum_relu_kernel<4, true>("
        "(anonymous namespace)::Row)")
B = 512
E0 = B * 40 * 64 * 64            # branch 0's elements at a batch of 512
WIDTHS = (40, 80, 160, 320)
# row 0 and row 1 of a two-branch module, as the card's autocast gives
# them: a float32 identity, a bfloat16 coarse term entering as float32
ROW0 = ((B, 40, 64, 64, 4), ((40, 64, 64, 4), (40, 32, 32, 2)), True)
ROW1 = ((B, 80, 32, 32, 2), ((80, 32, 32, 2), (80, 32, 32, 2)), False)


class _Run:
    def __init__(self, traced):
        self.traced = traced


def _trace(calls, per_call_us):
    """``calls`` profiled calls, each with kernels of these microseconds
    named as the kernel and an unrelated kernel beside them."""
    kernels, t = [], 0.0
    for _ in range(calls):
        for us in per_call_us:
            kernels.append((NAME, t, t + us))
            t += us + 1.0
        kernels.append(("void at::native::elementwise_kernel", t, t + 50.0))
        t += 51.0
    return Trace(calls=calls, window_s=1.0, kernels=kernels, copies=[],
                 busy_s=t / 1e6)


@pytest.fixture
def counted(monkeypatch):
    """The process served 3 batches, each summing one two-branch module."""
    monkeypatch.setattr(FSR.fuse_sum_relu, "rows", 6)
    monkeypatch.setattr(FSR.fuse_sum_relu, "launches", 6)
    monkeypatch.setattr(FSR.fuse_sum_relu, "shapes",
                        Counter({ROW0: 3, ROW1: 3}))
    monkeypatch.setattr(Predictor, "batches", 3)


def _read(name, run):
    return spec.module("metrics", name).read(run)


def _card_rows():
    """The 42 launches of a Lite-HRNet-30 forward at a batch of 512 as the
    card's autocast keys them: the modules' inputs NCHW, float32 but the
    last branch and, in a stage's first module, the branches its transition
    made (bfloat16); coarse terms and chains bfloat16; the outputs float32
    where a coarse term enters (as float32), the last row's bfloat16."""
    rows = []
    for n, modules, fresh in ((2, 3, (0, 1)), (3, 8, (1, 2)),
                              (4, 3, (2, 3))):
        for m in range(modules):
            sizes = [2 if j == n - 1 or (m == 0 and j in fresh) else 4
                     for j in range(n)]
            for i in range(n):
                C, hw = WIDTHS[i], 64 >> i
                terms = []
                for j in range(n):
                    side = 64 >> max(i, j)
                    size = sizes[i] if j == i else 2
                    terms.append((C, side, side, size))
                out = 4 if i < n - 1 else 2
                rows.append(((B, C, hw, hw, out), tuple(terms), i == 0))
    return rows


def test_costs_by_hand():
    cost = spec.module("costs", "fuse_sum_relu")
    n0 = B * 40 * 64 * 64
    assert cost.bytes_moved(ROW0) == n0 * 4 + B * 40 * 32 * 32 * 2 + 2 * n0 * 4
    assert cost.bytes_moved(ROW1, 2) == 3 * B * 80 * 32 * 32 * 2
    assert cost.operations(ROW0) == 3 * n0


def test_bytes_of_a_batch_of_512_by_hand():
    rows = _card_rows()
    assert len(rows) == 42 and sum(r[2] for r in rows) == 14
    cost = spec.module("costs", "fuse_sum_relu")
    # in units of E0 bytes a row of each module (row 0, row 1, ...):
    # stage 1: the first module's row 0 reads a bfloat16 identity
    stage1 = (2 + 0.5 + 8 + 3) + 2 * (4 + 0.5 + 8 + 3)
    # stage 2: the first module's row 1 reads a bfloat16 identity
    row0 = 4 + 0.5 + 0.125 + 8
    stage2 = (row0 + 4.25 + 2) + 7 * (row0 + 5.25 + 2)
    # stage 3: the first module's row 2 reads a bfloat16 identity
    row0 = 4 + 0.5 + 0.125 + 0.03125 + 8
    stage3 = (row0 + 5.3125 + 2.625 + 1.25) + 2 * (row0 + 5.3125 + 3.125
                                                    + 1.25)
    assert stage1 + stage2 + stage3 == 269.03125
    total = sum(cost.bytes_moved(r) for r in rows)
    assert total == 269.03125 * E0 == 22_567_976_960
    # 6.74 ms of HBM at 3.35 TB/s; the operations take a tenth of that
    assert total / peaks.HBM_BYTES_PER_S == pytest.approx(6.737e-3, rel=1e-3)
    ops = sum(cost.operations(r) for r in rows)
    assert ops / peaks.FLOPS["fp32"] < 0.1 * total / peaks.HBM_BYTES_PER_S


def test_rows_per_batch(counted):
    assert _read("fuse_rows_per_batch.serve", _Run(None)) == 2.0


def test_roofline_over_the_counted_shapes(counted):
    cost = spec.module("costs", "fuse_sum_relu")
    least = sum(cost.bytes_moved(r) for r in (ROW0, ROW1)) / peaks.HBM_BYTES_PER_S
    run = _Run(_trace(4, [600.0, 100.0]))
    want = 100.0 * least / 700e-6
    assert _read("fuse_sum_relu_roofline_pct.serve", run) == pytest.approx(want)
    assert 50.0 < want < 100.0


def test_roofline_reads_nothing_where_the_launches_do_not_fit(counted,
                                                              monkeypatch):
    name = "fuse_sum_relu_roofline_pct.serve"
    # a launch the trace lacks
    assert _read(name, _Run(_trace(4, [600.0]))) is None
    # a shape not launched the same in every batch
    monkeypatch.setattr(FSR.fuse_sum_relu, "shapes",
                        Counter({ROW0: 3, ROW1: 2}))
    assert _read(name, _Run(_trace(4, [600.0, 100.0]))) is None
    # no trace
    assert _read(name, _Run(None)) is None


def test_a_model_without_stage_modules_reads_zero_rows(monkeypatch):
    monkeypatch.setattr(FSR.fuse_sum_relu, "rows", 0)
    monkeypatch.setattr(FSR.fuse_sum_relu, "shapes", Counter())
    monkeypatch.setattr(Predictor, "batches", 7)
    assert _read("fuse_rows_per_batch.serve", _Run(None)) == 0.0
    assert _read("fuse_sum_relu_roofline_pct.serve",
                 _Run(_trace(2, [50.0]))) is None


@pytest.mark.parametrize("name", ["fuse_sum_relu_roofline_pct.serve",
                                  "fuse_rows_per_batch.serve"])
def test_a_program_without_the_kernel_or_the_counter_reads_nothing(
        name, monkeypatch, counted):
    run = _Run(_trace(1, [600.0, 100.0]))
    monkeypatch.setitem(sys.modules,
                        "litehandnet_tpu_torch.kernels.fuse_sum_relu", None)
    assert _read(name, run) is None
    monkeypatch.undo()
    monkeypatch.delattr(Predictor, "batches")
    assert _read(name, run) is None
