"""The readers of the ``dw_conv_bias_act`` kernel's per-layer metrics,
``dw_conv_bias_act_roofline_pct.serve`` and ``dw_launches_per_batch.serve``, on a
synthetic run: the launch counter over the batches served, and the least
time of the counted launches' shapes over their profiled device time; a
program without the kernel or the batch counter reads nothing and raises
nothing; and the kernel's costs by hand."""

import sys
from collections import Counter

import pytest

import litehandnet_tpu_torch.kernels  # noqa: F401  (binds the submodules)
from litehandnet_tpu_torch.serve import Predictor
from perfbench.core import peaks, spec
from perfbench.core.trace import Trace

DW = sys.modules["litehandnet_tpu_torch.kernels.dw_conv_bias_act"]
NAME = ("void (anonymous namespace)::dw_conv_bias_act_kernel<__nv_bfloat16, "
        "3>(__nv_bfloat16 const*, float const*, float const*, "
        "__nv_bfloat16*, (anonymous namespace)::Geometry, int, float)")
STEM = (128, 32, 128, 128, 7, 1)
DW64 = (128, 64, 64, 64, 3, 1)


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
        kernels.append(("void cudnn::other_kernel", t, t + 50.0))
        t += 51.0
    return Trace(calls=calls, window_s=1.0, kernels=kernels, copies=[],
                 busy_s=t / 1e6)


@pytest.fixture
def counted(monkeypatch):
    """The process served 5 batches, each launching the stem's 7x7 and two
    64-channel 3x3s, in bfloat16."""
    monkeypatch.setattr(DW.dw_conv_bias_act, "launches", 15)
    monkeypatch.setattr(DW.dw_conv_bias_act, "shapes",
                        Counter({STEM + (2,): 5, DW64 + (2,): 10}))
    monkeypatch.setattr(Predictor, "batches", 5)


def _read(name, run):
    return spec.module("metrics", name).read(run)


def test_costs_by_hand():
    cost = spec.module("costs", "dw_conv_bias_act")
    n = 128 * 32 * 128 * 128                   # 67,108,864 outputs
    assert cost.bytes_moved(STEM, 2) == 2 * 2 * n + 32 * 50 * 4
    assert cost.operations(STEM) == 100 * n
    assert cost.bytes_moved(DW64, 4) == 2 * 4 * 128 * 64 * 64 * 64 + 64 * 10 * 4
    assert cost.operations(DW64) == 20 * 128 * 64 * 64 * 64


def test_launches_per_batch(counted):
    assert _read("dw_launches_per_batch.serve", _Run(None)) == 3.0


def test_roofline_over_the_counted_shapes(counted):
    cost = spec.module("costs", "dw_conv_bias_act")
    # the stem is bound by its operations, the 3x3 by its bytes
    stem_s = cost.operations(STEM) / peaks.FLOPS["fp32"]
    dw_s = cost.bytes_moved(DW64, 2) / peaks.HBM_BYTES_PER_S
    assert stem_s > cost.bytes_moved(STEM, 2) / peaks.HBM_BYTES_PER_S
    assert dw_s > cost.operations(DW64) / peaks.FLOPS["fp32"]
    run = _Run(_trace(4, [150.0, 40.0, 40.0]))
    want = 100.0 * (stem_s + 2 * dw_s) / 230e-6
    assert _read("dw_conv_bias_act_roofline_pct.serve", run) == pytest.approx(want)
    assert 50.0 < want < 100.0


def test_roofline_reads_nothing_where_the_launches_do_not_fit(counted,
                                                              monkeypatch):
    # a launch the trace lacks
    assert _read("dw_conv_bias_act_roofline_pct.serve",
                 _Run(_trace(4, [300.0, 60.0]))) is None
    # a shape not launched the same in every batch
    monkeypatch.setattr(DW.dw_conv_bias_act, "shapes",
                        Counter({STEM + (2,): 5, DW64 + (2,): 9}))
    assert _read("dw_conv_bias_act_roofline_pct.serve",
                 _Run(_trace(4, [300.0, 60.0, 60.0]))) is None
    # no trace
    assert _read("dw_conv_bias_act_roofline_pct.serve", _Run(None)) is None


def test_a_graph_without_the_kernel_reads_zero_launches(monkeypatch):
    monkeypatch.setattr(DW.dw_conv_bias_act, "launches", 0)
    monkeypatch.setattr(DW.dw_conv_bias_act, "shapes", Counter())
    monkeypatch.setattr(Predictor, "batches", 7)
    assert _read("dw_launches_per_batch.serve", _Run(None)) == 0.0
    assert _read("dw_conv_bias_act_roofline_pct.serve",
                 _Run(_trace(2, [50.0]))) is None


@pytest.mark.parametrize("name", ["dw_conv_bias_act_roofline_pct.serve",
                                  "dw_launches_per_batch.serve"])
def test_a_program_without_the_kernel_or_the_counter_reads_nothing(
        name, monkeypatch, counted):
    run = _Run(_trace(1, [300.0, 60.0, 60.0]))
    monkeypatch.setitem(sys.modules,
                        "litehandnet_tpu_torch.kernels.dw_conv_bias_act",
                        None)
    assert _read(name, run) is None
    monkeypatch.undo()
    monkeypatch.delattr(Predictor, "batches")
    assert _read(name, run) is None
