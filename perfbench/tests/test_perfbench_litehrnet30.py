"""The cell ``litehrnet30.serve_b512``: its configuration, mix, limits and
readers resolve by name; a small traced run on the CPU gives each of its
new readers a number (28 cross-resolution gates a batch); a program
without the spans or the counter gives None and no error; the control and
each planted fault come out not correct."""

import math

import pytest

from perfbench import calibrate
from perfbench.core import faults, result, spec

from conftest import small_run

CELL = "litehrnet30.serve_b512"
NEW = ["hrnet_weighting_ms.serve", "hrnet_fuse_ms.serve",
       "hrnet_weightings_per_batch.serve"]


def test_the_cell_resolves_by_name():
    cell = spec.Cell(CELL)
    assert cell.entry["config"] == "litehrnet30" == cell.config["name"]
    assert cell.entry["traffic"] == "serve_b512"
    assert cell.mix["batch"] == 512 and cell.mix["kind"] == "serve"
    assert set(cell.mix) == set(spec.mix("serve_b128"))
    assert set(cell.config) == set(spec.config("resnet50"))
    assert cell.config["reduced"] == []
    assert {m["name"] for m in cell.end_to_end} == {"serve_img_s", "setup_s"}
    per_layer = {m["name"] for m in cell.per_layer}
    assert set(NEW) <= per_layer
    assert {"mfu_pct.serve", "forward_ms.serve", "idle_pct.serve"} <= per_layer
    for name in per_layer:
        assert callable(spec.module("metrics", name).read)
    assert set(cell.limits) == {"maxval_mean_gap", "pred_p75_px"}
    cfg = cell.port_config()        # raises where the file and program differ
    assert cfg.MODEL.depth == 30
    assert spec.reference(cell.config["reference"]).build(
        cell.model_spec()).out_conv.weight.shape[0] == 21


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    # the counters count since the process started, as in a benchmark run,
    # which is a process of its own; a test process has served before
    from litehandnet_tpu_torch.models.litehrnet import CrossResolutionWeighting
    from litehandnet_tpu_torch.serve import Predictor

    Predictor.batches = CrossResolutionWeighting.calls = 0
    r = small_run(CELL, tmp_path_factory.mktemp("hrnet"), trace=True,
                  mix={"trace_requests": 3})
    line = result.execute(r)
    return r, line, {k: v["value"] for k, v in line["metrics"].items()}


def test_a_small_traced_run_reads_every_new_metric(traced):
    _, line, got = traced
    assert line["correct"] is True
    for name in NEW:
        assert math.isfinite(got[name]) and got[name] > 0, name
    assert got["hrnet_weightings_per_batch.serve"] == 28.0
    assert (got["hrnet_weighting_ms.serve"] + got["hrnet_fuse_ms.serve"]
            <= got["forward_ms.serve"])


def test_the_counted_requests_hold_every_block(traced):
    from perfbench.core import spans

    r, _, _ = traced
    for g in spans.requests(r):
        names = [s.name for s in g]
        assert names.count("lhn.litehrnet.weighting") == 28
        assert names.count("lhn.litehrnet.fuse") == 14


def test_a_program_without_the_spans_or_counter_reads_none(traced,
                                                          monkeypatch):
    """What the readers see of a program that records neither: its
    requests without the model's spans, its gate class without ``calls``."""
    from litehandnet_tpu_torch.models import litehrnet
    from perfbench.core import spans

    r, _, _ = traced
    groups = [[s for s in g if not s.name.startswith("lhn.litehrnet")]
              for g in spans.requests(r)]
    monkeypatch.setattr(spans, "requests", lambda run: groups)
    for name in NEW[:2]:
        assert spec.module("metrics", name).read(r) is None
    monkeypatch.delattr(litehrnet.CrossResolutionWeighting, "calls")
    assert spec.module("metrics", NEW[2]).read(r) is None


def test_the_control_fails_the_limits(tmp_path):
    # the cell's own 256 x 256 crops: the keypoint distances the limits hold
    # are in image px, which a smaller crop shrinks
    r = small_run(CELL, tmp_path, mix={"batch": 2, "distinct": 8}, config={})
    got = calibrate.serve_readings(r, "control")
    assert any(got[n] > r.cell.limits[n]["limit"] for n in r.cell.limits)


@pytest.mark.parametrize("kind", ["half_batch", "altered_maxval",
                                  "altered_preds"])
def test_a_planted_fault_is_not_correct(kind, tmp_path):
    with faults.planted(kind):
        line = result.execute(small_run(CELL, tmp_path, config={},
                                        mix={"batch": 2, "distinct": 4}))
    assert line["correct"] is False and line["failed"] == line["attempted"]


def test_a_sound_run_at_the_cells_crops_is_correct(tmp_path):
    line = result.execute(small_run(CELL, tmp_path, config={},
                                    mix={"batch": 2, "distinct": 4}))
    assert line["correct"] is True
