"""The harness finds every cell, configuration, mix, limit and metric by
name from its files, and ``BENCHMARK.json`` keeps to the contract's shape."""

import json
import re

import pytest

from perfbench.core import spec

BENCH = spec.benchmark()
PARKED = spec.parked()
CELLS = [w["name"] for w in BENCH["workloads"] + PARKED["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


@pytest.mark.parametrize("name", CELLS)
def test_cell_resolves_by_name(name):
    cell = spec.Cell(name, BENCH)
    assert cell.config["name"] == cell.entry["config"]
    assert cell.mix["kind"] in ("serve", "train")
    assert (spec.BENCH_DIR / "core" / f"{cell.mix['kind']}.py").is_file()
    assert spec.reference(cell.config["reference"]).build
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.module("metrics", m["name"]).read)
    known = {"serve": {"maxval_mean_gap", "pred_p75_px"},
             "train": {"loss_gap", "grad_median_gap", "grad_gap",
                       "change_gap", "late_loss_gap",
                       "late_update_gap"}}[cell.mix["kind"]]
    compared = {n for n, v in cell.limits.items() if isinstance(v, dict)}
    assert compared and compared <= known
    for n in compared:
        lim = cell.limits[n]
        assert lim["limit"] > 0
        if "lower" in lim:
            # set from readings: room on both sides, the more above the lower
            assert lim["lower"] < lim["limit"] < lim["upper"]
            assert lim["limit"] / lim["lower"] >= lim["upper"] / lim["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_config_file_is_the_run_configuration(name):
    cell = spec.Cell(name, BENCH)
    cfg = cell.port_config()       # raises where the file and program differ
    assert cfg.MODEL.name == cell.config["config"]["MODEL"]["name"]


def with_parked():
    assert set(PARKED) <= {"workloads", "end_to_end", "per_layer"}
    assert not {w["name"] for w in BENCH["workloads"]} & {
        w["name"] for w in PARKED["workloads"]}
    return dict(BENCH, **{k: BENCH[k] + PARKED[k] for k in PARKED})


# the parked cells keep the shape too, so that moving them in is enough
@pytest.mark.parametrize("parked", [False, True])
def test_benchmark_keeps_the_contract_shape(parked):
    bench = with_parked() if parked else BENCH
    cells = [w["name"] for w in bench["workloads"]]
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert json.load(open(spec.ROOT / c["file"]))["name"] == c["name"]
    used = {w["config"] for w in bench["workloads"]}
    assert used == set(configs)
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in cells
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", cells))
    assert len(json.dumps(bench)) < 64 * 1024


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]
                                    if "roofline" in m["name"]])
def test_roofline_metrics_have_cost_functions(metric):
    kernel = metric.split("_roofline")[0]
    cost = spec.module("costs", kernel)
    assert callable(cost.bytes_moved) and callable(cost.operations)


def test_unknown_names_are_refused():
    with pytest.raises(KeyError):
        spec.Cell("no.such_cell", BENCH)
    with pytest.raises(KeyError):
        spec.module("metrics", "no_such_metric")
