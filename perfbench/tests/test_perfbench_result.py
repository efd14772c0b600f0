"""A run's result line: exactly the keys the contract reads, the compared
numbers last, and the numbers beside their limits as the last lines of
standard error."""

import json

import pytest

from perfbench.core import result

from conftest import small_run


@pytest.mark.parametrize("name,trace", [("litehandnet.serve_b128", False),
                                        ("litehandnet.serve_b1", True),
                                        ("litehandnet.train_b32", True)])
def test_result_line_keys(name, trace, tmp_path, capsys):
    r = small_run(name, tmp_path, trace=trace)
    line = result.execute(r)
    result.emit(r, line)
    out, err = capsys.readouterr()
    last = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(last) == keys + (["breakdown"] if trace else []) + ["checks"]
    assert last["correct"] is True and last["failed"] == 0
    assert set(last["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert {"busy_s", "window_s"} <= set(last["device"])
        assert set(last["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(last["breakdown"]["idle_gaps"]) <= 10
    else:
        assert "setup_s" in last["metrics"]
        for m in r.cell.end_to_end:
            assert last["metrics"][m["name"]]["unit"] == m["unit"]
    tail = err.strip().splitlines()[-len(last["checks"]) - 1:]
    for (name_, check), text in zip(last["checks"].items(), tail):
        assert text.startswith(f"{name_} ") and " limit " in text
    assert tail[-1] == "correct True"
