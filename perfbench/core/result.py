"""From a run to its result line: the runner named by the mix's ``kind``,
the cell's metrics (end-to-end with ``--trace 0``, per-layer with
``--trace 1``, each per-layer one read by ``metrics/<name>.py``), the device
and the numbers compared with their limits."""

from __future__ import annotations

import importlib
import json
import subprocess
import sys

import torch

from perfbench.core.run_context import Run


def card() -> str:
    """The card's name and power limit, for the earlier lines."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or out.stderr.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi: {e}"


def execute(run: Run) -> dict:
    """Drive the cell and build the result line (without printing it)."""
    cell = run.cell
    if run.device.type == "cuda":
        run.log(f"card: {card()}")
    runner = importlib.import_module(f"perfbench.core.{cell.mix['kind']}")
    out = runner.run(run)
    if run.device.type == "cuda":
        run.log(f"card after the check: {card()}")
    numbers = out["numbers"]
    metrics = {}
    if run.trace:
        from perfbench.core import spec

        for m in cell.per_layer:
            value = spec.module("metrics", m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out["e2e"][m["name"]],
                                  "unit": m["unit"]}
    device = {"platform": "gpu" if run.device.type == "cuda" else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if run.device.type == "cuda" else "cpu"),
              "count": 1, "memory_peak_bytes": int(run.memory_peak_bytes)}
    line = {"correct": out["failed"] == 0 and out["attempted"] > 0
            and all(numbers[n] <= cell.limits[n]["limit"] for n in numbers),
            "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if run.trace and run.traced is not None:
        t = run.traced
        run.log(f"traced: {t.calls} calls, {1e3 * t.window_s / t.calls:.3f} ms "
                f"a call profiled against {1e3 * (run.call_s or 0):.3f} ms in "
                f"the window, device busy {1e3 * t.busy_s / t.calls:.3f} ms "
                f"a call, {len(t.kernels)} kernels")
        device["busy_s"] = run.traced.busy_s
        device["window_s"] = run.traced.window_s
        line["breakdown"] = {"device_ops": run.traced.device_ops(),
                             "idle_gaps": run.traced.idle_gaps()}
    line["checks"] = {n: {"value": v, "limit": cell.limits[n]["limit"]}
                      for n, v in numbers.items()}
    run.log(f"notes: {json.dumps(run.notes)}")
    run.log(f"end-to-end this run: {json.dumps(out['e2e'])}")
    return line


def emit(run: Run, line: dict) -> None:
    """The compared numbers beside their limits as the last lines of
    standard error, then the result as the last line of standard output."""
    for name, c in line["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(f"correct {line['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
