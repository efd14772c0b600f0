"""Each cell on the card, as the benchmark runs it: a short window, its
answers correct (skips without a CUDA card; run on the chip)."""

import json
import subprocess
import sys

import pytest

from perfbench.core import spec

from conftest import ROOT


@pytest.mark.card
@pytest.mark.parametrize("name", [w["name"] for w in
                                  spec.benchmark()["workloads"]])
def test_cell_runs_correct_on_the_card(name, card):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", name, "--seed",
         "2147483659", "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, timeout=600, cwd=str(ROOT))
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"] is True
