"""Shared fixtures of the benchmark's own tests (run with
``python -m pytest perfbench/tests``)."""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a cell at a size the CPU holds: 64 x 64 crops (16 x 16 maps), batches of
# 2, the configurations' own widths
SMALL_MIX = {"batch": 2, "distinct": 2, "warmup": 1, "trace_requests": 2,
             "span_requests": 2, "trace_steps": 2, "late_from": 5}
SMALL_CONFIG = {"DATASET": {"image_size": [64, 64], "heatmap_size": [16, 16]}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card; skips elsewhere (run on the chip)")


@pytest.fixture
def card():
    """Skip unless a CUDA device is present (decided when the test runs)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def small_run(name, tmp_path, seed=2 ** 31 + 7, seconds=0.5, trace=False,
              mix=None, config=SMALL_CONFIG):
    """A ``Run`` of cell ``name`` on the CPU at the small size (``config``
    overrides the configuration; ``{}`` keeps the cell's crops)."""
    import time

    import torch

    from perfbench.core import spec
    from perfbench.core.run_context import Run

    cell = spec.Cell(name)
    small = dict(SMALL_MIX, **(mix or {}))
    cell.mix = dict(cell.mix, **{k: v for k, v in small.items()
                                 if k in cell.mix})
    return Run(cell=cell, seed=seed, seconds=seconds, trace=trace,
               device=torch.device("cpu"), t0=time.perf_counter(),
               overrides=copy.deepcopy(config), out_dir=tmp_path)
