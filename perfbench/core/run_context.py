"""The state of one benchmark run that the runners and the readers share."""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional

import torch

from perfbench.core import spec


def quarters(marks, start: float, seconds: float) -> list:
    """How many of the times ``marks`` fall in each quarter of the window
    (a window whose rate drifts shows it here)."""
    counts = [0, 0, 0, 0]
    for t in marks:
        counts[min(3, int(4 * (t - start) / seconds))] += 1
    return counts


@dataclass
class Run:
    cell: spec.Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t0: float                            # perf_counter at the process start
    overrides: Optional[dict] = None     # small sizes for the CPU tests
    out_dir: Path = spec.OUT_DIR
    # filled by the runner
    setup_s: Optional[float] = None
    rate: Optional[float] = None         # images a second of the window
    call_s: Optional[float] = None       # the window's seconds per call
    spans: Dict[str, List[float]] = field(default_factory=dict)
    traced: Optional[object] = None      # trace.Trace of the profiled calls
    memory_peak_bytes: int = 0
    notes: Dict[str, object] = field(default_factory=dict)

    def log(self, msg: str) -> None:
        """An earlier line of standard output (never the result line)."""
        print(f"[{time.perf_counter() - self.t0:8.2f}s] {msg}", flush=True)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warn(self, msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)
