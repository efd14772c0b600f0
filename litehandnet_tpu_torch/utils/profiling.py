"""Profiling and determinism helpers (port of
``litehandnet_tpu/utils/profiling.py``; the reference had thop/torchstat FPS
loops and the seed controls of utils/training_kits.py:12-31).

``trace`` records a ``torch.profiler`` trace (host and, where CUDA is
available, the card's kernels) and writes it as a Chrome/Perfetto json.
``cost_analysis`` counts FLOPs with ``FlopCounterMode`` (2 per multiply-add
of the convolutions and matrix products), as ``tools/benchmark`` does; JAX
takes XLA's cost analysis, so the two counts are not expected to agree.
"""

from __future__ import annotations

import contextlib
import os
import random
from typing import Dict, Mapping, Optional

import numpy as np
import torch

from litehandnet_tpu_torch.kernels._build import BUILD_DIR

DEFAULT_TRACE_DIR = str(BUILD_DIR / "trace")


@contextlib.contextmanager
def trace(log_dir: str = DEFAULT_TRACE_DIR):
    """Profile the block, the card's kernels too where CUDA is available;
    on exit write ``<log_dir>/trace.json``.

    Yields:
        the ``torch.profiler.profile``; its ``events()`` and
        ``key_averages()`` hold the trace once the block has ended.
    """
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    with prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_kernel_names(prof) -> list:
    """Names of the kernels a finished ``trace`` saw run on the card."""
    from torch.autograd import DeviceType

    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def cost_analysis(fn, *args) -> dict:
    """FLOPs of one call ``fn(*args)``, in total (``flops``) and per
    operator (``flops_by_operator``), without gradients."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        fn(*args)
    by_op = {str(op): int(n)
             for op, n in counter.get_flop_counts().get("Global", {}).items()}
    return dict(flops=float(counter.get_total_flops()),
                flops_by_operator=by_op)


def set_seeds(seed: int = 0, rank_offset: Optional[int] = None) -> int:
    """Seed python, numpy and torch with ``seed + 1 + rank_offset``
    (reference training_kits.py:12-31 and the per-rank offset of
    distributed_utils.py:23); ``rank_offset`` defaults to this process's
    ``torch.distributed`` rank, 0 outside a process group. Returns the
    seed used."""
    if rank_offset is None:
        dist = torch.distributed
        rank_offset = (dist.get_rank()
                       if dist.is_available() and dist.is_initialized() else 0)
    effective = seed + 1 + rank_offset
    random.seed(effective)
    np.random.seed(effective)
    torch.manual_seed(effective)
    return effective


def parameter_histograms(params: Mapping[str, torch.Tensor],
                         bins: int = 50) -> Dict[str, dict]:
    """Per parameter: a ``bins``-bin histogram (``hist``, ``edges``), its
    mean and its standard deviation (reference utils/weight_analysis.py), on
    the parameter's device. The edges are ``np.histogram``'s (an even split
    of [min, max] in the parameter's dtype); each value falls in the bin
    with ``edges[i] <= v < edges[i + 1]``, the last bin closed, as there."""
    out = {}
    for name, value in params.items():
        flat = value.detach().reshape(-1)
        ends = torch.stack([flat.min(), flat.max()]).cpu().numpy()
        edges = torch.from_numpy(np.histogram_bin_edges(ends, bins=bins))
        at = torch.bucketize(flat, edges.to(flat.device), right=True) - 1
        hist = torch.bincount(at.clamp_(0, bins - 1), minlength=bins)
        out[name] = dict(hist=hist.tolist(), edges=edges.tolist(),
                         mean=float(flat.double().mean()),
                         std=float(flat.double().std(unbiased=False)))
    return out
