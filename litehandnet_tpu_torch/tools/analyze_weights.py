"""Weight analysis CLI (port of ``litehandnet_tpu/tools/analyze_weights.py``;
the reference's ``utils/weight_analysis.py``): a histogram and summary
statistics of every parameter of a run's checkpoint, as JSON.

Usage:
    python -m litehandnet_tpu_torch.tools.analyze_weights --cfg <config> \
        [--load-best] [--out weights.json] [--top 20] [--device cuda|cpu]

Reads the run's ``checkpoint`` (or ``best``) slot as it was saved, without
the training run's optimizer or criterion; with no checkpoint it analyzes
the model's PyTorch init from seed 0. Buffers (BatchNorm statistics) are not
parameters and are left out, as JAX's ``params`` leave out its
``batch_stats``. The parameters and their statistics live on ``--device``
(CUDA unless ``cpu`` is asked).
"""

from __future__ import annotations

import argparse
import json

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.utils.profiling import parameter_histograms


def main(argv=None):
    parser = argparse.ArgumentParser(description="per-parameter weight "
                                     "statistics of a run's checkpoint")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--load-best", action="store_true")
    parser.add_argument("--out", default=None)
    parser.add_argument("--top", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_config(args.cfg)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_model(cfg, device=device)
    names = [name for name, _ in model.named_parameters()]
    params = dict(model.named_parameters())
    raw, _ = CheckpointManager(run_dir(cfg), cfg, read_only=True).restore_raw(
        best=args.load_best)
    if raw is not None:
        params = {name: raw["model"][name].to(device) for name in names}
        print("analyzed restored checkpoint", flush=True)
    else:
        print("no checkpoint; analyzing init", flush=True)

    hists = parameter_histograms(params)
    rows = sorted(((name, h["mean"], h["std"]) for name, h in hists.items()),
                  key=lambda r: -abs(r[2]))
    print(f"{'layer':60s} {'mean':>10s} {'std':>10s}")
    for name, mean, std in rows[: args.top]:
        print(f"{name[:60]:60s} {mean:10.4f} {std:10.4f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(hists, f)
        print(f"wrote {args.out}", flush=True)
    return hists


if __name__ == "__main__":
    main()
