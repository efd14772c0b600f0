"""Model benchmark CLI (port of ``litehandnet_tpu/tools/benchmark.py``; the
reference's ``test_models_performance.ipynb``): parameter counts, forward
FLOPs, and measured latency, serving and training rates per model family.

Usage:
    python -m litehandnet_tpu_torch.tools.benchmark [--models litehandnet
        resnet] [--size 256] [--batch 1] [--bf16] [--reps 30]
        [--train | --throughput] [--device cuda|cpu]

Prints one ``name: {json}`` line per model, or ``name: FAILED ...`` for a
model that fails, and goes on with the rest. FLOPs are counted by
``torch.utils.flop_counter.FlopCounterMode`` over one forward (2 per
multiply-add of the convolutions and matrix products); JAX's CLI takes XLA's
cost analysis, so the two counts are not expected to agree. ``--bf16`` runs
the float32 model under ``torch.autocast(bfloat16)``, as ``serve.Predictor``
does. On the card every timed window ends in ``torch.cuda.synchronize()``;
the time is the best of 3 windows of ``--reps`` back-to-back calls, after 3
warm-up calls.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import config_from_dict

DEFAULT_MODELS = [
    "litehandnet", "mynet", "hourglass", "hourglass_ablation", "litehrnet",
    "resnet", "mobilenetv2", "srhandnet",
]


def bench_config(name: str, size: int, train: bool = False):
    """The config JAX's CLI builds for ``name`` at ``size``: the family's
    defaults with 21 output channels (SRHandNet 24 with ``pred_bbox``); to
    train, SRHandNet gets its four heatmap sizes (1/16, 1/16, 1/8, 1/4) and
    the multi-scale ``SRHandNetLoss``, the others ``TopdownHeatmapLoss``."""
    model = dict(name=name, output_channel=21)
    heatmap = [size // 4, size // 4]
    loss = dict(type="TopdownHeatmapLoss", loss_weight=[1.0],
                auto_weight=False)
    if name == "srhandnet":
        model.update(output_channel=24, pred_bbox=True)
        if train:
            heatmap = [[size // 16] * 2, [size // 16] * 2, [size // 8] * 2,
                       [size // 4] * 2]
            loss = dict(type="SRHandNetLoss", loss_weight=[0.1, 0.2, 0.3, 0.4])
    return config_from_dict(dict(
        MODEL=model,
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=heatmap),
        PIPELINE=dict(simdr_split_ratio=0),
        LOSS=loss,
    ))


def flops_of(model: torch.nn.Module, x: torch.Tensor) -> float:
    """FLOPs of one forward of ``model`` on ``x``."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return float(counter.get_total_flops())


def seconds_per_call(fn, reps: int, device: torch.device) -> float:
    """Best of 3 windows of ``reps`` calls of ``fn``, after 3 warm-up
    calls; each window ends when the device has finished."""
    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    for _ in range(3):
        fn()
    sync()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        sync()
        best = min(best, (time.perf_counter() - t0) / reps)
    return best


def _autocast(device: torch.device, bf16: bool):
    return torch.autocast(device.type, dtype=torch.bfloat16, enabled=bf16)


def _input(batch: int, size: int, device: torch.device) -> torch.Tensor:
    """U(-1, 1) images ``[B, 3, size, size]`` from seed 0, channels_last."""
    x = np.random.RandomState(0).uniform(-1, 1, (batch, size, size, 3))
    return torch.from_numpy(x.astype(np.float32)).to(device).permute(0, 3, 1, 2)


def _served(cfg, deploy: bool, device: torch.device) -> torch.nn.Module:
    """Random weights from seed 0 in eval mode, channels_last: the
    deploy-fused graph when ``deploy``."""
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.serve import deploy_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    if deploy:
        return deploy_model(cfg, seed=0, device=device)
    model = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    return model.to(device, memory_format=torch.channels_last)


def bench_model(name: str, size: int, batch: int, bf16: bool, reps: int = 30,
                device="cuda") -> dict:
    """Params, GFLOPs, latency and fps of the eval forward; ``litehandnet``
    gives a ``train_graph`` and a ``deployed`` row, the others ``default``."""
    dev = resolve_device(device)
    cfg = bench_config(name, size)
    rows = {}
    modes = ["train_graph", "deployed"] if name == "litehandnet" else ["default"]
    for mode in modes:
        model = _served(cfg, mode == "deployed", dev)
        x = _input(batch, size, dev)

        @torch.no_grad()
        def forward():
            with _autocast(dev, bf16):
                return model(x)

        with _autocast(dev, bf16):
            flops = flops_of(model, x)
        dt = seconds_per_call(forward, reps, dev)
        rows[mode] = dict(
            params_M=round(sum(p.numel() for p in model.parameters()) / 1e6, 3),
            gflops=round(flops / 1e9, 3) if flops > 0 else None,
            latency_ms=round(dt * 1e3, 3),
            fps=round(batch / dt, 1),
        )
    return rows


def bench_throughput(name: str, size: int, batch: int, bf16: bool,
                     reps: int = 30, device="cuda") -> dict:
    """Serving rate: forward-only img/s at ``batch`` (the deploy-fused
    graph where the family has one)."""
    dev = resolve_device(device)
    cfg = bench_config(name, size)
    model = _served(cfg, name == "litehandnet", dev)
    x = _input(batch, size, dev)

    @torch.no_grad()
    def forward():
        with _autocast(dev, bf16):
            return model(x)

    dt = seconds_per_call(forward, reps, dev)
    return dict(ms_per_batch=round(dt * 1e3, 2),
                img_per_sec=round(batch / dt, 1))


def bench_train_step(name: str, size: int, batch: int, bf16: bool,
                     reps: int = 20, device="cuda") -> dict:
    """The whole train step (forward, loss, backward, BatchNorm statistics,
    Adam at 1e-3) on seeded uniform targets, as JAX :176-205 builds them:
    for SRHandNet four per-scale 24-channel targets for ``SRHandNetLoss``."""
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer
    from litehandnet_tpu_torch.train.state import TrainState

    dev = resolve_device(device)
    cfg = bench_config(name, size, train=True)
    model = get_model(cfg, device=dev)
    if dev.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    def adam(params):
        opt = make_optimizer("Adam", params, 1e-3)
        return opt, torch.optim.lr_scheduler.LambdaLR(opt, lambda t: 1.0)

    state = TrainState.create(model, get_loss(cfg).to(dev), adam)
    rng = np.random.RandomState(0)

    def uniform(lo, shape):
        return torch.from_numpy(
            rng.uniform(lo, 1, shape).astype(np.float32)).to(dev)

    if name == "srhandnet":
        target = [uniform(0, (batch, 24, h, w))
                  for w, h in cfg.DATASET.heatmap_size]
    else:
        target = uniform(0, (batch, 21, size // 4, size // 4))
    # on the device once, so the step's own transfer is a no-op
    b = {"img": uniform(-1, (batch, size, size, 3)), "target": target,
         "target_weight": torch.ones(batch, 24 if name == "srhandnet" else 21,
                                     device=dev)}
    step = make_train_step(dev)

    def one_step():
        with _autocast(dev, bf16):
            return step(state, b)

    dt = seconds_per_call(one_step, reps, dev)
    return dict(ms_per_step=round(dt * 1e3, 2),
                train_img_per_sec=round(batch / dt, 1))


def main(argv=None):
    parser = argparse.ArgumentParser(description="litehandnet_tpu_torch "
                                     "model benchmark")
    parser.add_argument("--models", nargs="+", default=DEFAULT_MODELS)
    parser.add_argument("--size", type=int, default=256)
    parser.add_argument("--batch", type=int, default=1)
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--reps", type=int, default=30)
    parser.add_argument("--train", action="store_true",
                        help="measure the full train step instead of the "
                             "inference forward")
    parser.add_argument("--throughput", action="store_true",
                        help="measure serving img/s (forward only; use with "
                             "a large --batch, e.g. 128)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    bench_fn = (bench_throughput if args.throughput
                else bench_train_step if args.train
                else bench_model)
    results = {}
    for name in args.models:
        try:
            results[name] = bench_fn(name, args.size, args.batch, args.bf16,
                                     args.reps, device=args.device)
            print(f"{name}: {json.dumps(results[name])}", flush=True)
        except Exception as e:  # keep benchmarking the rest
            print(f"{name}: FAILED {type(e).__name__}: {e}", flush=True)
    return results


if __name__ == "__main__":
    main()
