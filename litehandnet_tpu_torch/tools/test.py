"""Evaluation CLI (port of ``litehandnet_tpu/tools/test.py``).

Usage:
    python -m litehandnet_tpu_torch.tools.test --cfg <config.py or name> \
        [--load-best] [--train] [--allow-init] [--batch-size N] [--bf16] \
        [--data-parallel] [--decode-procs N] [--vis-dir D] [--device cuda|cpu]

Restores the run's checkpoint into a ``TrainState`` (model, criterion with
its SimDR decoders, optimizer), fuses ``litehandnet`` into its deploy graph
(reference test.py:106-107; the other families run their train graph in
eval mode), runs the test split from disk through the loader and the device
pipeline, the forward (bfloat16 under autocast with ``--bf16``) and
``TopDownDecoder`` (DARK through the ``blur_log`` kernel), and writes the
dataset's metrics to ``best_pth_metric.json`` or
``checkpoint_pth_metric.json`` (``train_``-prefixed under ``--train``),
plus ``simdr_metric.json`` for a model that gives SimDR vectors.

``--data-parallel`` splits each batch's forward over every local device in
this one process, as the reference's ``nn.DataParallel`` wrap does
(``test.py:81``) and JAX's sharded batch (:63-74): the model is replicated
once, each batch scattered, the replicas applied in parallel and their
outputs gathered on the first device, where the decode runs
(``torch.nn.parallel``; on the CPU, one device, the chunks run in turn).
The device count must divide the batch size.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.data.loader import DataLoader
from litehandnet_tpu_torch.eval.decoder import TopDownDecoder, unpack_outputs
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.serve import FUSED_FAMILIES
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.train.distributed import local_devices
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.precision import DynamicLossScaler
from litehandnet_tpu_torch.train.state import TrainState

META_KEYS = ("center", "scale", "image_file", "bbox_id", "bbox_score")


def restore_state(cfg, load_best: bool, allow_init: bool,
                  seed: int = 0) -> TrainState:
    """The run's checkpoint restored on the CPU into a ``TrainState`` whose
    criterion is ``get_loss(cfg)``, so a SimDR run's decoders load too;
    with ``allow_init`` and no checkpoint, the state of a fresh run (the
    model's PyTorch init drawn from ``seed``).

    Raises:
        FileNotFoundError: the run has no such checkpoint and
            ``allow_init`` is false (the reference refuses, test.py:100-101).
    """
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        model = get_model(cfg, device="cpu")
        criterion = get_loss(cfg)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=1)
    scaler = DynamicLossScaler() if cfg.TRAIN.get("loss_scale", False) else None
    state = TrainState.create(model, criterion, tx, loss_scaler=scaler)
    # read_only: evaluation never rewrites the training run's config.json
    # (under --train the config's test split was pointed at the train data)
    ckpt = CheckpointManager(run_dir(cfg), cfg, read_only=True)
    restored, _ = ckpt.restore(state, best=load_best)
    if restored is None:
        if not allow_init:
            raise FileNotFoundError(
                f"model not exist! no checkpoint under {run_dir(cfg)} "
                "(pass --allow-init to evaluate random init)")
        print("no checkpoint found; evaluating random init", flush=True)
    return state


def eval_model(cfg, model: torch.nn.Module, device) -> torch.nn.Module:
    """The evaluated model, in eval mode on ``device`` in ``channels_last``
    memory: ``model`` (a train graph), deploy-fused for ``litehandnet``."""
    if cfg.MODEL.name.lower() in FUSED_FAMILIES:
        deploy = get_model(cfg, deploy=True, device="cpu")
        deploy.load_state_dict(fuse_params(model))
        model = deploy
    return model.to(device=device, memory_format=torch.channels_last).eval()


class _Autocast(torch.nn.Module):
    """``model`` under bfloat16 autocast when ``enabled``: autocast is
    per thread, and each replica of ``--data-parallel`` runs in its own."""

    def __init__(self, model: torch.nn.Module, enabled: bool):
        super().__init__()
        self.model = model
        self.enabled = enabled

    def forward(self, x):
        with torch.autocast(x.device.type, dtype=torch.bfloat16,
                            enabled=self.enabled):
            return self.model(x)


class DataParallelForward:
    """``model`` (on ``devices[0]``) applied to each batch split over
    ``devices``: replicated once, then per batch scatter, ``parallel_apply``
    and gather on ``devices[0]`` (``torch.nn.parallel``). On the CPU (one
    device) the chunks run in turn and are concatenated."""

    def __init__(self, model: torch.nn.Module, devices):
        self.model = model
        self.devices = list(devices)
        self.replicas = None
        if self.devices[0].type == "cuda":
            from torch.nn.parallel import replicate

            self.replicas = replicate(model, self.devices, detach=True)

    def __call__(self, x: torch.Tensor):
        if self.replicas is None:
            return _concat([self.model(c) for c in x.chunk(len(self.devices))])
        from torch.nn.parallel import gather, parallel_apply, scatter

        inputs = scatter(x, self.devices)
        outputs = parallel_apply(self.replicas[:len(inputs)],
                                 [(i,) for i in inputs],
                                 devices=self.devices[:len(inputs)])
        return gather(outputs, self.devices[0])


def _concat(outputs):
    """The per-chunk outputs (tensors, or tuples and lists of them) joined
    along the batch, as ``torch.nn.parallel.gather`` joins them."""
    first = outputs[0]
    if torch.is_tensor(first):
        return torch.cat(outputs)
    return type(first)(_concat(parts) for parts in zip(*outputs))


def _floats(values) -> dict:
    return {k: float(v) for k, v in values.items()}


def main(argv=None):
    parser = argparse.ArgumentParser(description="litehandnet_tpu_torch evaluator")
    parser.add_argument("--cfg", required=True, help="experiment config")
    parser.add_argument("--load-best", action="store_true")
    parser.add_argument("--train", action="store_true",
                        help="evaluate the train split (reference "
                             "test.py:41-44,71-73)")
    parser.add_argument("--allow-init", action="store_true",
                        help="evaluate random init when no checkpoint exists "
                             "(the reference raises, test.py:100-101)")
    parser.add_argument("--batch-size", type=int, default=32)
    parser.add_argument("--data-parallel", action="store_true",
                        help="split each batch's forward over every local "
                             "device (the reference's nn.DataParallel eval "
                             "wrap, test.py:81); the device count must "
                             "divide --batch-size")
    parser.add_argument("--vis-dir", default=None)
    parser.add_argument("--bf16", action="store_true",
                        help="forward in bfloat16 under autocast")
    parser.add_argument("--decode-procs", type=int, default=0,
                        help="decode worker processes (0 = in-process)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    devices = None
    if args.data_parallel:
        devices = local_devices(device)
        device = devices[0]
        if args.batch_size % len(devices):
            raise SystemExit(
                f"--batch-size {args.batch_size} must divide the "
                f"{len(devices)} local devices")

    cfg = get_config(args.cfg)
    if args.train:
        # point the test split at the train annotations (test.py:71-73)
        cfg.DATASET.test.ann_file = cfg.DATASET.train.ann_file
        cfg.DATASET.test.img_prefix = cfg.DATASET.train.img_prefix
    num_joints = int(cfg.DATASET.num_joints)
    simdr_k = int(cfg.PIPELINE.get("simdr_split_ratio", 0) or 0)

    with DataLoader(cfg, "test", batch_size=args.batch_size, device=device,
                    decode_procs=args.decode_procs) as loader:
        decoder = TopDownDecoder(cfg, device=device)
        state = restore_state(cfg, args.load_best, args.allow_init)
        model = _Autocast(eval_model(cfg, state.model, device), args.bf16)
        forward = model if devices is None else DataParallelForward(
            model, devices)
        results, simdr_results = [], []
        batch = None
        for batch in loader.batches(0):
            x = batch["img"].permute(0, 3, 1, 2)
            with torch.no_grad():
                outputs = forward(x)
            hm, pred_x, pred_y = unpack_outputs(outputs, num_joints)
            meta = {k: batch[k] for k in META_KEYS}
            meta["center"] = batch["center"].cpu().numpy()
            meta["scale"] = batch["scale"].cpu().numpy()
            results.append(decoder.decode(meta, hm))
            if simdr_k > 0 and pred_x is not None:
                # the SimDR decode beside the heatmap decode (reference
                # test.py:117-147), from the model's own pred_x / pred_y
                simdr_results.append(decoder.decode_simdr(
                    meta, pred_x.float(), pred_y.float()))

        metric = cfg.EVAL.get("metric", ["PCK", "AUC", "EPE"])
        name_value = loader.dataset.evaluate(results, metric=metric)
        print(json.dumps(_floats(name_value), indent=2))

        out_dir = args.vis_dir or run_dir(cfg)
        os.makedirs(out_dir, exist_ok=True)
        # the file names which slot was evaluated (reference test.py:53-61);
        # a train-split evaluation gets its own prefix, so it never
        # overwrites the test-split metrics
        metric_file = ("best_pth_metric.json" if args.load_best
                       else "checkpoint_pth_metric.json")
        if args.train:
            metric_file = "train_" + metric_file
        with open(os.path.join(out_dir, metric_file), "w") as f:
            json.dump(_floats(name_value), f, indent=2)

        if simdr_results:
            simdr_metrics = loader.dataset.evaluate(simdr_results,
                                                    metric=["AUC"])
            print("SimDR:", json.dumps(_floats(simdr_metrics), indent=2))
            with open(os.path.join(out_dir, "simdr_metric.json"), "w") as f:
                json.dump(_floats(simdr_metrics), f, indent=2)
            name_value = dict(name_value, **{
                f"simdr_{k}": v for k, v in simdr_metrics.items()})

        if args.vis_dir and batch is not None:
            from litehandnet_tpu_torch.utils.vis import SaveResultImages

            saver = SaveResultImages(loader.dataset, args.vis_dir)
            last = results[-1]
            images = batch["img"].cpu().numpy()
            hm_size = cfg.DATASET.heatmap_size
            if hm_size and isinstance(hm_size[0], (list, tuple)):
                hm_size = hm_size[-1]  # multi-scale: the finest scale
            saver.save_images_with_joints(
                images, last["hm_preds"] * (
                    np.asarray(cfg.DATASET.image_size)[None, None]
                    / np.asarray(hm_size)[None, None]),
                None, name="pred_joints.png")
            saver.save_images_with_heatmap(
                images, last["output_heatmap"], name="pred_heatmaps.png")
        return name_value


if __name__ == "__main__":
    main()
