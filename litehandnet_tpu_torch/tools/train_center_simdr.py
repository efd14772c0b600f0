"""Gen-1 workflow: center-map + SimDR training with the
cycle-detection pass (port of ``litehandnet_tpu/tools/train_center_simdr.py``;
reference train_distributed_center_simdr_{freihand,mpii}.py).

Usage:
    python -m litehandnet_tpu_torch.tools.train_center_simdr --cfg <config> \
        [--num-devices N] [--seed S] [--workers N] [--cd-prob P] \
        [--device cuda|cpu]

The stacked MS-attention hourglass with region maps and SimDR heads, AdamW on
a per-epoch sine-decay LR (:110-113), and with probability ``--cd-prob`` per
step a second step on the same batch's ground-truth boxes re-cropped at half
resolution (:203-211): each box becomes a new (center, scale) of a second
``DevicePipeline`` at ``image_size // 2`` without SimDR targets, so
``CenterSimdrLoss`` drops its SimDR term there. Evaluation is
``ResultParser`` multi-hand PCK plus the heatmap PCK and region AP of the
reference ``test()`` (:240-278).

Random draws: the cycle-detection coin is ``np.random.RandomState(seed)``,
as in JAX, so the same steps take the second pass; the augmentation of both
pipelines and the dropout draw from torch generators (the loader's, one on
the device seeded ``seed + 78 + rank`` for the half-resolution pipeline,
and one per step seeded from a CPU generator at ``seed + 77``), where JAX
splits a PRNG key.

``--num-devices N`` starts N ranks on this host (one per GPU, rank i on
``cuda:i``; over gloo on the CPU with ``--device cpu``), as
``tools/train`` does: each steps on ``TRAIN.batch_per_gpu`` rows of its own
shard through the data-parallel step, both passes (the cycle-detection
coin is the same on every rank), at the LR times N (:89), SyncBN with
``TRAIN.syncBN``; rank 0 alone evaluates, logs and writes checkpoints
(:121, :174, :192).
"""

from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.data.device_pipeline import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    DevicePipeline,
)
from litehandnet_tpu_torch.data.loader import DataLoader
from litehandnet_tpu_torch.eval.legacy_eval import evaluate_ap, heatmap_pck
from litehandnet_tpu_torch.eval.result_parser import ResultParser, to_numpy
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.layers import set_sync_bn
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.train.distributed import (
    is_chief,
    make_mesh,
    make_train_step,
    process_index,
    run_ranks,
)
from litehandnet_tpu_torch.train.optim import make_optimizer
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.logging_ import MetricLogger

TRAIN_KEYS = ("img", "target", "target_weight", "simdr_x", "simdr_y")


def sine_decay_schedule(base_lr: float, steps_per_epoch: int, T: int = 40,
                        lr_gamma: float = 0.5):
    """Per-epoch sine-decay LR of step t (reference :110-113): one cosine
    quarter over a period of ``T + epoch / T`` epochs times ``lr_gamma **
    (epoch / T)``, floored at 5e-7. The reference steps its LambdaLR only
    while the LR is above 5e-7 (:215-217), so it freezes at the end of the
    first period and never restarts; the floor reproduces that."""

    def schedule(step: int) -> float:
        epoch = step / steps_per_epoch
        frac = min(epoch / (T + epoch / T), 1.0)
        lr = base_lr * math.cos(frac * math.pi / 2) * lr_gamma ** (epoch / T)
        return max(lr, 5e-7)

    return schedule


def adamw_factory(schedule, base_lr: float):
    """The optimizer factory of ``TrainState.create``: optax's ``adamw`` on
    ``schedule`` (weight decay 1e-4 scaled by the LR, as optax applies it)."""

    def factory(params):
        optimizer = make_optimizer("AdamW", params, base_lr)
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda t: schedule(t) / base_lr)
        return optimizer, scheduler

    return factory


def _step_generator(seeds: torch.Generator, device) -> torch.Generator:
    """A dropout generator on ``device`` seeded from ``seeds``."""
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=seeds))
    return torch.Generator(device).manual_seed(seed)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks to start on this host, one per GPU")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--workers", type=int, default=8)
    parser.add_argument("--cd-prob", type=float, default=0.6,
                        help="cycle-detection pass probability (:204)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    if args.num_devices is not None:
        run_ranks(_train, args.num_devices, (args,), device=args.device)
        return None
    return _train(resolve_device(args.device), args)


def _train(device, args):
    """One rank's (or the one process's) training on ``device``; returns
    the final ``TrainState``."""
    world = make_mesh(device=device)
    cfg = get_config(args.cfg)
    cfg.MODEL.with_region_map = True
    if cfg.LOSS.type.lower() != "centersimdrloss":
        cfg.LOSS.type = "CenterSimdrLoss"
    batch = int(cfg.TRAIN.batch_per_gpu)
    loader = DataLoader(cfg, "train", batch_size=batch,
                        num_workers=args.workers,
                        seed=args.seed + process_index(), device=device)
    steps_per_epoch = max(len(loader), 1)

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(args.seed)
        model = get_model(cfg, device="cpu")
        criterion = get_loss(cfg)
    if bool(cfg.TRAIN.get("syncBN", False)) and world.size > 1:
        set_sync_bn(model, world.group)
    if device.type == "cuda":
        model = model.to(device, memory_format=torch.channels_last)
    base_lr = float(cfg.OPTIMIZER.lr)
    schedule = sine_decay_schedule(
        base_lr * world.size, steps_per_epoch,
        T=int(cfg.OPTIMIZER.get("T", 40)),
        lr_gamma=float(cfg.OPTIMIZER.get("lr_gamma", 0.5)))
    state = TrainState.create(model, criterion.to(device),
                              adamw_factory(schedule, base_lr * world.size))
    step_fn = make_train_step(device, world)

    # the half-resolution pipeline of the cycle-detection pass; SimDR
    # supervision stays with the full-resolution step
    half_cfg = get_config(args.cfg)
    half_cfg.MODEL.with_region_map = True
    half_cfg.DATASET.image_size = [s // 2 for s in cfg.DATASET.image_size]
    half_cfg.DATASET.heatmap_size = [s // 2 for s in cfg.DATASET.heatmap_size]
    half_cfg.PIPELINE.simdr_split_ratio = 0
    cd_pipeline = DevicePipeline(half_cfg, loader.dataset.ann_info["flip_index"],
                                 is_train=True, device=device)

    directory = run_dir(cfg)
    ckpt = CheckpointManager(directory, cfg)
    logger = MetricLogger(directory, enabled=is_chief())
    parser_ = ResultParser(cfg, cd_enabled=False, device=device)

    rng = np.random.RandomState(args.seed)
    seeds = torch.Generator().manual_seed(args.seed + 77)
    cd_draws = torch.Generator(device).manual_seed(
        args.seed + 78 + process_index())
    total_epochs = int(cfg.TRAIN.get("total_epoches", 10))
    eval_interval = int(cfg.EVAL.get("interval", 1) or 1)
    best_pck = 0.0
    val_loader = None  # built at the first evaluation
    for epoch in range(total_epochs):
        agg, n = {}, 0
        for raw in loader.batches(epoch):
            metrics = step_fn(state, {k: raw[k] for k in TRAIN_KEYS if k in raw},
                              _step_generator(seeds, device))
            n += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
            if rng.rand() < args.cd_prob:
                # img_raw is in canvas coords (the loader may have shifted
                # or downscaled the source), so the fresh (center, scale)
                # comes from bbox_canvas and the joints from joints_canvas
                bbox = np.asarray(raw["bbox_canvas"])
                centers = bbox[:, :2] + bbox[:, 2:] / 2.0
                sides = np.maximum(bbox[:, 2:3], bbox[:, 3:4])
                scales = np.concatenate([sides, sides], axis=1) / 200.0 * 1.3
                cd_batch = cd_pipeline(
                    _raw_images(raw), raw["joints_canvas"], raw["vis_src"],
                    centers, scales, np.zeros(len(bbox), np.float32),
                    cd_draws, bboxes=bbox)
                cd_metrics = step_fn(
                    state, {k: cd_batch[k] for k in TRAIN_KEYS if k in cd_batch},
                    _step_generator(seeds, device))
                agg["cd_loss"] = agg.get("cd_loss", 0.0) + cd_metrics["loss"]
        agg = {k: float(v) / max(n, 1) for k, v in agg.items()}
        logger.log(epoch, agg, prefix="train/")
        # reference cadence: epoch % eval_interval == 0 (:341-343); the
        # chief alone evaluates (its forward is eval-mode, no collective)
        if is_chief() and epoch % eval_interval == 0:
            if val_loader is None:
                val_loader = DataLoader(cfg, "val", batch_size=batch,
                                        num_workers=args.workers,
                                        seed=args.seed, drop_last=False,
                                        device=device, shard=False)
            metrics = evaluate_multihand_pck(state.model, val_loader, parser_,
                                             full_metrics=True)
            pck = metrics["coor_pck"]
            logger.log(epoch, {"pck": pck, **metrics}, prefix="val/")
            # the best checkpoint follows an improved PCK (:304-329)
            if pck > best_pck:
                best_pck = pck
                ckpt.save(state, epoch, best=True)
        if is_chief():
            print(f"epoch {epoch}: {agg} best_pck={best_pck:.4f}", flush=True)
        ckpt.save(state, epoch)
    logger.close()
    loader.close()
    if val_loader is not None:
        val_loader.close()
    return state


@torch.no_grad()
def evaluate_multihand_pck(model, loader, parser_, max_batches=50,
                           full_metrics=False):
    """The reference Gen-1 ``test()`` (:240-278): boxes decoded from the last
    stack's region maps, per-box keypoints, multi-hand coordinate PCK
    against the ground truth, all in crop space.

    With ``full_metrics`` also the reference ``test()``'s heatmap PCK and
    region-map AP, keyed as JAX keys them (the reference's own calls pass
    the keypoint channels to ``evaluate_ap``, PARITY.md). Returns the PCK,
    or a dict of ``coor_pck``, ``hm_pck``, ``ap50`` and ``ap``.
    """
    model.eval()
    image_size = parser_.image_size[0]
    pcks, hm_pcks, ap50s, aps = [], [], [], []
    for bi, raw in enumerate(loader.batches(0)):
        if bi >= max_batches:
            break
        out = model(raw["img"].permute(0, 3, 1, 2))
        hm_list = out[0] if isinstance(out, tuple) else out
        hm = hm_list[-1].float().permute(0, 2, 3, 1)   # [B, H, W, K + 3]
        # the crop-space ground-truth box as [B, 1, 4] (cx, cy, w, h)
        bb = to_numpy(raw["bbox_crop"])
        gt_boxes = np.stack([bb[:, 0] + bb[:, 2] / 2, bb[:, 1] + bb[:, 3] / 2,
                             bb[:, 2], bb[:, 3]], axis=-1)[:, None]
        n_kpt = hm.shape[-1] - 3
        if full_metrics:
            # the scale bridge: the targets hold w/h as ratios of the input,
            # evaluate_ap decodes the Gen-1 scale (ratio x heatmap size);
            # without it every box is ~0 px wide and AP is 0
            region = hm[..., -3:].clone()
            region[..., 1:] *= torch.tensor(
                [hm.shape[2], hm.shape[1]], dtype=region.dtype,
                device=region.device)
            ap50, ap, _ = evaluate_ap(region, gt_boxes.tolist(), image_size)
            ap50s.append(ap50)
            aps.append(ap)
            tgt = to_numpy(raw["target"])
            if tgt.ndim == 5:  # stacked [B, S, C, H, W]
                tgt = tgt[:, -1]
            tw = to_numpy(raw["target_weight"])[:, :n_kpt, None]
            hm_pcks.append(heatmap_pck(
                to_numpy(hm[..., :n_kpt]),
                tgt[:, :n_kpt].transpose(0, 2, 3, 1), gt_boxes,
                image_size=image_size, target_weight=tw))
        boxes = parser_.get_pred_bbox(hm[..., -3:])
        kpts = parser_.get_group_keypoints(raw["img"], hm[..., :-3], boxes)
        gt_j = to_numpy(raw["joints"])             # [B, K, 2] crop coords
        gt_vis = to_numpy(raw["target_weight"])[:, :gt_j.shape[1]]
        gt_kpts = np.concatenate([gt_j, gt_vis[..., None]], axis=-1)[:, None]
        pcks.append(parser_.evaluate_pck(kpts, gt_kpts, gt_boxes))
    coor_pck = float(np.mean(pcks)) if pcks else 0.0
    if not full_metrics:
        return coor_pck
    return dict(coor_pck=coor_pck,
                hm_pck=float(np.mean(hm_pcks)) if hm_pcks else 0.0,
                ap50=float(np.mean(ap50s)) if ap50s else 0.0,
                ap=float(np.mean(aps)) if aps else 0.0)


def _raw_images(raw):
    """The loader's uint8 canvases, or the processed crop de-normalized
    when the batch has none."""
    if "img_raw" in raw:
        return raw["img_raw"]
    img = to_numpy(raw["img"])
    mean = np.array(IMAGENET_MEAN, np.float32)
    std = np.array(IMAGENET_STD, np.float32)
    return ((img * std + mean) * 255.0).clip(0, 255).astype(np.uint8)


if __name__ == "__main__":
    main()
