"""Training CLI (port of ``litehandnet_tpu/tools/train.py``; the reference
``dist_train.py``).

Usage:
    python -m litehandnet_tpu_torch.tools.train --cfg <config.py or name> \
        [--seed S] [--workers N] [--decode-procs N] [--epochs E] \
        [--num-devices N] [--coordinator host:port --num-processes P \
         --process-id I] [--device cuda|cpu]

Builds the train and val loaders (decode on the host, the fused pipeline on
the device), then ``Trainer.init_state`` and ``Trainer.fit`` on their
batches.

Several GPUs (one process per GPU, as the reference's ``mp.spawn``,
``dist_train.py:271-276``): ``--num-devices N`` starts N ranks on this
host, rank i on ``cuda:i`` (over gloo on the CPU with ``--device cpu``).
On several hosts each host runs the same command with ``--coordinator``
(rank 0's host and a free port), ``--num-processes`` (the number of hosts)
and its ``--process-id``; under torchrun (``torchrun --nproc-per-node N -m
litehandnet_tpu_torch.tools.train ...``) each process is one rank from
torchrun's environment. Each rank steps on ``TRAIN.batch_per_gpu`` rows of
its own shard of the records, its loader seeded ``seed + rank``; the LR is
scaled by the world size, and rank 0 alone logs and writes checkpoints.
"""

from __future__ import annotations

import argparse

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.data.loader import DataLoader
from litehandnet_tpu_torch.train.distributed import (
    initialize_multihost,
    is_chief,
    make_mesh,
    process_index,
    run_ranks,
)
from litehandnet_tpu_torch.train.trainer import Trainer

#: the batch keys the train and eval steps read
STEP_KEYS = ("img", "target", "target_weight", "simdr_x", "simdr_y")


def main(argv=None):
    """Train as ``argv`` says. Returns the final ``TrainState`` of a run in
    this process, None when ``--num-devices`` ran the ranks in new ones.

    Raises:
        RuntimeError: ``--device`` is CUDA and no CUDA device is available.
        ValueError: ``--num-devices`` exceeds the CUDA device count.
    """
    parser = argparse.ArgumentParser(description="litehandnet_tpu_torch trainer")
    parser.add_argument("--cfg", required=True, help="experiment config")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks to start on this host, one per GPU")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of the rendezvous of several hosts")
    parser.add_argument("--num-processes", type=int, default=None,
                        help="with --coordinator: the number of hosts (of "
                             "ranks without --num-devices)")
    parser.add_argument("--process-id", type=int, default=None,
                        help="with --coordinator: this host's index (this "
                             "rank without --num-devices)")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--workers", type=int, default=8,
                        help="decode threads per loader")
    parser.add_argument("--decode-procs", type=int, default=0,
                        help="decode worker processes per loader "
                             "(data/mp_decode.py) instead of the threads; "
                             "0 decodes in this process")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override cfg.TRAIN.total_epoches")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    if args.num_devices is not None:
        run_ranks(_train, args.num_devices, (args,), device=args.device,
                  coordinator=args.coordinator,
                  num_processes=args.num_processes or 1,
                  process_id=args.process_id or 0)
        return None
    joined = initialize_multihost(args.coordinator, args.num_processes,
                                  args.process_id, device=args.device)
    try:
        return _train(make_mesh(device=args.device).device, args)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _train(device, args):
    """One rank's (or the one process's) training on ``device``."""
    cfg = get_config(args.cfg)
    if args.epochs is not None:
        cfg.TRAIN.total_epoches = args.epochs
    batch = int(cfg.TRAIN.batch_per_gpu)
    loader_kw = dict(batch_size=batch, num_workers=args.workers,
                     device=device, decode_procs=args.decode_procs)
    with DataLoader(cfg, "train", seed=args.seed + process_index(),
                    **loader_kw) as train_loader, \
            DataLoader(cfg, "val", seed=args.seed, **loader_kw) as val_loader:
        steps_per_epoch = max(len(train_loader), 1)
        trainer = Trainer(cfg, steps_per_epoch, device=device)
        if is_chief():
            print(f"device={args.device} ranks={trainer.world.size} "
                  f"batch={batch} steps/epoch={steps_per_epoch} "
                  f"train={len(train_loader.dataset)} "
                  f"val={len(val_loader.dataset)}", flush=True)

        def step_batches(loader, epoch):
            for b in loader.batches(epoch):
                yield {k: v for k, v in b.items() if k in STEP_KEYS}

        try:
            state = trainer.init_state(seed=args.seed)
            state = trainer.fit(
                state, lambda epoch: step_batches(train_loader, epoch),
                lambda: step_batches(val_loader, 0), seed=args.seed)
        finally:
            trainer.close()
    if is_chief():
        print("training complete", flush=True)
    return state


if __name__ == "__main__":
    main()
