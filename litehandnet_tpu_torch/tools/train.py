"""Training CLI on one device (port of ``litehandnet_tpu/tools/train.py``).

Usage:
    python -m litehandnet_tpu_torch.tools.train --cfg <config.py or name> \
        [--seed S] [--workers N] [--decode-procs N] [--epochs E] \
        [--device cuda|cpu]

Builds the train and val loaders (decode on the host, the fused pipeline on
the device), then ``Trainer.init_state`` and ``Trainer.fit`` on their
batches. Multi-GPU training (``--num-devices``, ``--coordinator``) is not
ported yet.
"""

from __future__ import annotations

import argparse

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.data.loader import DataLoader
from litehandnet_tpu_torch.train.trainer import Trainer

#: the batch keys the train and eval steps read
STEP_KEYS = ("img", "target", "target_weight", "simdr_x", "simdr_y")


def main(argv=None):
    parser = argparse.ArgumentParser(description="litehandnet_tpu_torch trainer")
    parser.add_argument("--cfg", required=True, help="experiment config")
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

    cfg = get_config(args.cfg)
    if args.epochs is not None:
        cfg.TRAIN.total_epoches = args.epochs
    batch = int(cfg.TRAIN.batch_per_gpu)
    loader_kw = dict(batch_size=batch, num_workers=args.workers,
                     seed=args.seed, device=args.device,
                     decode_procs=args.decode_procs)
    with DataLoader(cfg, "train", **loader_kw) as train_loader, \
            DataLoader(cfg, "val", **loader_kw) as val_loader:
        steps_per_epoch = max(len(train_loader), 1)
        print(f"device={args.device} batch={batch} "
              f"steps/epoch={steps_per_epoch} train={len(train_loader.dataset)} "
              f"val={len(val_loader.dataset)}", flush=True)

        def step_batches(loader, epoch):
            for b in loader.batches(epoch):
                yield {k: v for k, v in b.items() if k in STEP_KEYS}

        trainer = Trainer(cfg, steps_per_epoch, device=args.device)
        try:
            state = trainer.init_state(seed=args.seed)
            state = trainer.fit(
                state, lambda epoch: step_batches(train_loader, epoch),
                lambda: step_batches(val_loader, 0), seed=args.seed)
        finally:
            trainer.close()
    print("training complete", flush=True)
    return state


if __name__ == "__main__":
    main()
