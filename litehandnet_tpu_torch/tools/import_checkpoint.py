"""Bring a reference PyTorch checkpoint into the port's run layout (port of
``litehandnet_tpu/tools/import_checkpoint.py``).

The reference trains to ``.pth`` dicts ``{epoch, state_dict, optimizer,
config, min_val_loss}`` (dist_train.py:212-233), bare state dicts, or (its
published SRHandNet) a TorchScript archive. This CLI loads one into the
port's train graph of ``cfg.MODEL.name`` (or ``--family``) and saves it with
``CheckpointManager`` in the experiment's run directory
(``save_root/dataset/model/ID/``), so that ``tools/test --cfg ...
--load-best`` evaluates it with no code. The port's modules carry the
reference's names, so the state dict loads strictly as it is, with no
renaming; only DDP's ``module.`` prefix is stripped.

Criterion-owned parameters (the SimDR linear decoders,
loss/centernet_simdr_loss.py:42-69, the auto-weight ``mtl_p``) start fresh
from seed 1, as JAX's ``_synth_crit_batch`` init does: the reference's
checkpoints store only ``model.state_dict()``.

Usage:
    python -m litehandnet_tpu_torch.tools.import_checkpoint \
        --cfg litehandnet/freihand_256_dark_h4_ca_r4 --pth best_model.pth \
        [--slot best|latest|both] [--family NAME] [--force] \
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.precision import DynamicLossScaler
from litehandnet_tpu_torch.train.state import TrainState

SLOTS = {"best": ("best",), "latest": ("latest",), "both": ("best", "latest")}


def read_reference(path: str):
    """(state dict without ``module.`` prefixes, epoch, min_val_loss) of a
    reference ``.pth``: a ``{epoch, state_dict, ...}`` dict, a bare state
    dict or a TorchScript archive."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, torch.jit.ScriptModule):
        # a scripted module keeps its attribute names in its state dict
        ckpt = {"state_dict": ckpt.state_dict()}
    state_dict = ckpt.get("state_dict", ckpt)
    state_dict = {(k[len("module."):] if k.startswith("module.") else k): v
                  for k, v in state_dict.items()}
    epoch = int(ckpt.get("epoch", 0))
    min_val_loss = float(ckpt.get("min_val_loss", float("inf")))
    return state_dict, epoch, min_val_loss


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="reference .pth -> the port's checkpoint in the run "
                    "directory")
    parser.add_argument("--cfg", required=True, help="experiment config")
    parser.add_argument("--pth", required=True, help="torch checkpoint file")
    parser.add_argument("--family", default=None,
                        help="model family to load into (default: "
                             "cfg.MODEL.name)")
    parser.add_argument("--slot", choices=sorted(SLOTS), default="both",
                        help="which checkpoint slot(s) to write")
    parser.add_argument("--force", action="store_true",
                        help="overwrite existing checkpoints in the run "
                             "directory")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)

    cfg = get_config(args.cfg)
    if args.family:
        cfg.MODEL.name = args.family
    device = resolve_device(args.device)
    state_dict, epoch, min_val_loss = read_reference(args.pth)

    out_dir = run_dir(cfg)
    slots = SLOTS[args.slot]
    if not args.force:
        # never silently replace a trained run's checkpoints
        existing = [s for s in slots if os.path.exists(os.path.join(
            out_dir, ("best" if s == "best" else "checkpoint") + ".pt"))]
        if existing:
            raise SystemExit(
                f"refusing to overwrite existing checkpoint slot(s) "
                f"{existing} in {out_dir}; pass --force to replace them")

    model = get_model(cfg, device=device)
    model.load_state_dict(state_dict)          # strict: the same names
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(1)
        criterion = get_loss(cfg).to(device)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=1)
    scaler = DynamicLossScaler() if cfg.TRAIN.get("loss_scale", False) else None
    state = TrainState.create(model, criterion, tx, loss_scaler=scaler)

    mgr = CheckpointManager(out_dir, cfg)
    for slot in slots:
        mgr.save(state, epoch=epoch, min_val_loss=min_val_loss,
                 best=slot == "best")
    print(f"imported {args.pth} -> {out_dir} (slots: {', '.join(slots)}, "
          f"epoch {epoch})", flush=True)
    return out_dir


if __name__ == "__main__":
    main()
