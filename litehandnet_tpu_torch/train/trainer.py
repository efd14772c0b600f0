"""Top-down trainer: epoch loops, evaluation cadence, best-model tracking
(port of ``litehandnet_tpu/train/trainer.py``; reference dist_train.py:50-233
and train/topdown_trainer.py).

The trainer is data-source agnostic: ``train_batches(epoch)`` and
``val_batches()`` return iterables of batch dicts in the layout of
``train.distributed`` (``img`` ``[B, H, W, 3]``, ``target``
``[B, K, H, W]``, ``target_weight`` ``[B, K]``). It runs on one device,
CUDA unless ``device="cpu"`` is asked, or as one rank of a process group
(``train.distributed.initialize_multihost``): then each rank's batches are
its own rows, the steps are data-parallel, the LR is scaled by the world
size, and the chief alone logs, prints and writes checkpoints (JAX
``trainer.py:45-67, 210-227``).
"""

from __future__ import annotations

import time
from typing import Callable, Iterable, Optional

import torch

from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.layers import set_sync_bn
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.train.distributed import (
    is_chief,
    make_eval_step,
    make_mesh,
    make_train_step,
)
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.precision import DynamicLossScaler
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.logging_ import MetricLogger


class Trainer:
    def __init__(self, cfg, steps_per_epoch: int,
                 log_dir: Optional[str] = None, device="cuda"):
        """Under a process group the world is its ranks, and a CUDA
        ``device`` without an index is this rank's (``make_mesh``).

        Raises RuntimeError when ``device`` is CUDA and no CUDA device is
        available."""
        self.cfg = cfg
        self.world = make_mesh(device=device)
        self.device = self.world.device
        # the reference multiplies the LR by the world size
        # (optimizer_scheduler.py); SyncBN needs more than one rank
        self.sync_bn = (bool(cfg.TRAIN.get("syncBN", False))
                        and self.world.size > 1)
        self.tx, self.schedule = make_optimizer_from_config(
            cfg, steps_per_epoch=steps_per_epoch, world_size=self.world.size)
        self.train_step = make_train_step(self.device, self.world)
        self.eval_step = make_eval_step(self.device, self.world)
        self.steps_per_epoch = steps_per_epoch
        directory = log_dir or run_dir(cfg)
        self.ckpt = CheckpointManager(directory, cfg)
        self.logger = MetricLogger(directory, enabled=is_chief())
        self.min_val_loss = float("inf")
        self.start_epoch = 0

    # -- state ------------------------------------------------------------
    def init_state(self, seed: int = 0) -> TrainState:
        """Model (PyTorch's default init drawn from ``seed`` on the CPU, so
        a seed gives the same weights on every device and rank), criterion,
        optimizer and, with ``TRAIN.loss_scale``, a dynamic loss scaler."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            model = get_model(self.cfg, device="cpu")
            criterion = get_loss(self.cfg)
        if self.sync_bn:
            set_sync_bn(model, self.world.group)
        if self.device.type == "cuda":
            model = model.to(self.device, memory_format=torch.channels_last)
        criterion = criterion.to(self.device)
        scaler = (DynamicLossScaler() if self.cfg.TRAIN.get("loss_scale", False)
                  else None)
        return TrainState.create(model, criterion, self.tx, loss_scaler=scaler)

    def maybe_resume(self, state: TrainState) -> TrainState:
        if not self.cfg.CHECKPOINT.get("resume", False):
            return state
        best = self.cfg.CHECKPOINT.get("load_best", False)
        if not self.cfg.OPTIMIZER.get("resume", True):
            # weights-only resume (dist_train.py:101-111): model, BN
            # statistics and criterion parameters come back; the optimizer
            # is fresh, the epoch 0 and the best-loss floor reset. The
            # reference skips its warmup pass whenever a checkpoint exists
            # (dist_train.py:145-147), so the schedule is rebuilt without
            # warmup: full LR from step 0.
            raw, _ = self.ckpt.restore_raw(best=best)
            if raw is None:
                return state
            if int(self.cfg.OPTIMIZER.get("warmup_steps", 0) or 0) > 0:
                cfg_nowarm = config_from_dict(self.cfg.to_dict())
                cfg_nowarm.OPTIMIZER.warmup_steps = 0
                self.tx, self.schedule = make_optimizer_from_config(
                    cfg_nowarm, steps_per_epoch=self.steps_per_epoch,
                    world_size=self.world.size)
            state.model.load_state_dict(raw["model"])
            state.criterion.load_state_dict(raw["criterion"])
            return TrainState.create(state.model, state.criterion, self.tx,
                                     loss_scaler=state.loss_scaler)
        restored, meta = self.ckpt.restore(state, best=best)
        if restored is None:
            return state
        self.start_epoch = int(meta.get("epoch", -1)) + 1
        # the reference resets the floor to 1e6 on every resume (it saves
        # 'min_val_sum' but reads 'min_val_loss', dist_train.py:100,214);
        # restoring the true floor keeps `best` from being overwritten by a
        # worse model
        self.min_val_loss = float(meta.get("min_val_loss", float("inf")))
        return restored

    # -- loops ------------------------------------------------------------
    def train_one_epoch(self, state: TrainState, batches: Iterable,
                        epoch: int, generator: torch.Generator):
        """Reference train_one_epoch (topdown_trainer.py:68-87). Each step
        draws one seed from ``generator`` for its dropout generator (each
        rank its own from it). The metrics are means over the ranks."""
        agg, n = {}, 0
        for batch in batches:
            seed = int(torch.randint(0, 2 ** 62, (1,), generator=generator))
            step_gen = torch.Generator(self.device).manual_seed(seed)
            metrics = self.train_step(state, batch, step_gen)
            n += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
        agg = {k: float(v) / max(n, 1) for k, v in agg.items()}
        self.logger.log(epoch, agg, prefix="train/")
        self.logger.log(epoch, {"lr": self.schedule(state.step)})
        return state, agg

    def val_one_epoch(self, state: TrainState, batches: Iterable,
                      epoch: int):
        """Reference val_one_epoch (topdown_trainer.py:26-41): loss only, the
        mean over the ranks, so every rank takes the same save decision."""
        agg, n = {}, 0
        for batch in batches:
            _, metrics = self.eval_step(state, batch)
            n += 1
            for k, v in metrics.items():
                agg[k] = agg.get(k, 0.0) + v
        agg = {k: float(v) / max(n, 1) for k, v in agg.items()}
        self.logger.log(epoch, agg, prefix="val/")
        return agg

    def fit(self, state: TrainState,
            train_batches: Callable[[int], Iterable],
            val_batches: Optional[Callable[[], Iterable]] = None,
            seed: int = 0) -> TrainState:
        cfg = self.cfg
        total_epochs = int(cfg.TRAIN.get("total_epoches", 1))
        eval_interval = int(cfg.EVAL.get("interval", 1)) if "EVAL" in cfg else 1
        ckpt_interval = int(cfg.CHECKPOINT.get("interval", 10))
        generator = torch.Generator().manual_seed(seed + 1234)

        state = self.maybe_resume(state)
        for epoch in range(self.start_epoch, total_epochs):
            t0 = time.time()
            state, train_metrics = self.train_one_epoch(
                state, train_batches(epoch), epoch, generator)
            msg = (f"epoch {epoch}: train_loss="
                   f"{train_metrics.get('loss', float('nan')):.5f} "
                   f"({time.time() - t0:.1f}s)")
            # reference cadence (dist_train.py:181): epoch % interval == 0,
            # which includes the first epoch of the run
            if val_batches is not None and epoch % eval_interval == 0:
                val_loss = self.val_one_epoch(state, val_batches(), epoch).get(
                    "loss", float("nan"))
                msg += f" val_loss={val_loss:.5f}"
                # `<=` like the reference (dist_train.py:209 saves on ties)
                if val_loss <= self.min_val_loss:
                    self.min_val_loss = val_loss
                    self.ckpt.save(state, epoch, self.min_val_loss, best=True)
            # periodic save + an unconditional last-epoch save
            # (dist_train.py:224-225)
            if epoch % ckpt_interval == 0 or epoch == total_epochs - 1:
                self.ckpt.save(state, epoch, self.min_val_loss)
            if is_chief():
                print(msg, flush=True)
        return state

    def close(self) -> None:
        """Close the metric log."""
        self.logger.close()
