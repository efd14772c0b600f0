"""The train and eval steps (port of the single-device path of
``litehandnet_tpu/train/distributed.py``: ``make_train_step`` :85-167 and
``make_eval_step`` :187-208).

Batches keep the JAX package's layout at this boundary: ``img``
``[B, H, W, 3]`` float32 (normalized), which the step views as NCHW in
channels_last memory without a copy; ``target`` ``[B, K, H, W]`` (the port's
heatmap layout; a list per scale for SRHandNet) and ``target_weight``
``[B, K]`` (or a list per scale). numpy arrays or tensors.

JAX's ``make_train_step`` takes the model, criterion and optimizer because
its state holds arrays only; here they live in :class:`TrainState`.
Multi-GPU data parallelism (DDP, SyncBatchNorm) is not ported yet: with
``TRAIN.syncBN`` on one device BatchNorm is plain, as in JAX.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.models.layers import set_dropout_generator
from litehandnet_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]


def to_device(v, device: torch.device, dtype: Optional[torch.dtype] = None):
    """A batch entry on ``device`` (in ``dtype`` when given): each element of
    a list (SRHandNet's per-scale targets and weights, JAX ``_to_global``
    :240-254) on its own."""
    if isinstance(v, (list, tuple)):
        return [to_device(e, device, dtype) for e in v]
    t = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v))
    return t.to(device, dtype, non_blocking=True)


def batch_to_device(batch: dict, device: torch.device) -> dict:
    """Tensors on ``device`` (lists of them for multi-scale targets);
    ``img`` becomes the model's NCHW input, in channels_last memory on CUDA.
    On the CPU it is made NCHW-contiguous: the CPU backward of this model in
    channels_last memory corrupted the heap under PyTorch 2.13."""
    out = {k: to_device(v, device) for k, v in batch.items()}
    img = out["img"].permute(0, 3, 1, 2)
    out["img"] = img if device.type == "cuda" else img.contiguous()
    return out


def _trained_params(state: TrainState):
    return [p for group in state.optimizer.param_groups
            for p in group["params"]]


def make_train_step(device="cuda") -> Callable[..., Metrics]:
    """Build ``train_step(state, batch, generator=None) -> metrics``.

    One step: train-mode forward (channel dropout drawn from ``generator``),
    criterion, backward, optimizer and LR-schedule step, all in place on
    ``state``. With a loss scaler the loss is scaled before the backward
    and the gradients unscaled after it; on a non-finite gradient the update
    is skipped and the BatchNorm running statistics the forward moved are
    put back (``distributed.py:147-157``), so parameters, optimizer state,
    schedule and statistics stay as they were; ``state.step`` still counts
    the step. Metrics are ``{'loss', 'heatmap'}`` as detached tensors on
    the device (reading them waits for the step).

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    dev = resolve_device(device)

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None) -> Metrics:
        batch = batch_to_device(batch, dev)
        model, criterion, scaler = state.model, state.criterion, state.loss_scaler
        model.train()
        criterion.train()
        saved = None
        if scaler is not None:
            saved = [b.detach().clone() for b in model.buffers()]
        set_dropout_generator(model, generator)
        try:
            out = model(batch["img"])
        finally:
            set_dropout_generator(model, None)
        loss, loss_dict = criterion(out, batch)
        state.optimizer.zero_grad(set_to_none=True)
        (loss if scaler is None else scaler.scale_loss(loss)).backward()
        finite = True
        if scaler is not None:
            grads = [p.grad for p in _trained_params(state)
                     if p.grad is not None]
            scaler.unscale(grads)
            finite = scaler.update(grads)
        if finite:
            state.optimizer.step()
            state.scheduler.step()
        else:
            with torch.no_grad():
                for buf, old in zip(model.buffers(), saved):
                    buf.copy_(old)
        state.step += 1
        metrics = {"loss": loss.detach()}
        metrics.update({k: v.detach() for k, v in loss_dict.items()})
        return metrics

    return train_step


def make_eval_step(device="cuda") -> Callable[..., Tuple[torch.Tensor,
                                                         Metrics]]:
    """Build ``eval_step(state, batch) -> (heatmaps, metrics)``: eval-mode
    forward and loss (reference val_one_epoch, topdown_trainer.py:26-41).

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    dev = resolve_device(device)

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        batch = batch_to_device(batch, dev)
        state.model.eval()
        state.criterion.eval()
        out = state.model(batch["img"])
        loss, loss_dict = state.criterion(out, batch)
        metrics = {"loss": loss}
        metrics.update(loss_dict)
        return out, metrics

    return eval_step
