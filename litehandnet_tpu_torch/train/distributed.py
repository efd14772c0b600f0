"""The train and eval steps, and data parallelism over processes (port of
``litehandnet_tpu/train/distributed.py``).

Batches keep the JAX package's layout at this boundary: ``img``
``[B, H, W, 3]`` float32 (normalized), which the step views as NCHW in
channels_last memory without a copy; ``target`` ``[B, K, H, W]`` (the port's
heatmap layout; a list per scale for SRHandNet) and ``target_weight``
``[B, K]`` (or a list per scale). numpy arrays or tensors.

JAX's ``make_train_step`` takes the model, criterion and optimizer because
its state holds arrays only; here they live in :class:`TrainState`.

Data parallelism is PyTorch's idiom and the reference's
(``train/spawn_dist.py``): one process per GPU, each a rank of a
``torch.distributed`` process group (NCCL on CUDA, gloo on the CPU), each
stepping on its own rows. JAX runs one program over a device mesh instead;
the semantics of its multi-device step (:130-157) are kept:

* the model's gradients are averaged over the ranks by
  ``DistributedDataParallel`` and the criterion's (``auto_weight``) by an
  all-reduce, so the loss scaler decides on the averaged gradients and every
  rank skips the same step;
* the logged ``loss`` and its parts are means over the ranks;
* BatchNorm running statistics are averaged after the step (DDP's
  ``broadcast_buffers``, which would keep rank 0's, is off);
* with ``TRAIN.syncBN`` at world > 1 the BatchNorm batch statistics are
  means over the ranks (``models.layers.set_sync_bn``);
* dropout draws from a generator per rank, seeded from the step's seed and
  the rank (JAX folds ``axis_index`` into the key): the same distribution,
  other draws than JAX's.

``make_train_step(remat=True)`` (or ``LHN_REMAT=1``) rematerializes the
train-mode forward in the backward (:class:`Rematerialized`), as JAX wraps
``apply_model`` in ``jax.checkpoint`` (:100-101).
"""

from __future__ import annotations

import contextlib
import os
import shutil
import tempfile
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn
from torch.utils.checkpoint import checkpoint

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.models.layers import (
    rematerializing,
    set_dropout_generator,
)
from litehandnet_tpu_torch.train.state import TrainState

Metrics = Dict[str, torch.Tensor]

#: how long a rank waits for the others at the rendezvous and in a collective
DEFAULT_TIMEOUT = timedelta(minutes=30)


# -- the world ---------------------------------------------------------------

def process_index() -> int:
    """This process's rank, 0 without a process group (JAX
    ``jax.process_index``)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """The number of ranks, 1 without a process group (JAX
    ``jax.process_count``)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_chief() -> bool:
    """Rank 0, or no process group: the one process that writes
    checkpoints, logs and prints (replaces ``rank == 0`` gating)."""
    return process_index() == 0


@dataclass(frozen=True)
class World:
    """The data-parallel world of this process: ``size`` ranks, this one
    ``rank`` on ``device``; ``group`` is the process group (None when the
    process runs alone, without one)."""

    size: int
    rank: int
    device: torch.device
    group: Optional[object] = None


def _local_index(rank: int) -> int:
    """This rank's CUDA device index: torchrun's ``LOCAL_RANK``, else the
    rank modulo the local device count."""
    if "LOCAL_RANK" in os.environ:
        return int(os.environ["LOCAL_RANK"])
    return rank % max(torch.cuda.device_count(), 1)


def check_device_count(num_devices: Optional[int], device="cuda") -> None:
    """Raises ValueError when ``num_devices`` ranks of this host would need
    more CUDA devices than it has (never runs fewer ranks silently), and
    RuntimeError when ``device`` is CUDA and no CUDA device is available."""
    dev = resolve_device(device)
    if num_devices is None:
        return
    if num_devices < 1:
        raise ValueError(f"num_devices must be positive, not {num_devices}")
    if dev.type == "cuda" and num_devices > torch.cuda.device_count():
        raise ValueError(
            f"{num_devices} devices asked for, {torch.cuda.device_count()} "
            "CUDA devices available")


def make_mesh(num_devices: Optional[int] = None, device="cuda") -> World:
    """The world of this process (JAX ``make_mesh``: the 1-D ``data`` mesh).

    With a process group: its size and this rank, on ``cuda:<local rank>``
    (an explicit CUDA index in ``device`` is kept) or the CPU. Without one:
    a world of 1.

    Raises:
        ValueError: ``num_devices`` exceeds the CUDA device count, or asks
            for more than one rank in a process without a process group
            (ranks are processes: ``tools/train --num-devices``, torchrun).
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    check_device_count(num_devices, device)
    dev = resolve_device(device)
    if not dist.is_initialized():
        if num_devices is not None and num_devices > 1:
            raise ValueError(
                f"{num_devices} ranks asked for in a process without a process "
                "group: start one process per rank (tools/train --num-devices, "
                "torchrun) and call initialize_multihost first")
        return World(1, 0, dev)
    rank = dist.get_rank()
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", _local_index(rank))
    return World(dist.get_world_size(), rank, dev, dist.group.WORLD)


def local_devices(device="cuda") -> list:
    """Every device of ``device``'s type in this process: each CUDA device,
    or the CPU (one device)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [dev]


def batch_spec(world: World, n: int) -> slice:
    """The rows of an ``n``-row global batch that ``world.rank`` steps on
    (JAX ``P('data')``: the batch axis split over the ranks in order).

    Raises:
        ValueError: ``n`` does not divide into ``world.size`` equal shards.
    """
    if n % world.size:
        raise ValueError(f"a batch of {n} rows does not split over "
                         f"{world.size} ranks")
    per = n // world.size
    return slice(world.rank * per, (world.rank + 1) * per)


def globalize_batch(batch: dict, world: Optional[World] = None) -> dict:
    """``batch`` unchanged. Multi-controller JAX stitches each process's
    rows into one global array (:220-237); under DDP each rank steps on its
    own rows, and the collectives inside the step join the ranks."""
    return batch


def initialize_multihost(coordinator: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None,
                         backend: Optional[str] = None, device="cuda",
                         timeout: timedelta = DEFAULT_TIMEOUT) -> bool:
    """Join the process group (JAX ``jax.distributed.initialize``, the
    reference's tcp:// / env:// rendezvous, ``distributed_utils.py:7-29``).

    ``coordinator`` is ``host:port`` (a ``tcp://`` rendezvous) or a URL
    (``file://...``); ``num_processes`` and ``process_id`` default to
    torchrun's ``WORLD_SIZE`` and ``RANK``. Without a coordinator the
    rendezvous is torchrun's ``env://`` when its variables are set, else
    nothing happens (one process, no group). ``backend`` defaults to NCCL on
    CUDA and gloo on the CPU; on CUDA the process's device is set to its
    local rank's first. Returns whether it joined a group now.

    Raises:
        ValueError: a coordinator without a world size or rank.
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    if dist.is_initialized():
        return False
    env = all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if coordinator is None and not env:
        return False
    dev = resolve_device(device)
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if num_processes is None or process_id is None:
        raise ValueError("a coordinator needs num_processes and process_id "
                         "(or torchrun's WORLD_SIZE and RANK)")
    if coordinator is None:
        init_method = "env://"
    elif "://" in coordinator:
        init_method = coordinator
    else:
        init_method = f"tcp://{coordinator}"
    if dev.type == "cuda":
        torch.cuda.set_device(dev if dev.index is not None
                              else _local_index(process_id))
    dist.init_process_group(
        backend or ("nccl" if dev.type == "cuda" else "gloo"),
        init_method=init_method, world_size=num_processes, rank=process_id,
        timeout=timeout)
    return True


def run_ranks(main: Callable, num_devices: int, args: tuple = (),
              device="cuda", coordinator: Optional[str] = None,
              num_processes: int = 1, process_id: int = 0,
              timeout: timedelta = DEFAULT_TIMEOUT) -> None:
    """Run ``main(device, *args)`` in ``num_devices`` new processes of this
    host, each a rank of one process group, on ``cuda:<i>`` or the CPU
    (``torch.multiprocessing.spawn``, the reference's ``mp.spawn``,
    ``dist_train.py:271-276``). On several hosts, ``coordinator`` is the
    rendezvous (``host:port``), ``num_processes`` the number of hosts and
    ``process_id`` this host's index: host p's i-th process is rank
    ``p * num_devices + i``. Alone, the ranks meet in a file store in a new
    temporary directory. ``main`` must be picklable (a module-level
    function). Returns when every rank has returned; raises when one fails
    (the others are terminated).

    Raises:
        ValueError: more devices than the host has.
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    check_device_count(num_devices, device)
    dev_type = resolve_device(device).type
    store = None
    if coordinator is None:
        store = tempfile.mkdtemp(prefix="lhn_rendezvous_")
        coordinator = f"file://{os.path.join(store, 'store')}"
    try:
        torch.multiprocessing.spawn(
            _rank_entry, nprocs=num_devices, join=True,
            args=(main, args, dev_type, coordinator,
                  num_processes * num_devices, process_id * num_devices,
                  timeout))
    finally:
        if store is not None:
            shutil.rmtree(store, ignore_errors=True)


def _rank_entry(i: int, main: Callable, args: tuple, dev_type: str,
                coordinator: str, world_size: int, first_rank: int,
                timeout: timedelta) -> None:
    device = torch.device("cuda", i) if dev_type == "cuda" else torch.device("cpu")
    initialize_multihost(coordinator, world_size, first_rank + i,
                         device=device, timeout=timeout)
    try:
        main(device, *args)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def rank_seed(seed: int, rank: int) -> int:
    """A seed of ``rank``'s own from a shared ``seed``: ``seed`` itself at
    rank 0, so a world of 1 draws what one process draws."""
    return seed ^ ((rank * 0x9E3779B97F4A7C15) & (2 ** 63 - 1))


def _mean_over_ranks_(tensors, group) -> None:
    """Replace each tensor by its mean over the ranks, in one all-reduce."""
    if not tensors:
        return
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _metrics_mean(metrics: Metrics, group) -> Metrics:
    dtype = torch.promote_types(metrics["loss"].dtype, torch.float32)
    values = [v.detach().to(dtype).reshape(()).clone()
              for v in metrics.values()]
    _mean_over_ranks_(values, group)
    return dict(zip(metrics, values))


def _bn_running_stats(model: nn.Module) -> list:
    return [buf for mod in model.modules()
            if isinstance(mod, nn.modules.batchnorm._BatchNorm)
            and mod.running_mean is not None
            for buf in (mod.running_mean, mod.running_var)]


# -- the steps ---------------------------------------------------------------

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


class Rematerialized(nn.Module):
    """``model``'s forward, whose activations the backward recomputes
    instead of keeping them (``torch.utils.checkpoint``, non-reentrant;
    JAX ``jax.checkpoint`` around ``apply_model``, :100-101): one more
    forward's work for fewer live activations.

    The recompute runs under :func:`models.layers.rematerializing`: the
    BatchNorm running statistics move once a step, as in the plain step,
    and dropout replays ``generator`` from its state before the forward
    (the checkpoint's own RNG stash covers only PyTorch's default
    generators, which dropout uses when ``generator`` is None). A SyncBN
    site all-reduces its statistics again in the recompute, as JAX's
    ``psum`` does under ``jax.checkpoint``. Under DDP this module is the
    one DDP wraps, so DDP's forward runs once a step."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, img: torch.Tensor,
                generator: Optional[torch.Generator] = None):
        def contexts():
            replay = None
            if generator is not None:
                replay = torch.Generator(generator.device)
                replay.set_state(generator.get_state())
            return contextlib.nullcontext(), rematerializing(self.model, replay)

        return checkpoint(self.model, img, use_reentrant=False,
                          context_fn=contexts)


def make_train_step(device="cuda", world: Optional[World] = None,
                    remat: Optional[bool] = None) -> Callable[..., Metrics]:
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

    With a ``world`` that has a process group (``make_mesh`` after
    ``initialize_multihost``; at any size, 1 included) the step is
    data-parallel, as the module docstring says: ``state.model`` runs
    wrapped in ``DistributedDataParallel`` (``find_unused_parameters``, as
    the reference sets it, ``spawn_dist.py:49-58``), and every rank must
    call the step on its own rows of the same number of batches.

    ``remat`` (None: ``LHN_REMAT=1``, read here, as JAX :80-81) runs the
    forward as :class:`Rematerialized`: the same loss, gradients and
    statistics as the plain step, in exchange for a second forward in the
    backward.

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    dev = resolve_device(device)
    group = None if world is None else world.group
    if remat is None:
        remat = os.environ.get("LHN_REMAT", "0") == "1"
    wrapped = {}

    def forward_module(model: nn.Module) -> nn.Module:
        if group is None and not remat:
            return model
        known = wrapped.get(id(model))
        if known is None or known[0] is not model:
            module = Rematerialized(model) if remat else model
            if group is not None:
                from torch.nn.parallel import DistributedDataParallel

                module = DistributedDataParallel(
                    module, device_ids=[dev] if dev.type == "cuda" else None,
                    broadcast_buffers=False, find_unused_parameters=True,
                    process_group=group)
            known = wrapped[id(model)] = (model, module)
        return known[1]

    def train_step(state: TrainState, batch: dict,
                   generator: Optional[torch.Generator] = None) -> Metrics:
        batch = batch_to_device(batch, dev)
        model, criterion, scaler = state.model, state.criterion, state.loss_scaler
        model.train()
        criterion.train()
        saved = None
        if scaler is not None:
            saved = [b.detach().clone() for b in model.buffers()]
        if group is not None and generator is not None:
            generator = torch.Generator(generator.device).manual_seed(
                rank_seed(generator.initial_seed(), world.rank))
        set_dropout_generator(model, generator)
        inputs = (batch["img"], generator) if remat else (batch["img"],)
        try:
            out = forward_module(model)(*inputs)
        finally:
            set_dropout_generator(model, None)
        loss, loss_dict = criterion(out, batch)
        state.optimizer.zero_grad(set_to_none=True)
        (loss if scaler is None else scaler.scale_loss(loss)).backward()
        if group is not None:
            # DDP averaged the model's gradients in the backward
            _mean_over_ranks_([p.grad for p in criterion.parameters()
                               if p.grad is not None], group)
        finite = True
        if scaler is not None:
            grads = [p.grad for p in _trained_params(state)
                     if p.grad is not None]
            scaler.unscale(grads)
            finite = scaler.update(grads)
        if finite:
            state.optimizer.step()
            state.scheduler.step()
            if group is not None:
                with torch.no_grad():
                    _mean_over_ranks_(_bn_running_stats(model), group)
        else:
            with torch.no_grad():
                for buf, old in zip(model.buffers(), saved):
                    buf.copy_(old)
        state.step += 1
        metrics = {"loss": loss.detach()}
        metrics.update({k: v.detach() for k, v in loss_dict.items()})
        if group is not None:
            metrics = _metrics_mean(metrics, group)
        return metrics

    return train_step


def make_eval_step(device="cuda", world: Optional[World] = None
                   ) -> Callable[..., Tuple[torch.Tensor, Metrics]]:
    """Build ``eval_step(state, batch) -> (heatmaps, metrics)``: eval-mode
    forward and loss (reference val_one_epoch, topdown_trainer.py:26-41).
    With a ``world`` that has a process group the metrics are means over
    the ranks (JAX :203-204); the outputs stay this rank's.

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
    """
    dev = resolve_device(device)
    group = None if world is None else world.group

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict):
        batch = batch_to_device(batch, dev)
        state.model.eval()
        state.criterion.eval()
        out = state.model(batch["img"])
        loss, loss_dict = state.criterion(out, batch)
        metrics = {"loss": loss}
        metrics.update(loss_dict)
        if group is not None:
            metrics = _metrics_mean(metrics, group)
        return out, metrics

    return eval_step
