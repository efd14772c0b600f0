"""Optimizers and the per-step LR schedule (port of
``litehandnet_tpu/train/optim.py``).

The schedule is a function of the optimizer step, as in optax, and drives a
``LambdaLR``; step t of training uses ``schedule(t)``:

* linear warmup from ``base / warmup_steps`` to ``base`` over
  ``warmup_steps`` steps, after which the main schedule starts again from
  its own step 0 (optax ``join_schedules``, ``optim.py:55-66``);
* Adam/AdamW: the LR scales by 0.1 at every ``step_epoch`` boundary,
  counted in steps (``e * steps_per_epoch``);
* SGD: cosine annealing with warm restarts, T0 = 10 epochs, Tmult = 2,
  counted in steps.

Optimizers follow optax: Adam (b1 0.9, b2 0.999, eps 1e-8); AdamW with
optax's weight decay 1e-4 (torch's default is 1e-2); SGD with momentum 0.9
and decayed weights of 1e-8 added to the gradient. Adai and AdaiW are not
ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, List, Sequence, Tuple

import torch

Schedule = Callable[[int], float]
# builds (optimizer, scheduler) over a list of parameters
OptimizerFactory = Callable[[List[torch.nn.Parameter]],
                            Tuple[torch.optim.Optimizer,
                                  torch.optim.lr_scheduler.LambdaLR]]


def _linear(init: float, end: float, steps: int) -> Schedule:
    def schedule(t: int) -> float:
        frac = 1.0 - min(max(t, 0), steps) / steps
        return (init - end) * frac + end
    return schedule


def _cosine(init: float, decay_steps: int) -> Schedule:
    def schedule(t: int) -> float:
        t = min(t, decay_steps)
        return init * 0.5 * (1.0 + math.cos(math.pi * t / decay_steps))
    return schedule


def _join(schedules: Sequence[Schedule], boundaries: Sequence[int]) -> Schedule:
    """optax ``join_schedules``: past each boundary the next schedule runs
    from its own step 0."""
    def schedule(t: int) -> float:
        value = schedules[0](t)
        for boundary, sched in zip(boundaries, schedules[1:]):
            if t >= boundary:
                value = sched(t - boundary)
        return value
    return schedule


def make_lr_schedule(
    base_lr: float,
    optimizer_type: str = "Adam",
    warmup_steps: int = 0,
    step_epoch: Sequence[int] = (170, 200),
    steps_per_epoch: int = 1000,
    total_epochs: int = 210,
) -> Schedule:
    """Warmup + (cosine warm restarts | multi-step) schedule, per step."""
    if optimizer_type.lower() in ("sgd", "adai", "adaiw"):
        schedules, boundaries = [], []
        t0, start = 10, 0
        while start < total_epochs:
            schedules.append(_cosine(base_lr, t0 * steps_per_epoch))
            start += t0
            boundaries.append(start * steps_per_epoch)
            t0 *= 2
        main = _join(schedules, boundaries[:-1])
    else:
        milestones = sorted(int(e) * steps_per_epoch for e in step_epoch)

        def main(t: int) -> float:
            return base_lr * 0.1 ** sum(t >= m for m in milestones)

    if warmup_steps > 0:
        warm = _linear(base_lr / warmup_steps, base_lr, warmup_steps)
        return _join([warm, main], [warmup_steps])
    return main


def make_optimizer(optimizer_type: str, params: Iterable[torch.nn.Parameter],
                   lr: float) -> torch.optim.Optimizer:
    """The optimizer named by ``optimizer_type`` at learning rate ``lr``.

    Raises:
        KeyError: Adai/AdaiW (not ported yet) or an unknown name.
    """
    name = optimizer_type.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    raise KeyError(f"optimizer {optimizer_type!r} is not ported yet; "
                   "ported: ['Adam', 'AdamW', 'SGD']")


def make_optimizer_from_config(cfg, steps_per_epoch: int, world_size: int = 1
                               ) -> Tuple[OptimizerFactory, Schedule]:
    """(optimizer factory, schedule) from ``cfg.OPTIMIZER`` / ``cfg.TRAIN``.

    The LR is scaled by the world size, as in the reference
    (dist_train.py:68). The factory takes the parameters to train and gives
    ``(optimizer, LambdaLR)``.
    """
    opt = cfg.OPTIMIZER
    base_lr = float(opt.lr) * world_size
    schedule = make_lr_schedule(
        base_lr,
        optimizer_type=opt.type,
        warmup_steps=int(opt.get("warmup_steps", 0)),
        step_epoch=opt.get("step_epoch", [170, 200]),
        steps_per_epoch=steps_per_epoch,
        total_epochs=int(cfg.TRAIN.get("total_epoches", 210)),
    )

    def factory(params):
        optimizer = make_optimizer(opt.type, params, base_lr)
        scheduler = torch.optim.lr_scheduler.LambdaLR(
            optimizer, lambda t: schedule(t) / base_lr)
        return optimizer, scheduler

    return factory, schedule
