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
and decayed weights of 1e-8 added to the gradient; Adai and AdaiW as the
JAX package's ``scale_by_adai`` / ``adai`` (:77-155).
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


class Adai(torch.optim.Optimizer):
    """Adai / AdaiW: adaptive-inertia SGD (Xie et al., ICML 2022), as the
    JAX package's ``adai`` (``train/optim.py:77-155``) with the reference
    factory's hyper-parameters (optimizer_scheduler.py:19-24).

    Per element, ``v = beta2 v + (1 - beta2) g^2`` and ``v_hat = v / (1 -
    beta2^t)``; the inertia ``beta1 = clip(1 - beta0 v_hat / mean(v_hat), 0,
    1 - eps)``, where the mean runs over every element of every parameter;
    ``m = beta1 m + (1 - beta1) g`` and the step is ``lr`` times the
    bias-corrected ``m / (1 - prod(beta1))``, with no adaptive division.
    ``decoupled=False`` (Adai) adds ``weight_decay * p`` to the gradient
    before the statistics; ``decoupled=True`` (AdaiW) adds it to the step.
    A parameter without a gradient counts as a zero gradient, as in optax,
    where every leaf of the tree has one.
    """

    def __init__(self, params, lr: float, betas=(0.1, 0.99), eps: float = 1e-3,
                 weight_decay: float = 1e-8, decoupled: bool = False):
        super().__init__(params, dict(lr=lr, betas=tuple(betas), eps=eps,
                                      weight_decay=weight_decay,
                                      decoupled=decoupled))

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        entries, total, v_hat_sum = [], 0, 0.0
        for group in self.param_groups:
            beta0, beta2 = group["betas"]
            for p in group["params"]:
                g = torch.zeros_like(p) if p.grad is None else p.grad
                if not group["decoupled"]:
                    g = g + group["weight_decay"] * p
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["exp_avg"] = torch.zeros_like(p)
                    state["exp_avg_sq"] = torch.zeros_like(p)
                    state["beta1_prod"] = torch.ones_like(p)
                state["step"] += 1
                state["exp_avg_sq"].mul_(beta2).addcmul_(g, g, value=1 - beta2)
                bias2 = 1.0 - beta2 ** state["step"]
                v_hat_sum = v_hat_sum + state["exp_avg_sq"].sum() / bias2
                total += p.numel()
                entries.append((group, p, g, state, bias2))
        v_mean = v_hat_sum / max(total, 1)
        for group, p, g, state, bias2 in entries:
            beta0 = group["betas"][0]
            beta1 = (1.0 - beta0 * (state["exp_avg_sq"] / bias2) / v_mean
                     ).clamp_(0.0, 1.0 - group["eps"])
            m = state["exp_avg"]
            m.mul_(beta1).add_((1.0 - beta1) * g)
            state["beta1_prod"].mul_(beta1)
            update = m / (1.0 - state["beta1_prod"])
            if group["decoupled"]:
                update = update + group["weight_decay"] * p
            p.sub_(group["lr"] * update)
        return loss


def make_optimizer(optimizer_type: str, params: Iterable[torch.nn.Parameter],
                   lr: float) -> torch.optim.Optimizer:
    """The optimizer named by ``optimizer_type`` at learning rate ``lr``.

    Raises:
        KeyError: an unknown name.
    """
    name = optimizer_type.lower()
    if name == "sgd":
        return torch.optim.SGD(params, lr=lr, momentum=0.9, weight_decay=1e-8)
    if name == "adam":
        return torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8)
    if name == "adamw":
        return torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=1e-4)
    if name in ("adai", "adaiw"):
        return Adai(params, lr=lr, decoupled=name == "adaiw")
    raise KeyError(f"unknown optimizer {optimizer_type!r}; ported: "
                   "['Adam', 'AdamW', 'SGD', 'Adai', 'AdaiW']")


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
