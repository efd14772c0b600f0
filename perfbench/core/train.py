"""The train runner: ``Trainer.train_step`` on batches staged on the device,
steps back to back, the window ending at a synchronize.

Batches are ``distinct`` sets of normalized noise images ``[B, H, W, 3]``
and Gaussian targets (sigma from the configuration) at keypoints drawn from
the seed, some joints invisible. Step k takes batch ``k % distinct`` and a
dropout generator seeded from the run's seed and k. Set-up builds one
trainer, runs its first ``checked_steps`` steps through the same call on
rows that all differ (they warm every shape), and records the loss of each,
the gradient of the first (as Adam received it: its first moment after one
step over 1 - beta1) and the change of every parameter after the last; the
window then goes on with the same trainer, and keeps a snapshot of its
state before step ``late_from`` and what ``late_steps`` steps from there
made of it (``LateSteps``). After the window the plain reference follows
the first steps from the same weights, batches and dropout masks
(``judge``), and the late steps from the snapshot (``judge_late``): it can
follow the window's state only from the program's own.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from typing import Dict, Optional

import torch

from perfbench.core import spec, trace
from perfbench.core.program import load, seeded_weights, trainer
from perfbench.core.run_context import Run, quarters
from perfbench.reference.common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    Adam,
    balanced_l2,
    exact_fp32,
    set_generator,
    warmup_lr,
)
# a leaf whose reference gradient is below this share of the median leaf's
# is moved by Adam from rounding alone and is left out of the change
STILL_LEAF = 1e-3


def make_batches(r: Run, cfg) -> Dict[str, torch.Tensor]:
    """``{'img' [D, B, H, W, 3], 'target' [D, B, K, h, w],
    'target_weight' [D, B, K]}`` on the device, float32."""
    mix, dev = r.cell.mix, r.device
    D, B = int(mix["distinct"]), int(mix["batch"])
    H, W = cfg.DATASET.image_size
    h, w = cfg.DATASET.heatmap_size
    K = int(cfg.DATASET.num_joints)
    sigma = float(cfg.PIPELINE.sigma)
    gen = torch.Generator(dev).manual_seed(spec.sub_seed(r.seed, "batches"))
    u8 = torch.randint(0, 256, (D, B, H, W, 3), generator=gen, device=dev,
                       dtype=torch.uint8)
    mean = torch.tensor(IMAGENET_MEAN, device=dev) * 255.0
    std = torch.tensor(IMAGENET_STD, device=dev) * 255.0
    img = (u8.float() - mean) / std
    del u8
    margin = float(mix["keypoint_margin_px"])
    u = torch.rand((D, B, K, 3), generator=gen, device=dev)
    jx = margin + (w - 1 - 2 * margin) * u[..., 0]
    jy = margin + (h - 1 - 2 * margin) * u[..., 1]
    visible = (u[..., 2] < float(mix["visible"])).float()
    xs = torch.arange(w, device=dev, dtype=torch.float32)
    ys = torch.arange(h, device=dev, dtype=torch.float32)
    target = torch.exp(-((xs.view(1, 1, 1, 1, w) - jx[..., None, None]) ** 2
                         + (ys.view(1, 1, 1, h, 1) - jy[..., None, None]) ** 2)
                       / (2 * sigma ** 2)) * visible[..., None, None]
    return {"img": img, "target": target, "target_weight": visible}


def step_seed(r: Run, k: int) -> int:
    return spec.sub_seed(r.seed, "dropout", k)


def batch(data: Dict[str, torch.Tensor], k: int) -> Dict[str, torch.Tensor]:
    j = k % data["img"].shape[0]
    return {name: t[j] for name, t in data.items()}


def first_steps(r: Run, step, model, optimizer, weights, n: int) -> dict:
    """Steps 0..n-1 through ``step(k)``; the loss of each, the gradient norm
    of every parameter at step 0 as the optimizer received it, and the norm
    of every parameter's change after step n-1 (device tensors)."""
    params = dict(model.named_parameters())
    losses = [step(0)["loss"].detach().clone()]
    beta1 = optimizer.param_groups[0]["betas"][0]
    grads = {name: (optimizer.state[p]["exp_avg"] / (1.0 - beta1)).double().norm()
             for name, p in params.items()}
    for k in range(1, n):
        losses.append(step(k)["loss"].detach().clone())
    change = {name: (p.detach() - weights[name]).double().norm()
              for name, p in params.items()}
    return {"loss": losses, "grad": grads, "change": change}


def reference_model(r: Run, state: Dict[str, torch.Tensor]):
    """The plain reference model on the run's device, holding ``state``, in
    train mode."""
    with torch.device(r.device):
        model = spec.reference(r.cell.config["reference"]).build(
            r.cell.model_spec(r.overrides))
    load(model, state)
    model.train()
    return model


def reference_run(r: Run, data, model, adam, first: int, n: int,
                  control: Optional[str] = None, on_grad=None) -> list:
    """The plain reference's steps ``first .. first + n - 1`` (float32,
    TF32 off): forward with step k's dropout masks, balanced L2 loss,
    backward, Adam at step k's warmup LR. ``control``: ``"bf16"`` runs
    forward and backward under bfloat16 autocast (the step below the
    configuration's float32); ``"half_batch"`` steps on the first half of
    each batch only (a fault). ``on_grad(k, params)`` sees each step's
    gradients. Returns the losses."""
    cfg = r.cell.port_config(r.overrides)
    dev = r.device
    params = dict(model.named_parameters())
    base, warmup = float(cfg.OPTIMIZER.lr), int(cfg.OPTIMIZER.warmup_steps)
    weight = float(cfg.LOSS.loss_weight[0])
    losses = []
    with exact_fp32():
        for k in range(first, first + n):
            b = batch(data, k)
            # NCHW-contiguous: the CPU backward in channels_last memory corrupts
            # the heap under some PyTorch builds
            x = b["img"].permute(0, 3, 1, 2).contiguous()
            tgt, tw = b["target"], b["target_weight"]
            if control == "half_batch":
                half = x.shape[0] // 2
                x, tgt, tw = x[:half], tgt[:half], tw[:half]
            set_generator(model, torch.Generator(dev).manual_seed(step_seed(r, k)))
            with (torch.autocast(dev.type, dtype=torch.bfloat16)
                  if control == "bf16" else contextlib.nullcontext()):
                heat = model(x)
            loss = weight * balanced_l2(heat.float(), tgt, tw)
            for p in params.values():
                p.grad = None
            loss.backward()
            if on_grad is not None:
                on_grad(k, params)
            adam.step(warmup_lr(base, warmup, k))
            losses.append(loss.detach())
    return losses


def reference_steps(r: Run, data, n: int, control: Optional[str] = None) -> dict:
    """The plain reference's first ``n`` steps from the seeded weights
    (``reference_run``): the loss of each, the gradient norm of every
    parameter at step 0 and the norm of every parameter's change after the
    last."""
    weights = seeded_weights(r)
    model = reference_model(r, weights)
    params = dict(model.named_parameters())
    out = {"grad": None}

    def on_grad(k, params):
        if k == 0:
            out["grad"] = {name: p.grad.double().norm()
                           for name, p in params.items()}

    out["loss"] = reference_run(r, data, model, Adam(list(params.values())),
                                0, n, control, on_grad)
    out["change"] = {name: (p.detach() - weights[name]).double().norm()
                     for name, p in params.items()}
    return out


def snapshot(model, optimizer, k: int) -> dict:
    """The program's train state before step ``k``, cloned: every
    parameter and buffer, and Adam's moments."""
    params = dict(model.named_parameters())
    st = [optimizer.state[p] for p in params.values()]
    return {"k": k,
            "state": {n: t.detach().clone()
                      for n, t in model.state_dict().items()},
            "exp_avg": [s["exp_avg"].clone() for s in st],
            "exp_avg_sq": [s["exp_avg_sq"].clone() for s in st]}


class LateSteps:
    """Steps ``first .. first + n - 1`` of the run, in the window as a rule:
    the program's state before them (``snapshot``), the loss of each and
    every parameter after them, cloned on the device with no synchronize.
    At a fixed step index, so that what they compare does not depend on how
    many steps the window holds."""

    def __init__(self, model, optimizer, first: int, n: int):
        self.model, self.optimizer = model, optimizer
        self.first, self.n = first, n
        self.snapshot, self.loss, self.after = None, [], None

    def step(self, step, k: int):
        """``step(k)``, with the snapshots where ``k`` is one of the late
        steps."""
        if k == self.first:
            self.snapshot = snapshot(self.model, self.optimizer, k)
        out = step(k)
        if self.first <= k < self.first + self.n:
            self.loss.append(out["loss"].detach())
            if k == self.first + self.n - 1:
                self.after = {name: p.detach().clone()
                              for name, p in self.model.named_parameters()}
        return out

    @property
    def done(self) -> bool:
        return self.after is not None

    def result(self) -> dict:
        return {"snapshot": self.snapshot, "loss": self.loss,
                "after": self.after}


def reference_late(r: Run, data, snap: dict, n: int,
                   control: Optional[str] = None) -> dict:
    """The plain reference's ``n`` steps from the program's snapshot (its
    parameters, buffers and Adam moments; the step count is the
    reference's own): the loss of each and every parameter after them."""
    model = reference_model(r, snap["state"])
    params = dict(model.named_parameters())
    adam = Adam(list(params.values()))
    adam.m = [m.clone() for m in snap["exp_avg"]]
    adam.v = [v.clone() for v in snap["exp_avg_sq"]]
    adam.t = snap["k"]
    losses = reference_run(r, data, model, adam, snap["k"], n, control)
    return {"loss": losses,
            "after": {name: p.detach().clone() for name, p in params.items()}}


def judge_late(prog: dict, ref: dict) -> Dict[str, float]:
    """The numbers of the steps after the window, both sides from the same
    snapshot: ``late_loss_gap``, the largest |loss - reference loss| /
    |reference loss|; ``late_update_gap``, |u - u_ref| / |u_ref| over all
    parameters as one vector, u the change over the steps (an update of the
    wrong sign reads 2, none 1; a stale Adam step count shows through the
    bias correction, which the reference takes from its own count)."""
    snap = prog["snapshot"]
    before = snap["state"]
    num = den = 0.0
    for name, after in ref["after"].items():
        u_ref = (after - before[name]).double()
        u = (prog["after"][name] - before[name]).double()
        num += float((u - u_ref).square().sum())
        den += float(u_ref.square().sum())
    lp = [float(v) for v in prog["loss"]]
    lr = [float(v) for v in ref["loss"]]
    return {"late_loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
            "late_update_gap": (num / max(den, 1e-300)) ** 0.5}


def judge(prog: dict, ref: dict):
    """The numbers of the checked steps:

    ``loss_gap``: the largest |loss - reference loss| / |reference loss|.
    For each parameter, the gap between the norms of its step-0 gradient
    (program and reference), as a share of the reference's norm or the
    median parameter's, whichever is larger: ``grad_median_gap`` is the
    median parameter's gap, ``grad_gap`` the widest. ``change_gap``: the
    widest such gap of the norm of each parameter's change after the checked
    steps, over the parameters whose reference gradient is at least
    ``STILL_LEAF`` of the median's. Returns (numbers, the still leaves)."""
    def floats(d):
        return {k: float(v) for k, v in d.items()}

    lp = [float(v) for v in prog["loss"]]
    lr = [float(v) for v in ref["loss"]]
    gp, gr = floats(prog["grad"]), floats(ref["grad"])
    med_g = statistics.median(gr.values())
    grad = [abs(gp[k] - gr[k]) / max(gr[k], med_g) for k in gr]
    still = sorted(k for k in gr if gr[k] < STILL_LEAF * med_g)
    dp, dr = floats(prog["change"]), floats(ref["change"])
    moved = [k for k in dr if k not in still]
    med_d = statistics.median(dr[k] for k in moved)
    numbers = {
        "loss_gap": max(abs(a - b) / abs(b) for a, b in zip(lp, lr)),
        "grad_median_gap": statistics.median(grad),
        "grad_gap": max(grad),
        "change_gap": max(abs(dp[k] - dr[k]) / max(dr[k], med_d)
                          for k in moved)}
    return numbers, still


def run(r: Run) -> dict:
    cfg = r.cell.port_config(r.overrides)
    mix = r.cell.mix
    n_checked = int(mix["checked_steps"])
    B = int(mix["batch"])
    data = make_batches(r, cfg)
    weights = seeded_weights(r)
    r.log("set-up: batches and weights made")
    tr, state = trainer(r, weights)
    r.log("set-up: trainer built")

    def step(k):
        gen = torch.Generator(r.device).manual_seed(step_seed(r, k))
        return tr.train_step(state, batch(data, k), gen)

    prog = first_steps(r, step, state.model, state.optimizer, weights,
                       n_checked)
    del weights
    r.sync()
    r.log(f"set-up: {n_checked} checked steps run")
    r.setup_s = time.perf_counter() - r.t0
    start = time.perf_counter()
    deadline = start + r.seconds
    k = n_checked
    marks = []
    n_late = int(mix["late_steps"])
    late = LateSteps(state.model, state.optimizer,
                     max(int(mix["late_from"]), n_checked), n_late)
    while time.perf_counter() < deadline:
        late.step(step, k)
        k += 1
        marks.append(time.perf_counter())
    r.sync()
    end = time.perf_counter()
    steps = k - n_checked
    r.rate = steps * B / (end - start)
    r.call_s = (end - start) / steps
    r.log(f"window: {steps} steps of {B} in {end - start:.3f} s "
          f"({(end - start) / steps * 1e3:.3f} ms a step), set-up "
          f"{r.setup_s:.3f} s; steps enqueued in each quarter "
          f"{quarters(marks, start, r.seconds)}")
    while not late.done:        # a window too short for the late steps
        late.step(step, k)
        k += 1
    if r.trace:
        first = k
        r.traced = trace.profile(lambda i: step(first + i),
                                 int(mix["trace_steps"]), "train.step",
                                 r.device)
        k += 2 * r.traced.calls
    r.sync()
    if r.device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    prog = {"loss": [float(v) for v in prog["loss"]],
            "grad": {n: float(v) for n, v in prog["grad"].items()},
            "change": {n: float(v) for n, v in prog["change"].items()}}
    del tr, state, step
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    ref = reference_steps(r, data, n_checked)
    numbers, still = judge(prog, ref)
    late = late.result()
    numbers.update(judge_late(late, reference_late(r, data, late["snapshot"],
                                                   n_late)))
    r.notes["still_leaves"] = len(still)
    r.notes["numbers"] = numbers
    numbers = {n: v for n, v in numbers.items() if n in r.cell.limits}
    broken = any(numbers[n] > r.cell.limits[n]["limit"] for n in numbers)
    e2e = {"setup_s": r.setup_s, "train_img_s": r.rate}
    return dict(numbers=numbers, attempted=k,
                failed=n_checked + n_late if broken else 0, e2e=e2e)
