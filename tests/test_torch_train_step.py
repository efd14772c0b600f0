"""One whole train step of the port (``litehandnet_tpu_torch.train.
distributed.make_train_step``) against the JAX package's
``make_train_step`` on the CPU: the same numpy weights (BN statistics
included), batch and optimizer (SGD). Compared: the loss and its parts, every
gradient (recorded by an optax transform placed before the JAX optimizer),
the parameters after the update, the criterion's ``mtl_p``, and the
BatchNorm running statistics. Channel dropout is identity on both sides
(flax and torch draw different bits).

The reference is JAX's step in float64 throughout (``jax.enable_x64``, with
the JAX model's float32 casts mapped to float64 inside the test only).
Against it the port's float64 step must agree to rounding. The port's
float32 step, with the ``moments`` and fused depthwise paths on and off,
must agree in the loss and the statistics; its gradients are held globally
only, because one leaky-ReLU input that changes sign under float32 rounding
moves a layer's gradient by percents (JAX's own float32 step included), and
the fused paths must give the plain path's gradients leaf by leaf."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from litehandnet_tpu.config import config_from_dict as jax_config
from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.losses import get_loss as jax_get_loss
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import hourglass_ablation as jax_ablation
from litehandnet_tpu.models import litehandnet as jax_litehandnet
from litehandnet_tpu.models import ms_att_hourglass as jax_mynet
from litehandnet_tpu.ops.encode import msra_heatmaps
from litehandnet_tpu.train import distributed as JD
from litehandnet_tpu.train.optim import make_optimizer as jax_make_optimizer
from litehandnet_tpu.train.state import TrainState as JaxTrainState
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.layers import Dropout
from litehandnet_tpu_torch.train.distributed import make_train_step
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.precision import DynamicLossScaler
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.weights import (
    load_jax_criterion,
    load_jax_variables,
    rules_for,
)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import init_jax, jax_float64, record_grads

B, SIZE, HM, K = 2, 64, 16, 21
LR = 1e-3


def _cfg_dict(ca_type, features, num_stage, num_block, auto_weight):
    cfg = make_cfg("litehandnet", "freihand", image_size=SIZE, **{
        "MODEL.input_channel": features, "MODEL.num_stage": num_stage,
        "MODEL.num_block": num_block, "MODEL.ca_type": ca_type})
    cfg["OPTIMIZER"].update(type="SGD", lr=LR, warmup_steps=0)
    cfg["LOSS"]["auto_weight"] = auto_weight
    return cfg


def _batch(seed=0):
    """Images of unit-normal noise, each sample scaled and shifted on its
    own. Without that the channel attention's pooled [B, C, 1, 1] map is
    nearly equal across the batch, its BatchNorm's variance over B = 2
    values cancels, and float32 gradients of the step differ by percents
    between any two summation orders (JAX's own against float64 too)."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(8, SIZE - 8, size=(B, K, 2)).astype(np.float32)
    target = np.stack([np.asarray(msra_heatmaps(j, np.ones(K), (SIZE, SIZE),
                                                (HM, HM), 2.0, unbiased=True)[0])
                       for j in joints])
    img = (rng.normal(size=(B, SIZE, SIZE, 3))
           * rng.uniform(0.5, 2.0, size=(B, 1, 1, 1))
           + rng.uniform(-1.0, 1.0, size=(B, 1, 1, 3)))
    return {
        "img": img.astype(np.float32),
        "target": target,                                     # [B, H, W, K]
        "target_weight": (rng.uniform(size=(B, K)) > 0.1).astype(np.float32),
    }


def _jax_step(cfg_dict, batch, variables, crit_vars, monkeypatch):
    """JAX's step in float64: (new state, metrics, gradients), as numpy."""
    cfg = jax_config(cfg_dict)
    model, crit = jax_get_model(cfg), jax_get_loss(cfg)
    tx = optax.chain(record_grads(),
                     jax_make_optimizer("SGD", optax.constant_schedule(LR)))
    f64 = lambda tree: jax.tree.map(lambda a: np.asarray(a, np.float64), tree)
    with jax_float64(monkeypatch, jax_litehandnet, jax_mynet, jax_ablation):
        state = JaxTrainState.create(f64(variables), f64(crit_vars), tx)
        step = JD.make_train_step(model, crit, tx, JD.make_mesh(1),
                                  donate=False)
        new_state, metrics = step(
            state, {k: jnp.asarray(v, jnp.float64) for k, v in batch.items()},
            jax.random.PRNGKey(2))
        assert metrics["loss"].dtype == jnp.float64
        return (jax.tree.map(np.asarray, new_state),
                {k: float(v) for k, v in metrics.items()},
                jax.tree.map(np.asarray, new_state.opt_state[0]))


def _variables(cfg_dict, batch):
    """numpy float32 model and criterion variables from a seed."""
    cfg = jax_config(cfg_dict)
    model, crit = jax_get_model(cfg), jax_get_loss(cfg)
    variables = init_jax(model, batch["img"], train=False)
    crit_vars = {}
    if cfg.LOSS.get("auto_weight", False):
        crit_vars = {"params": {"mtl_p": np.array([0.8, 1.2], np.float32)}}
    return variables, crit_vars


def _port_step(cfg_dict, variables, crit_vars, batch, dtype=torch.float32):
    cfg = config_from_dict(cfg_dict)
    model = get_model(cfg, device="cpu")
    load_jax_variables(model, variables, rules_for(cfg.MODEL.name))
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = 0.0
    criterion = get_loss(cfg)
    if crit_vars:
        load_jax_criterion(criterion, crit_vars["params"])
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    state = TrainState.create(model.to(dtype), criterion.to(dtype), tx)
    port_batch = {"img": batch["img"],
                  "target": batch["target"].transpose(0, 3, 1, 2),
                  "target_weight": batch["target_weight"]}
    port_batch = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dtype)
                  for k, v in port_batch.items()}
    metrics = make_train_step("cpu")(state, port_batch)
    return state, metrics


CASES = [
    # (ca_type, features, num_stage, num_block, auto_weight)
    pytest.param("none", 32, 2, [1], False, id="none"),
    pytest.param("se", 32, 2, [1], False, id="se"),
    # 128 channels: the C % 128 BatchNorms that go through ``moments``,
    # the channel attention's at its 1x1 map among them
    pytest.param("ca", 128, 2, [1], True, id="ca-c128-auto_weight"),
]


@pytest.mark.parametrize("ca_type,features,num_stage,num_block,auto_weight",
                         CASES)
def test_train_step_matches_jax(ca_type, features, num_stage, num_block,
                                auto_weight, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    cfg_dict = _cfg_dict(ca_type, features, num_stage, num_block, auto_weight)
    batch = _batch()
    variables, crit_vars = _variables(cfg_dict, batch)
    jstate, jmetrics, jgrads = _jax_step(cfg_dict, batch, variables,
                                         crit_vars, monkeypatch)

    # float64: the same function, to rounding
    monkeypatch.setenv("LHN_FUSED_BN", "0")   # moments takes float32/bf16
    state64, metrics64 = _port_step(cfg_dict, variables, crit_vars, batch,
                                    torch.float64)
    _compare(state64, metrics64, jstate, jmetrics, jgrads, crit_vars,
             rtol=1e-9, grad_rtol=1e-9, global_rtol=None)

    # float32: plain BatchNorm statistics, the moments path, and the moments
    # path with the fused depthwise convs (LHN_FUSED_BN, LHN_FUSED_DW)
    grads = {}
    for switches in (("0", "0"), ("1", "0"), ("1", "1")):
        monkeypatch.setenv("LHN_FUSED_BN", switches[0])
        monkeypatch.setenv("LHN_FUSED_DW", switches[1])
        state, metrics = _port_step(cfg_dict, variables, crit_vars, batch)
        _compare(state, metrics, jstate, jmetrics, jgrads, crit_vars,
                 rtol=1e-5, grad_rtol=None, global_rtol=5e-2)
        grads[switches] = {k: p.grad for k, p in state.model.named_parameters()}
    # the fused paths change only the backward's formulas: their forward is
    # the plain path's bits, so no leaky-ReLU input flips between them
    want_grads = grads[("0", "0")]
    gmax = max(float(g.abs().max()) for g in want_grads.values())
    for switches in (("1", "0"), ("1", "1")):
        for name, want in want_grads.items():
            np.testing.assert_allclose(
                grads[switches][name].numpy(), want.numpy(), rtol=0,
                atol=1e-4 * float(want.abs().max()) + 1e-6 * gmax,
                err_msg=f"{name} LHN_FUSED_BN, LHN_FUSED_DW = {switches}")


def test_hourglass_ablation_cbam_train_step_matches_jax(monkeypatch):
    """The served ``hourglass_ablation`` family with CBAM gates at 128
    channels (two stages): the float64 step to rounding, per gradient leaf;
    the float32 step, with every 128-channel BatchNorm's statistics through
    ``moments``, in the loss, the statistics and all gradients."""
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm
    from litehandnet_tpu_torch.ops import fused_bn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    cfg_dict = make_cfg("hourglass_ablation", "freihand", image_size=SIZE, **{
        "MODEL.input_channel": 128, "MODEL.num_stage": 2,
        "MODEL.num_block": [1], "MODEL.ca_type": "cbam"})
    cfg_dict["OPTIMIZER"].update(type="SGD", lr=LR, warmup_steps=0)
    batch = _batch()
    variables, crit_vars = _variables(cfg_dict, batch)
    jstate, jmetrics, jgrads = _jax_step(cfg_dict, batch, variables,
                                         crit_vars, monkeypatch)

    monkeypatch.setenv("LHN_FUSED_BN", "0")
    state64, metrics64 = _port_step(cfg_dict, variables, crit_vars, batch,
                                    torch.float64)
    _compare(state64, metrics64, jstate, jmetrics, jgrads, crit_vars,
             rtol=1e-9, grad_rtol=1e-9, global_rtol=None,
             family="hourglass_ablation")

    calls = []
    kernel = fused_bn.moments_kernel
    monkeypatch.setattr(fused_bn, "moments_kernel",
                        lambda x: calls.append(x.shape) or kernel(x))
    monkeypatch.setenv("LHN_FUSED_BN", "1")
    state, metrics = _port_step(cfg_dict, variables, crit_vars, batch)
    _compare(state, metrics, jstate, jmetrics, jgrads, crit_vars, rtol=1e-5,
             grad_rtol=None, global_rtol=5e-2, family="hourglass_ablation")
    sites = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                for m in state.model.modules())
    assert len(calls) == sites > 0


def _compare(state, metrics, jstate, jmetrics, jgrads, crit_vars, rtol,
             grad_rtol, global_rtol, family="litehandnet"):
    """The port's step against JAX's float64 step. ``rtol``: loss, BN
    statistics, ``mtl_p``. ``grad_rtol``: every gradient leaf, relative to
    the leaf's max, plus 1e-2 x ``grad_rtol`` of the largest gradient (a leaf
    whose gradient is zero in exact arithmetic, such as a bias whose shift
    the next BatchNorm removes, holds rounding only). ``global_rtol``: the
    gradient over all leaves, |g - g_jax| / |g_jax|."""
    assert set(metrics) == set(jmetrics) == {"loss", "heatmap"}
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(jmetrics[k], rel=rtol), k

    # gradients, in port names: JAX's recorded gradients loaded through the
    # same rules as the weights
    dtype = next(state.model.parameters()).dtype
    twin = copy.deepcopy(state.model).double()
    rules = rules_for(family)
    load_jax_variables(twin, {"params": jgrads["model"],
                              "batch_stats": jstate.batch_stats}, rules)
    jax_grads = {k: v.detach() for k, v in twin.named_parameters()}
    gmax = max(float(g.abs().max()) for g in jax_grads.values())
    grad_err = {}
    num = den = 0.0
    for name, p in state.model.named_parameters():
        want, got = jax_grads[name], p.grad.double()
        grad_err[name] = float((got - want).abs().max())
        num += float((got - want).square().sum())
        den += float(want.square().sum())
        if grad_rtol is not None:
            tol = grad_rtol * (float(want.abs().max()) + 1e-2 * gmax)
            assert grad_err[name] <= tol, (name, grad_err[name], tol)
    if global_rtol is not None:
        assert (num / den) ** 0.5 <= global_rtol

    # parameters after the SGD step: LR times the gradient's error, plus
    # rounding of the weight; the BatchNorm running statistics
    load_jax_variables(twin, {"params": jstate.params,
                              "batch_stats": jstate.batch_stats}, rules)
    want_sd = twin.state_dict()
    eps = float(torch.finfo(dtype).eps)
    for name, value in state.model.state_dict().items():
        if name.endswith("num_batches_tracked"):
            continue
        want, got = want_sd[name], value.double()
        scale = float(want.abs().max())
        if name in grad_err:
            tol = LR * (grad_err[name] if grad_rtol is None else
                        grad_rtol * (float(jax_grads[name].abs().max())
                                     + 1e-2 * gmax)) + 2 * eps * scale
            assert float((got - want).abs().max()) <= tol, name
        else:
            torch.testing.assert_close(got, want, rtol=rtol,
                                       atol=rtol * 0.1 * scale, msg=name)

    if crit_vars:
        np.testing.assert_allclose(
            state.criterion.mtl_p.grad.double().numpy(),
            np.asarray(jgrads["crit"]["mtl_p"]), rtol=rtol)
        np.testing.assert_allclose(
            state.criterion.mtl_p.detach().double().numpy(),
            np.asarray(jstate.crit_params["mtl_p"]), rtol=rtol)
    assert state.step == int(jstate.step) == 1

def test_overflow_skip_keeps_params_optimizer_and_bn_stats():
    """With a loss scaler, a non-finite step leaves the parameters, the
    optimizer state, the LR schedule and the BatchNorm running statistics
    as they were, halves the scale and still counts the step
    (distributed.py:143-157)."""
    cfg = config_from_dict(_cfg_dict("ca", 32, 3, [1, 1], True))
    cfg.OPTIMIZER.type = "Adam"
    model = get_model(cfg, device="cpu")
    criterion = get_loss(cfg)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    state = TrainState.create(model, criterion, tx,
                              loss_scaler=DynamicLossScaler(init_scale=2.0 ** 10))
    batch = _batch(seed=1)
    batch = {"img": batch["img"], "target": batch["target"].transpose(0, 3, 1, 2),
             "target_weight": batch["target_weight"]}
    step = make_train_step("cpu")
    step(state, batch, torch.Generator().manual_seed(0))   # a finite step
    assert state.loss_scaler.scale == 2.0 ** 10 and state.step == 1

    before = {k: v.clone() for k, v in model.state_dict().items()}
    crit_before = criterion.mtl_p.detach().clone()
    opt_before = {i: {k: v.clone() for k, v in s.items()}
                  for i, s in enumerate(state.optimizer.state.values())}
    sched_before = state.scheduler.state_dict()
    bad = dict(batch, img=np.full_like(batch["img"], np.nan))
    metrics = step(state, bad, torch.Generator().manual_seed(1))

    assert not np.isfinite(float(metrics["loss"]))
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert torch.equal(criterion.mtl_p.detach(), crit_before)
    for i, s in enumerate(state.optimizer.state.values()):
        for k, v in s.items():
            assert torch.equal(v, opt_before[i][k]), (i, k)
    assert state.scheduler.state_dict() == sched_before
    assert state.loss_scaler.scale == 2.0 ** 9
    assert state.step == 2
