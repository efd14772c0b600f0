"""LiteHandNet MSRB (``litehandnet_msrb``, the alternative flagship): the
port against JAX on the CPU. ``num_stage`` 3, ``input_channel`` 32, 64x64,
B = 2 (the JAX zoo test's size), for each ``msrb_ca`` / ``rbu_ca`` in none,
se and ca: eval mode in float32 (rtol 1e-4, atol 1e-5 of the output's
largest magnitude), train mode in float64 on both sides (rtol 1e-9) with the
running statistics; the deploy graph (``fuse_params``) against the train
graph and against JAX's deploy apply (1e-5 of the max); the weights both
ways; one full-width eval forward (4 stages, 128 channels) at 64x64, B = 1;
one float64 SGD step against JAX's, and the float32 step with
``LHN_FUSED_DW=1`` taking ``dw_conv3x3_stats`` (its plain twin here) at
every stride-1 depthwise RepConv, at dilations 1 and 2, against the port's
plain step and against JAX's step with ``LHN_FUSED_DW=1``. ``DWConvELAN`` and
``RepDownsampleUnit``, which no model builds, against JAX alone."""

import functools

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import litehandnet_msrb as jax_msrb
from litehandnet_tpu.models.reparam import fuse_params as jax_fuse_params
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.models import layers
from litehandnet_tpu_torch.models import litehandnet_msrb as msrb
from litehandnet_tpu_torch.ops import fused_bn
from litehandnet_tpu_torch.utils.weights import (
    load_jax_variables,
    repconv_rules,
    rules_for,
)
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    no_dropout,  # noqa: F401  (fixture)
    STEP_LR,
    apply_jax,
    assert_close_scaled,
    assert_family_forward,
    assert_served_config,
    assert_step_matches_jax,
    assert_weights_round_trip,
    init_jax,
    load_layer,
    step_batches,
    to_nchw,
    to_nhwc,
    zoo_cfg,
)

RULES = rules_for("litehandnet_msrb")
CA_TYPES = ["none", "se", "ca"]


def _x(B=2):
    return np.random.RandomState(2).normal(size=(B, 64, 64, 3)).astype(
        np.float32)


def _cfg(ca, features=32, num_stage=3):
    return zoo_cfg("litehandnet_msrb", num_stage=num_stage,
                   input_channel=features, msrb_ca=ca, rbu_ca=ca)


@functools.lru_cache(maxsize=None)
def _jax_side(ca, features=32, num_stage=3):
    model = jax_get_model(jax_cfg(_cfg(ca, features, num_stage)))
    return model, init_jax(model, _x(1), seed=3, train=False)


def _port(ca, features=32, num_stage=3, deploy=False):
    model = get_model(config_from_dict(_cfg(ca, features, num_stage)),
                      deploy=deploy, device="cpu")
    if not deploy:
        load_jax_variables(model, _jax_side(ca, features, num_stage)[1],
                           RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("ca", CA_TYPES)
def test_forward_parity(ca, mode, no_dropout, monkeypatch):
    model, variables = _jax_side(ca)
    out = assert_family_forward(no_dropout(_port(ca)), model, variables,
                                _x(), mode, RULES, monkeypatch, [jax_msrb])
    assert out.shape == (2, 21, 16, 16)


@pytest.mark.parametrize("ca", CA_TYPES)
def test_deploy_graph_equals_train_graph_and_jax(ca):
    """``fuse_params`` of the port's train graph loads strictly into the
    deploy graph, which equals the train graph in eval mode and JAX's deploy
    apply on JAX's ``fuse_params``, both within 1e-5 of the output's max."""
    train = _port(ca).eval()
    deploy = _port(ca, deploy=True)
    deploy.load_state_dict(fuse_params(train))
    with torch.no_grad():
        want = train(to_nchw(_x()))
        got = deploy.eval()(to_nchw(_x()))
    assert_close_scaled(got.numpy(), want.numpy(), 1e-5, 1e-5)
    cfg = jax_cfg(_cfg(ca))
    jax_deploy = jax_get_model(cfg, deploy=True)
    jax_vars = jax_fuse_params(_jax_side(ca)[1])
    jax_out, _ = apply_jax(jax_deploy, jax_vars, _x(), False)
    assert_close_scaled(to_nhwc(got), jax_out, 1e-5, 1e-5)
    # and the port's deploy graph takes JAX's fused weights through the
    # deploy names of the rules
    twin = _port(ca, deploy=True)
    load_jax_variables(twin, jax_vars, RULES)
    with torch.no_grad():
        assert_close_scaled(to_nhwc(twin.eval()(to_nchw(_x()))), jax_out,
                            1e-5, 1e-5)


@pytest.mark.parametrize("ca", CA_TYPES)
def test_import_torch_state_dict_round_trip_and_counts(ca):
    assert_weights_round_trip("litehandnet_msrb", _port(ca), _jax_side(ca)[1])


def test_full_width_eval_forward():
    """Exp 101's width and depth (4 stages, 128 channels) at 64x64, B = 1,
    in float32 eval mode."""
    model, variables = _jax_side("ca", 128, 4)
    want, _ = apply_jax(model, variables, _x(1), False)
    with torch.no_grad():
        got = _port("ca", 128, 4).eval()(to_nchw(_x(1)))
    assert got.dtype == torch.float32 and got.shape == (1, 21, 16, 16)
    assert_close_scaled(to_nhwc(got), want, 1e-4, 1e-5)


def test_served_config_matches_jax_template():
    assert_served_config("litehandnet_msrb/freihand_256", "litehandnet", 101,
                         MODEL=dict(name="litehandnet_msrb", num_stage=4,
                                    input_channel=128, msrb_ca="ca",
                                    rbu_ca="ca", output_channel=21))


def _step_cfg(input_channel=32):
    cfg = make_cfg("litehandnet", "freihand", image_size=64, MODEL=dict(
        name="litehandnet_msrb", num_stage=3, input_channel=input_channel,
        msrb_ca="ca", rbu_ca="ca", output_channel=21))
    cfg["OPTIMIZER"].update(type="SGD", lr=STEP_LR, warmup_steps=0)
    return cfg


def test_train_step_matches_jax(monkeypatch):
    """One float64 SGD step against JAX's, dropout identity on both
    sides."""
    from flax import linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x: x)
    cfg = _step_cfg()
    jax_batch, port_batch = step_batches(21, [(16, 16)])
    variables = init_jax(jax_get_model(jax_cfg(cfg)), jax_batch["img"],
                         seed=5, train=False)
    assert_step_matches_jax(cfg, variables, jax_batch, port_batch,
                            monkeypatch, [jax_msrb], RULES)


def test_fused_depthwise_step_takes_dw_conv3x3_stats(monkeypatch):
    """``LHN_FUSED_DW=1`` on the CPU: every stride-1 depthwise RepConv (the
    MSRB halves at dilations 1 and 2, the RBUs' ``conv.1``, the stem's
    ``conv1.1``) takes ``dw_conv3x3_stats``, here its plain twin, in the
    float32 train step; the step's loss, BatchNorm statistics and every
    gradient leaf equal the unfused float32 step's. The fused kernel takes
    float32 and bfloat16 only, so the float64 comparison with JAX is the
    unfused step's (``test_train_step_matches_jax``)."""
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.state import TrainState

    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x: x)
    calls = []
    kernel = fused_bn.dw_kernel
    monkeypatch.setattr(fused_bn, "dw_kernel", lambda x, w, d: calls.append(
        (tuple(x.shape), d)) or kernel(x, w, d))
    cfg = config_from_dict(_step_cfg())
    _, batch = step_batches(21, [(16, 16)])
    variables = init_jax(jax_get_model(jax_cfg(_step_cfg())), batch["img"],
                         seed=5, train=False)
    runs = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("LHN_FUSED_DW", fused)
        model = get_model(cfg, device="cpu")
        load_jax_variables(model, variables, RULES)
        tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
        state = TrainState.create(model, get_loss(cfg), tx)
        metrics = make_train_step("cpu")(state, {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()})
        runs[fused] = (metrics, state.model)
        if fused == "0":
            assert calls == []
    sites = [m for m in runs["1"][1].modules()
             if isinstance(m, layers.RepConv) and m.conv.conv.groups > 1
             and m.conv.conv.stride == (1, 1)]
    assert len(calls) == len(sites) > 0
    assert {d for _, d in calls} == {1, 2}
    (m0, model0), (m1, model1) = runs["0"], runs["1"]
    assert float(m1["loss"]) == pytest.approx(float(m0["loss"]), rel=1e-6)
    grads0 = {k: p.grad for k, p in model0.named_parameters()}
    gmax = max(float(g.abs().max()) for g in grads0.values())
    for name, p in model1.named_parameters():
        np.testing.assert_allclose(
            p.grad.numpy(), grads0[name].numpy(), rtol=0,
            atol=1e-4 * float(grads0[name].abs().max()) + 1e-6 * gmax,
            err_msg=name)
    sd0 = model0.state_dict()
    for name, value in model1.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(value, sd0[name], rtol=1e-5,
                                       atol=1e-6, msg=name)


def test_fused_depthwise_step_matches_jax_fused_step(monkeypatch):
    """``LHN_FUSED_DW=1`` on both sides, float32 (the fused op takes
    float32 and bfloat16 only): JAX's ``make_train_step`` routes its
    depthwise RepConvs through ``ops.fused_bn.dw_conv3x3_stats`` (its gate
    asks for a TPU, answered yes here, so the op lowers to its jnp reference
    under its custom VJP), the port's through ``dw_conv3x3_stats`` (its
    plain twin here), at dilations 1 and 2 on each side; 64 channels, so
    that the MSRB halves have the 32 that JAX's gate asks for, and B = 8.

    The loss (rtol 1e-5) and the BatchNorm running statistics (1e-5 of each
    statistic's largest magnitude) agree at float32 rounding. The gradients of this random-weight step carry float32
    rounding amplified through some 30 train-mode BatchNorms: the port's
    and JAX's plain float32 steps differ by percents over all leaves (the
    float64 steps agree to 1e-9, ``test_train_step_matches_jax``). So the
    gradients are held over all leaves within 15%, and the fused steps'
    gap to each other must be the plain steps' gap: the fused routes add
    no error of their own."""
    import jax
    import optax
    from flax import linen as fnn

    from litehandnet_tpu.losses import get_loss as jax_get_loss
    from litehandnet_tpu.ops import fused_bn as jax_fused_bn
    from litehandnet_tpu.train import distributed as JD
    from litehandnet_tpu.train.optim import make_optimizer as jax_optimizer
    from litehandnet_tpu.train.state import TrainState as JaxTrainState
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.state import TrainState
    from tests.torch_parity import record_grads

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x: x)
    jax_calls, port_calls = [], []
    jax_dw, port_dw = jax_fused_bn.dw_conv3x3_stats, fused_bn.dw_kernel
    monkeypatch.setattr(jax_fused_bn, "dw_conv3x3_stats",
                        lambda x, w, d=1: jax_calls.append((x.shape, d))
                        or jax_dw(x, w, d))
    monkeypatch.setattr(fused_bn, "dw_kernel", lambda x, w, d: port_calls.append(
        (tuple(x.shape), d)) or port_dw(x, w, d))
    cfg_dict = _step_cfg(input_channel=64)
    cfg = config_from_dict(cfg_dict)
    jax_batch, port_batch = step_batches(21, [(16, 16)], B=8)
    jcfg = jax_cfg(cfg_dict)
    variables = init_jax(jax_get_model(jcfg), jax_batch["img"], seed=5,
                         train=False)

    def jax_step():
        tx = optax.chain(record_grads(), jax_optimizer(
            "SGD", optax.constant_schedule(STEP_LR)))
        step = JD.make_train_step(jax_get_model(jcfg), jax_get_loss(jcfg),
                                  tx, JD.make_mesh(1), donate=False)
        jstate, jmetrics = step(JaxTrainState.create(variables, {}, tx),
                                jax_batch, jax.random.PRNGKey(2))
        jstate = jax.tree.map(np.asarray, jstate)
        twin = get_model(cfg, device="cpu")
        load_jax_variables(twin, {"params": jstate.opt_state[0]["model"],
                                  "batch_stats": jstate.batch_stats}, RULES)
        grads = {k: v.detach().double() for k, v in twin.named_parameters()}
        return jmetrics, grads, twin.state_dict()

    def port_step():
        model = get_model(cfg, device="cpu")
        load_jax_variables(model, variables, RULES)
        tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
        state = TrainState.create(model, get_loss(cfg), tx)
        metrics = make_train_step("cpu")(state, {
            k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in port_batch.items()})
        grads = {k: p.grad.double() for k, p in model.named_parameters()}
        return metrics, grads, model.state_dict()

    def gap(got, want):
        num = sum(float((got[k] - want[k]).square().sum()) for k in want)
        return (num / sum(float(g.square().sum()) for g in want.values())
                ) ** 0.5

    runs = {}
    for fused in ("0", "1"):
        monkeypatch.setenv("LHN_FUSED_DW", fused)
        monkeypatch.setattr(jax_fused_bn, "_on_tpu", lambda f=fused: f == "1")
        runs[fused] = (jax_step(), port_step())
        assert bool(jax_calls) == bool(port_calls) == (fused == "1")
    assert {d for _, d in jax_calls} == {d for _, d in port_calls} == {1, 2}
    # JAX's gate also asks for C % 32 == 0 and W % 8 == 0: the port fuses
    # every site JAX fuses, and more
    assert not {tuple(s) for s, _ in jax_calls} - {
        (n, h, w, c) for (n, c, h, w), _ in port_calls}

    (jmetrics, jgrads, jsd), (metrics, grads, sd) = runs["1"]
    assert set(metrics) == set(jmetrics)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(jmetrics[k]),
                                                  rel=1e-5), k
    for name, value in sd.items():
        if name.endswith(("running_mean", "running_var")):
            err = float((value - jsd[name]).abs().max())
            assert err <= 1e-5 * float(jsd[name].abs().max()), (name, err)
    plain = gap(runs["0"][1][1], runs["0"][0][1])
    assert gap(grads, jgrads) <= 0.15
    assert gap(grads, jgrads) == pytest.approx(plain, rel=1e-2, abs=1e-4)


def test_dwconv_elan_and_downsample_unit_match_jax(monkeypatch):
    """The library units no model builds: ``DWConvELAN`` (two chains,
    ``proj``, channel shuffle) and ``RepDownsampleUnit`` (stride 2,
    channel shuffle), eval mode in float32, at 16 channels."""
    rng = np.random.RandomState(4)
    x = rng.normal(size=(2, 16, 16, 16)).astype(np.float32)
    for jax_mod, port, rules in (
        (jax_msrb.DWConvELAN(24), msrb.DWConvELAN(16, 24),
         lambda tp, fp: [r for n in ("c1", "c2") for k in "abcd"
                         for r in repconv_rules(tp + rf"\.{n}{k}",
                                                fp + rf"/{n}{k}")]
         + [(tp + r"\.proj", "conv", fp + r"/proj/conv")]),
        (jax_msrb.RepDownsampleUnit(), msrb.RepDownsampleUnit(16),
         lambda tp, fp: [r for n in ("r1", "r2", "r3", "l1", "l2")
                         for r in repconv_rules(tp + rf"\.{n}",
                                                fp + rf"/{n}")]),
    ):
        variables = init_jax(jax_mod, x, seed=6)
        want, _ = apply_jax(jax_mod, variables, x, False)
        port = load_layer(port, variables, rules)
        with torch.no_grad():
            got = port(to_nchw(x))
        assert_close_scaled(to_nhwc(got), want, 1e-5, 1e-6)
