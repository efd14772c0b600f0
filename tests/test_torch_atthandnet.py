"""AttHandNet (``atthandnet``): the port against JAX on the CPU, piece by
piece at small sizes, then a two-stage model with the real head, and the
full 224x224 model. Mish, ``blur_pool`` (odd sizes and 2x2, where the
reflect pad reads the far edge), ``rel_to_abs``, ``AugmentedConv`` with
H != W and 1 or 4 heads (the raw reshape of the attention result is the
reference's quirk: at H != W and 4 heads a transpose would give another
function), ``ARBAdd`` with kernels 2, 3 and 5, ``DenseBlock`` and
``Transition``: eval mode in float32 (rtol 1e-5, atol 1e-5 of the output's
largest magnitude) and train mode in float64 (rtol 1e-9) with the running
statistics. The two-stage model (8x8 input, the head ``min(relu(x), 1)``
to ``[B, 21, 2]``): forward, weights both ways and one float64 SGD step on
coordinate targets against JAX's ``make_train_step``."""

import copy
import functools
import time

import jax
import numpy as np
import pytest
import torch
from flax import linen as fnn

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.models import atthandnet as ja
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu_torch.config import config_from_dict, get_config
from litehandnet_tpu_torch.models import atthandnet as ta
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.utils.weights import (
    arb_rules,
    augmented_conv_rules,
    load_jax_variables,
    rules_for,
)
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    STEP_LR,
    apply_jax,
    assert_close_scaled,
    assert_step_matches_jax,
    assert_weights_round_trip,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    to_nhwc,
)

RULES = rules_for("atthandnet")


def _rng(seed=0):
    return np.random.RandomState(seed)


def test_mish_matches_jax():
    x = _rng().uniform(-30, 30, size=(4, 1000)).astype(np.float32)
    np.testing.assert_allclose(ta.mish(torch.from_numpy(x)).numpy(),
                               np.asarray(ja.mish(x)), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape,filt", [
    ((2, 7, 9, 3), 2), ((2, 7, 9, 3), 3), ((2, 7, 9, 3), 4),
    ((2, 7, 9, 3), 5), ((1, 2, 2, 4), 3)])
def test_blur_pool_matches_jax(shape, filt):
    x = _rng(1).normal(size=shape).astype(np.float32)
    want = np.asarray(ja.blur_pool(x, filt_size=filt))
    got = ta.blur_pool(to_nchw(x), ta.binomial_filter(shape[-1], filt))
    assert got.shape[2:] == (ta.blurred_size(shape[1], filt),
                             ta.blurred_size(shape[2], filt))
    np.testing.assert_allclose(to_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_rel_to_abs_matches_jax():
    x = _rng(2).normal(size=(2, 3, 5, 9))
    with jax.enable_x64(True):
        want = np.asarray(ja._rel_to_abs(x))
    np.testing.assert_array_equal(ta.rel_to_abs(torch.from_numpy(x)).numpy(),
                                  want)


def _holder(layer):
    holder = torch.nn.Module()
    holder.add_module("m", layer)
    return holder


def assert_layer_matches(jax_layer, port_layer, rules_fn, x, mode,
                         monkeypatch, **apply_kw):
    """A flax layer against the port layer on the same weights: eval in
    float32, or train in float64 with the running statistics after the
    call."""
    variables = init_jax(jax_layer, x, seed=3, **apply_kw)
    holder = _holder(port_layer)
    rules = rules_fn(r"m", r"m")
    load_jax_variables(holder, {c: {"m": t} for c, t in variables.items()},
                       rules)
    if mode == "eval":
        want = np.asarray(jax_layer.apply(variables, x, **apply_kw))
        with torch.no_grad():
            got = port_layer.eval()(to_nchw(x))
        assert_close_scaled(to_nhwc(got), want, 1e-5, 1e-5)
        return
    with jax_float64(monkeypatch, ja):
        want, new = jax_layer.apply(to_float64(variables),
                                    x.astype(np.float64), train=True,
                                    mutable=["batch_stats"])
        want = np.asarray(want)
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    monkeypatch.setenv("LHN_FUSED_BN", "0")
    port_layer.double().train()
    with torch.no_grad():
        got = port_layer(to_nchw(x).double())
    assert_close_scaled(to_nhwc(got), want, 1e-9, 1e-10)
    twin = copy.deepcopy(holder)
    load_jax_variables(twin, {"params": {"m": variables["params"]},
                              "batch_stats": {"m": stats}}, rules)
    want_sd = twin.state_dict()
    n = 0
    for name, value in holder.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            n += 1
            torch.testing.assert_close(value, want_sd[name], rtol=1e-9,
                                       atol=1e-12, msg=name)
    assert n > 0


@pytest.mark.parametrize("kernel", [2, 3])
@pytest.mark.parametrize("heads", [1, 4])
def test_augmented_conv_matches_jax(heads, kernel):
    """H = 6, W = 4 (``key_rel_w`` [7, dk/Nh], ``key_rel_h`` [11, dk/Nh])."""
    x = _rng(4).normal(size=(2, 6, 4, 8)).astype(np.float32)
    jax_layer = ja.AugmentedConv(40, kernel, num_heads=heads)
    port = ta.AugmentedConv(8, 40, kernel, (6, 4), num_heads=heads)
    variables = init_jax(jax_layer, x, seed=3)
    want = np.asarray(jax_layer.apply(variables, x))
    holder = _holder(port)
    load_jax_variables(holder, {"params": {"m": variables["params"]}},
                       augmented_conv_rules(r"m", r"m"))
    with torch.no_grad():
        got = port(to_nchw(x))
    assert got.shape == (2, 40, 6, 4)
    assert_close_scaled(to_nhwc(got), want, 1e-5, 1e-5)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("kernel", [2, 3, 5])
def test_arb_add_matches_jax(kernel, mode, monkeypatch):
    """An even kernel's +1 bottom/right pad keeps the 6x4 map's size."""
    x = _rng(5).normal(size=(2, 6, 4, 8)).astype(np.float32)
    assert_layer_matches(
        ja.ARBAdd(10, kernel, aug=True, num_heads=4),
        ta.ARBAdd(8, 10, kernel, (6, 4), aug=True, num_heads=4),
        arb_rules, x, mode, monkeypatch, train=False)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_dense_block_matches_jax(mode, monkeypatch):
    x = _rng(6).normal(size=(2, 6, 4, 8)).astype(np.float32)
    port = ta.DenseBlock(8, 10, 3, 2, (6, 4), num_heads=4, aug=True)
    assert port.out_channels == 28
    assert_layer_matches(
        ja.DenseBlock(10, 3, 2, 4, True), port,
        lambda tp, fp: arb_rules(tp + r"\.arb\.(\d+)", fp + r"/arb\1"),
        x, mode, monkeypatch, train=False)


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_transition_matches_jax(mode, monkeypatch):
    """1x1 conv, BlurPool (its filter buffer is skipped by the rules), BN:
    7x9 -> 4x5."""
    x = _rng(7).normal(size=(2, 7, 9, 8)).astype(np.float32)
    assert_layer_matches(
        ja.Transition(16), ta.Transition(8, 16),
        lambda tp, fp: [(tp + r"\.conv", "conv", fp + r"/conv/conv"),
                        (tp + r"\.batch_normalization", "bn",
                         fp + r"/norm/bn"),
                        (tp + r"\.activation", "skip", r"")],
        x, mode, monkeypatch, train=False)


# -- a two-stage model with the real head ------------------------------------

TWO_STAGES = ((10, 5, 2, 4, False, 16), (10, 3, 2, 4, True, 16))
TWO_FINAL = (10, 2, 2, 4, True)
SIZE = 8   # 8 -> 4 -> 2: the last dense block and aug block at 2x2


class JaxTwoStage(fnn.Module):
    """JAX ``AttHandNet.__call__`` (``atthandnet.py:275-299``) with two
    stages and a two-block last dense block."""

    num_joints: int = 21

    @fnn.compact
    def __call__(self, x, train: bool = False):
        for i, (g, k, it, nh, aug, t_out) in enumerate(TWO_STAGES):
            x = ja.DenseBlock(g, k, it, nh, aug, name=f"dense{i + 1}")(
                x, train)
            x = ja.Transition(t_out, name=f"transition{i + 1}")(x, train)
        x = ja.DenseBlock(*TWO_FINAL[:3], TWO_FINAL[3], TWO_FINAL[4],
                          name="dense8")(x, train)
        x = ja.AugBlock(100, 2, num_heads=10, name="aug_final")(x, train)
        x = fnn.avg_pool(x, (2, 2), strides=(2, 2))
        x = ja.Conv(self.num_joints * 2, 1, name="head")(x)
        x = ja.jnp.minimum(jax.nn.relu(x), 1.0)
        return x.reshape(x.shape[0], self.num_joints, 2).astype(
            ja.jnp.float32)


class PortTwoStage(ta.AttHandNet):
    STAGES = TWO_STAGES
    FINAL = TWO_FINAL


def _img(B=2, seed=8):
    return _rng(seed).normal(size=(B, SIZE, SIZE, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _two_stage_vars():
    return init_jax(JaxTwoStage(), _img(), seed=9, train=False)


def _port_two_stage():
    model = PortTwoStage(21, (SIZE, SIZE))
    load_jax_variables(model, _two_stage_vars(), RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_two_stage_model_matches_jax(mode, monkeypatch):
    variables = _two_stage_vars()
    if mode == "eval":
        want, _ = apply_jax(JaxTwoStage(), variables, _img(), False)
        with torch.no_grad():
            got = _port_two_stage().eval()(to_nchw(_img()))
        assert got.dtype == torch.float32 and got.shape == (2, 21, 2)
        assert_close_scaled(got.numpy(), want, 1e-5, 1e-5)
        return
    with jax_float64(monkeypatch, ja):
        want, _ = apply_jax(JaxTwoStage(), to_float64(variables),
                            _img().astype(np.float64), True)
    monkeypatch.setenv("LHN_FUSED_BN", "0")
    with torch.no_grad():
        got = _port_two_stage().double().train()(to_nchw(_img()).double())
    assert_close_scaled(got.numpy(), want, 1e-9, 1e-10)


def test_head_clamps_to_unit_interval():
    """``min(relu(x), 1)``: a head bias of +-5 saturates every output at 1
    or 0."""
    model = _port_two_stage().eval()
    for bias, value in ((5.0, 1.0), (-5.0, 0.0)):
        with torch.no_grad():
            model.conv.weight.zero_()
            model.conv.bias.fill_(bias)
            out = model(to_nchw(_img()))
        assert torch.equal(out, torch.full_like(out, value))


def test_import_torch_state_dict_round_trip_and_counts():
    assert_weights_round_trip("atthandnet", _port_two_stage(),
                              _two_stage_vars())


def test_train_step_matches_jax(monkeypatch):
    """One float64 SGD step of the two-stage model on coordinate targets in
    [0, 1] with ``target_weight`` (``TopdownHeatmapLoss(balance=False)``,
    JAX ``losses.py:303``)."""
    cfg = make_cfg("atthandnet", "freihand", image_size=SIZE,
                   **{"LOSS.loss_weight": [1.0]})
    cfg["OPTIMIZER"].update(type="SGD", lr=STEP_LR, warmup_steps=0)
    rng = _rng(10)
    batch = {"img": _img(),
             "target": rng.uniform(size=(2, 21, 2)).astype(np.float32),
             "target_weight": (rng.uniform(size=(2, 21)) > 0.1).astype(
                 np.float32)}
    assert_step_matches_jax(cfg, _two_stage_vars(), batch, batch, monkeypatch,
                            [ja], RULES, jax_model=JaxTwoStage(),
                            port_model=PortTwoStage(21, (SIZE, SIZE)))


# -- the full model -----------------------------------------------------------

def test_full_model_counts_jax_parameters():
    """``atthandnet/freihand_224`` builds at 224x224 with JAX's parameter
    count (1,945,122; shapes only)."""
    import jax.numpy as jnp

    cfg = get_config("atthandnet/freihand_224")
    jax_model = jax_get_model(jax_cfg(cfg.to_dict()))
    shapes = jax.eval_shape(
        lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 224, 224, 3), jnp.float32))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax == 1945122


@pytest.mark.slow
def test_full_model_forward_matches_jax():
    """The whole 224x224 model, eval mode in float32, B = 1."""
    t0 = time.perf_counter()
    cfg = config_from_dict(dict(MODEL=dict(name="atthandnet",
                                           output_channel=42),
                                DATASET=dict(num_joints=21,
                                             image_size=[224, 224])))
    jax_model = jax_get_model(jax_cfg(cfg.to_dict()))
    x = _rng(11).normal(size=(1, 224, 224, 3)).astype(np.float32)
    variables = init_jax(jax_model, x, seed=12, train=False)
    want = np.asarray(jax.jit(lambda v, x: jax_model.apply(
        v, x, train=False))(variables, x))
    model = get_model(cfg, device="cpu")
    load_jax_variables(model, variables, RULES)
    with torch.no_grad():
        got = model(to_nchw(x))
    assert got.shape == (1, 21, 2)
    assert_close_scaled(got.numpy(), want, 1e-5, 1e-5)
    print(f"full AttHandNet parity: {time.perf_counter() - t0:.1f} s")
