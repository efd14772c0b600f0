"""The stacked hourglass (``hourglass``): the port against JAX on the CPU
with 2 stacks, 2 levels and 32 features, 64x64 inputs, B = 2. Eval mode in
float32 (rtol 1e-4, atol 1e-5 of the output's largest magnitude); train mode
in float64 (rtol 1e-9) with the running statistics after the call. The
weight mapping both ways, the full-width parameter count, the nearest resize
and ceil-mode pool at the odd sizes a hourglass reaches, and one float64
train step (loss, gradients, statistics) against JAX's ``make_train_step``
with the stacked output supervised by one target."""

import functools

import numpy as np
import pytest

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import hourglass as jax_hourglass
from litehandnet_tpu.models import layers as jax_layers
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models import layers
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    STEP_LR,
    assert_family_forward,
    assert_served_config,
    assert_step_matches_jax,
    assert_weights_round_trip,
    init_jax,
    step_batches,
    to_nchw,
    to_nhwc,
    zoo_cfg,
)

RULES = rules_for("hourglass")
MODEL = {"num_stack": 2, "num_level": 2, "input_channel": 32}


def _x():
    return np.random.RandomState(2).normal(size=(2, 64, 64, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side():
    model = jax_get_model(jax_cfg(zoo_cfg("hourglass", **MODEL)))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port():
    model = get_model(config_from_dict(zoo_cfg("hourglass", **MODEL)),
                      device="cpu")
    load_jax_variables(model, _jax_side()[1], RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_parity(mode, monkeypatch):
    model, variables = _jax_side()
    out = assert_family_forward(_port(), model, variables, _x(), mode, RULES,
                                monkeypatch, [jax_hourglass])
    assert out.shape == (2, 2, 21, 16, 16)


def test_import_torch_state_dict_round_trip_and_counts():
    assert_weights_round_trip("hourglass", _port(), _jax_side()[1])


def test_served_config_matches_jax_template():
    assert_served_config("hourglass/freihand_256_s2", "hourglass", 42,
                         **{"MODEL.num_stack": 2})


@pytest.mark.parametrize("src,dst", [
    ((5, 7), (9, 13)), ((3, 3), (5, 5)), ((4, 6), (7, 11)), ((7, 5), (3, 2)),
])
def test_resize_and_pool_at_odd_sizes(src, dst):
    """``resize_nearest`` (an odd map resized to its skip's size) and the
    ceil-mode ``max_pool2`` equal JAX's at odd sizes."""
    x = np.random.RandomState(4).normal(size=(2,) + src + (3,)).astype(np.float32)
    np.testing.assert_array_equal(
        to_nhwc(layers.resize_nearest(to_nchw(x), dst)),
        np.asarray(jax_layers.resize_nearest(x, dst)))
    np.testing.assert_array_equal(to_nhwc(layers.max_pool2(to_nchw(x))),
                                  np.asarray(jax_layers.max_pool2(x)))


def test_train_step_matches_jax(monkeypatch):
    """A stacked output ``[B, S, K, H, W]`` against one ``[B, K, H, W]``
    target shared by every stack (``losses.distance_loss``)."""
    cfg = make_cfg("hourglass", "freihand", image_size=64, **{
        f"MODEL.{k}": v for k, v in MODEL.items()})
    cfg["OPTIMIZER"].update(type="SGD", lr=STEP_LR, warmup_steps=0)
    jax_batch, port_batch = step_batches(21, [(16, 16)])
    variables = init_jax(jax_get_model(jax_cfg(cfg)), jax_batch["img"],
                         seed=5, train=False)
    assert_step_matches_jax(cfg, variables, jax_batch, port_batch,
                            monkeypatch, [jax_hourglass], RULES)
