"""``mynet`` (MSAttHourglass): the port against JAX in eval mode and in
train mode (batch statistics, running statistics after the call; dropout
identity on both sides), with and without the output activation that the
misspelt key ``output_acitivation`` switches on, plus the weight mapping
both ways and the parameter count. On the CPU, ``input_channel`` 32, 64x64
inputs, B = 2. Eval mode in float32: rtol 1e-4, atol 1e-5 of the output's
largest magnitude. Train mode in float64 on both sides (see
``test_torch_hourglass_ablation.py``): rtol 1e-9, atol 1e-10 of the largest
magnitude; running statistics rtol 1e-9."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import ms_att_hourglass as jax_mynet
from litehandnet_tpu.utils.torch_import import import_torch_state_dict
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    no_dropout,  # noqa: F401  (fixture)
    apply_jax,
    assert_close_scaled,
    assert_served_config,
    assert_state_matches,
    family_cfg,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    to_nhwc,
)

RULES = rules_for("mynet")


def _x():
    return np.random.RandomState(2).normal(size=(2, 64, 64, 3)).astype(np.float32)


def _cfg(activation):
    return family_cfg("mynet", num_block=(1, 2, 1),
                      output_acitivation=activation)


@functools.lru_cache(maxsize=None)
def _jax_side(activation):
    model = jax_get_model(jax_cfg(_cfg(activation)))
    return model, init_jax(model, _x(), seed=3, train=False)


@functools.lru_cache(maxsize=None)
def _jax_out(activation, mode):
    model, variables = _jax_side(activation)
    if mode == "eval":
        return apply_jax(model, variables, _x(), False)
    return apply_jax(model, to_float64(variables), _x().astype(np.float64),
                     True)


def _port(activation):
    model = get_model(config_from_dict(_cfg(activation)), device="cpu")
    load_jax_variables(model, _jax_side(activation)[1], RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("activation", [False, True], ids=["act0", "act1"])
def test_forward_parity(activation, mode, no_dropout, monkeypatch):
    model = no_dropout(_port(activation))
    if mode == "eval":
        want, _ = _jax_out(activation, mode)
        with torch.no_grad():
            out = model(to_nchw(_x()))
        assert out.shape == (2, 21, 16, 16) and out.dtype == torch.float32
        assert_close_scaled(to_nhwc(out), want, 1e-4, 1e-5)
        if activation:   # leaky ReLU of slope 0.5 on the heatmaps
            assert (want < 0).any()
        return
    with jax_float64(monkeypatch, jax_mynet):
        want, stats = _jax_out(activation, mode)
    model = model.double().train()
    with torch.no_grad():
        out = model(to_nchw(_x()).double())
    assert out.dtype == torch.float64
    assert_close_scaled(to_nhwc(out), want, 1e-9, 1e-10)
    assert_state_matches(model, _jax_side(activation)[1], stats, RULES,
                         rtol=1e-9)


def test_import_torch_state_dict_round_trip_and_counts():
    variables = _jax_side(False)[1]
    model = _port(False)
    back = import_torch_state_dict("mynet", model.state_dict(), variables)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(got[path], leaf)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(variables["params"]))


def test_served_config_matches_jax_template():
    """``mynet/freihand_256`` is JAX exp 11 in every field the port reads,
    and its full-width model counts JAX's parameters."""
    assert_served_config("mynet/freihand_256", "mynet", 11)
