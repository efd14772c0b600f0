"""The image classifier (``classifier``, MobileNetV2 backbone, GAP, Linear
head): the port against JAX on the CPU at ``widen_factor`` 0.25, 32x32, 10
classes, B = 2. Eval mode in float32 (rtol 1e-4, atol 1e-5 of the output's
largest magnitude), train mode in float64 (rtol 1e-9) with the running
statistics; the port's own weight rules carry JAX's variables across (JAX's
importer has none for this family); the parameter count of the full-width
1000-class model."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import classifier as jax_classifier
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import simplebaseline as jax_simplebaseline
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    apply_jax,
    assert_close_scaled,
    assert_state_matches,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    zoo_cfg,
)

RULES = rules_for("classifier")


def _x():
    return np.random.RandomState(2).normal(size=(2, 32, 32, 3)).astype(
        np.float32)


def _cfg(widen=0.25, classes=10):
    return zoo_cfg("classifier", size=32, num_classes=classes,
                   widen_factor=widen)


@functools.lru_cache(maxsize=None)
def _jax_side():
    model = jax_get_model(jax_cfg(_cfg()))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port():
    model = get_model(config_from_dict(_cfg()), device="cpu")
    load_jax_variables(model, _jax_side()[1], RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_parity(mode, monkeypatch):
    model, variables = _jax_side()
    port = _port()
    if mode == "eval":
        want, _ = apply_jax(model, variables, _x(), False)
        with torch.no_grad():
            got = port.eval()(to_nchw(_x()))
        assert got.dtype == torch.float32 and got.shape == (2, 10)
        assert_close_scaled(got.numpy(), want, 1e-4, 1e-5)
        return
    with jax_float64(monkeypatch, jax_classifier, jax_simplebaseline):
        want, stats = apply_jax(model, to_float64(variables),
                                _x().astype(np.float64), True)
    monkeypatch.setenv("LHN_FUSED_BN", "0")
    port = port.double().train()
    with torch.no_grad():
        got = port(to_nchw(_x()).double())
    assert_close_scaled(got.numpy(), want, 1e-9, 1e-10)
    assert_state_matches(port, variables, stats, RULES, rtol=1e-9)


def test_weights_carry_every_jax_leaf():
    """The port's rules use every JAX leaf and fill every port tensor (the
    loader raises otherwise); the counts agree."""
    _, variables = _jax_side()
    port = _port()
    assert sum(p.numel() for p in port.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(variables["params"]))


def test_full_width_counts_jax_parameters():
    """``widen_factor`` 1.0, 1000 classes at 224x224 (shapes only)."""
    d = _cfg(1.0, 1000)
    jax_model = jax_get_model(jax_cfg(d))
    shapes = jax.eval_shape(
        lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 224, 224, 3), np.float32))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model(config_from_dict(d), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
