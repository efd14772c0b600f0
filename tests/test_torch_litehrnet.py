"""Lite-HRNet (``litehrnet``): the port against JAX on the CPU at depth 18,
64x64 inputs, B = 2. Eval mode in float32 (rtol 1e-4, atol 1e-5 of the
output's largest magnitude); train mode in float64 (rtol 1e-9) with the
running statistics after the call, where the reference's fuse quirk shows:
the ``fuse_layers[i][0]`` BatchNorms move twice a step. The align-corners
bilinear resize in the forward and the backward, ``channel_shuffle``, the
weight mapping both ways and the full-width parameter counts (depth 18 and
30)."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import layers as jax_layers
from litehandnet_tpu.models import litehrnet as jax_litehrnet
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model, layers
from litehandnet_tpu_torch.models.litehrnet import (
    StageModule,
    resize_bilinear_align_corners,
)
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_family_forward,
    assert_served_config,
    assert_weights_round_trip,
    init_jax,
    jax_float64,
    to_nchw,
    to_nhwc,
    zoo_cfg,
)

RULES = rules_for("litehrnet")


def _x():
    return np.random.RandomState(2).normal(size=(2, 64, 64, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side():
    model = jax_get_model(jax_cfg(zoo_cfg("litehrnet", depth=18)))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port():
    model = get_model(config_from_dict(zoo_cfg("litehrnet", depth=18)),
                      device="cpu")
    load_jax_variables(model, _jax_side()[1], RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_parity(mode, monkeypatch):
    model, variables = _jax_side()
    port = _port()
    out = assert_family_forward(port, model, variables, _x(), mode, RULES,
                                monkeypatch, [jax_litehrnet])
    assert out.shape == (2, 21, 16, 16)
    if mode == "train":
        # the reference's fuse quirk: fuse_layers[i][0] runs twice per row
        # i >= 1, every other BatchNorm once
        for module in port.modules():
            if not isinstance(module, StageModule):
                continue
            for i, row in enumerate(module.fuse_layers):
                calls = 2 if i >= 1 else 1
                for m in row[0].modules():
                    if isinstance(m, torch.nn.BatchNorm2d):
                        assert int(m.num_batches_tracked) == calls


def test_import_torch_state_dict_round_trip_and_counts():
    assert_weights_round_trip("litehrnet", _port(), _jax_side()[1])


@pytest.mark.parametrize("depth,exp_id,name", [
    (30, 36, "litehrnet/freihand_256_d30"),
    (18, 31, "litehrnet/freihand_256_d18"),
])
def test_served_config_matches_jax_template(depth, exp_id, name):
    assert_served_config(name, "litehrnet", exp_id, **{"MODEL.depth": depth})


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((3, 5), (6, 9)),
                                     ((8, 8), (8, 8)), ((5, 2), (16, 7))])
def test_bilinear_align_corners_forward_and_backward(src, dst, monkeypatch):
    """The IterativeHead's resize equals JAX's ``scale_and_translate`` form
    in float64 (its float32 scale mapped to float64), and so does its
    gradient (of a weighted sum of the output)."""
    rng = np.random.RandomState(5)
    x = rng.normal(size=(2,) + src + (3,))
    w = rng.normal(size=(2,) + dst + (3,))
    with jax_float64(monkeypatch, jax_litehrnet):
        want, vjp = jax.vjp(
            lambda a: jax_litehrnet.resize_bilinear_align_corners(a, dst), x)
        want_grad, = vjp(w)
    xt = to_nchw(x).requires_grad_(True)
    got = resize_bilinear_align_corners(xt, dst)
    (got * to_nchw(w)).sum().backward()
    np.testing.assert_allclose(to_nhwc(got), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(want_grad),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("groups", [2, 4])
def test_channel_shuffle_equals_jax(groups):
    x = np.random.RandomState(6).normal(size=(2, 3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        to_nhwc(layers.channel_shuffle(to_nchw(x), groups)),
        np.asarray(jax_layers.channel_shuffle(x, groups)))
