"""``mynet_stacked`` (MSAttHourglassStacked, exp 16's family) against JAX on
the CPU at ``main_channels`` 32, ``hg_depth`` 3, 64x64 inputs, 2 stacks,
B = 2: eval mode in float32 (rtol 1e-4, atol 1e-5 of each output's largest
magnitude) on the stacks' K + 3 maps and the SimDR vectors, also for a
half-resolution input (the cycle-detection pass: joint maps resized to
``image_size // 4`` before the SimDR heads); train mode in float64 (rtol
1e-9, atol 1e-10 of the max; dropout identity on both sides) with the
running statistics after the call; the weight mapping both ways; exp 16's
config and parameter count; the 128-channel BatchNorm sites of the full
width model."""

import functools

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import ms_att_hourglass_stacked as jax_stacked
from litehandnet_tpu_torch.config import config_from_dict, get_config
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.layers import TorchBatchNorm
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    no_dropout,  # noqa: F401  (fixture)
    apply_jax,
    assert_close_scaled,
    assert_served_config,
    assert_state_matches,
    assert_weights_round_trip,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    to_nhwc,
)

RULES = rules_for("mynet_stacked")
CFG = make_cfg("mynet_stacked", "freihand", exp_id=16, image_size=64,
               **{"MODEL.main_channels": 32, "MODEL.hg_depth": 3})


def _x(size=64):
    return np.random.RandomState(2).normal(size=(2, size, size, 3)).astype(
        np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side():
    model = jax_get_model(jax_cfg(CFG))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port():
    model = get_model(config_from_dict(CFG), device="cpu")
    load_jax_variables(model, _jax_side()[1], RULES)
    return model


def _assert_outputs(got, want, rtol, atol):
    """``(maps per stack, pred_x, pred_y)`` of the port against JAX's."""
    maps, px, py = got
    assert len(maps) == len(want[0]) == 2
    for m, w in zip(maps, want[0]):
        assert m.shape[1] == 24
        assert_close_scaled(to_nhwc(m), w, rtol, atol)
    for v, w in ((px, want[1]), (py, want[2])):
        assert v.shape == (2, 21, 128)
        assert_close_scaled(v.detach().numpy(), w, rtol, atol)


@pytest.mark.parametrize("size", [64, 32], ids=["full", "half"])
def test_eval_forward(size):
    model, variables = _jax_side()
    want, _ = apply_jax(model, variables, _x(size), False)
    with torch.no_grad():
        got = _port()(to_nchw(_x(size)))
    assert all(m.dtype == torch.float32 and m.shape[2] == size // 4
               for m in got[0])
    _assert_outputs(got, want, 1e-4, 1e-5)


def test_train_forward_float64(no_dropout, monkeypatch):
    model, variables = _jax_side()
    with jax_float64(monkeypatch, jax_stacked):
        want, stats = apply_jax(model, to_float64(variables),
                                _x().astype(np.float64), True)
    monkeypatch.setenv("LHN_FUSED_BN", "0")   # moments takes float32/bf16
    port = no_dropout(_port()).double().train()
    with torch.no_grad():
        got = port(to_nchw(_x()).double())
    assert got[1].dtype == torch.float64
    _assert_outputs(got, want, 1e-9, 1e-10)
    assert_state_matches(port, variables, stats, RULES, rtol=1e-9)


def test_import_torch_state_dict_round_trip_and_counts():
    assert_weights_round_trip("mynet_stacked", _port(), _jax_side()[1])


def test_served_config_matches_jax_template():
    """``mynet_stacked/freihand_256_region_simdr`` is JAX exp 16 in every
    field the port reads; its full-width model counts JAX's parameters."""
    assert_served_config("mynet_stacked/freihand_256_region_simdr",
                         "mynet_stacked", 16)


def test_full_width_moments_sites():
    """Exp 16 at full width has 43 BatchNorms at C = 128 (the ``moments``
    sites): 1 in the stem, and per stack 9 in the three attention blocks,
    10 in the pre-activation residuals and 2 in the feature head; each runs
    once per forward."""
    cfg = get_config("mynet_stacked/freihand_256_region_simdr")
    model = get_model(cfg, device="cpu")
    calls = []
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm) and mod.num_features % 128 == 0:
            mod.register_forward_pre_hook(lambda m, a: calls.append(m))
    with torch.no_grad():
        model(torch.zeros(1, 3, 64, 64))
    assert len(calls) == len(set(map(id, calls))) == 43
