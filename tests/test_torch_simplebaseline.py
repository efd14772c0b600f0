"""SimpleBaseline (``resnet`` and ``mobilenetv2`` with the shared deconv
head): the port against JAX on the CPU at 64x64, B = 2. ResNet 18 and 50
(basic and bottleneck blocks), ResNet 18 with the deep stem, MobileNetV2 at
``widen_factor`` 0.5 and 1.0. Eval mode in float32 (rtol 1e-4, atol 1e-5
of the output's largest magnitude); train mode in float64 on both sides
(rtol 1e-9), with the running statistics after the call. Weights both
ways; a deconv kernel left unflipped gives another function; the full-width
configs count JAX's parameters."""

import functools

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import simplebaseline as jax_simplebaseline
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.utils import weights
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    apply_jax,
    assert_family_forward,
    assert_served_config,
    assert_weights_round_trip,
    init_jax,
    to_jax_layout,
    to_nchw,
    zoo_cfg,
)

CASES = {
    "resnet18": dict(name="resnet", depth=18),
    "resnet50": dict(name="resnet", depth=50),
    "mobilenetv2_w0.5": dict(name="mobilenetv2", widen_factor=0.5),
    "mobilenetv2_w1.0": dict(name="mobilenetv2", widen_factor=1.0),
}
# the deep stem is the port's and JAX's, but JAX's import table has no rule
# for it: forward parity only
FORWARD_ONLY = {"resnet18_deep_stem": dict(name="resnet", depth=18,
                                           deep_stem=True)}


def _x():
    return np.random.RandomState(2).normal(size=(2, 64, 64, 3)).astype(np.float32)


def _cfg(case):
    return zoo_cfg(**{**CASES, **FORWARD_ONLY}[case])


@functools.lru_cache(maxsize=None)
def _jax_side(case):
    model = jax_get_model(jax_cfg(_cfg(case)))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port(case):
    cfg = config_from_dict(_cfg(case))
    model = get_model(cfg, device="cpu")
    load_jax_variables(model, _jax_side(case)[1], rules_for(cfg.MODEL.name))
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted({**CASES, **FORWARD_ONLY}))
def test_forward_parity(case, mode, monkeypatch):
    model, variables = _jax_side(case)
    out = assert_family_forward(
        _port(case), model, variables, _x(), mode,
        rules_for(_cfg(case)["MODEL"]["name"]), monkeypatch,
        [jax_simplebaseline])
    assert out.shape == (2, 21, 16, 16)


@pytest.mark.parametrize("case", sorted(CASES))
def test_import_torch_state_dict_round_trip_and_counts(case):
    assert_weights_round_trip(CASES[case]["name"], _port(case),
                              _jax_side(case)[1])


def test_unflipped_deconv_kernel_gives_another_function(monkeypatch):
    """Flax's ConvTranspose and torch's ConvTranspose2d agree only with the
    kernel flipped in both spatial axes: loaded unflipped, the head is off
    by far more than the parity tolerance."""
    model, variables = _jax_side("resnet18")
    want, _ = apply_jax(model, variables, _x(), False)
    kind = weights._KINDS["deconv"]
    monkeypatch.setitem(kind, "weight", (
        "params", "kernel", lambda a: np.transpose(a, (2, 3, 0, 1))))
    with torch.no_grad():
        got = to_jax_layout(_port("resnet18").eval()(to_nchw(_x())))
    assert np.abs(got - want).max() > 1e-2 * np.abs(want).max()


@pytest.mark.parametrize("name,family,exp_id,overrides", [
    ("resnet/freihand_256_r50", "resnet", 20, {"MODEL.depth": 50}),
    ("mobilenetv2/freihand_256", "mobilenetv2", 26, {}),
])
def test_served_config_matches_jax_template(name, family, exp_id, overrides):
    assert_served_config(name, family, exp_id, **overrides)


@pytest.mark.parametrize("depth", [18, 34, 50, 101, 152])
def test_every_depth_counts_jax_parameters(depth):
    """``get_model`` builds every ResNet depth; the counts equal JAX's
    (shapes only)."""
    import jax

    d = zoo_cfg("resnet", size=256, depth=depth)
    jax_model = jax_get_model(jax_cfg(d))
    shapes = jax.eval_shape(
        lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 64, 64, 3), np.float32))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model(config_from_dict(d), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
