"""Full LiteHandNet: port against JAX in the train graph (eval mode) and the
deploy graph, for every ca_type x reduction, plus the weight mapping both
ways. float32 on the CPU, input_channel 32, 64x64 inputs."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import fuse_params as jax_fuse
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.utils.torch_import import import_torch_state_dict
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_close_scaled,
    init_jax,
    small_model_cfg,
    to_nchw,
    to_nhwc,
)

RTOL, ATOL = 1e-4, 1e-5
CASES = [(ca, r) for ca in ("ca", "se", "none") for r in (2, 4)]


def _x():
    return np.random.RandomState(1).normal(size=(1, 64, 64, 3)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_side(ca_type, reduction, deploy):
    """(variables, output) of the JAX model; deploy runs on JAX-fused
    variables."""
    cfg = jax_cfg(small_model_cfg(ca_type, reduction))
    if deploy:
        train_variables, _ = _jax_side(ca_type, reduction, False)
        variables = jax.tree_util.tree_map(np.asarray,
                                           jax_fuse(train_variables))
    else:
        variables = init_jax(jax_get_model(cfg), _x(), train=False)
    out = jax_get_model(cfg, deploy=deploy).apply(variables, _x(), train=False)
    return variables, np.asarray(out)


def _port(ca_type, reduction, deploy):
    cfg = config_from_dict(small_model_cfg(ca_type, reduction))
    return get_model(cfg, deploy=deploy, device="cpu")


@pytest.mark.parametrize("deploy", [False, True], ids=["train", "deploy"])
@pytest.mark.parametrize("ca_type,reduction", CASES)
def test_forward_parity(ca_type, reduction, deploy):
    variables, want = _jax_side(ca_type, reduction, deploy)
    model = _port(ca_type, reduction, deploy)
    load_jax_variables(model, variables)
    with torch.no_grad():
        out = model(to_nchw(_x()))
    assert out.shape == (1, 21, 16, 16) and out.dtype == torch.float32
    assert_close_scaled(to_nhwc(out), want, RTOL, ATOL)


@pytest.mark.parametrize("ca_type", ["ca", "se"])
def test_import_torch_state_dict_round_trip(ca_type):
    """The JAX package's own reference-name rules read the port's
    state_dict back into the very variables it was loaded from."""
    variables, _ = _jax_side(ca_type, 4, False)
    model = _port(ca_type, 4, False)
    load_jax_variables(model, variables)
    back = import_torch_state_dict("litehandnet", model.state_dict(), variables)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(got[path], leaf)


def test_load_rejects_wrong_graph():
    """Train-graph variables do not load into a deploy graph."""
    variables, _ = _jax_side("ca", 4, False)
    with pytest.raises(KeyError):
        load_jax_variables(_port("ca", 4, True), variables)


def test_registry_holds_every_jax_family():
    """``get_model`` accepts every name of JAX's registry and builds it."""
    from litehandnet_tpu.models import model_names as jax_model_names
    from litehandnet_tpu_torch.models import model_names
    from tests.torch_parity import zoo_cfg

    assert model_names() == jax_model_names()
    for name in jax_model_names():
        size = 224 if name == "atthandnet" else 64
        model = get_model(config_from_dict(zoo_cfg(name, size=size)),
                          device="cpu")
        assert not model.training and sum(
            p.numel() for p in model.parameters()) > 0, name


def test_get_model_unported_family_raises():
    """Every family of the JAX registry is ported; a name outside it
    raises."""
    cfg = config_from_dict(dict(MODEL=dict(name="nosuchmodel")))
    with pytest.raises(KeyError, match="unknown model 'nosuchmodel'"):
        get_model(cfg, device="cpu")
