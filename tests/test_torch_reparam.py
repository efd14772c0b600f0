"""Port re-parameterization (litehandnet_tpu_torch.models.reparam): port
deploy on port-fused weights equals the port train graph in eval mode, and
port fusion equals JAX fusion. float32 on the CPU."""

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import fuse_params as jax_fuse
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import layers as J
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.models import layers as T
from litehandnet_tpu_torch.utils.weights import (
    attention_rules,
    load_jax_variables,
    randomize_,
    repblock_rules,
    repconv_rules,
)
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_close_scaled,
    init_jax,
    load_layer,
    small_model_cfg,
)

RTOL, ATOL = 1e-4, 1e-5


def _deploy_of(train_model, deploy_model):
    deploy_model.load_state_dict(fuse_params(train_model))
    return deploy_model.eval()


@pytest.mark.parametrize("ca_type", ["ca", "se", "none"])
def test_port_deploy_equals_port_train(ca_type):
    cfg = config_from_dict(small_model_cfg(ca_type, 4))
    train = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    deploy = _deploy_of(train, get_model(cfg, deploy=True, device="cpu"))
    x = torch.from_numpy(
        np.random.RandomState(0).normal(size=(2, 3, 64, 64)).astype(np.float32))
    with torch.no_grad():
        want, got = train(x), deploy(x)
    assert_close_scaled(got.numpy(), want.numpy(), RTOL, ATOL)


def test_fuse_matches_jax_fuse():
    """Every fused tensor equals the JAX ``fuse_params`` leaf it maps to."""
    d = small_model_cfg("ca", 4)
    x = np.zeros((1, 64, 64, 3), np.float32)
    variables = init_jax(jax_get_model(jax_cfg(d)), x, train=False)
    cfg = config_from_dict(d)
    train = get_model(cfg, device="cpu")
    load_jax_variables(train, variables)
    port_fused = fuse_params(train)
    jax_fused = get_model(cfg, deploy=True, device="cpu")
    load_jax_variables(jax_fused,
                       jax.tree_util.tree_map(np.asarray, jax_fuse(variables)))
    want = jax_fused.state_dict()
    assert sorted(port_fused) == sorted(want)
    for key, value in want.items():
        np.testing.assert_allclose(port_fused[key].numpy(), value.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("make,rules,cin", [
    (lambda d: (J.RepConv(8, 3, 1, 2, 2, groups=8, deploy=d),
                T.RepConv(8, 8, 3, 1, 2, 2, groups=8, deploy=d)),
     repconv_rules, 8),
    (lambda d: (J.RepBlock(8, 7, 1, 3, groups=8, deploy=d),
                T.RepBlock(8, 8, 7, 1, 3, groups=8, deploy=d)),
     repblock_rules, 8),
    (lambda d: (J.RepBlock(16, 3, 2, 1, deploy=d),
                T.RepBlock(3, 16, 3, 2, 1, deploy=d)),
     repblock_rules, 3),
    (lambda d: (J.ChannelAttention(deploy=d), T.ChannelAttention(8, d)),
     attention_rules, 8),
], ids=["dw_repconv_dilated", "dw_repblock_identity", "repblock_stem",
        "channel_attention"])
def test_layer_fusion_matches_jax_deploy(make, rules, cin):
    """Port-fused layer in the deploy graph equals the JAX deploy layer on
    JAX-fused variables."""
    x = np.random.RandomState(2).normal(size=(2, 12, 12, cin)).astype(np.float32)
    jax_train, port_train = make(False)
    jax_deploy, port_deploy = make(True)
    variables = init_jax(jax_train, x, train=False)
    fused = jax.tree_util.tree_map(np.asarray, jax_fuse(variables))
    want = np.asarray(jax_deploy.apply(fused, x, train=False))
    load_layer(port_train, variables, rules)
    holder = torch.nn.Module()
    holder.add_module("m", port_train)
    port_deploy.load_state_dict(
        {k[2:]: v for k, v in fuse_params(holder).items()})
    with torch.no_grad():
        got = port_deploy.eval()(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want,
                               rtol=RTOL, atol=ATOL)


def test_fuse_rejects_deploy_graph():
    cfg = config_from_dict(small_model_cfg())
    with pytest.raises(ValueError, match="already a deploy graph"):
        fuse_params(get_model(cfg, deploy=True, device="cpu"))
