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
    to_nchw,
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


def test_fold_input_normalization_is_exact_on_valid_padding():
    """Folding ``(x - mean) / std`` into a VALID-padded first conv is exact
    (JAX ``tests/test_litehandnet.py:104-130``) and gives JAX's folded
    kernel and bias on the same weights; every other tensor is shared."""
    from flax import linen as fnn

    from litehandnet_tpu.models.reparam import (
        fold_input_normalization as jax_fold,
    )
    from litehandnet_tpu_torch.models.reparam import fold_input_normalization

    class JaxTiny(fnn.Module):
        @fnn.compact
        def __call__(self, x):
            x = fnn.Conv(8, (3, 3), strides=(2, 2), padding="VALID",
                         name="stem")(x)
            return fnn.leaky_relu(fnn.Conv(4, (1, 1), name="head")(x))

    class Tiny(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.stem = torch.nn.Conv2d(3, 8, 3, 2)
            self.head = torch.nn.Conv2d(8, 4, 1)

        def forward(self, x):
            return torch.nn.functional.leaky_relu(self.head(self.stem(x)))

    variables = init_jax(JaxTiny(), np.zeros((1, 32, 32, 3), np.float32))
    model = Tiny()
    load_jax_variables(model, variables, [
        (r"stem", "conv", r"stem"), (r"head", "conv", r"head")])
    mean = np.float32([0.485, 0.456, 0.406]) * 255.0
    std = np.float32([0.229, 0.224, 0.225]) * 255.0
    raw = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3)).astype(
        np.float32)
    with torch.no_grad():
        want = model(to_nchw((raw - mean) / std))
        sd = model.state_dict()
        folded = fold_input_normalization(sd, mean, std, conv="stem")
        assert folded["head.weight"] is sd["head.weight"]
        model.load_state_dict(folded)
        got = model(to_nchw(raw))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    jax_folded = jax_fold(variables, mean, std, conv_path=("stem",))
    np.testing.assert_allclose(
        folded["stem.weight"].numpy(),
        np.transpose(np.asarray(jax_folded["params"]["stem"]["kernel"]),
                     (3, 2, 0, 1)), rtol=1e-6, atol=1e-9)
    np.testing.assert_allclose(folded["stem.bias"].numpy(),
                               np.asarray(jax_folded["params"]["stem"]["bias"]),
                               rtol=1e-5, atol=1e-5)


def test_fold_input_normalization_default_is_litehandnets_stem():
    """The default ``conv`` is LiteHandNet's fused stem conv
    (``pre.conv1.0.rep``, JAX's ``('pre', 'c1', 'rep', 'conv')``)."""
    from litehandnet_tpu_torch.models.reparam import fold_input_normalization

    cfg = config_from_dict(small_model_cfg())
    train = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    sd = fuse_params(train)
    folded = fold_input_normalization(sd, [1.0, 2.0, 3.0], [2.0, 2.0, 2.0])
    changed = {k for k in sd if folded[k] is not sd[k]}
    assert changed == {"pre.conv1.0.rep.weight", "pre.conv1.0.rep.bias"}
