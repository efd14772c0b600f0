"""Port layers (litehandnet_tpu_torch.models.layers) against the JAX
layers, with the same numpy weights and inputs, in float32 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.models import layers as J
from litehandnet_tpu_torch.models import layers as T
from litehandnet_tpu_torch.utils.weights import (
    attention_rules,
    repblock_rules,
    repconv_rules,
)
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    init_jax,
    load_layer,
    to_nchw,
    to_nhwc,
)

RTOL = ATOL = 1e-5


def _conv_rules(tp, fp):
    return [(tp, "conv", fp + "/conv")]


def _check(jax_mod, port_mod, rules_fn, x, **apply_kw):
    variables = init_jax(jax_mod, x, **apply_kw)
    want = np.asarray(jax_mod.apply(variables, x, **apply_kw))
    load_layer(port_mod, variables, rules_fn)
    with torch.no_grad():
        got = to_nhwc(port_mod(to_nchw(x)))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def _x(C=8, H=12, W=12, B=2, seed=0):
    return np.random.RandomState(seed).normal(size=(B, H, W, C)).astype(np.float32)


@pytest.mark.parametrize("k,s,p,d,g", [
    (1, 1, 0, 1, 1), (3, 2, 1, 1, 1), (3, 1, 2, 2, 8), (7, 1, 3, 1, 8),
])
def test_conv_parity(k, s, p, d, g):
    _check(J.Conv(16 if g == 1 else 8, k, s, p, d, g),
           T.Conv(8, 16 if g == 1 else 8, k, s, p, d, g),
           _conv_rules, _x())


@pytest.mark.parametrize("deploy", [False, True])
@pytest.mark.parametrize("act", ["leaky_relu", "relu", None])
def test_repconv_parity(deploy, act):
    ja = {"leaky_relu": J.leaky_relu, "relu": J.relu, None: None}[act]
    ta = {"leaky_relu": T.leaky_relu, "relu": T.relu, None: None}[act]
    _check(J.RepConv(16, 3, 2, 1, act=ja, deploy=deploy),
           T.RepConv(8, 16, 3, 2, 1, act=ta, deploy=deploy),
           repconv_rules, _x(), train=False)


def test_repconv_act_quirk():
    """LeakyReLU's positional ``inplace`` makes a RepConv identity or ReLU."""
    assert T.repconv_act(T.leaky_relu, inplace=True) is None
    assert T.repconv_act(T.leaky_relu, inplace=False) is T.relu
    assert T.repconv_act(T.relu, inplace=True) is T.relu
    x = np.linspace(-2, 2, 16, dtype=np.float32).reshape(1, 1, 4, 4)
    jax_relu = J.repconv_act(J.leaky_relu, inplace=False)
    port_relu = T.repconv_act(T.leaky_relu, inplace=False)
    np.testing.assert_array_equal(port_relu(torch.from_numpy(x)).numpy(),
                                  np.asarray(jax_relu(x)))


@pytest.mark.parametrize("deploy", [False, True])
@pytest.mark.parametrize("cin,cout,k,s,g", [
    (3, 16, 3, 2, 1),   # stem c1: no identity branch
    (8, 8, 7, 1, 8),    # stem c2: depthwise 7x7 with identity branch
    (8, 8, 3, 1, 1),    # dense 3x3 with identity branch
])
def test_repblock_parity(deploy, cin, cout, k, s, g):
    _check(J.RepBlock(cout, k, s, k // 2, groups=g, deploy=deploy),
           T.RepBlock(cin, cout, k, s, k // 2, groups=g, deploy=deploy),
           repblock_rules, _x(C=cin), train=False)


@pytest.mark.parametrize("deploy", [False, True])
@pytest.mark.parametrize("hw", [12, 16])
def test_channel_attention_parity(deploy, hw):
    """Pooling 12x12 or 16x16 to 3x3: uneven regions at 16."""
    _check(J.ChannelAttention(deploy=deploy), T.ChannelAttention(8, deploy),
           attention_rules, _x(H=hw, W=hw), train=False)


def test_se_block_parity():
    _check(J.SEBlock(4), T.SEBlock(8, 4), attention_rules, _x(), train=False)


@pytest.mark.parametrize("size,out", [((16, 16), (3, 3)), ((64, 64), (8, 8)),
                                      ((7, 9), (3, 4)), ((12, 12), (1, 1))])
def test_adaptive_avg_pool_parity(size, out):
    x = _x(H=size[0], W=size[1])
    want = np.asarray(J.adaptive_avg_pool(jnp.asarray(x), out))
    got = to_nhwc(T.adaptive_avg_pool(to_nchw(x), out))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("src,dst", [((4, 4), (8, 8)), ((4, 4), (4, 4)),
                                     ((4, 3), (8, 9)), ((4, 4), (7, 7))])
def test_resize_nearest_parity(src, dst):
    x = _x(H=src[0], W=src[1])
    want = np.asarray(J.resize_nearest(jnp.asarray(x), dst))
    got = to_nhwc(T.resize_nearest(to_nchw(x), dst))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("hw", [(8, 8), (7, 9)])
def test_max_pool2_ceil_parity(hw):
    x = _x(H=hw[0], W=hw[1])
    want = np.asarray(J.max_pool2(jnp.asarray(x)))
    got = to_nhwc(T.max_pool2(to_nchw(x)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["leakyrelu", "relu", "silu", "mish",
                                  "sigmoid", "none"])
def test_get_activation_parity(name):
    ja, ta = J.get_activation(name), T.get_activation(name)
    assert (ja is None) == (ta is None)
    if ja is not None:
        x = np.linspace(-3, 3, 25, dtype=np.float32)
        np.testing.assert_allclose(ta(torch.from_numpy(x)).numpy(),
                                   np.asarray(ja(x)), rtol=RTOL, atol=ATOL)
