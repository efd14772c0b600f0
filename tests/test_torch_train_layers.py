"""Port layers in train mode (``litehandnet_tpu_torch.models.layers``)
against the JAX layers: outputs and BatchNorm running statistics after one
train-mode call, with the same numpy weights and inputs, float32 on the
CPU. Dropout is identity on both sides wherever a whole layer is compared
(flax and torch draw different bits)."""

import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from litehandnet_tpu.models import layers as J
from litehandnet_tpu_torch.models import layers as T
from litehandnet_tpu_torch.utils.weights import (
    attention_rules,
    repblock_rules,
    repconv_rules,
)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import init_jax, load_layer, to_nchw, to_nhwc

# outputs: float32 sums in two orders, 1e-5 relative plus 1e-5 of the
# output's magnitude; running statistics 1e-5 relative plus 1e-6
RTOL = 1e-5


def _bn_rules(tp, fp):
    return [(tp, "bn", fp + "/bn")]


def _x(shape, seed=0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=shape) * 2.0 + shift).astype(np.float32)


def _check_train(jax_mod, port_mod, rules_fn, x, port_kw=None, **jax_kw):
    """One train-mode call on each side from the same variables; compare
    the outputs and the running statistics they leave."""
    variables = init_jax(jax_mod, x, train=False)
    want, updated = jax_mod.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"], **jax_kw)
    load_layer(port_mod, variables, rules_fn).train()
    got = port_mod(to_nchw(x), **(port_kw or {}))
    want = np.asarray(want)
    np.testing.assert_allclose(to_nhwc(got), want, rtol=RTOL,
                               atol=1e-5 * max(1.0, float(np.abs(want).max())))
    # the JAX running statistics, loaded through the same rules, must equal
    # the port's buffers after its call
    twin = load_layer(copy.deepcopy(port_mod),
                      {"params": variables["params"],
                       "batch_stats": updated["batch_stats"]}, rules_fn)
    for (name, buf), want_buf in zip(port_mod.named_buffers(), twin.buffers()):
        if buf.is_floating_point():
            np.testing.assert_allclose(buf.numpy(), want_buf.numpy(),
                                       rtol=RTOL, atol=1e-6, err_msg=name)
    return got


@pytest.mark.parametrize("C,fused,shift", [
    (8, "1", 0.0), (128, "1", 0.0), (128, "0", 0.0), (128, "1", 5.0),
])
def test_batchnorm_train_stats_route(C, fused, shift, monkeypatch):
    """Batch statistics through ``moments`` (C % 128 == 0 with the gate on)
    or the plain two-pass, normalization, and the unbiased running-var
    EMA at momentum 0.1. (At |mean| >> std the float32 ``x - mean`` of
    either side rounds at the mean's scale; the statistics themselves are
    held there in test_torch_fused_bn.py.)"""
    monkeypatch.setenv("LHN_FUSED_BN", fused)
    _check_train(J.BatchNorm(), T.TorchBatchNorm(C), _bn_rules,
                 _x((2, 6, 5, C), shift=shift))


def test_batchnorm_train_routes_through_moments(monkeypatch):
    """The gate decides whether ``moments`` runs: C % 128 == 0 sites only,
    and not with ``LHN_FUSED_BN=0``."""
    calls = []
    real = T.moments
    monkeypatch.setattr(T, "moments", lambda x: calls.append(x.shape) or real(x))
    for C, env, want in ((128, "1", 1), (64, "1", 0), (128, "0", 0)):
        monkeypatch.setenv("LHN_FUSED_BN", env)
        calls.clear()
        T.TorchBatchNorm(C).train()(torch.randn(2, C, 3, 3))
        assert len(calls) == want, (C, env)


@pytest.mark.parametrize("C,shape,smallc,fused,want", [
    (64, (2, 64, 3, 3), "1", "1", 1),     # 128 % 64 == 0, 18 * 64 % 128 == 0
    (32, (1, 32, 2, 2), "1", "1", 1),
    (64, (1, 64, 1, 1), "1", "1", 0),     # M * C = 64: not a 128-row view
    (48, (2, 48, 4, 4), "1", "1", 0),     # 128 % 48 != 0
    (64, (2, 64, 3, 3), "0", "1", 0),     # the flag is opt-in
    (64, (2, 64, 3, 3), "1", "0", 0),     # LHN_FUSED_BN=0 wins
    (128, (2, 128, 3, 3), "0", "1", 1),
])
def test_batchnorm_small_channel_gate_follows_flag(C, shape, smallc, fused,
                                                   want, monkeypatch):
    """``LHN_FUSED_BN_SMALLC=1`` routes C < 128 sites with 128 % C == 0
    and M * C % 128 == 0 through ``moments``, as JAX's gate does
    (``fused_bn.py:152-172``); the statistics and output equal JAX's
    BatchNorm with the same flag."""
    calls = []
    real = T.moments
    monkeypatch.setattr(T, "moments", lambda x: calls.append(x.shape) or real(x))
    monkeypatch.setenv("LHN_FUSED_BN_SMALLC", smallc)
    monkeypatch.setenv("LHN_FUSED_BN", fused)
    assert T.moments_site(C, shape[0] * shape[2] * shape[3]) == bool(want)
    x = _x((shape[0], shape[2], shape[3], C), seed=4)
    _check_train(J.BatchNorm(), T.TorchBatchNorm(C), _bn_rules, x)
    assert len(calls) == want


def test_batchnorm_train_precomputed_route():
    """Statistics handed in by a fused producer: normalization and the EMA
    use them as given."""
    x = _x((2, 4, 4, 16), seed=1)
    rng = np.random.RandomState(2)
    mean = rng.normal(size=16).astype(np.float32)
    var = rng.uniform(0.5, 2.0, size=16).astype(np.float32)
    _check_train(J.BatchNorm(), T.TorchBatchNorm(16), _bn_rules, x,
                 port_kw=dict(precomputed=(torch.from_numpy(mean),
                                           torch.from_numpy(var))),
                 precomputed=(jnp.asarray(mean), jnp.asarray(var)))


@pytest.mark.parametrize("fused", ["1", "0"])
def test_batchnorm_train_one_value_per_channel(fused, monkeypatch):
    """The channel attention's BatchNorm at B = 1 sees one value per
    channel: variance 0, running var EMA of var * n / max(n - 1, 1) = 0,
    where ``F.batch_norm`` would raise."""
    monkeypatch.setenv("LHN_FUSED_BN", fused)
    _check_train(J.BatchNorm(), T.TorchBatchNorm(128), _bn_rules,
                 _x((1, 1, 1, 128), seed=3))


@pytest.mark.parametrize("act", [None, "leaky_relu"])
def test_repconv_train_parity(act):
    ja = {"leaky_relu": J.leaky_relu, None: None}[act]
    ta = {"leaky_relu": T.leaky_relu, None: None}[act]
    _check_train(J.RepConv(16, 3, 2, 1, act=ja), T.RepConv(8, 16, 3, 2, 1, act=ta),
                 repconv_rules, _x((2, 12, 12, 8), seed=4))


@pytest.mark.parametrize("fused_dw", ["0", "1"])
@pytest.mark.parametrize("dilation", [1, 2])
def test_repconv_depthwise_train_parity(dilation, fused_dw, monkeypatch):
    """The depthwise 3x3 RepConv of MSAB's DWConv. With ``LHN_FUSED_DW=1``
    the port runs ``dw_conv3x3_stats`` and hands its statistics to the BN;
    the JAX side (plain conv on the CPU) gives the same output and
    statistics."""
    monkeypatch.setenv("LHN_FUSED_DW", fused_dw)
    calls = []
    real = T.dw_conv3x3_stats
    monkeypatch.setattr(T, "dw_conv3x3_stats",
                        lambda x, w, d: calls.append(d) or real(x, w, d))
    C = 32
    _check_train(
        J.RepConv(C, 3, 1, dilation, dilation, groups=C, act=J.relu),
        T.RepConv(C, C, 3, 1, dilation, dilation, groups=C, act=T.relu),
        repconv_rules, _x((2, 10, 12, C), seed=5))
    assert calls == ([dilation] if fused_dw == "1" else [])


def test_repconv_fused_path_only_at_fusable_sites(monkeypatch):
    monkeypatch.setenv("LHN_FUSED_DW", "1")
    x = torch.randn(2, 8, 6, 6)
    fusable = T.RepConv(8, 8, 3, 1, 2, 2, groups=8).train()
    assert fusable._dw_fusable(x)
    for mod in (T.RepConv(8, 8, 3, 2, 1, groups=8),    # stride 2
                T.RepConv(8, 16, 3, 1, 1, groups=8),   # not depthwise
                T.RepConv(8, 8, 3, 1, 1, groups=1),    # dense
                T.RepConv(8, 8, 1, 1, 0, groups=8)):   # 1x1
        assert not mod._dw_fusable(x)
    monkeypatch.setenv("LHN_FUSED_BN", "0")
    assert not fusable._dw_fusable(x)
    monkeypatch.setenv("LHN_FUSED_BN", "1")
    monkeypatch.setenv("LHN_FUSED_DW", "0")
    assert not fusable._dw_fusable(x)


@pytest.mark.parametrize("cin,cout,k,s,g", [
    (3, 16, 3, 2, 1),   # stem c1: no identity branch
    (8, 8, 7, 1, 8),    # stem c2: depthwise 7x7 with identity branch
    (8, 8, 3, 1, 1),    # dense 3x3 with identity branch
])
def test_repblock_train_parity(cin, cout, k, s, g):
    _check_train(J.RepBlock(cout, k, s, k // 2, groups=g),
                 T.RepBlock(cin, cout, k, s, k // 2, groups=g),
                 repblock_rules, _x((2, 12, 12, cin), seed=6))


def _dropout_identity(port_mod, monkeypatch):
    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    T.set_dropout_generator(port_mod, None)
    for mod in port_mod.modules():
        if isinstance(mod, T.ChannelDropout):
            mod.p = 0.0
    return port_mod


@pytest.mark.parametrize("shape", [(2, 12, 12, 8), (2, 16, 16, 8),
                                   (1, 6, 6, 128)])
def test_channel_attention_train_parity(shape, monkeypatch):
    """Train-mode ChannelAttention with dropout at identity; (1, 6, 6, 128)
    puts its BatchNorm on a 1x1 map at B = 1 through ``moments``."""
    C = shape[-1]
    port = _dropout_identity(T.ChannelAttention(C), monkeypatch)
    _check_train(J.ChannelAttention(), port, attention_rules,
                 _x(shape, seed=7))


def test_channel_dropout_draws_whole_channels():
    """Each (b, c) is kept with probability 1 - p and scaled by 1/(1 - p),
    the same distribution as flax ``Dropout(rate=p, broadcast_dims=(1, 2))``
    on NHWC; draws come from the generator given; eval mode is identity."""
    drop = T.ChannelDropout(0.3).train()
    x = torch.ones(64, 256, 1, 1)
    drop.generator = torch.Generator().manual_seed(0)
    y = drop(x)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(kept.float().mean().item() - 0.7) < 0.01
    drop.generator = torch.Generator().manual_seed(0)
    assert torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)
    assert torch.equal(T.ChannelDropout(0.0).train()(x), x)


def test_set_dropout_generator_reaches_every_channel_dropout():
    model = torch.nn.Sequential(T.ChannelAttention(8), T.ChannelAttention(8))
    gen = torch.Generator()
    T.set_dropout_generator(model, gen)
    drops = [m for m in model.modules() if isinstance(m, T.ChannelDropout)]
    assert len(drops) == 2 and all(d.generator is gen for d in drops)
    T.set_dropout_generator(model, None)
    assert all(d.generator is None for d in drops)
