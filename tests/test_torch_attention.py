"""The port's attention library (``models/attention.py``) against the JAX
package's, module by module, in eval mode and in train mode (batch
statistics and the running statistics after one call; dropout identity on
both sides), plus rank-2 BatchNorm, element-wise dropout and adaptive average
pooling at the families' shapes. float32 on the CPU, 16x16 maps, B = 2.
Tolerances: outputs rtol 1e-5, atol 1e-5 of the output's largest magnitude;
running statistics rtol 1e-5; gradients rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.models import attention as JA
from litehandnet_tpu.models.layers import TorchBatchNorm as JaxTorchBatchNorm
from litehandnet_tpu.models.layers import adaptive_avg_pool as jax_adaptive_pool
from litehandnet_tpu_torch.models import attention as A
from litehandnet_tpu_torch.models.layers import (
    Dropout,
    TorchBatchNorm,
    adaptive_avg_pool,
    set_dropout_generator,
)
from litehandnet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    no_dropout,  # noqa: F401  (fixture)
    apply_jax,
    assert_close_scaled,
    assert_state_matches,
    init_jax,
    load_layer,
    to_nchw,
    to_nhwc,
)

C = 32


def _x(seed, shape=(2, 16, 16, C)):
    rng = np.random.RandomState(seed)
    # per-sample scale and shift: batch statistics over B = 2 well apart
    per_sample = (shape[0],) + (1,) * (len(shape) - 1)
    x = rng.normal(size=shape) * rng.uniform(0.5, 2.0, per_sample)
    return (x + rng.uniform(-1, 1, per_sample)).astype(np.float32)


def _stacks(n=2):
    return [_x(10 + i) for i in range(n)]


def _stage_rules(tp, fp):
    return [(tp + r"\.ln\.(\d+)", "ln", fp + r"/ln\1"),
            (tp + r"\.fc1\.(\d+)", "linear", fp + r"/fc1_\1"),
            (tp + r"\.fc2\.(\d+)", "linear", fp + r"/fc2_\1")]


def _fc_rules(tp, fp):
    return [(tp + r"\.ln", "ln", fp + r"/ln"), (tp + r"\.fc", "linear", fp + r"/fc")]


def _se_rules(tp, fp):
    return [(tp + r"\.fc\.0", "linear", fp + r"/fc1"),
            (tp + r"\.fc\.2", "linear", fp + r"/fc2")]


def _rca_rules(tp, fp):
    return [(tp + r"\.sharedMLP\.0", "conv", fp + r"/mlp1/conv"),
            (tp + r"\.sharedMLP\.2", "conv", fp + r"/mlp2/conv")]


def _rsa_rules(tp, fp):
    return [(tp + r"\.conv", "conv", fp + r"/conv/conv")]


def _cbam_rules(tp, fp):
    """The reference torch names (``torch_import.py:735-743``)."""
    return ([(tp + r"\.pre\.0", "conv", fp + r"/c1/conv"),
             (tp + r"\.pre\.1", "bn", fp + r"/bn1/bn"),
             (tp + r"\.pre\.3", "conv", fp + r"/c2/conv"),
             (tp + r"\.pre\.4", "bn", fp + r"/bn2/bn"),
             (tp + r"\.residual_conv", "conv", fp + r"/res/conv")]
            + _rca_rules(tp + r"\.ca", fp + r"/ca")
            + _rsa_rules(tp + r"\.sa", fp + r"/sa"))


def _sk_rules(tp, fp):
    return [(tp + r"\.convs\.(\d+)\.0", "conv", fp + r"/conv\1/conv"),
            (tp + r"\.convs\.(\d+)\.1", "bn", fp + r"/bn\1/bn"),
            (tp + r"\.fc", "linear", fp + r"/fc"),
            (tp + r"\.fcs\.(\d+)", "linear", fp + r"/fcs\1")]


def _bam_rules(tp, fp):
    return [(tp + r"\.c_fc0", "linear", fp + r"/c_fc0"),
            (tp + r"\.c_bn0", "bn", fp + r"/c_bn0"),
            (tp + r"\.c_fc_final", "linear", fp + r"/c_fc_final"),
            (tp + r"\.s_reduce", "conv", fp + r"/s_reduce/conv"),
            (tp + r"\.s_bn0", "bn", fp + r"/s_bn0/bn"),
            (tp + r"\.s_di(\d)", "conv", fp + r"/s_di\1/conv"),
            (tp + r"\.s_di(\d)_bn", "bn", fp + r"/s_di\1_bn/bn"),
            (tp + r"\.s_final", "conv", fp + r"/s_final/conv")]


def _nam_rules(tp, fp):
    return [(tp + r"\.bn", "bn", fp + r"/bn")]


# (id, flax module, port module, rules, input maker, has BatchNorm)
CASES = {
    "stage": (lambda: JA.StageChannelAttention(C, reduction=4, n_block=2),
              lambda: A.StageChannelAttention(C, reduction=4, n_block=2),
              _stage_rules, _stacks, False),
    "stage3_min_unit": (
        lambda: JA.StageChannelAttention(C, reduction=8, n_block=3),
        lambda: A.StageChannelAttention(C, reduction=8, n_block=3),
        _stage_rules, lambda: _stacks(3), False),
    "stage_all": (lambda: JA.StageChannelAttentionAll(C, n_block=2),
                  lambda: A.StageChannelAttentionAll(C, n_block=2),
                  _stage_rules, _stacks, False),
    "stage_fc": (lambda: JA.StageChannelAttentionFC(C, n_block=2),
                 lambda: A.StageChannelAttentionFC(C, n_block=2),
                 _fc_rules, _stacks, False),
    "se": (lambda: JA.SELayer(16), lambda: A.SELayer(C, 16), _se_rules,
           lambda: _x(1), False),
    "region_channel": (lambda: JA.RegionChannelAttention(8),
                       lambda: A.RegionChannelAttention(C, 8), _rca_rules,
                       lambda: _x(2), False),
    "region_spatial": (lambda: JA.RegionSpatialAttention(7),
                       lambda: A.RegionSpatialAttention(7), _rsa_rules,
                       lambda: _x(3), False),
    "cbam": (lambda: JA.CBAM(C), lambda: A.CBAM(C, C), _cbam_rules,
             lambda: _x(4), True),
    "cbam_widen": (lambda: JA.CBAM(48), lambda: A.CBAM(C, 48), _cbam_rules,
                   lambda: _x(5), True),
    "sk": (lambda: JA.SKConv(C, n_scale=3, min_unit=8),
           lambda: A.SKConv(C, n_scale=3, min_unit=8), _sk_rules,
           lambda: _x(6), True),
    "sk_grouped": (lambda: JA.SKConv(C, groups=4, n_scale=2, min_unit=8),
                   lambda: A.SKConv(C, groups=4, n_scale=2, min_unit=8),
                   _sk_rules, lambda: _x(7), True),
    "bam": (lambda: JA.BAM(16, 4), lambda: A.BAM(C, 16, 4), _bam_rules,
            lambda: _x(8), True),
    "nam": (lambda: JA.NAMChannelAtt(), lambda: A.NAMChannelAtt(C),
            _nam_rules, lambda: _x(9), True),
}


def _port_input(x):
    return [to_nchw(v) for v in x] if isinstance(x, list) else to_nchw(x)


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_module_matches_flax(case, mode, no_dropout):
    make_jax, make_port, rules, make_x, has_bn = CASES[case]
    x = make_x()
    jax_mod = make_jax()
    variables = init_jax(jax_mod, x, train=False)
    want, stats = apply_jax(jax_mod, variables, x, mode == "train")
    port = no_dropout(load_layer(make_port(), variables, rules))
    port.train(mode == "train")
    with torch.no_grad():
        got = to_nhwc(port(_port_input(x)))
    assert got.shape == want.shape
    assert_close_scaled(got, want, 1e-5, 1e-5)
    if mode == "train" and has_bn:
        holder = torch.nn.Module()
        holder.add_module("m", port)
        assert_state_matches(
            holder, {"params": {"m": variables["params"]}}, {"m": stats},
            rules(r"m", r"m"))


def test_nam_gamma_gets_gradient_only_through_normalization():
    """``bn.weight.detach()`` in the gate, as JAX's ``stop_gradient``: the
    gradients of every parameter and of the input equal ``jax.grad``'s."""
    x = _x(9)
    w = np.random.RandomState(11).normal(size=x.shape).astype(np.float32)
    jax_mod = JA.NAMChannelAtt()
    variables = init_jax(jax_mod, x, train=False)

    def loss(params, x):
        out, _ = jax_mod.apply({"params": params,
                                "batch_stats": variables["batch_stats"]},
                               x, train=True, mutable=["batch_stats"])
        return jnp.sum(out * w)

    gp, gx = jax.grad(loss, argnums=(0, 1))(variables["params"], x)
    port = load_layer(A.NAMChannelAtt(C), variables, _nam_rules).train()
    xt = to_nchw(x).requires_grad_(True)
    (port(xt) * to_nchw(w)).sum().backward()
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(gx), rtol=1e-4,
                               atol=1e-4 * float(np.abs(gx).max()))
    for name, leaf in (("weight", "scale"), ("bias", "bias")):
        want = np.asarray(gp["bn"][leaf])
        np.testing.assert_allclose(getattr(port.bn, name).grad.numpy(), want,
                                   rtol=1e-4, atol=1e-4 * np.abs(want).max())


@pytest.mark.parametrize("channels", [24, 128], ids=["c24", "c128-moments"])
@pytest.mark.parametrize("mode", ["eval", "train"])
def test_rank2_batchnorm_matches_jax(channels, mode):
    """``TorchBatchNorm`` on ``[B, C]`` (BatchNorm1d; BAM's channel gate)
    against JAX ``TorchBatchNorm`` (momentum 0.9 in flax, 0.1 in torch); at
    C = 128 the statistics go through ``moments``' path."""
    x = _x(20, (6, channels))
    jax_bn = JaxTorchBatchNorm(use_running_average=mode == "eval")
    variables = init_jax(jax_bn, x)
    if mode == "eval":
        want, stats = np.asarray(jax_bn.apply(variables, x)), None
    else:
        out, new = jax_bn.apply(variables, x, mutable=["batch_stats"])
        want, stats = np.asarray(out), new["batch_stats"]
    holder = torch.nn.Module()
    holder.add_module("m", TorchBatchNorm(channels))
    rules = [(r"m", "bn", r"m")]
    load_jax_variables(holder, {c: {"m": v} for c, v in variables.items()},
                       rules)
    holder.train(mode == "train")
    with torch.no_grad():
        got = holder.m(torch.from_numpy(x))
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    if stats is not None:
        assert_state_matches(holder, {"params": {"m": variables["params"]}},
                             {"m": stats}, rules)


def test_dropout_is_elementwise_and_seeded():
    drop = Dropout(0.3).train()
    holder = torch.nn.Sequential(drop)
    set_dropout_generator(holder, torch.Generator().manual_seed(5))
    x = torch.ones(64, 256)
    y = drop(x)
    kept = y != 0
    assert abs(float(kept.float().mean()) - 0.7) < 0.02
    torch.testing.assert_close(y[kept], torch.full_like(y[kept], 1 / 0.7))
    # element-wise: rows and columns are neither all kept nor all dropped
    assert kept.any(1).all() and (~kept).any(1).all()
    assert kept.any(0).all() and (~kept).any(0).all()
    set_dropout_generator(holder, torch.Generator().manual_seed(5))
    assert torch.equal(drop(x), y)
    assert torch.equal(drop.eval()(x), x)


@pytest.mark.parametrize("size,out", [
    (64, 3), (32, 3), (16, 3), (8, 3), (4, 3), (2, 3), (17, 3),   # gates
    (64, 8), (64, 4), (16, 2), (23, 5),                           # shortcut
])
def test_adaptive_avg_pool_matches_jax_region_rule(size, out):
    """``F.adaptive_avg_pool2d`` gives JAX's regions ``[floor(i S / O),
    ceil((i + 1) S / O))`` at the gates' (3, 3) pools of the families' maps
    and at the hourglass shortcut's pools."""
    x = _x(30, (2, size, size + 1, 8))
    want = np.asarray(jax_adaptive_pool(x, (out, out + 1)))
    got = to_nhwc(adaptive_avg_pool(to_nchw(x), (out, out + 1)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
