"""The YOLOv5-style block library (``models/rep_blocks.py``): each block of
JAX ``tests/test_rep_blocks.py:95-108`` against JAX's on the same weights at
16x16, B = 2, in eval mode (float32, rtol 1e-4, atol 1e-5 of the output's
largest magnitude) and train mode (float64, rtol 1e-9, with the running
statistics); ``fuse_conv_bn`` against the train graph and against JAX's
``fuse_conv_bn`` + deploy apply; the two decided deviations from JAX's
walk: a sibling of a fused conv/bn pair is kept, and a BatchNorm without
its running statistics raises a ``ValueError`` that names the module."""

import copy

import jax
import numpy as np
import pytest
import torch
from torch import nn

from litehandnet_tpu.models import rep_blocks as jrb
from litehandnet_tpu_torch.models import rep_blocks as trb
from litehandnet_tpu_torch.utils.weights import load_jax_variables
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_close_scaled,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    to_nhwc,
)


def _path(m):
    return "m" + m.group(1).replace(".", "/")


# every conv / bn of the library keeps its module path: ``a.b.conv`` is
# JAX's ``a/b/conv``
RULES = [
    (r"m((?:\.\w+)*?)\.conv", "conv", lambda m: _path(m) + "/conv"),
    (r"m((?:\.\w+)*?)\.bn", "bn", lambda m: _path(m) + "/bn"),
]

CASES = {
    "conv": (lambda: jrb.ConvBnAct(16, 3, 2),
             lambda: trb.ConvBnAct(8, 16, 3, 2), 8),
    "conv_1x1_noact": (lambda: jrb.ConvBnAct(12, 1, act=False),
                       lambda: trb.ConvBnAct(8, 12, 1, act=False), 8),
    "dwconv": (lambda: jrb.dw_conv(8, 16, k=3, s=1),
               lambda: trb.dw_conv(8, 16, k=3, s=1), 8),
    "bottleneck": (lambda: jrb.Bottleneck(16, shortcut=True, groups=2),
                   lambda: trb.Bottleneck(16, 16, shortcut=True, groups=2),
                   16),
    "crossconv": (lambda: jrb.CrossConv(16, kernel=3, stride=2),
                  lambda: trb.CrossConv(8, 16, kernel=3, stride=2), 8),
    "focus": (lambda: jrb.Focus(16, 3), lambda: trb.Focus(3, 16, 3), 3),
}


def _holder(layer):
    holder = nn.Module()
    holder.add_module("m", layer)
    return holder


def _setup(name, deploy=False):
    jax_fn, port_fn, cin = CASES[name]
    x = np.random.RandomState(7).normal(size=(2, 16, 16, cin)).astype(
        np.float32)
    jax_layer = jax_fn()
    variables = init_jax(jax_layer, x, seed=3, train=False)
    holder = _holder(port_fn())
    load_jax_variables(holder, {c: {"m": t} for c, t in variables.items()},
                       RULES)
    return jax_layer, variables, holder, x


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_block_matches_jax(name, mode, monkeypatch):
    jax_layer, variables, holder, x = _setup(name)
    if mode == "eval":
        want = np.asarray(jax_layer.apply(variables, x, train=False))
        with torch.no_grad():
            got = holder.m.eval()(to_nchw(x))
        assert_close_scaled(to_nhwc(got), want, 1e-4, 1e-5)
        return
    with jax_float64(monkeypatch, jrb):
        want, new = jax_layer.apply(to_float64(variables),
                                    x.astype(np.float64), train=True,
                                    mutable=["batch_stats"])
        want = np.asarray(want)
        stats = jax.tree_util.tree_map(np.asarray, new["batch_stats"])
    monkeypatch.setenv("LHN_FUSED_BN", "0")
    holder = holder.double().train()
    with torch.no_grad():
        got = holder.m(to_nchw(x).double())
    assert_close_scaled(to_nhwc(got), want, 1e-9, 1e-10)
    twin = copy.deepcopy(holder)
    load_jax_variables(twin, {"params": {"m": variables["params"]},
                              "batch_stats": {"m": stats}}, RULES)
    want_sd = twin.state_dict()
    for key, value in holder.state_dict().items():
        if key.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(value, want_sd[key], rtol=1e-9,
                                       atol=1e-12, msg=key)


@pytest.mark.parametrize("name", ["conv", "bottleneck", "focus"])
def test_fuse_conv_bn_matches_train_graph_and_jax(name):
    """The fused state dict loads strictly into the ``deploy=True`` graph,
    which equals the train graph in eval mode and JAX's deploy apply on
    JAX's ``fuse_conv_bn``."""
    jax_layer, variables, holder, x = _setup(name)
    deploy = {"conv": lambda: trb.ConvBnAct(8, 16, 3, 2, deploy=True),
              "bottleneck": lambda: trb.Bottleneck(16, 16, True, 2,
                                                   deploy=True),
              "focus": lambda: trb.Focus(3, 16, 3, deploy=True)}[name]()
    deploy.load_state_dict(trb.fuse_conv_bn(holder.m))
    with torch.no_grad():
        want = holder.m.eval()(to_nchw(x))
        got = deploy.eval()(to_nchw(x))
    assert_close_scaled(got.numpy(), want.numpy(), 1e-5, 1e-5)
    jax_deploy = {"conv": lambda: jrb.ConvBnAct(16, 3, 2, deploy=True),
                  "bottleneck": lambda: jrb.Bottleneck(16, True, 2,
                                                       deploy=True),
                  "focus": lambda: jrb.Focus(16, 3, deploy=True)}[name]()
    jax_out = np.asarray(jax_deploy.apply(jrb.fuse_conv_bn(variables), x))
    assert_close_scaled(to_nhwc(got), jax_out, 1e-5, 1e-5)


class _WithSibling(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv = nn.Conv2d(4, 4, 3, padding=1, bias=False)
        self.bn = nn.BatchNorm2d(4)
        self.scale = nn.Parameter(torch.full((4,), 2.0))


def test_fuse_conv_bn_keeps_siblings():
    """Decided deviation: a sibling of the fused pair (``scale``) stays in
    the fused state dict; JAX's walk returns only the fused ``conv`` at that
    level (ADVICE.md, ``rep_blocks.py:186-188``)."""
    fused = trb.fuse_conv_bn(_WithSibling())
    assert set(fused) == {"conv.weight", "conv.bias", "scale"}
    assert torch.equal(fused["scale"], torch.full((4,), 2.0))
    jax_vars = {"params": {"conv": {"kernel": np.ones((3, 3, 4, 4))},
                           "bn": {"scale": np.ones(4), "bias": np.zeros(4)},
                           "scale": np.full(4, 2.0)},
                "batch_stats": {"bn": {"mean": np.zeros(4),
                                       "var": np.ones(4)}}}
    assert set(jrb.fuse_conv_bn(jax_vars)["params"]) == {"conv"}


def test_fuse_conv_bn_without_statistics_names_the_module():
    """Decided deviation: a BatchNorm without running statistics raises a
    ``ValueError`` naming its module; JAX's walk raises a bare
    ``KeyError('bn')``."""
    sd = trb.Bottleneck(8, 8).state_dict()
    del sd["cv2.bn.running_var"]
    with pytest.raises(ValueError, match=r"cv2 has no BatchNorm running_var"):
        trb.fuse_conv_bn(sd)
    variables = init_jax(jrb.Bottleneck(8), np.zeros((1, 8, 8, 8),
                                                      np.float32),
                         train=False)
    del variables["batch_stats"]["cv2"]
    with pytest.raises(KeyError):
        jrb.fuse_conv_bn(variables)


def test_autopad_and_focus_order():
    assert trb.autopad(3) == jrb.autopad(3) == 1
    assert trb.autopad((1, 5)) == jrb.autopad((1, 5)) == (0, 2)
    assert trb.autopad(3, 0) == 0
    x = torch.arange(2 * 3 * 4 * 4, dtype=torch.float32).reshape(2, 3, 4, 4)
    focus = trb.Focus(3, 12, act=False)
    seen = []
    focus.conv.register_forward_pre_hook(lambda m, a: seen.append(a[0]))
    focus.eval()(x)
    want = torch.cat([x[..., ::2, ::2], x[..., 1::2, ::2], x[..., ::2, 1::2],
                      x[..., 1::2, 1::2]], 1)
    assert torch.equal(seen[0], want)
