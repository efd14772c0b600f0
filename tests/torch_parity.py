"""Helpers for the port's parity tests: small configs, JAX variables with
non-trivial weights and BatchNorm statistics, and layout conversion.

Inputs and weights are made with numpy from a seed and handed to both the JAX
package and the port as numpy arrays.
"""

from __future__ import annotations

import contextlib
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.utils.weights import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread. The models here are tiny, and the
    test workers share the machine's cores: with a thread per core in each
    worker a 64x64 forward measured seconds instead of milliseconds.
    Imported by a test module, this applies to that module's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_model_cfg(ca_type="ca", reduction=4, features=32, size=64):
    """A LiteHandNet config dict at test size (the serve config's keys)."""
    return dict(
        MODEL=dict(
            name="litehandnet", num_stage=4, num_block=[2, 2, 2],
            input_channel=features, ca_type=ca_type, reduction=reduction,
            activation="leakyrelu", output_channel=21,
        ),
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=[size // 4, size // 4]),
        PIPELINE=dict(use_udp=False, kernel=(11, 11), unbiased_encoding=True),
    )


def family_cfg(name, features=32, size=64, num_block=(2, 2, 2), **model):
    """A config dict of model family ``name`` at test size; ``model`` adds
    ``cfg.MODEL`` keys (``ca_type``, ``msrb``, ...)."""
    return dict(
        MODEL=dict(name=name, num_stage=4, num_block=list(num_block),
                   input_channel=features, output_channel=21, **model),
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=[size // 4, size // 4]),
        PIPELINE=dict(use_udp=False, kernel=(11, 11), unbiased_encoding=True),
    )


def assert_served_config(name, family, exp_id, **overrides):
    """The port's config ``name`` equals the JAX template's experiment
    (``make_cfg(family, 'freihand', exp_id, 256, **overrides)``) in every
    field the port reads, and its full-width model counts the JAX model's
    parameters (shapes only: nothing is run)."""
    from litehandnet_tpu.config import config_from_dict as jax_cfg
    from litehandnet_tpu.config.templates import make_cfg
    from litehandnet_tpu.models import get_model as jax_get_model
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model

    want = make_cfg(family, "freihand", exp_id=exp_id, image_size=256,
                    **overrides)
    cfg = get_config(name)
    assert cfg.ID == exp_id and dict(cfg.MODEL) == want["MODEL"]
    for section in ("CHECKPOINT", "EVAL", "TRAIN", "OPTIMIZER", "LOSS"):
        assert dict(cfg[section]) == want[section], section
    for key in ("image_size", "heatmap_size", "num_joints", "name"):
        assert cfg.DATASET[key] == want["DATASET"][key], key
    for key, value in cfg.PIPELINE.items():
        assert want["PIPELINE"][key] == value, key
    jax_model = jax_get_model(jax_cfg(want))
    shapes = jax.eval_shape(
        lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 256, 256, 3), np.float32))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax


def apply_jax(module, variables, x_nhwc, train):
    """(output, batch statistics after the call) of a flax module as numpy;
    in eval mode the statistics are the given ones. Dropout must be made
    identity by the caller (flax and torch draw different bits)."""
    if not train:
        out = module.apply(variables, x_nhwc, train=False)
        return jax.tree_util.tree_map(np.asarray, out), variables.get(
            "batch_stats", {})
    out, new = module.apply(variables, x_nhwc, train=True,
                            mutable=["batch_stats"])
    return (jax.tree_util.tree_map(np.asarray, out),
            jax.tree_util.tree_map(np.asarray, new.get("batch_stats", {})))


# ``jax.numpy`` as the JAX model modules see it inside ``jax_float64``: their
# float32 casts (BatchNorm statistics, the heads' outputs) become float64
_JNP64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
_JNP64.float32 = jnp.float64


@contextlib.contextmanager
def jax_float64(monkeypatch, *modules):
    """Run the JAX side in float64 throughout: ``jax.enable_x64``, the
    float32 casts of ``modules`` (and of ``models.layers``) mapped to
    float64, and the plain BatchNorm statistics (the Pallas ``moments``
    path computes in float32 by design). Callers pass float64 inputs and
    variables."""
    from litehandnet_tpu.models import layers

    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (layers, *modules):
            mp.setattr(mod, "jnp", _JNP64)
        mp.setenv("LHN_FUSED_BN", "0")
        yield


def to_float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as identity on both sides: flax ``Dropout`` monkeypatched,
    and ``dropout_off(model)`` for the port's modules."""
    from flax import linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)

    def dropout_off(model):
        from litehandnet_tpu_torch.models.layers import Dropout

        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        return model

    return dropout_off


def assert_state_matches(model, variables, batch_stats, rules, rtol=1e-5):
    """The port model's BatchNorm running statistics equal ``batch_stats``
    (JAX's after the same call), loaded through ``rules``; ``variables``
    gives the params the loader also needs."""
    twin = copy.deepcopy(model)
    load_jax_variables(twin, {"params": variables["params"],
                              "batch_stats": batch_stats}, rules)
    want = twin.state_dict()
    n = 0
    for name, value in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            n += 1
            scale = float(want[name].abs().max())
            torch.testing.assert_close(value, want[name], rtol=rtol,
                                       atol=rtol * scale, msg=name)
    assert n > 0


def init_jax(module, x_nhwc, seed=0, **apply_kw):
    """numpy variables of a flax module for input ``x_nhwc``, drawn from a
    numpy seed: conv kernels N(0, 1/fan_in), every bias and running mean
    N(0, 0.1^2), BN scales and running variances U(0.5, 1.5), so that fusion
    and the weight mapping are exercised. Only the variables' shapes come
    from flax (``eval_shape``, no compile)."""
    shapes = jax.eval_shape(
        lambda x: module.init(jax.random.PRNGKey(0), x, **apply_kw), x_nhwc)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            out = rng.normal(0.0, fan_in ** -0.5, leaf.shape)
        elif name in ("bias", "mean"):
            out = rng.normal(0.0, 0.1, leaf.shape)
        elif name in ("scale", "var"):
            out = rng.uniform(0.5, 1.5, leaf.shape)
        else:
            raise KeyError(f"unexpected variable {name}")
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def load_layer(layer: torch.nn.Module, variables, rules_fn) -> torch.nn.Module:
    """Load a flax layer's variables into the port layer ``layer``, through
    rules built by ``rules_fn(torch_prefix, jax_prefix)``."""
    holder = torch.nn.Module()
    holder.add_module("m", layer)
    nested = {c: {"m": tree} for c, tree in variables.items()}
    load_jax_variables(holder, nested, rules_fn(r"m", r"m"))
    return layer.eval()


def assert_close_scaled(got, want, rtol, atol):
    """``assert_allclose`` with ``atol`` in units of the output's largest
    magnitude (at least 1). Random weights grow the activations to O(100)
    through the residual stack, and float32 summation-order error grows with
    them, so an absolute floor in raw units would fail only where an output
    crosses zero."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def to_nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return x_nchw.detach().permute(0, 2, 3, 1).numpy()
