"""Helpers for the port's parity tests: small configs, JAX variables with
non-trivial weights and BatchNorm statistics, and layout conversion.

Inputs and weights are made with numpy from a seed and handed to both the JAX
package and the port as numpy arrays.
"""

from __future__ import annotations

import jax
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
