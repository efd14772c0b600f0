"""The port's SoftPool (``kernels.softpool_2x2`` and the differentiable
``models.attention.soft_pool``) against the JAX package's ``soft_pool`` (XLA)
and its Pallas kernel ``softpool_2x2`` in interpret mode, on the CPU, where
the wrapper runs its plain version. Float32; tolerances rtol = atol = 1e-5,
as ``tests/test_pallas.py`` holds the Pallas kernel to ``soft_pool``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.models.attention import soft_pool as jax_soft_pool
from litehandnet_tpu.ops.pallas_kernels import softpool_2x2 as pallas_softpool
from litehandnet_tpu_torch.kernels import KERNELS
from litehandnet_tpu_torch.kernels.softpool_2x2 import (
    softpool_2x2,
    softpool_2x2_reference,
)
from litehandnet_tpu_torch.models.attention import SoftPooling, soft_pool
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import to_nchw, to_nhwc

TOL = dict(rtol=1e-5, atol=1e-5)


def _x(shape, seed=0, scale=2.0):
    return (np.random.RandomState(seed).normal(size=shape) * scale).astype(
        np.float32)


def test_plain_version_matches_jax_and_pallas_kernel():
    x = _x((2, 16, 16, 32))
    want = np.asarray(jax_soft_pool(x, 2, 2))
    np.testing.assert_allclose(np.asarray(pallas_softpool(x, interpret=True)),
                               want, **TOL)
    nchw = to_nchw(x)
    for inp in (nchw, nchw.contiguous(memory_format=torch.channels_last)):
        got = softpool_2x2(inp)
        assert got.shape == (2, 32, 8, 8) and got.dtype == torch.float32
        np.testing.assert_allclose(to_nhwc(got), want, **TOL)
    np.testing.assert_allclose(to_nhwc(soft_pool(nchw)), want, **TOL)
    np.testing.assert_allclose(to_nhwc(SoftPooling()(nchw)), want, **TOL)


@pytest.mark.parametrize("kernel,stride,H,W", [
    (3, 2, 17, 23),     # odd sizes floor
    (2, 1, 9, 8),       # overlapping windows
    (3, 3, 10, 11),
    (1, 1, 5, 6),
    (2, 2, 7, 9),
])
def test_general_window_matches_jax(kernel, stride, H, W):
    x = _x((3, H, W, 21), seed=kernel * 10 + stride)
    want = np.asarray(jax_soft_pool(x, kernel, stride))
    got = to_nhwc(softpool_2x2(to_nchw(x), kernel, stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


def test_window_larger_than_map_is_empty_as_in_jax():
    x = _x((1, 3, 5, 4))
    want = np.asarray(jax_soft_pool(x, 4, 2))
    got = softpool_2x2(to_nchw(x), 4, 2)
    assert to_nhwc(got).shape == want.shape == (1, 0, 1, 4)


def test_unshifted_exp_gives_jax_nan_pattern():
    """exp overflows above ~88.7: inf * x / inf is NaN; a window whose values
    all lie below ~-104 underflows to 0 / 0. No max shift hides either."""
    x = _x((1, 8, 8, 4), seed=3)
    x[0, 0, 1, 0] = 89.5                  # one overflowing value
    x[0, 2:4, 2:4, 1] = -120.0            # a whole window underflows
    x[0, 4, 4, 2] = 88.0                  # large but finite
    want = np.asarray(jax_soft_pool(x, 2, 2))
    got = to_nhwc(softpool_2x2(to_nchw(x)))
    assert np.isnan(want[0, 0, 0, 0]) and np.isnan(want[0, 1, 1, 1])
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    np.testing.assert_allclose(got[finite], want[finite], **TOL)


@pytest.mark.parametrize("kernel,stride", [(2, 2), (3, 2)])
def test_gradient_matches_jax_grad(kernel, stride):
    x = _x((2, 9, 10, 8), seed=5)
    w = _x((2, (9 - kernel) // stride + 1, (10 - kernel) // stride + 1, 8),
           seed=6)
    want = np.asarray(jax.grad(
        lambda v: jnp.sum(jax_soft_pool(v, kernel, stride) * w))(x))
    xt = to_nchw(x).requires_grad_(True)
    (soft_pool(xt, kernel, stride) * to_nchw(w)).sum().backward()
    np.testing.assert_allclose(to_nhwc(xt.grad), want, **TOL)


def test_bfloat16_sums_in_float32_and_rounds_once():
    """The port's bfloat16 result is the float32 result rounded once (the
    TPU kernel and JAX compute in bfloat16 throughout: a decided
    deviation)."""
    x = to_nchw(_x((2, 8, 8, 16), seed=7)).to(torch.bfloat16)
    got = softpool_2x2(x)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, softpool_2x2(x.float()).to(torch.bfloat16))
    assert torch.equal(got, softpool_2x2_reference(x))


def test_bfloat16_deviation_from_jax_is_jax_rounding():
    """A decided deviation: on bfloat16 input JAX's ``soft_pool`` and the
    Pallas kernel compute exp, products and sums in bfloat16 and land many
    bfloat16 ulps from the float32 result; the port rounds the float32
    result once, so it stays within half an ulp of it."""
    x = (np.random.RandomState(8).normal(size=(2, 32, 32, 32)) * 3.0)
    xb = jnp.asarray(x, jnp.bfloat16)
    x32 = np.asarray(xb.astype(jnp.float32))          # the bf16 values, exact
    exact = np.asarray(jax_soft_pool(x32, 2, 2))
    ulp = np.abs(exact) * 2.0 ** -7
    slack = 1e-6 * np.abs(x32).max()                  # float32 cancellation
    port = to_nhwc(softpool_2x2(to_nchw(x32).to(torch.bfloat16)).float())
    assert (np.abs(port - exact) <= 0.5 * ulp + slack).all()
    for jax_bf16 in (jax_soft_pool(xb, 2, 2), pallas_softpool(xb, interpret=True)):
        err = np.abs(np.asarray(jax_bf16.astype(jnp.float32)) - exact)
        assert (err > ulp + slack).mean() > 0.01


def test_cpu_launches_no_kernel_and_bad_inputs_raise():
    before = {name: k.launches for name, k in KERNELS.items()}
    x = to_nchw(_x((1, 4, 4, 3))).requires_grad_(True)
    soft_pool(x).sum().backward()
    assert {name: k.launches for name, k in KERNELS.items()} == before
    for dtype in (torch.float64, torch.float16, torch.int32):
        with pytest.raises(TypeError):
            softpool_2x2(torch.zeros(1, 3, 4, 4, dtype=dtype))
    with pytest.raises(TypeError):
        softpool_2x2(torch.zeros(1, 3, 4, 4, device="meta"))
    with pytest.raises(ValueError):
        softpool_2x2(torch.zeros(3, 4, 4))
    with pytest.raises(ValueError):
        softpool_2x2(torch.zeros(1, 3, 4, 4), kernel=0)
