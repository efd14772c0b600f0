"""Port's fused BatchNorm-statistics ops (``litehandnet_tpu_torch.ops.
fused_bn`` and the kernel wrappers ``kernels.moments`` and
``kernels.dw_conv3x3_stats``) against the JAX package's
``ops/fused_bn.py``: its plain references, its Pallas bodies in interpret
mode, and ``jax.grad`` through its custom VJPs. On the CPU the wrappers run
their plain versions; the CUDA kernels are held to the same plain versions
on the card by ``chip_smoke.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.ops import fused_bn as J
from litehandnet_tpu_torch.kernels import dw_conv3x3_stats as dw_wrapper
from litehandnet_tpu_torch.kernels import moments as moments_wrapper
from litehandnet_tpu_torch.kernels.dw_conv3x3_stats import (
    dw_conv3x3_stats_reference,
)
from litehandnet_tpu_torch.kernels.moments import moments_reference
from litehandnet_tpu_torch.ops import fused_bn as T
from tests.test_fused_bn import _interp_dw, _interp_moments
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import to_nchw, to_nhwc


def _nhwc(shape, seed, scale=1.0, shift=0.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(*shape) * scale + shift).astype(np.float32)


# mean: float32 sums in two orders, 1e-6 relative (atol 1e-6 of the data's
# magnitude for means near 0); var: 1e-5 relative (tests/test_fused_bn.py)
def _assert_moments(got, want, x):
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(got[0], np.asarray(want[0]), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(got[1], np.asarray(want[1]), rtol=1e-5)


@pytest.mark.parametrize("shape,shift", [
    ((2, 16, 16, 128), 0.0),    # a flagship C % 128 site
    ((2, 1, 1, 128), 0.0),      # the channel attention's 1x1 map
    ((3, 5, 7, 21), 0.0),       # ragged: C = 21, M = 105
    ((1, 4, 4, 1), 0.0),        # C = 1
    ((8, 8, 16, 128), 250.0),   # |mean| / std = 250
])
def test_moments_plain_matches_jax(shape, shift):
    x = _nhwc(shape, seed=1, shift=shift)
    mean, var = T.moments(to_nchw(x))
    got = (mean.numpy(), var.numpy())
    _assert_moments(got, J._moments_ref(jnp.asarray(x)), x)
    _assert_moments(got, J.moments(jnp.asarray(x)), x)


@pytest.mark.parametrize("shift", [0.0, 250.0])
def test_moments_plain_matches_pallas_body(shift):
    """The Pallas kernel's Chan-merged blocks (interpret mode) and the
    port's plain version agree; at |mean|/std = 250 both keep the float64
    two-pass to 1e-4 (tests/test_fused_bn.py:40-51)."""
    x = _nhwc((64 * 16, 128), seed=2, shift=shift)
    want = _interp_moments(jnp.asarray(x), block_rows=64)
    mean, var = T.moments(torch.from_numpy(x).view(64 * 16, 128, 1, 1))
    _assert_moments((mean.numpy(), var.numpy()), want, x)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(var.numpy(), x64.var(0), rtol=1e-4)


def test_moments_grad_matches_jax():
    """The analytic backward equals ``jax.grad`` through the JAX custom VJP
    (same closed form) and through the plain reference (autodiff)."""
    x = _nhwc((4, 8, 8, 128), seed=3, shift=2.0)
    a = np.random.RandomState(4).randn(128).astype(np.float32)
    b = np.random.RandomState(5).randn(128).astype(np.float32)

    def jax_loss(fn):
        def loss(x):
            m, v = fn(x)
            return jnp.sum(m * a) + jnp.sum(v * b)
        return loss

    xt = to_nchw(x).requires_grad_()
    m, v = T.moments(xt)
    (m * torch.from_numpy(a)).sum().add((v * torch.from_numpy(b)).sum()).backward()
    got = to_nhwc(xt.grad)
    for fn in (J.moments, J._moments_ref):
        want = np.asarray(jax.grad(jax_loss(fn))(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-6 * np.abs(want).max())


def _dw_weights(C, seed):
    """JAX ``[3, 3, C]`` taps and the port's OIHW ``[C, 1, 3, 3]``."""
    w = (np.random.RandomState(seed).randn(3, 3, C) * 0.3).astype(np.float32)
    return w, torch.from_numpy(np.ascontiguousarray(w.transpose(2, 0, 1)[:, None]))


@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("shape", [(2, 16, 16, 128), (2, 9, 13, 24)])
def test_dw_conv3x3_stats_plain_matches_jax(shape, dilation):
    """y, mean and var against the JAX reference (``_dw_ref`` + two-pass
    moments) and the Pallas body in interpret mode: y and mean within 1e-5,
    var within 1e-4 (tests/test_fused_bn.py:106-119)."""
    x = _nhwc(shape, seed=6)
    w, wt = _dw_weights(shape[-1], seed=7)
    y, mean, var = T.dw_conv3x3_stats(to_nchw(x), wt, dilation)
    y_ref = J._dw_ref(jnp.asarray(x), jnp.asarray(w), dilation)
    m_ref, v_ref = J._moments_ref(y_ref)
    wants = [(y_ref, m_ref, v_ref)]
    if shape[2] % 8 == 0:
        wants.append(_interp_dw(jnp.asarray(x), jnp.asarray(w), dilation))
    for wy, wm, wv in wants:
        np.testing.assert_allclose(to_nhwc(y), np.asarray(wy), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(mean.numpy(), np.asarray(wm), rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(var.numpy(), np.asarray(wv), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("dilation", [1, 2])
def test_dw_conv3x3_stats_grad_matches_jax(dilation):
    """Autograd over the plain conv + two-pass moments equals ``jax.grad``
    through the JAX custom VJP, for x and w (rtol 1e-5)."""
    x = _nhwc((2, 8, 8, 32), seed=8)
    w, wt = _dw_weights(32, seed=9)
    cy = np.random.RandomState(10).randn(2, 8, 8, 32).astype(np.float32)
    cm = np.random.RandomState(11).randn(32).astype(np.float32)
    cv = np.random.RandomState(12).randn(32).astype(np.float32)

    def loss(x, w):
        y, m, v = J.dw_conv3x3_stats(x, w, dilation)
        return jnp.sum(y * cy) + jnp.sum(m * cm) + jnp.sum(v * cv)

    gx, gw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    xt = to_nchw(x).requires_grad_()
    wt = wt.requires_grad_()
    y, m, v = T.dw_conv3x3_stats(xt, wt, dilation)
    total = ((y * to_nchw(cy)).sum() + (m * torch.from_numpy(cm)).sum()
             + (v * torch.from_numpy(cv)).sum())
    total.backward()
    np.testing.assert_allclose(to_nhwc(xt.grad), np.asarray(gx), rtol=1e-5,
                               atol=1e-5 * float(np.abs(gx).max()))
    got_w = wt.grad.numpy()[:, 0].transpose(1, 2, 0)
    np.testing.assert_allclose(got_w, np.asarray(gw), rtol=1e-5,
                               atol=1e-5 * float(np.abs(gw).max()))


def test_wrappers_use_plain_version_on_cpu():
    """A CPU tensor takes the plain version, counted as no launch."""
    x = to_nchw(_nhwc((2, 6, 5, 24), seed=13))
    _, wt = _dw_weights(24, seed=14)
    launches = (moments_wrapper.launches, dw_wrapper.launches)
    for got, want in zip(moments_wrapper(x), moments_reference(x)):
        assert torch.equal(got, want)
    for got, want in zip(dw_wrapper(x, wt, 2),
                         dw_conv3x3_stats_reference(x, wt, 2)):
        assert torch.equal(got, want)
    assert (moments_wrapper.launches, dw_wrapper.launches) == launches


def test_bfloat16_plain_versions_accumulate_in_float32():
    x = to_nchw(_nhwc((2, 4, 4, 8), seed=15, shift=3.0)).bfloat16()
    mean, var = moments_wrapper(x)
    assert mean.dtype == var.dtype == torch.float32
    want_mean, want_var = moments_reference(x.float())
    assert torch.equal(mean, want_mean) and torch.equal(var, want_var)
    _, wt = _dw_weights(8, seed=16)
    y, mean, var = dw_wrapper(x, wt, 1)
    y32, m32, v32 = dw_conv3x3_stats_reference(x.float(), wt, 1)
    assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
    assert torch.equal(mean, m32) and torch.equal(var, v32)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16, torch.int32])
def test_wrappers_raise_for_unsupported_dtype(dtype):
    x = torch.ones(2, 4, 3, 3, dtype=dtype)
    w = torch.ones(4, 1, 3, 3)
    with pytest.raises(TypeError):
        moments_wrapper(x)
    with pytest.raises(TypeError):
        dw_wrapper(x, w, 1)
    with pytest.raises((TypeError, ValueError)):
        T.moments(x)
    with pytest.raises(ValueError):
        T.dw_conv3x3_stats(x, w, 1)


def test_wrappers_raise_for_unsupported_shapes():
    x = torch.ones(2, 4, 3, 3)
    with pytest.raises(ValueError):
        moments_wrapper(x[0])                      # not 4-D
    with pytest.raises(ValueError):
        moments_wrapper(x[:0])                     # empty
    with pytest.raises(ValueError):
        dw_wrapper(x, torch.ones(4, 1, 5, 5), 1)   # not 3x3
    with pytest.raises(ValueError):
        dw_wrapper(x, torch.ones(4, 1, 3, 3), 0)   # dilation < 1
    with pytest.raises(ValueError):
        T.dw_conv3x3_stats(x, torch.ones(4, 1, 3, 3), 16)  # halo too wide


def test_dw_conv3x3_stats_supported_gate():
    assert T.dw_conv3x3_stats_supported((2, 64, 64, 64), torch.float32, 2)
    assert T.dw_conv3x3_stats_supported((1, 24, 17, 23), torch.bfloat16, 1)
    assert not T.dw_conv3x3_stats_supported((2, 64, 64), torch.float32, 1)
    assert not T.dw_conv3x3_stats_supported((2, 8, 8, 8), torch.float64, 1)
    assert not T.dw_conv3x3_stats_supported((2, 8, 8, 8), torch.float32, 0)
    assert T.dw_conv3x3_stats_supported((2, 8, 8, 8), torch.float32, 15)
    assert not T.dw_conv3x3_stats_supported((2, 8, 8, 8), torch.float32, 16)
