"""The port's target encoders (``udp_heatmaps``, ``simdr_targets``,
``region_map``, and ``msra_heatmaps`` biased and unbiased) against
``litehandnet_tpu.ops.encode``, batched over B, within 1e-6 absolute."""

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.ops import encode as JE
from litehandnet_tpu_torch.ops import encode as TE
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ATOL = 1e-6


def _joints(B=3, K=21, size=(96, 128), seed=0):
    rng = np.random.RandomState(seed)
    joints = np.stack([rng.uniform(-12, size[0] + 12, size=(B, K)),
                       rng.uniform(-12, size[1] + 12, size=(B, K))],
                      -1).astype(np.float32)
    vis = (rng.rand(B, K) > 0.15).astype(np.float32)
    return joints, vis


def _hwk_to_khw(a):
    return np.moveaxis(np.asarray(a), -1, -3)


@pytest.mark.parametrize("unbiased", [False, True])
@pytest.mark.parametrize("sigma", [2.0, 3.0])
def test_msra_heatmaps(unbiased, sigma):
    joints, vis = _joints()
    jw = np.linspace(0.5, 1.5, 21).astype(np.float32)
    t, w = TE.msra_heatmaps(torch.from_numpy(joints), torch.from_numpy(vis),
                            (96, 128), (24, 32), sigma, unbiased=unbiased,
                            joint_weights=torch.from_numpy(jw))
    fn = jax.vmap(lambda j, v: JE.msra_heatmaps(
        j, v, (96, 128), (24, 32), sigma, unbiased=unbiased, joint_weights=jw))
    jt, jw_ = fn(joints, vis)
    np.testing.assert_allclose(t.numpy(), _hwk_to_khw(jt), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw_))


@pytest.mark.parametrize("sigma", [2.0, 3.0])
def test_udp_heatmaps(sigma):
    joints, vis = _joints(seed=1)
    jw = np.linspace(0.5, 1.5, 21).astype(np.float32)
    t, w = TE.udp_heatmaps(torch.from_numpy(joints), torch.from_numpy(vis),
                           (96, 128), (24, 32), sigma,
                           joint_weights=torch.from_numpy(jw))
    jt, jw_ = jax.vmap(lambda j, v: JE.udp_heatmaps(
        j, v, (96, 128), (24, 32), sigma, joint_weights=jw))(joints, vis)
    np.testing.assert_allclose(t.numpy(), _hwk_to_khw(jt), rtol=0, atol=ATOL)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw_))


@pytest.mark.parametrize("k", [1, 2])
def test_simdr_targets(k):
    joints, vis = _joints(seed=2)
    tx, ty = TE.simdr_targets(torch.from_numpy(joints), torch.from_numpy(vis),
                              (96, 128), k, 2.0)
    jx, jy = jax.vmap(lambda j, v: JE.simdr_targets(
        j, v, (96, 128), k, 2.0))(joints, vis)
    assert tx.shape == (3, 21, 96 * k) and ty.shape == (3, 21, 128 * k)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=0, atol=ATOL)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0, atol=ATOL)


@pytest.mark.parametrize("encoding", ["MSRA", "UDP"])
@pytest.mark.parametrize("patch", ["gen1", "srhandnet"])
def test_region_map(patch, encoding):
    rng = np.random.RandomState(3)
    xy = rng.uniform(-10, 80, size=(5, 2))
    wh = rng.uniform(4, 120, size=(5, 2))
    bbox = np.concatenate([xy, wh], -1).astype(np.float32)
    got = TE.region_map(torch.from_numpy(bbox), (96, 128), (24, 32), 2.0,
                        encoding=encoding, patch=patch)
    want = jax.vmap(lambda b: JE.region_map(
        b, (96, 128), (24, 32), 2.0, encoding=encoding, patch=patch))(bbox)
    assert got.shape == (5, 3, 32, 24)
    np.testing.assert_allclose(got.numpy(), _hwk_to_khw(want), rtol=0,
                               atol=ATOL)
