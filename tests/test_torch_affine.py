"""The port's ``ops/affine.py`` against ``litehandnet_tpu.ops.affine`` on the
same numpy inputs, batched, on the CPU (matrices within 1e-5 relative)."""

import numpy as np
import pytest
import torch

from litehandnet_tpu.ops import affine as JA
from litehandnet_tpu_torch.ops import affine as TA
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)


def _boxes(B, rot, seed=0):
    rng = np.random.RandomState(seed)
    center = rng.uniform(60, 200, size=(B, 2)).astype(np.float32)
    scale = rng.uniform(0.4, 1.6, size=(B, 2)).astype(np.float32)
    rots = np.full(B, rot, np.float32)
    rots[::2] += rng.uniform(-3, 3, size=rots[::2].shape).astype(np.float32)
    return center, scale, rots


def _close(got, want, rtol=1e-5):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()))


@pytest.mark.parametrize("inv", [False, True])
@pytest.mark.parametrize("rot", [0.0, 30.0, -75.0])
def test_get_affine_transform(rot, inv):
    center, scale, rots = _boxes(6, rot)
    shift = (0.05, -0.1)
    got = TA.get_affine_transform(torch.from_numpy(center),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(rots), (192, 256),
                                  shift=shift, inv=inv)
    _close(got, JA.get_affine_transform(center, scale, rots, (192, 256),
                                        shift=shift, inv=inv))


@pytest.mark.parametrize("rot", [0.0, 30.0, -75.0])
def test_get_warp_matrix(rot):
    center, scale, rots = _boxes(6, rot, seed=1)
    got = TA.get_warp_matrix(torch.from_numpy(rots),
                             torch.from_numpy(center * 2.0), (255.0, 191.0),
                             torch.from_numpy(scale * 200.0))
    _close(got, JA.get_warp_matrix(rots, center * 2.0, (255.0, 191.0),
                                   scale * 200.0))


def test_rotate_and_third_point():
    rng = np.random.RandomState(2)
    a = rng.randn(5, 2).astype(np.float32)
    b = rng.randn(5, 2).astype(np.float32)
    ang = rng.uniform(-3, 3, size=5).astype(np.float32)
    _close(TA._rotate_point(torch.from_numpy(a), torch.from_numpy(ang)),
           JA._rotate_point(a, ang))
    _close(TA._get_3rd_point(torch.from_numpy(a), torch.from_numpy(b)),
           JA._get_3rd_point(a, b))


@pytest.mark.parametrize("rot", [0.0, 30.0, -75.0])
def test_affine_transform_points_and_invert(rot):
    center, scale, rots = _boxes(4, rot, seed=3)
    mat = np.array(JA.get_affine_transform(center, scale, rots, (256, 256)))
    pts = np.random.RandomState(4).uniform(0, 300, size=(4, 21, 2)).astype(
        np.float32)
    _close(TA.affine_transform_points(torch.from_numpy(pts),
                                      torch.from_numpy(mat)),
           JA.affine_transform_points(pts, mat))
    _close(TA.invert_affine(torch.from_numpy(mat)), JA.invert_affine(mat),
           rtol=1e-5)
