"""Port ``utils/centermap`` against JAX's on the same seeded numpy inputs,
on the CPU: ``pool_nms`` bit for bit (max pooling rounds nothing),
``decode_bbox`` within 1e-6 relative (the same top-k order, ties to the
lower index, and float32 box arithmetic), ``letterbox`` bit for bit,
``gaussian_radius`` equal and ``draw_gaussian`` to 1e-12 (numpy copies)."""

import numpy as np
import pytest
import torch

from litehandnet_tpu.utils import centermap as JC
from litehandnet_tpu_torch.utils import centermap as TC


def _peaks(shape, seed, plateau=False):
    rng = np.random.RandomState(seed)
    heat = rng.uniform(0, 1, shape).astype(np.float32)
    if plateau:
        # equal values across many cells: the top-k order is the tie order
        heat = np.round(heat * 4) / 4
    return heat


@pytest.mark.parametrize("kernel", [3, 5])
@pytest.mark.parametrize("plateau", [False, True])
def test_pool_nms_matches_jax(kernel, plateau):
    heat = _peaks((2, 16, 12, 4), 1, plateau)
    want = np.asarray(JC.pool_nms(heat, kernel))
    got = TC.pool_nms(torch.from_numpy(heat), kernel).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("plateau", [False, True])
@pytest.mark.parametrize("max_out", [5, 40])
def test_decode_bbox_matches_jax(plateau, max_out):
    rng = np.random.RandomState(2)
    heat = _peaks((3, 16, 20, 1), 3, plateau)
    wh = rng.uniform(1, 8, (3, 16, 20, 2)).astype(np.float32)
    off = rng.uniform(0, 1, (3, 16, 20, 2)).astype(np.float32)
    want = np.asarray(JC.decode_bbox(heat, wh, off, 0.3, max_out))
    got = TC.decode_bbox(torch.from_numpy(heat), torch.from_numpy(wh),
                         torch.from_numpy(off), 0.3, max_out).numpy()
    assert got.shape == (3, max_out, 5)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_letterbox_matches_jax():
    rng = np.random.RandomState(4)
    for shape, size in [((48, 80, 3), (64, 64)), ((90, 30, 3), (40, 72))]:
        img = rng.randint(0, 255, shape, np.uint8)
        np.testing.assert_array_equal(TC.letterbox(img, size),
                                      JC.letterbox(img, size))


def test_gaussian_radius_and_draw_match_jax():
    for hw in [(8, 8), (3, 17), (40, 12), (100, 100), (1, 1)]:
        for ov in (0.3, 0.5, 0.7, 0.9):
            assert TC.gaussian_radius(hw, ov) == JC.gaussian_radius(hw, ov)
    rng = np.random.RandomState(0)
    for center, radius in [((20, 12), 5), ((0, 0), 4), ((63, 63), 7),
                           ((2, 60), 3), ((70, 5), 2)]:
        base = rng.uniform(0, 0.3, (64, 64)).astype(np.float32)
        np.testing.assert_allclose(
            TC.draw_gaussian(base.copy(), center, radius, 0.8),
            JC.draw_gaussian(base.copy(), center, radius, 0.8), rtol=1e-12)
