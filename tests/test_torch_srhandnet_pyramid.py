"""``SRHandNetPyramid`` (two-stage multi-hand SRHandNet inference) on the
CPU: its bilinear gather and its peak NMS against JAX's ``_resize_into`` and
``_nms_peaks`` on the same inputs (gather within 1e-5 of the pixel range,
peaks equal), and the whole pyramid on a stub network whose region map
encodes a known box and whose keypoint channels peak at a known cell: the
frame-space box and keypoints as ``tests/test_srhandnet_pyramid.py``
derives them (within 1 px and 1e-2 px), an empty frame finds no hand; and
both stages and the whole call against JAX's ``SRHandNetPyramid`` driven by
a stub of the same crafted maps on each side (rects and keypoints within
1e-4 px, masks and peak values equal)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.eval import srhandnet_pyramid as J
from litehandnet_tpu_torch.eval import srhandnet_pyramid as T
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

K, NET, HM = 21, 256, 64
FRAME_H, FRAME_W = 480, 640
CX, CY, RW, RH = 300.0, 200.0, 160.0, 120.0
RATIO_IN = min(NET / FRAME_H, NET / FRAME_W)        # 0.4
RATIO_DOWN = NET / HM                                # 4.0
PEAK_X = int(round(CX * RATIO_IN / RATIO_DOWN))
PEAK_Y = int(round(CY * RATIO_IN / RATIO_DOWN))
KPT_HM_X, KPT_HM_Y = 12, 10


@pytest.mark.parametrize("rect", [(0.0, 0.0, 640.0, 480.0),
                                  (121.5, 37.25, 90.0, 150.0),
                                  (600.0, 400.0, 80.0, 120.0)])
def test_resize_into_equals_jax(rect):
    frame = np.random.RandomState(0).uniform(
        -0.5, 0.5, (FRAME_H, FRAME_W, 3)).astype(np.float32)
    want, want_ratio = J._resize_into(jnp.asarray(frame),
                                      tuple(np.float32(v) for v in rect),
                                      (NET, NET))
    got, ratio = T._resize_into(torch.from_numpy(frame),
                                torch.tensor([rect], dtype=torch.float32),
                                (NET, NET))
    assert float(ratio[0]) == float(want_ratio)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_nms_peaks_equals_jax():
    rng = np.random.RandomState(1)
    hm = np.round(rng.uniform(0, 1, (HM, HM)) * 8).astype(np.float32) / 8
    hm[0, 5] = 2.0        # on the border: excluded
    for k, thr in ((4, 0.25), (30, 0.5), (1, 0.99)):
        want = J._nms_peaks(jnp.asarray(hm), k, thr)
        got = T._nms_peaks(torch.from_numpy(hm), k, thr)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


class Stub(torch.nn.Module):
    """Crafted 4-scale outputs: one image is stage 1 (a region map in the
    last 3 channels), more are stage 2 (every keypoint channel of the first
    crop peaks at a known cell)."""

    def __init__(self, empty=False):
        super().__init__()
        self.empty = empty

    def forward(self, img):
        B = img.shape[0]
        hm = torch.zeros(B, K + 3, HM, HM)
        if not self.empty and B == 1:
            hm[0, K, PEAK_Y, PEAK_X] = 1.0
            hm[0, K + 1] = RW * RATIO_IN / NET
            hm[0, K + 2] = RH * RATIO_IN / NET
        elif not self.empty:
            hm[0, :K, KPT_HM_Y, KPT_HM_X] = 1.0
        return (hm,) * 4


def test_pyramid_geometry_round_trip():
    pyr = T.SRHandNetPyramid(Stub(), input_hw=(NET, NET), max_hands=4,
                             num_joints=K, device="cpu")
    coords, found, rects, hand_valid = pyr(np.zeros((FRAME_H, FRAME_W, 3),
                                                    np.uint8))
    assert hand_valid[0] and not hand_valid[1:].any()
    left, top, w, h = rects[0]
    np.testing.assert_allclose([left, top, w, h],
                               [CX - RW / 2, CY - RH / 2, RW, RH], atol=1.0)
    scale = RATIO_DOWN / min(NET / h, NET / w)
    assert found[0].all()
    np.testing.assert_allclose(coords[0, :, 0], KPT_HM_X * scale + left,
                               atol=1e-2)
    np.testing.assert_allclose(coords[0, :, 1], KPT_HM_Y * scale + top,
                               atol=1e-2)


def test_pyramid_empty_frame():
    pyr = T.SRHandNetPyramid(Stub(empty=True), max_hands=4, num_joints=K,
                             device="cpu")
    _, found, _, hand_valid = pyr(np.zeros((FRAME_H, FRAME_W, 3), np.uint8))
    assert not hand_valid.any() and not found.any()


def _scene_maps(max_hands):
    """numpy ``[1, HM, HM, K + 3]`` stage-1 and ``[max_hands, HM, HM, K + 3]``
    stage-2 maps. Stage 1: a center channel of quantized clutter below
    det_thr with peaks of 0.75, 0.75 (a tie), 0.5 and 0.4 (this one 2 cells
    from the 0.75 at (30, 30): suppressed by the 5x5 NMS), one at the
    map's second row (the excluded border) and one two cells in (its w/h
    window reaches row 0); w/h channels of seeded continuous ratios. Stage
    2: hand n keeps 21, 16, 15, ... of its keypoint peaks above hand_thr
    (the rest peak at 0.15, below it), over quantized clutter."""
    rng = np.random.RandomState(4)
    det = np.zeros((1, HM, HM, K + 3), np.float32)
    det[0, :, :, K] = np.round(rng.uniform(0, 1, (HM, HM)) * 4) / 20
    for (y, x), v in (((30, 30), 0.75), ((10, 45), 0.75), ((2, 20), 0.5),
                      ((32, 31), 0.4), ((1, 50), 0.9)):
        det[0, y, x, K] = v
    det[0, :, :, K + 1:] = rng.uniform(0.05, 0.4, (HM, HM, 2))
    hands = np.round(rng.uniform(0, 1, (max_hands, HM, HM, K + 3)) * 3) / 20
    keep = [21, 16, 15] + [8] * (max_hands - 3)
    for n in range(max_hands):
        for k in range(K):
            y, x = rng.randint(2, HM - 2, 2)
            hands[n, y, x, k] = (0.3 + 0.05 * (k % 7)) if k < keep[n] else 0.15
    return det, hands.astype(np.float32)


class _MapsStub(torch.nn.Module):
    """The port side of ``_scene_maps``: stage 1 for one image, stage 2 for
    a batch of crops, as 4 scales (NCHW)."""

    def __init__(self, maps):
        super().__init__()
        self.maps = [torch.from_numpy(m).permute(0, 3, 1, 2) for m in maps]

    def forward(self, img):
        hm = self.maps[0] if img.shape[0] == 1 else self.maps[1]
        return (hm,) * 4


class _JaxMapsStub:
    """The JAX side of ``_scene_maps``: ``apply`` as a flax module's, NHWC."""

    def __init__(self, maps):
        self.maps = [jnp.asarray(m) for m in maps]

    def apply(self, variables, img, train=False):
        hm = self.maps[0] if img.shape[0] == 1 else self.maps[1]
        return (hm,) * 4


@pytest.mark.parametrize("frame_hw", [(FRAME_H, FRAME_W), (200, 120)])
def test_pyramid_equals_jax(frame_hw):
    """detect_bbox (window means, ratio mapping, NMS and tie order, the
    padded candidate), detect_hands (per-crop decode) and the whole call
    (the most-5-missing rule) against JAX's on the same maps: rects,
    coordinates within 1e-4 px, masks and peak values equal."""
    max_hands = 4
    maps = _scene_maps(max_hands)
    frame = np.random.RandomState(5).randint(0, 255, (*frame_hw, 3), np.uint8)
    want_pyr = J.SRHandNetPyramid(_JaxMapsStub(maps), {}, input_hw=(NET, NET),
                                  max_hands=max_hands, num_joints=K)
    pyr = T.SRHandNetPyramid(_MapsStub(maps), input_hw=(NET, NET),
                             max_hands=max_hands, num_joints=K, device="cpu")

    want_rects, want_valid, want_vals = (
        np.asarray(a) for a in want_pyr._detect(jnp.asarray(frame)))
    rects, valid, vals = (t.numpy() for t in pyr.detect_bbox(
        pyr._frame(frame)))
    np.testing.assert_allclose(rects, want_rects, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(valid, want_valid)
    np.testing.assert_array_equal(vals, want_vals)
    assert valid.tolist() == [True, True, True, False]

    want_coords, want_found = (np.asarray(a) for a in want_pyr._hands(
        jnp.asarray(frame), jnp.asarray(want_rects)))
    coords, found = (t.numpy() for t in pyr.detect_hands(
        pyr._frame(frame), torch.from_numpy(want_rects.copy())))
    np.testing.assert_allclose(coords, want_coords, rtol=0, atol=1e-4)
    np.testing.assert_array_equal(found, want_found)

    got, want = pyr(frame), want_pyr(frame)
    for name, g, w in zip(("coords", "found", "rects", "hand_valid"), got,
                          want):
        if g.dtype == bool:
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4, err_msg=name)
    assert got[3].tolist() == [True, True, False, False]
