"""``ResultParser`` (``eval/result_parser.py``) against the JAX package on
the synthetic multi-hand scene of ``tests/test_detect.py`` (region maps and
Gaussian keypoint maps of two or three hands), on the CPU: the same boxes
and keypoints within 1e-4 input px (DARK at 19 taps on Gaussian peaks, 1e-5
heatmap px at stride 4 and beyond) with the same confidences, the same PCK
and AP; cycle detection through a fake ``model_fn``; the SimDR vector decode
and the multi-hand PCK on random inputs."""

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_config
from litehandnet_tpu.eval.result_parser import ResultParser as JaxParser
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.eval.result_parser import ResultParser
from tests.test_detect import _synthetic_scene
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

HANDS3 = ((60, 70, 80, 90), (170, 180, 70, 60), (200, 60, 40, 44))


def _cfg(dark=True, img=256, hm=64):
    return dict(DATASET=dict(num_joints=21, image_size=[img, img],
                             heatmap_size=[hm, hm]),
                PIPELINE=dict(unbiased_encoding=dark, simdr_split_ratio=2))


def _parsers(dark=True, **kw):
    return (JaxParser(jax_config(_cfg(dark)), **kw),
            ResultParser(config_from_dict(_cfg(dark)), device="cpu", **kw))


def _scenes():
    """Two images: the 2-hand scene and a 3-hand scene."""
    rng = np.random.RandomState(0)
    a = _synthetic_scene(rng)
    b = _synthetic_scene(rng, hands=HANDS3)
    region = np.stack([a[0], b[0]])
    kpt_hm = np.stack([a[1], b[1]])
    return region, kpt_hm, [a[2], b[2]], [a[3], b[3]]


def _assert_keypoints(got, want):
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got[..., 2], want[..., 2])


@pytest.mark.parametrize("dark", [True, False], ids=["dark", "offset"])
def test_end_to_end(dark):
    region, kpt_hm, gt_boxes, gt_kpts = _scenes()
    jp, tp = _parsers(dark, cd_enabled=False, max_num_bbox=4)
    want_boxes = jp.get_pred_bbox(region)
    boxes = tp.get_pred_bbox(torch.from_numpy(region))
    assert boxes.shape == want_boxes.shape == (2, 4, 5)
    assert [(b[:, 4] > 0).sum() for b in boxes] == [2, 3]
    np.testing.assert_allclose(boxes[..., :4], want_boxes[..., :4], rtol=1e-5,
                               atol=1e-4)
    np.testing.assert_array_equal(boxes[..., 4], want_boxes[..., 4])
    want = jp.get_group_keypoints(None, kpt_hm, want_boxes)
    got = tp.get_group_keypoints(None, torch.from_numpy(kpt_hm), boxes)
    _assert_keypoints(got, want)
    gt = np.zeros((2, 4, 21, 3), np.float32)
    gtb = np.zeros((2, 4, 4), np.float32)
    for i in range(2):
        gt[i, :len(gt_kpts[i])] = gt_kpts[i]
        gtb[i, :len(gt_boxes[i])] = gt_boxes[i]
    pck = tp.evaluate_pck(got, gt, gtb)
    assert pck == jp.evaluate_pck(want, gt, gtb) and pck > 0.9
    gt_list = [g.tolist() for g in gt_boxes]
    ap = tp.evaluate_ap(list(boxes), gt_list)
    assert ap == jp.evaluate_ap(list(want_boxes), gt_list) and ap[0] == 1.0


def test_cycle_detection_with_a_fake_model():
    """A small hand (area ratio <= 0.1) is cropped, re-inferred at half size
    by ``model_fn`` and decoded again: the same crops and keypoints."""
    rng = np.random.RandomState(1)
    region, kpt_hm, _, _ = _synthetic_scene(
        rng, hands=((60, 70, 30, 30), (180, 180, 120, 120)))
    images = np.random.RandomState(2).normal(
        size=(1, 256, 256, 3)).astype(np.float32)
    calls = {"jax": [], "port": []}

    def fake(side):
        def model_fn(crops):
            calls[side].append(np.asarray(crops).copy())
            n = crops.shape[0]
            return np.tile(kpt_hm[None, 10:42, 20:52, :], (n, 1, 1, 1))
        return model_fn

    kw = dict(cd_enabled=True, max_num_bbox=10, cd_ratio=0.1)
    jp = JaxParser(jax_config(_cfg()), model_fn=fake("jax"), **kw)
    tp = ResultParser(config_from_dict(_cfg()), model_fn=fake("port"),
                      device="cpu", **kw)
    boxes = tp.get_pred_bbox(region[None])
    want = jp.get_group_keypoints(images, kpt_hm[None], boxes)
    got = tp.get_group_keypoints(torch.from_numpy(images),
                                 torch.from_numpy(kpt_hm[None]), boxes)
    assert len(calls["port"]) == len(calls["jax"]) == 1
    np.testing.assert_array_equal(calls["port"][0], calls["jax"][0])
    assert calls["port"][0].shape == (1, 128, 128, 3)
    _assert_keypoints(got, want)


def test_simdr_vector_decode():
    rng = np.random.RandomState(3)
    xv = rng.uniform(size=(2, 21, 512)).astype(np.float32)
    yv = rng.uniform(size=(2, 21, 512)).astype(np.float32)
    xv[0, 2] = 0.5                                  # a flat vector: ties
    boxes = np.array([[[60, 70, 80, 90, 0.9], [0, 0, 0, 0, 0.0]],
                      [[170, 180, 70, 60, 0.8], [240, 20, 60, 80, 0.5]]],
                     np.float32)
    jp, tp = _parsers(cd_enabled=False)
    np.testing.assert_array_equal(
        tp.get_kpts_from_vectors(torch.from_numpy(xv), torch.from_numpy(yv),
                                 boxes),
        jp.get_kpts_from_vectors(xv, yv, boxes))


def test_multihand_pck_on_random_hands():
    """The center quirk (all joints summed, divided by the visible count)
    and the ``max(cx, cy)`` normalization, with an empty hand slot."""
    rng = np.random.RandomState(4)
    B, M, K = 3, 4, 21
    pred = rng.uniform(0, 200, (B, M, K, 3)).astype(np.float32)
    gt = rng.uniform(0, 200, (B, M, K, 3)).astype(np.float32)
    pred[..., 2] = (rng.uniform(size=(B, M, K)) > 0.2).astype(np.float32)
    gt[..., 2] = (rng.uniform(size=(B, M, K)) > 0.2).astype(np.float32)
    pred[1, 3, :, 2] = 0.0
    boxes = rng.uniform(20, 220, (B, M, 4)).astype(np.float32)
    jp, tp = _parsers(cd_enabled=False)
    for thr in (0.2, 0.5):
        assert tp.evaluate_pck(pred, gt, boxes, thr) == jp.evaluate_pck(
            pred, gt, boxes, thr)


def test_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ResultParser(config_from_dict(_cfg()))
