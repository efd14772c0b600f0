"""The port's host-side NMS suite (``litehandnet_tpu_torch/eval/nms.py``)
against the JAX package's: the same kept indices and the same OKS and
rescored values, exactly, in float64, on seeded boxes and pose dbs."""

import numpy as np
import pytest

from litehandnet_tpu.eval import nms as J
from litehandnet_tpu_torch.eval import nms as T

COCO_SIGMAS = np.array([
    0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07,
    1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


def _boxes(n, seed):
    rng = np.random.RandomState(seed)
    xy = rng.uniform(0, 40, (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    return np.concatenate([xy, xy + wh, rng.uniform(0, 1, (n, 1))], axis=1)


def _pose_db(n, k, seed, clusters=3):
    """Poses jittered around a few centres (so OKS is high within a cluster),
    with float64 keypoints and scores."""
    rng = np.random.RandomState(seed)
    centres = rng.uniform(50, 200, (clusters, k, 2))
    db = []
    for i in range(n):
        xy = centres[i % clusters] + rng.normal(0, 3.0 * (1 + i % 4), (k, 2))
        kpts = np.concatenate([xy, rng.uniform(0, 1, (k, 1))], axis=1)
        db.append(dict(keypoints=kpts, score=float(rng.uniform(0.1, 1.0)),
                       area=float(rng.uniform(2000, 8000))))
    return db


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7])
@pytest.mark.parametrize("seed", [0, 1])
def test_nms(seed, thr):
    dets = _boxes(40, seed)
    got, want = T.nms(dets, thr), J.nms(dets, thr)
    assert [int(i) for i in got] == [int(i) for i in want]
    assert 0 < len(got) < len(dets)


@pytest.mark.parametrize("vis_thr", [None, 0.3])
@pytest.mark.parametrize("k,sigmas", [(17, None), (17, COCO_SIGMAS),
                                      (21, np.full(21, 0.08))])
def test_oks_iou(k, sigmas, vis_thr):
    db = _pose_db(12, k, seed=k)
    g = db[0]["keypoints"].flatten()
    d = np.stack([p["keypoints"].flatten() for p in db[1:]])
    areas = np.array([p["area"] for p in db[1:]])
    got = T.oks_iou(g, d, db[0]["area"], areas, sigmas, vis_thr)
    want = J.oks_iou(g, d, db[0]["area"], areas, sigmas, vis_thr)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    assert (got > 0.5).any() and (got < 0.5).any()


@pytest.mark.parametrize("vis_thr", [None, 0.2])
@pytest.mark.parametrize("thr", [0.5, 0.9])
def test_oks_nms(thr, vis_thr):
    db = _pose_db(30, 17, seed=3)
    got = T.oks_nms(db, thr, sigmas=COCO_SIGMAS, vis_thr=vis_thr)
    want = J.oks_nms(db, thr, sigmas=COCO_SIGMAS, vis_thr=vis_thr)
    assert [int(i) for i in got] == [int(i) for i in want]
    assert T.oks_nms([], thr) == J.oks_nms([], thr) == []


@pytest.mark.parametrize("max_dets", [5, 20])
@pytest.mark.parametrize("thr", [0.3, 0.9])
def test_soft_oks_nms(thr, max_dets):
    db = _pose_db(30, 17, seed=4)
    got = T.soft_oks_nms(db, thr, max_dets=max_dets, sigmas=COCO_SIGMAS)
    want = J.soft_oks_nms(db, thr, max_dets=max_dets, sigmas=COCO_SIGMAS)
    assert got == want and len(got) == min(max_dets, len(db))
    assert T.soft_oks_nms([], thr) == []


@pytest.mark.parametrize("type_", ["gaussian", "linear"])
def test_rescore(type_):
    rng = np.random.RandomState(5)
    overlap, scores = rng.uniform(0, 1, 50), rng.uniform(0, 1, 50)
    np.testing.assert_array_equal(T._rescore(overlap, scores, 0.4, type_),
                                  J._rescore(overlap, scores, 0.4, type_))
