"""The port's COCO keypoint evaluator (``litehandnet_tpu_torch/eval/
cocoeval.py``) against the JAX package's: ``KeypointCOCOeval.run()`` gives
the same 10 stats within 1e-12 on seeded ground truth and detections, with
hand and COCO sigmas, images without detections or without ground truth,
crowd regions, unlabeled ground truth and all-invisible detections."""

import numpy as np
import pytest

from litehandnet_tpu.data.coco import COCO as JaxCOCO
from litehandnet_tpu.eval import cocoeval as J
from litehandnet_tpu_torch.data.coco import COCO
from litehandnet_tpu_torch.eval import cocoeval as T

COCO_SIGMAS = np.array([
    0.26, 0.25, 0.25, 0.35, 0.35, 0.79, 0.79, 0.72, 0.72, 0.62, 0.62, 1.07,
    1.07, 0.87, 0.87, 0.89, 0.89]) / 10.0


def _gt_dt(k, seed, n_images=8):
    """A COCO dataset dict and detections: 0-3 people per image (image 0
    has none), one crowd region and one unlabeled person; detections are
    the ground truth moved by a per-person noise level, plus false
    positives, with image 1 left without detections and one all-invisible
    detection."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    aid = 0
    for i in range(n_images):
        images.append(dict(id=i, file_name=f"{i}.jpg", width=640, height=480))
        for p in range(0 if i == 0 else rng.randint(1, 4)):
            x, y = rng.uniform(0, 400, 2)
            w, h = rng.uniform(20, 220, 2)   # small, medium and large areas
            xy = np.stack([rng.uniform(x, x + w, k), rng.uniform(y, y + h, k)], 1)
            v = np.where(rng.rand(k) < 0.15, 0, 2)
            if i == 3 and p == 0:
                v[:] = 0                      # unlabeled: ignored ground truth
            ann = dict(id=aid, image_id=i, category_id=1,
                       iscrowd=int(i == 5 and p == 0),
                       keypoints=[float(c) for row in np.concatenate(
                           [xy, v[:, None]], 1) for c in row],
                       bbox=[float(x), float(y), float(w), float(h)],
                       area=float(w * h))
            anns.append(ann)
            aid += 1
            if i == 1:
                continue
            noise = rng.choice([0.5, 3.0, 10.0, 40.0])
            dxy = xy + rng.normal(0, noise, xy.shape)
            s = rng.uniform(0.2, 1.0, (k, 1))
            dets.append(dict(image_id=i, score=float(rng.uniform(0.3, 1.0)),
                             keypoints=[float(c) for c in np.concatenate(
                                 [dxy, s], 1).ravel()]))
        for _ in range(rng.randint(0, 2)):     # false positives
            xy = rng.uniform(0, 400, (k, 2))
            dets.append(dict(image_id=i, score=float(rng.uniform(0, 0.6)),
                             keypoints=[float(c) for c in np.concatenate(
                                 [xy, np.ones((k, 1))], 1).ravel()]))
    dets.append(dict(image_id=2, score=0.99, keypoints=[1.0, 2.0, 0.0] * k))
    dataset = dict(images=images, annotations=anns,
                   categories=[dict(id=1, name="person")])
    return dataset, dets


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("sigmas", ["hand", "coco"])
def test_run_equals_jax(sigmas, seed):
    sig = T.HAND_SIGMAS if sigmas == "hand" else COCO_SIGMAS
    dataset, dets = _gt_dt(len(sig), seed)
    got = T.KeypointCOCOeval(COCO(dataset=dataset), dets, sigmas=sig).run()
    want = J.KeypointCOCOeval(JaxCOCO(dataset=dataset), dets, sigmas=sig).run()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got.shape == (10,)
    # the fixture is not at a trivial corner: AP neither 0 nor 1
    assert 0.05 < got[0] < 0.95, got


def test_ground_truth_as_detections_scores_one():
    dataset, _ = _gt_dt(17, seed=3)
    dets = [dict(image_id=a["image_id"], score=1.0, keypoints=a["keypoints"])
            for a in dataset["annotations"]
            if not a["iscrowd"] and max(a["keypoints"][2::3]) > 0]
    got = T.KeypointCOCOeval(COCO(dataset=dataset), dets,
                             sigmas=COCO_SIGMAS).run()
    want = J.KeypointCOCOeval(JaxCOCO(dataset=dataset), dets,
                              sigmas=COCO_SIGMAS).run()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    assert got[0] == pytest.approx(1.0)
    assert T.STAT_NAMES == J.STAT_NAMES


def test_img_ids_subset_and_kpt_keys():
    """Evaluation over a subset of images, and keypoints gathered from
    several fields (the wholebody evaluators' ``kpt_key`` list)."""
    dataset, dets = _gt_dt(6, seed=4)
    for rec in dataset["annotations"] + dets:
        kp = rec["keypoints"]
        rec["a"], rec["b"] = kp[:9], kp[9:]
    sig = np.full(6, 0.05)
    kw = dict(sigmas=sig, kpt_key=["a", "b"], img_ids=[2, 3, 4, 6])
    got = T.KeypointCOCOeval(COCO(dataset=dataset), dets, **kw).run()
    want = J.KeypointCOCOeval(JaxCOCO(dataset=dataset), dets, **kw).run()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
