"""The port's body datasets (``litehandnet_tpu_torch/data/body.py``)
against the JAX package's, on seeded fixtures in ``tmp_path``: COCO (ground
truth boxes and a detection ``bbox_file``), MPII and MPII-action (a GT
``.mat`` written with ``scipy.io.savemat``). The db equals JAX's record by
record; ``evaluate`` on the same results gives the same COCO stats (within
1e-12) and the same PCKh (exactly)."""

import json

import numpy as np
import pytest

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.data import build_dataset as jax_build_dataset
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data import build_dataset, get_dataset_class

scipy_io = pytest.importorskip("scipy.io")

MPII_NAMES = [
    "rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis", "thorax",
    "upperneck", "head", "rwri", "relb", "rsho", "lsho", "lelb", "lwri",
]


def write_coco(root, seed, n_images=6):
    """A COCO-format person dataset (17 joints, 1-3 people per image, a
    crowd and an unlabeled person that the GT db skips) and a detection
    ``bbox_file`` (the ground-truth boxes moved, one low-score and one
    non-person box). Returns (prefix, ann_file, bbox_file)."""
    rng = np.random.RandomState(seed)
    images, anns, boxes = [], [], []
    aid = 0
    for i in range(n_images):
        images.append(dict(id=i, file_name=f"images/{i:04d}.jpg", width=640,
                           height=480))
        for p in range(rng.randint(1, 4)):
            x, y = rng.uniform(0, 400, 2)
            w, h = rng.uniform(60, 220, 2)
            xy = np.stack([rng.uniform(x, x + w, 17),
                           rng.uniform(y, y + h, 17)], 1)
            v = np.where(rng.rand(17) < 0.2, 0, 2)
            if i == 2 and p == 0:
                v[:] = 0
            kpts = [float(c) for row in np.concatenate([xy, v[:, None]], 1)
                    for c in row]
            anns.append(dict(id=aid, image_id=i, category_id=1,
                             iscrowd=int(i == 4 and p == 0), keypoints=kpts,
                             bbox=[float(x), float(y), float(w), float(h)],
                             area=float(w * h), num_keypoints=int((v > 0).sum())))
            aid += 1
            boxes.append(dict(image_id=i, category_id=1,
                              score=float(rng.uniform(0.05, 1.0)),
                              bbox=[float(x + rng.normal(0, 5)),
                                    float(y + rng.normal(0, 5)),
                                    float(w), float(h)]))
    boxes.append(dict(image_id=0, category_id=2, score=0.9,
                      bbox=[1.0, 2.0, 30.0, 40.0]))
    (root / "images").mkdir(exist_ok=True)
    ann_file = root / "person_keypoints.json"
    ann_file.write_text(json.dumps(dict(
        images=images, annotations=anns,
        categories=[dict(id=1, name="person")])))
    bbox_file = root / "person_detections.json"
    bbox_file.write_text(json.dumps(boxes))
    return str(root) + "/", str(ann_file), str(bbox_file)


def write_mpii(root, seed, n=8):
    """An MPII json list and its ``mpii_gt_val.mat`` (the layout of
    ``tests/test_mpii_eval.py``): joints in MATLAB 1-based pixels, one
    missing joint, head boxes of diagonal 100 (head size 60)."""
    rng = np.random.RandomState(seed)
    pos_gt = rng.uniform(100, 400, (16, 2, n))
    hb0 = rng.uniform(50, 80, (2, n))
    headboxes = np.stack([hb0, hb0 + np.float64([[60.0], [80.0]])])
    jnt_missing = np.zeros((16, n))
    jnt_missing[5, 0] = 1
    scipy_io.savemat(root / "mpii_gt_val.mat", dict(
        dataset_joints=np.array([MPII_NAMES], dtype=object),
        jnt_missing=jnt_missing, pos_gt_src=pos_gt, headboxes_src=headboxes))
    anno = [dict(image=f"{i:09d}.jpg",
                 center=([-1.0, -1.0] if i == 3 else
                         rng.uniform(200, 300, 2).tolist()),
                 scale=float(rng.uniform(1.0, 2.0)),
                 joints=pos_gt[:, :, i].tolist(),
                 joints_vis=(1 - jnt_missing[:, i]).tolist())
            for i in range(n)]
    ann_file = root / "mpii_val.json"
    ann_file.write_text(json.dumps(anno))
    return str(root) + "/", str(ann_file), pos_gt


def coco_cfg(prefix, ann_file, **extra):
    split = dict(ann_file=ann_file, img_prefix=prefix)
    return dict(DATASET=dict(name="coco", num_joints=17, image_size=[192, 256],
                             heatmap_size=[48, 64], train=split, val=split,
                             test=split, **extra))


def mpii_cfg(name, prefix, ann_file):
    split = dict(ann_file=ann_file, img_prefix=prefix)
    return dict(DATASET=dict(name=name, num_joints=16, image_size=[256, 256],
                             heatmap_size=[64, 64], train=split, val=split,
                             test=split))


def both(d, data_type, seed=3):
    got = build_dataset(config_from_dict(d), data_type,
                        rng=np.random.RandomState(seed))
    want = jax_build_dataset(jax_cfg(d), data_type,
                             rng=np.random.RandomState(seed))
    return got, want


def assert_same_db(got, want):
    assert type(got).__name__ == type(want).__name__
    assert len(got.db) == len(want.db) > 0
    for g, w in zip(got.db, want.db):
        assert set(g) == set(w)
        for k in w:
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k
    assert got.ann_info.keys() == want.ann_info.keys()
    np.testing.assert_array_equal(got.sigmas, want.sigmas)
    assert got.dataset_name == want.dataset_name


def test_registry_resolves_the_body_datasets():
    for name, cls in [("coco", "TopDownCocoDataset"),
                      ("mpii", "TopDownMpiiDataset"),
                      ("mpii_action", "TopDownMpiiActionDataset")]:
        assert get_dataset_class(name).__name__ == cls


@pytest.mark.parametrize("data_type", ["train", "val"])
def test_coco_gt_db_equals_jax(tmp_path, data_type):
    prefix, ann, _ = write_coco(tmp_path, seed=0)
    got, want = both(coco_cfg(prefix, ann), data_type)
    assert_same_db(got, want)


@pytest.mark.parametrize("det_bbox_thr", [0.0, 0.3])
def test_coco_detection_db_equals_jax(tmp_path, det_bbox_thr):
    prefix, ann, bbox_file = write_coco(tmp_path, seed=1)
    got, want = both(coco_cfg(prefix, ann, use_gt_bbox=False,
                              bbox_file=bbox_file,
                              det_bbox_thr=det_bbox_thr), "test")
    assert_same_db(got, want)
    assert all(r["bbox_score"] >= det_bbox_thr for r in got.db)


def _coco_results(ds, seed):
    """Two result batches over ``ds.db``: its joints moved by a per-record
    noise level, keypoint scores around the visibility threshold."""
    rng = np.random.RandomState(seed)
    out = []
    for part in np.array_split(np.arange(len(ds.db)), 2):
        recs = [ds.db[i] for i in part]
        preds = np.stack([np.concatenate([
            r["joints_3d"][:, :2] + rng.normal(0, rng.choice([1, 6, 20]),
                                               (17, 2)),
            rng.uniform(0, 1, (17, 1))], 1) for r in recs]).astype(np.float32)
        boxes = np.stack([np.concatenate([
            r["center"], r["scale"], [np.prod(r["scale"] * 200.0),
                                      r["bbox_score"]]]) for r in recs])
        out.append(dict(preds=preds, boxes=boxes.astype(np.float32),
                        image_paths=[r["image_file"] for r in recs],
                        bbox_ids=[r["bbox_id"] for r in recs]))
    return out


@pytest.mark.parametrize("soft_nms", [False, True])
@pytest.mark.parametrize("use_gt_bbox", [True, False])
def test_coco_evaluate_equals_jax(tmp_path, use_gt_bbox, soft_nms):
    prefix, ann, bbox_file = write_coco(tmp_path, seed=2)
    extra = dict(soft_nms=soft_nms, oks_thr=0.5)
    if not use_gt_bbox:
        extra.update(use_gt_bbox=False, bbox_file=bbox_file)
    got_ds, want_ds = both(coco_cfg(prefix, ann, **extra), "test")
    if not use_gt_bbox:
        # detection records carry no joints: score the GT db's joints,
        # matched by image
        gt_ds, _ = both(coco_cfg(prefix, ann), "test")
        by_img = {r["image_file"]: r["joints_3d"] for r in gt_ds.db}
        for ds in (got_ds, want_ds):
            for r in ds.db:
                r["joints_3d"] = by_img.get(r["image_file"],
                                            np.zeros((17, 3), np.float32))
    results = _coco_results(got_ds, seed=3)
    got = got_ds.evaluate(results, metric="mAP")
    want = want_ds.evaluate(results, metric="mAP")
    assert list(got) == list(want)
    np.testing.assert_allclose([got[k] for k in got], [want[k] for k in want],
                               rtol=0, atol=1e-12)
    assert 0.0 < got["mAP"] < 1.0
    with pytest.raises(KeyError):
        got_ds.evaluate(results, metric="PCK")


@pytest.mark.parametrize("name", ["mpii", "mpii_action"])
@pytest.mark.parametrize("data_type", ["train", "test"])
def test_mpii_db_equals_jax(tmp_path, name, data_type):
    prefix, ann, _ = write_mpii(tmp_path, seed=4)
    got, want = both(mpii_cfg(name, prefix, ann), data_type)
    assert_same_db(got, want)
    assert got.num_images == want.num_images


@pytest.mark.parametrize("noise", [0.0, 45.0])
@pytest.mark.parametrize("name", ["mpii", "mpii_action"])
def test_mpii_pckh_equals_jax(tmp_path, name, noise):
    prefix, ann, pos_gt = write_mpii(tmp_path, seed=5)
    got_ds, want_ds = both(mpii_cfg(name, prefix, ann), "test")
    rng = np.random.RandomState(6)
    preds = pos_gt + rng.uniform(-noise, noise, pos_gt.shape)
    # 0-based predictions, in two batches, one record repeated (the
    # evaluator keeps one per bbox_id)
    flat = preds.transpose(2, 0, 1) - 1.0
    results = [dict(preds=flat[:5], bbox_ids=list(range(5))),
               dict(preds=flat[4:], bbox_ids=list(range(4, 8)))]
    got = got_ds.evaluate(results, metric="PCKh")
    want = want_ds.evaluate(results, metric="PCKh")
    assert list(got) == list(want)
    for k in want:
        assert float(got[k]) == float(want[k]), k
    if noise == 0.0:
        assert float(got["PCKh"]) == pytest.approx(100.0)
    else:
        assert 5.0 < float(got["PCKh"]) < 95.0
    with pytest.raises(KeyError):
        got_ds.evaluate(results, metric=["PCKh", "AUC"])
