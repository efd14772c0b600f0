"""The port's host data layer against the JAX package's, on a FreiHAND-style
COCO fixture in ``tmp_path``: the dataset db, the raw batches of the loader
(PIL decode on both sides), the val batches end to end through the eval
pipeline, ``evaluate`` on the same results, the ground-truth round trip at
PCK 1.0, the metrics, and the oversized-image ROI path."""

import json
import time

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.data import build_dataset as jax_build_dataset
from litehandnet_tpu.data import get_dataset_class as jax_get_dataset_class
from litehandnet_tpu.data.loader import DataLoader as JaxLoader
from litehandnet_tpu.eval import metrics as JM
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data import (
    ConcatDataset,
    build_concat_dataset,
    build_dataset,
    dataset_names,
    get_dataset_class,
)
from litehandnet_tpu_torch.data.loader import DataLoader, make_dataloader, prefetch_iter
from litehandnet_tpu_torch.eval import metrics as TM
from litehandnet_tpu_torch.eval.decoder import TopDownDecoder
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_pipeline_batch,
    pipeline_coordinate_gap,
    pipeline_to_port_layout,
)


def _write_dataset(root, n, size, seed, bbox_fn, joints_fn):
    from PIL import Image

    img_dir = root / "images"
    img_dir.mkdir()
    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(n):
        arr = rng.randint(0, 255, size=(size[1], size[0], 3), dtype=np.uint8)
        name = f"img_{i:03d}.jpg"
        Image.fromarray(arr).save(img_dir / name)
        images.append(dict(id=i, file_name=f"images/{name}", width=size[0],
                           height=size[1]))
        joints = joints_fn(rng)
        vis = (rng.rand(21) > 0.1).astype(int)
        kpts = [v for (x, y), s in zip(joints, vis) for v in (float(x), float(y), int(s))]
        annotations.append(dict(id=i, image_id=i, category_id=1, iscrowd=0,
                                keypoints=kpts, bbox=bbox_fn(rng), area=1.0))
    ann_file = root / "ann.json"
    ann_file.write_text(json.dumps(dict(images=images, annotations=annotations,
                                        categories=[dict(id=1, name="hand")])))
    return str(root) + "/", str(ann_file)


@pytest.fixture(scope="module")
def tiny_freihand(tmp_path_factory):
    """8 FreiHAND-style JPEGs of noise, 21 joints, ~10% invisible
    (``tests/test_data.py:15-47`` with visibility flags) at 64x64, the
    configs' input size: FreiHAND's bbox is the whole input-size image."""
    return _write_dataset(
        tmp_path_factory.mktemp("freihand"), 8, (64, 64), 0,
        lambda rng: [6.0, 6.0, 52.0, 52.0],
        lambda rng: rng.uniform(8, 56, size=(21, 2)))


@pytest.fixture(scope="module")
def tiny_large_onehand(tmp_path_factory):
    """4 1280x960 images with the hand far off the canvas: the ROI window
    and downscale paths of ``_load_image``."""
    return _write_dataset(
        tmp_path_factory.mktemp("onehand10k_large"), 4, (1280, 960), 1,
        lambda rng: [850.0, 650.0, 120.0, 120.0],
        lambda rng: rng.uniform(0, 110, size=(21, 2)) + np.array([850, 650]))


def _cfg_dict(prefix, ann_file, name="freihand", size=(64, 64)):
    split = dict(ann_file=ann_file, img_prefix=prefix)
    return dict(
        MODEL=dict(name="litehandnet"),
        DATASET=dict(name=name, num_joints=21, image_size=list(size),
                     heatmap_size=[size[0] // 4, size[1] // 4],
                     train=split, val=split, test=split),
        PIPELINE=dict(flip_prob=0.5, rot_prob=0.5, rot_factor=30,
                      scale_factor=0.3, use_udp=False, sigma=2,
                      encoding="MSRA", unbiased_encoding=True,
                      simdr_split_ratio=2),
        TRAIN=dict(batch_per_gpu=3),
        EVAL=dict(metric=["PCK", "AUC", "EPE"], pck_threshold=0.2),
    )


def _assert_records_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in w:
            if k == "ann_info":
                continue
            if isinstance(w[k], np.ndarray):
                assert g[k].dtype == w[k].dtype, k
                np.testing.assert_array_equal(g[k], w[k], err_msg=k)
            else:
                assert g[k] == w[k], k


def test_registry():
    assert dataset_names() == sorted([
        "freihand", "rhd", "rhd2d", "onehand10k", "panoptic",
        "panoptic_hand2d", "coco_wholebody_hand", "zhhand", "coco", "mpii",
        "mpii_action"])
    for name in ("coco", "mpii", "mpii_action"):
        assert get_dataset_class(name).__name__ == (
            jax_get_dataset_class(name).__name__)
    with pytest.raises(KeyError, match="unknown"):
        get_dataset_class("nope")


@pytest.mark.parametrize("data_type", ["train", "val"])
@pytest.mark.parametrize("name", ["freihand", "rhd", "onehand10k", "zhhand"])
def test_db_equals_jax(tiny_freihand, name, data_type):
    d = _cfg_dict(*tiny_freihand, name=name)
    got = build_dataset(config_from_dict(d), data_type,
                        rng=np.random.RandomState(3))
    want = jax_build_dataset(jax_cfg(d), data_type,
                             rng=np.random.RandomState(3))
    _assert_records_equal(got.db, want.db)
    _assert_records_equal([got[i] for i in range(len(got))],
                          [want[i] for i in range(len(want))])
    assert got.ann_info.keys() == want.ann_info.keys()
    assert got.ann_info["flip_index"] == want.ann_info["flip_index"]


def test_panoptic_and_wholebody_db_equal_jax(tmp_path):
    rng = np.random.RandomState(4)
    images, anns = [], []
    for i in range(3):
        images.append(dict(id=i, file_name=f"im{i}.jpg", width=300, height=200))
        hand = lambda: [float(v) for xy in rng.uniform(10, 190, (21, 2))
                        for v in (*xy, 2)]
        anns.append(dict(
            id=i, image_id=i, category_id=1, iscrowd=0, keypoints=hand(),
            bbox=[10.0 + i, 20.0, 80.0, 60.0 + i], head_size=30.0 + i,
            lefthand_valid=True, lefthand_kpts=hand(),
            lefthand_box=[5.0, 6.0, 70.0, 50.0],
            righthand_valid=i != 1, righthand_kpts=hand(),
            righthand_box=[50.0, 60.0, 40.0, 90.0]))
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns,
                                   categories=[dict(id=1, name="hand")])))
    for name in ("panoptic", "coco_wholebody_hand"):
        d = _cfg_dict(str(tmp_path) + "/", str(ann), name=name)
        got = build_dataset(config_from_dict(d), "train",
                            rng=np.random.RandomState(5))
        want = jax_build_dataset(jax_cfg(d), "train",
                                 rng=np.random.RandomState(5))
        _assert_records_equal(got.db, want.db)
    assert len(got) == 5  # two hands per annotation, one right hand invalid


def _raw_equal(got, want):
    assert set(got) == set(want)
    for k, w in want.items():
        if isinstance(w, list):
            assert got[k] == w, k
        else:
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)


@pytest.mark.parametrize("data_type", ["train", "val"])
def test_raw_batches_equal_jax(tiny_freihand, data_type):
    d = _cfg_dict(*tiny_freihand)
    kw = dict(batch_size=3, num_workers=2, use_device_pipeline=False, seed=2)
    loader = DataLoader(config_from_dict(d), data_type, **kw)
    jloader = JaxLoader(jax_cfg(d), data_type, use_native=False, **kw)
    assert len(loader) == len(jloader) == (2 if data_type == "train" else 3)
    for epoch in (0, 1):
        got = list(loader.batches(epoch))
        want = list(jloader.batches(epoch))
        assert len(got) == len(want) == len(loader)
        for g, w in zip(got, want):
            _raw_equal(g, w)
    if data_type == "val":  # padded by repeating the last record
        assert list(want[-1]["bbox_id"]) == [6, 7, 7]


def test_oversized_images_raw_batches_equal_jax(tiny_large_onehand):
    d = _cfg_dict(*tiny_large_onehand, name="onehand10k", size=(224, 224))
    kw = dict(batch_size=4, num_workers=2, use_device_pipeline=False)
    for data_type, canvas in (("val", None), ("train", (160, 160))):
        got = list(DataLoader(config_from_dict(d), data_type,
                              canvas_hw=canvas, **kw).batches(0))
        want = list(JaxLoader(jax_cfg(d), data_type, canvas_hw=canvas,
                              use_native=False, **kw).batches(0))
        for g, w in zip(got, want):
            _raw_equal(g, w)
        assert (got[0]["offset"] > 0).all()
    assert (got[0]["img_scale"] < 1).all()  # the downscale path ran


VAL_KEYS = ("img", "target", "target_weight", "joints", "simdr_x", "simdr_y")
HOST_KEYS = ("img_raw", "joints_src", "vis_src", "bbox", "offset", "img_scale",
             "joints_canvas", "bbox_canvas", "bbox_id", "bbox_score")


def test_val_batches_equal_jax(tiny_freihand):
    """The eval pipeline end to end: decode, canvas, crop, normalize and
    targets on the CPU against JAX's loader; host arrays exactly, the
    pipeline's outputs within the pipeline's bounds (torch_parity)."""
    d = _cfg_dict(*tiny_freihand)
    cfg = config_from_dict(d)
    loader = DataLoader(cfg, "val", batch_size=3, num_workers=2, device="cpu")
    jloader = JaxLoader(jax_cfg(d), "val", batch_size=3, num_workers=2,
                        use_native=False)
    raws = list(DataLoader(cfg, "val", batch_size=3, num_workers=2,
                           use_device_pipeline=False).batches())
    got, want = list(loader.batches()), list(jloader.batches())
    assert len(got) == len(want) == len(raws) == 3
    params = loader.pipeline.sample_params(3)
    for g, w, raw in zip(got, want, raws):
        w = pipeline_to_port_layout(w)
        for k in HOST_KEYS:
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        assert g["image_file"] == list(w["image_file"])
        # source-space center and scale
        np.testing.assert_allclose(g["center"].numpy(), w["center"], rtol=1e-6)
        np.testing.assert_allclose(g["scale"].numpy(), w["scale"], rtol=1e-6)
        gap = pipeline_coordinate_gap(loader.pipeline, raw["center_canvas"],
                                      raw["scale_canvas"], raw["rotation"],
                                      params)
        assert_pipeline_batch({k: g[k] for k in VAL_KEYS},
                              {k: w[k] for k in VAL_KEYS}, gap)


def test_train_batches_run_the_pipeline(tiny_freihand):
    """Train batches: the same raw batches as without the pipeline, shapes
    in the trainer's layout, and one device generator per epoch seeded
    from ``seed`` (the same epoch twice gives the same batches)."""
    cfg = config_from_dict(_cfg_dict(*tiny_freihand))
    loader = DataLoader(cfg, "train", batch_size=3, num_workers=2, seed=1,
                        device="cpu")
    first, again = list(loader.batches(0)), list(loader.batches(0))
    other = list(loader.batches(1))
    assert len(first) == len(loader) == 2
    b = first[0]
    assert b["img"].shape == (3, 64, 64, 3) and b["img"].dtype == torch.float32
    assert b["target"].shape == (3, 21, 16, 16)
    assert b["target_weight"].shape == (3, 21)
    assert b["simdr_x"].shape == (3, 21, 128)
    assert float(b["img"].std()) > 0.1
    for x, y in zip(first, again):
        assert torch.equal(x["img"], y["img"])
        assert torch.equal(x["target"], y["target"])
    assert not torch.equal(first[0]["img"], other[0]["img"])


def _results(loader, batches, decoder, outputs_fn):
    results = []
    for b in batches:
        meta = {k: b[k] for k in ("center", "scale", "image_file", "bbox_id",
                                  "bbox_score")}
        meta["center"] = np.asarray(meta["center"])
        meta["scale"] = np.asarray(meta["scale"])
        results.append(decoder.decode(meta, outputs_fn(b)))
    return results


def test_gt_round_trip_pck_one(tiny_freihand):
    """Eval pipeline -> decode the targets -> unwarp -> original joints:
    ``evaluate`` gives PCK 1.0 (JAX tests/test_data.py:107-129), and the
    padded last batch's repeated record is dropped by the bbox_id dedup."""
    d = _cfg_dict(*tiny_freihand)
    cfg = config_from_dict(d)
    loader = DataLoader(cfg, "val", batch_size=3, num_workers=2, device="cpu")
    decoder = TopDownDecoder(cfg, device="cpu")
    results = _results(loader, loader.batches(), decoder,
                       lambda b: b["target"].permute(0, 2, 3, 1))
    assert sum(len(r["bbox_ids"]) for r in results) == 9  # 8 + 1 repeat
    metrics = loader.dataset.evaluate(results, metric=["PCK", "AUC", "EPE"])
    assert metrics["PCK"] == 1.0, metrics
    assert metrics["EPE"] < 1.5 and metrics["AUC"] > 0.9, metrics


@pytest.mark.parametrize("name", ["freihand", "panoptic"])
def test_evaluate_equals_jax(tiny_freihand, tmp_path, name):
    d = _cfg_dict(*tiny_freihand, name=name)
    if name == "panoptic":
        ann = json.loads(open(d["DATASET"]["val"]["ann_file"]).read())
        for a in ann["annotations"]:
            a["head_size"] = 40.0
        path = tmp_path / "ann.json"
        path.write_text(json.dumps(ann))
        for split in ("train", "val", "test"):
            d["DATASET"][split]["ann_file"] = str(path)
    ds = build_dataset(config_from_dict(d), "val")
    jds = jax_build_dataset(jax_cfg(d), "val")
    rng = np.random.RandomState(6)
    results = []
    for start in (0, 3, 6):  # batches of 3, the last padded with a repeat
        ids = [min(i, 7) for i in range(start, start + 3)]
        gt = np.stack([ds.db[i]["joints_3d"][:, :2] for i in ids])
        preds = gt + rng.normal(0, 12, gt.shape)
        preds = np.concatenate([preds, rng.rand(3, 21, 1)], -1)
        boxes = np.concatenate([rng.rand(3, 4) * 100, rng.rand(3, 2)], -1)
        results.append(dict(
            preds=preds.astype(np.float32), boxes=boxes.astype(np.float32),
            image_paths=[ds.db[i]["image_file"] for i in ids],
            bbox_ids=[ds.db[i]["bbox_id"] for i in ids]))
    metric = list(ds.METRICS)
    got = ds.evaluate(results, metric=metric)
    want = jds.evaluate(results, metric=metric)
    assert got == want
    assert list(got) == metric
    out = tmp_path / "res"
    out.mkdir()
    assert ds.evaluate(results, res_folder=str(out), metric=metric) == want
    assert len(json.loads((out / "result_keypoints.json").read_text())) == 8
    with pytest.raises(KeyError):
        ds.evaluate(results, metric=["mAP"])


def test_metrics_equal_jax():
    rng = np.random.RandomState(7)
    gt = rng.uniform(0, 200, (12, 21, 2))
    pred = gt + rng.normal(0, 8, gt.shape)
    mask = rng.rand(12, 21) > 0.2
    mask[3] = False
    norm = rng.uniform(20, 200, (12, 2))
    norm[5, 1] = 0.0  # a degenerate normalizer masks the row
    for thr in (0.05, 0.2, 0.5):
        got = TM.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        want = JM.keypoint_pck_accuracy(pred, gt, mask, thr, norm)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[1:] == want[1:]
    assert TM.keypoint_auc(pred, gt, mask, 30) == JM.keypoint_auc(pred, gt, mask, 30)
    assert TM.keypoint_epe(pred, gt, mask) == JM.keypoint_epe(pred, gt, mask)
    acc, avg, cnt = TM.keypoint_pck_accuracy(gt, gt, mask, 0.1, norm)
    assert avg == 1.0 and cnt == 21


def test_concat_dataset(tiny_freihand):
    d = _cfg_dict(*tiny_freihand)
    cd = build_concat_dataset([config_from_dict(d)] * 2, "val")
    assert isinstance(cd, ConcatDataset) and len(cd) == 16
    assert cd.dataset_name == "freihand+freihand"
    assert cd[9]["image_file"] == cd.datasets[1][1]["image_file"]
    assert cd[-1]["bbox_id"] == 7 and len(cd.db) == 16
    with pytest.raises(ValueError):
        ConcatDataset([])


def test_make_dataloader_and_device_default(tiny_freihand, monkeypatch):
    d = _cfg_dict(*tiny_freihand)
    ds, loader = make_dataloader(config_from_dict(d), "val", device="cpu")
    assert loader.batch_size == 3 and ds is loader.dataset
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DataLoader(config_from_dict(d), "val")


def test_prefetch_abandon_shuts_down_worker():
    closed = []

    def gen():
        try:
            i = 0
            while True:
                yield i
                i += 1
        finally:
            closed.append(True)

    it = prefetch_iter(gen(), size=2)
    assert next(it) == 0
    it.close()
    for _ in range(50):
        if closed:
            break
        time.sleep(0.1)
    assert closed
