"""Port ``data/od_dataset`` against JAX's: both annotation formats (the
mmdet middle format and COCO-WholeBody hand boxes) written to ``tmp_path``
from a seed; records equal, AP equal (host numpy on both sides)."""

import json

import numpy as np
import pytest

from litehandnet_tpu.data import od_dataset as JO
from litehandnet_tpu_torch.data import od_dataset as TO


def _middle_format(path, seed=0, n=6):
    rng = np.random.RandomState(seed)
    infos = []
    for i in range(n):
        k = int(rng.randint(0, 4)) if i else 0   # image 0 has no box
        xy = rng.uniform(0, 200, (k, 2))
        wh = rng.uniform(1, 60, (k, 2))
        infos.append({"filename": f"img_{i:03d}.jpg", "width": 256,
                      "height": 256,
                      "ann": {"bboxes": np.concatenate([xy, xy + wh], 1)
                              .round(2).tolist(),
                              "labels": [0] * k}})
    path.write_text(json.dumps(infos))
    return str(path)


def _wholebody(path, seed=1, n=5):
    rng = np.random.RandomState(seed)
    images, anns = [], []
    for i in range(n):
        images.append({"id": 10 + i, "file_name": f"{i:012d}.jpg",
                       "width": 320, "height": 240})
        for j in range(int(rng.randint(0, 3))):
            ann = {"id": 100 * i + j, "image_id": 10 + i, "category_id": 1,
                   "iscrowd": 0}
            for side in ("left", "right"):
                ann[f"{side}hand_valid"] = bool(rng.rand() < 0.7)
                # some boxes below min_size
                ann[f"{side}hand_box"] = [float(v) for v in np.round(
                    [*rng.uniform(0, 200, 2), *rng.uniform(0.5, 40, 2)], 2)]
            anns.append(ann)
    path.write_text(json.dumps({"images": images, "annotations": anns,
                                "categories": [{"id": 1, "name": "person"}]}))
    return str(path)


def _records(ds):
    out = []
    for i in range(len(ds)):
        r = dict(ds[i])
        r["bboxes"] = r["bboxes"].tolist()
        r["labels"] = r["labels"].tolist()
        out.append(r)
    return out


def _predictions(ds, seed):
    """Noisy copies of the GT (cx, cy, w, h, conf) plus padding rows."""
    rng = np.random.RandomState(seed)
    preds = []
    for i in range(len(ds)):
        b = ds.get_ann_info(i)["bboxes"]
        rows = np.concatenate([(b[:, :2] + b[:, 2:]) / 2, b[:, 2:] - b[:, :2]],
                              1) + rng.normal(0, 0.3, (len(b), 4))
        conf = rng.uniform(0.1, 1, (len(b), 1))
        pad = np.zeros((2, 5))
        preds.append(np.concatenate([np.concatenate([rows, conf], 1), pad])
                     .astype(np.float32))
    preds[-1] = None
    return preds


@pytest.mark.parametrize("test_mode", [False, True])
@pytest.mark.parametrize("fmt", ["middle", "wholebody"])
def test_records_and_ap_match_jax(tmp_path, test_mode, fmt):
    if fmt == "middle":
        ann = _middle_format(tmp_path / "od.json")
        jds = JO.CustomDataset(ann, "imgs", test_mode=test_mode)
        tds = TO.CustomDataset(ann, "imgs", test_mode=test_mode)
    else:
        ann = _wholebody(tmp_path / "cwb.json")
        jds = JO.CWBHandDataset(ann, "imgs", test_mode=test_mode, min_size=4)
        tds = TO.CWBHandDataset(ann, "imgs", test_mode=test_mode, min_size=4)
    assert len(tds) == len(jds) > 0
    assert _records(tds) == _records(jds)
    assert tds.CLASSES == jds.CLASSES == ("hand",)
    preds = _predictions(tds, 5)
    for thr in (None, 0.5, [0.3, 0.7]):
        assert tds.evaluate(preds, thr) == jds.evaluate(preds, thr)
    ap50, _ = tds.evaluate(preds)
    assert ap50 > 0.5


def test_wholebody_drops_small_and_invalid_hands(tmp_path):
    ann = _wholebody(tmp_path / "cwb.json")
    doc = json.loads((tmp_path / "cwb.json").read_text())
    ds = TO.CWBHandDataset(ann, test_mode=True, min_size=4)
    want = sum(1 for a in doc["annotations"] for s in ("left", "right")
               if a[f"{s}hand_valid"] and min(a[f"{s}hand_box"][2:]) >= 4)
    assert sum(len(ds.get_ann_info(i)["bboxes"]) for i in range(len(ds))) \
        == want
