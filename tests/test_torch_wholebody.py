"""Port ``eval/wholebody`` and ``tools/eval_wholebody`` against JAX's on a
seeded COCO-WholeBody ground truth and prediction written to ``tmp_path``
(the reference's example files are not in the repo): every part's 10 stats
within 1e-6 (both sides are the same float64 numpy protocol)."""

import json

import numpy as np
import pytest

from litehandnet_tpu.data.coco import COCO as JCOCO
from litehandnet_tpu.eval import wholebody as JW
from litehandnet_tpu.tools.eval_wholebody import main as jax_main
from litehandnet_tpu_torch.data.coco import COCO
from litehandnet_tpu_torch.eval import wholebody as TW
from litehandnet_tpu_torch.tools.eval_wholebody import main

FIELDS = [("keypoints", 17), ("foot_kpts", 6), ("face_kpts", 68),
          ("lefthand_kpts", 21), ("righthand_kpts", 21)]


def _person(rng, cx, cy, size, visible=0.8):
    rec = {}
    for field, n in FIELDS:
        xy = rng.normal(0, size / 4, (n, 2)) + (cx, cy)
        v = (rng.rand(n) < visible) * 2
        rec[field] = np.concatenate([xy, v[:, None]], 1).ravel().tolist()
    return rec


def write_wholebody(tmp_path, seed=0, n_images=6):
    """GT with 1-3 people per image (one crowd, one with no visible point);
    predictions are the GT plus noise, one missed person, one false person,
    and part scores on half of them (the rest fall back to ``score``)."""
    rng = np.random.RandomState(seed)
    images, anns, dets = [], [], []
    for i in range(n_images):
        images.append({"id": i + 1, "file_name": f"{i:012d}.jpg",
                       "width": 640, "height": 480})
        for j in range(int(rng.randint(1, 4))):
            cx, cy = rng.uniform(100, 540), rng.uniform(100, 380)
            size = float(rng.uniform(40, 200))
            person = _person(rng, cx, cy, size,
                             visible=0.0 if (i, j) == (2, 0) else 0.8)
            ann = dict(person, id=len(anns) + 1, image_id=i + 1,
                       category_id=1, iscrowd=int((i, j) == (4, 0)),
                       bbox=[cx - size / 2, cy - size / 2, size, size],
                       area=size * size * 0.6)
            anns.append(ann)
            if (i, j) == (1, 0):
                continue                                   # missed
            det = {"image_id": i + 1, "category_id": 1,
                   "score": float(rng.uniform(0.3, 1))}
            for field, n in FIELDS:
                k = np.asarray(person[field]).reshape(n, 3)
                k[:, :2] += rng.normal(0, size * (0.004 if n == 68 else 0.03), (n, 2))
                k[:, 2] = rng.uniform(0.2, 1, n)
                det[field] = k.ravel().tolist()
            if len(dets) % 2:
                for part in ("foot", "face", "lefthand", "righthand"):
                    det[f"{part}_score"] = float(rng.uniform(0.2, 1))
            dets.append(det)
        if i == 3:                                          # a false person
            fake = _person(rng, 320, 240, 80)
            dets.append(dict(fake, image_id=i + 1, category_id=1, score=0.9))
    gt = {"images": images, "annotations": anns,
          "categories": [{"id": 1, "name": "person"}]}
    gt_file, res_file = tmp_path / "gt.json", tmp_path / "res.json"
    gt_file.write_text(json.dumps(gt))
    res_file.write_text(json.dumps(dets))
    return str(gt_file), str(res_file)


def test_parts_table_matches_jax():
    assert list(TW.PARTS) == list(JW.PARTS)
    for part, (key, sigmas) in TW.PARTS.items():
        assert key == JW.PARTS[part][0]
        np.testing.assert_array_equal(sigmas, JW.PARTS[part][1])


@pytest.mark.parametrize("part", list(JW.PARTS))
def test_evaluate_part_matches_jax(tmp_path, part):
    gt_file, res_file = write_wholebody(tmp_path)
    dets = json.loads(open(res_file).read())
    want = JW.evaluate_part(JCOCO(gt_file), dets, part)
    got = TW.evaluate_part(COCO(gt_file), dets, part)
    assert len(got) == 10
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0 < got[0] < 1, got                              # a real AP


def test_evaluate_wholebody_and_part_scores(tmp_path):
    gt_file, res_file = write_wholebody(tmp_path, seed=1)
    dets = json.loads(open(res_file).read())
    want = JW.evaluate_wholebody(JCOCO(gt_file), dets, img_ids=[1, 2, 3, 4])
    got = TW.evaluate_wholebody(COCO(gt_file), dets, img_ids=[1, 2, 3, 4])
    assert list(got) == list(want) and len(got) == 6 * 11
    np.testing.assert_allclose(list(got.values()), list(want.values()),
                               rtol=0, atol=1e-6)
    scored = TW._ensure_part_score(dets, "face")
    assert all("face_score" in d for d in scored)
    assert all("face_score" not in d for d in dets if "foot_score" not in d)


def test_cli_matches_jax(tmp_path, capsys):
    gt_file, res_file = write_wholebody(tmp_path, seed=2)
    argv = ["--gt_file", gt_file, "--res_file", res_file,
            "--parts", "lefthand", "righthand"]
    want = jax_main(argv)
    capsys.readouterr()
    got = main(argv)
    out = capsys.readouterr().out
    assert got == pytest.approx(want, abs=1e-6)
    assert "lefthand AP" in out and "righthand mAP" in out
