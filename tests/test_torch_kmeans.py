"""Port ``utils/kmeans`` and ``tools/split_testset`` against JAX's (numpy on
both sides): centers and thresholds to 1e-12, labels, counts and the
written split files equal, the degenerate clusters of JAX's
``tests/test_centermap.py`` included."""

import json

import numpy as np
import pytest

from litehandnet_tpu.tools import split_testset as JS
from litehandnet_tpu.utils import kmeans as JK
from litehandnet_tpu_torch.tools import split_testset as TS
from litehandnet_tpu_torch.utils import kmeans as TK


def _sizes(seed):
    rng = np.random.RandomState(seed)
    return np.concatenate([rng.uniform(0.05, 0.3, 40),
                           rng.uniform(0.35, 0.55, 30),
                           rng.uniform(0.6, 0.95, 30)]).tolist()


@pytest.mark.parametrize("k", [2, 3])
def test_kmeans_1d_and_split_by_size_match_jax(k):
    rng = np.random.RandomState(3)
    values = np.concatenate([rng.normal(30.0, 2.0, 50),
                             rng.normal(120.0, 5.0, 50),
                             rng.normal(70.0, 3.0, 20)])
    for seed in (0, 1):
        (gc, gl), (wc, wl) = (TK.kmeans_1d(values, k, seed=seed),
                              JK.kmeans_1d(values, k, seed=seed))
        np.testing.assert_allclose(gc, wc, rtol=1e-12)
        np.testing.assert_array_equal(gl, wl)
    db = [dict(bbox=[0, 0, v, v * 0.8]) for v in values]
    assert TK.split_by_size(db, k) == JK.split_by_size(db, k)


@pytest.mark.parametrize("centers", [(0.2, 0.4, 0.6, 0.8), (0.5,),
                                     (0.9, 0.95), (0.1, 0.3, 0.5)])
def test_kmeans_ref_and_thresholds_match_jax(centers):
    for seed in (7, 8):
        sizes = _sizes(seed)
        gc, gn = TK.kmeans_ref(sizes, centers)
        wc, wn = JK.kmeans_ref(sizes, centers)
        np.testing.assert_allclose(gc, wc, rtol=1e-12)
        np.testing.assert_array_equal(gn, wn)
        gt, gcnt = TK.size_thresholds(sizes, gc)
        wt, wcnt = JK.size_thresholds(sizes, wc)
        np.testing.assert_allclose(gt, wt, rtol=1e-12)
        assert gcnt == wcnt


def _coco(path, sides):
    images = [dict(id=i, file_name=f"{i}.jpg", width=224, height=224)
              for i in range(len(sides))]
    anns = [dict(id=i, image_id=i, category_id=1, iscrowd=0,
                 bbox=[5.0, 5.0, s, s], area=s * s, keypoints=[])
            for i, s in enumerate(sides)]
    path.write_text(json.dumps(dict(images=images, annotations=anns,
                                    categories=[dict(id=1, name="hand")])))
    return str(path)


def _run_both(tmp_path, ann, extra, capsys):
    outs = []
    for name, main in (("jax", JS.main), ("port", TS.main)):
        paths = main(["--ann", ann, "--image-size", "224", "224",
                      "--out-dir", str(tmp_path / name), *extra])
        outs.append(([json.loads(open(p).read()) for p in paths],
                     [p.rsplit("/", 1)[1] for p in paths],
                     capsys.readouterr().out.replace(str(tmp_path / name),
                                                     "OUT")))
    return outs


def test_split_testset_cli_matches_jax(tmp_path, capsys):
    rng = np.random.RandomState(5)
    sides = [float(rng.choice([40, 100, 160, 210]) + rng.uniform(-8, 8))
             for _ in range(120)]
    ann = _coco(tmp_path / "test.json", sides)
    (jd, jn, jo), (td, tn, to) = _run_both(tmp_path, ann, [], capsys)
    assert tn == jn == ["small.json", "middle.json", "large.json",
                        "xlarge.json"]
    assert td == jd and to == jo
    assert sorted(a["id"] for d in td for a in d["annotations"]) \
        == list(range(120))


@pytest.mark.parametrize("extra", [[], ["--clusters", "0.5", "--names", "all"],
                                   ["--clusters", "0.1", "0.9"]])
def test_split_testset_degenerate_clusters_match_jax(tmp_path, capsys,
                                                     extra):
    """All boxes tiny: empty clusters are dropped with a warning; one
    initial center gives one bin."""
    rng = np.random.RandomState(7)
    ann = _coco(tmp_path / "test.json",
                [float(rng.uniform(30, 60)) for _ in range(40)])
    (jd, jn, jo), (td, tn, to) = _run_both(tmp_path, ann, extra, capsys)
    assert td == jd and tn == jn and to == jo
    assert sum(len(d["annotations"]) for d in td) == 40


def test_split_testset_rejects_wrong_name_count(tmp_path):
    ann = _coco(tmp_path / "test.json", [50.0, 60.0])
    with pytest.raises(SystemExit):
        TS.main(["--ann", ann, "--out-dir", str(tmp_path / "o"),
                 "--clusters", "0.2", "0.5", "--names", "a"])


def test_build_splits_without_annotations():
    bins, thresholds, centers = TS.build_splits({"annotations": []}, 224.0**2,
                                                [0.6, 0.2])
    want = JS.build_splits({"annotations": []}, 224.0**2, [0.6, 0.2])
    assert (bins, thresholds) == want[:2] and list(centers) == list(want[2])
