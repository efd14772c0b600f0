"""Process decode (``litehandnet_tpu_torch/data/mp_decode.py``): two
spawned workers decode into one shared-memory block the same canvases,
offsets and scales as the in-process decode; ``DataLoader(decode_procs=2)``
yields the same batches as ``decode_procs=0``; ``close()`` unlinks the
block; and the modules a worker imports load no torch."""

import json
import subprocess
import sys
from multiprocessing import shared_memory

import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data.image_io import _load_image
from litehandnet_tpu_torch.data.loader import DataLoader
from litehandnet_tpu_torch.data.mp_decode import ProcessDecodePool, default_procs
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

CANVAS = (96, 96)


@pytest.fixture
def images(tmp_path):
    """Seven JPEGs and PNGs: small ones that fit the canvas, two larger
    than it (the ROI window, then the downscale) and a missing file."""
    from PIL import Image

    rng = np.random.RandomState(0)
    paths, centers, scales = [], [], []
    for i, (h, w) in enumerate([(64, 64), (80, 48), (200, 150), (64, 64),
                                (300, 400), (50, 70)]):
        p = tmp_path / f"{i}.{'png' if i % 2 else 'jpg'}"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(p)
        paths.append(str(p))
        centers.append(rng.uniform(0.3, 0.7, 2) * (w, h))
        scales.append(rng.uniform(0.1, 0.3, 2))
    paths.append(str(tmp_path / "missing.jpg"))
    centers.append([10.0, 10.0])
    scales.append([0.2, 0.2])
    return (paths, np.asarray(centers, np.float32),
            np.asarray(scales, np.float32))


def test_pool_decode_equals_in_process(images):
    paths, centers, scales = images
    pool = ProcessDecodePool(2, 8, CANVAS, roi_margin=1.2, use_native=False)
    try:
        for n in (len(paths), 3):
            canv, off, fsc = pool.decode(paths[:n], centers[:n], scales[:n])
            canv = canv.copy()
            for i in range(n):
                want = _load_image(paths[i], CANVAS, center=centers[i],
                                   scale=scales[i], margin=1.2)
                np.testing.assert_array_equal(canv[i], want[0])
                np.testing.assert_array_equal(off[i], want[1])
                np.testing.assert_array_equal(fsc[i], want[2])
        # the large sources took the ROI window and the downscale
        assert (off[:n] != 0).any() or (fsc[:n] != 1).any()
        with pytest.raises(ValueError):
            pool.decode(paths * 2, np.tile(centers, (2, 1)),
                        np.tile(scales, (2, 1)))
    finally:
        pool.close()


def test_close_unlinks_the_block():
    pool = ProcessDecodePool(2, 2, (8, 8))
    name = pool.name
    shared_memory.SharedMemory(name=name).close()  # it exists
    pool.close()
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
    pool.close()  # a second close does nothing
    with pytest.raises(ValueError):
        ProcessDecodePool(0, 2, (8, 8))


def test_default_procs():
    assert 1 <= default_procs() <= max((__import__("os").cpu_count() or 1), 1)


def test_worker_modules_import_no_torch():
    probe = ("import sys, litehandnet_tpu_torch.data.mp_decode, "
             "litehandnet_tpu_torch.data.image_io; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] == 'torch'))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def _fixture_cfg(tmp_path, n=7):
    from PIL import Image

    rng = np.random.RandomState(1)
    (tmp_path / "images").mkdir()
    imgs, anns = [], []
    for i in range(n):
        size = (64, 64) if i != 2 else (200, 160)   # one oversized source
        name = f"images/{i}.jpg"
        Image.fromarray(rng.randint(0, 255, size + (3,), np.uint8)).save(
            tmp_path / name)
        imgs.append(dict(id=i, file_name=name, width=size[1], height=size[0]))
        kp = [v for xy in rng.uniform(8, 56, (21, 2))
              for v in (float(xy[0]), float(xy[1]), 1)]
        anns.append(dict(id=i, image_id=i, category_id=1, iscrowd=0,
                         keypoints=kp, bbox=[4.0, 4.0, 56.0, 56.0]))
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(dict(images=imgs, annotations=anns,
                                   categories=[dict(id=1, name="hand")])))
    split = dict(ann_file=str(ann), img_prefix=str(tmp_path) + "/")
    return config_from_dict(dict(
        MODEL=dict(name="litehandnet"),
        DATASET=dict(name="onehand10k", num_joints=21, image_size=[64, 64],
                     heatmap_size=[16, 16], train=split, val=split,
                     test=split),
        PIPELINE=dict(sigma=2, unbiased_encoding=True, scale_factor=0.25,
                      rot_factor=30, rot_prob=0.5, flip_prob=0.5),
        TRAIN=dict(batch_per_gpu=3)))


@pytest.mark.parametrize("data_type", ["train", "val"])
def test_loader_batches_equal_in_process(tmp_path, data_type):
    """Raw batches and pipeline batches (the train pipeline's draws come
    from the loader's seeded generator) are the same with two decode
    processes as in this process."""
    cfg = _fixture_cfg(tmp_path)
    kw = dict(batch_size=3, seed=2, device="cpu", num_workers=2)
    with DataLoader(cfg, data_type, decode_procs=0, **kw) as ref, \
            DataLoader(cfg, data_type, decode_procs=2, **kw) as mp:
        assert mp.decode_pool is not None and ref.decode_pool is None
        for epoch in (0, 1):
            want, got = list(ref.batches(epoch)), list(mp.batches(epoch))
            assert len(got) == len(want) == len(ref)
            for g, w in zip(got, want):
                assert set(g) == set(w)
                for k in w:
                    if torch.is_tensor(w[k]):
                        assert torch.equal(g[k], w[k]), k
                    elif isinstance(w[k], np.ndarray):
                        np.testing.assert_array_equal(g[k], w[k], err_msg=k)
                    else:
                        assert g[k] == w[k], k
        name = mp.decode_pool.name
    assert mp.decode_pool is None
    with pytest.raises(FileNotFoundError):
        shared_memory.SharedMemory(name=name)
