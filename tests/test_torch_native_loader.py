"""The port's native JPEG ROI decoder (``litehandnet_tpu_torch/native``)
against JAX's ``litehandnet_tpu/native``, as ``tests/test_native_loader.py``
holds JAX's: the two builds of the same source decode bit for bit alike; the
port's native decode keeps ``_load_image``'s geometry exactly and its pixels
within that test's tolerances; ``DataLoader(use_native=True)`` equals
``use_native=False`` to them, in this process and in decode workers; an
image it cannot decode takes the Python path."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from litehandnet_tpu import native as jax_native
from litehandnet_tpu_torch import native
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data.image_io import _load_image
from litehandnet_tpu_torch.data.loader import DataLoader
from litehandnet_tpu_torch.data.mp_decode import ProcessDecodePool


@pytest.fixture(autouse=True)
def native_decoders():
    """Both builds, made (or found) when a test first needs them."""
    if not (native.available() and jax_native.available()):
        pytest.skip("native decoder unavailable (no g++/libjpeg)")


@pytest.fixture(scope="module")
def imgdir(tmp_path_factory):
    from PIL import Image

    d = tmp_path_factory.mktemp("native_imgs")
    rng = np.random.RandomState(7)

    def smooth(w, h):
        base = rng.randint(0, 255, (32, 32, 3), np.uint8)
        return np.asarray(
            Image.fromarray(base).resize((w, h), Image.BILINEAR), np.uint8)

    Image.fromarray(smooth(300, 260)).save(d / "small.jpg", quality=92)
    Image.fromarray(smooth(1280, 960)).save(d / "big.jpg", quality=92)
    Image.fromarray(smooth(640, 480)).save(d / "mid.png")
    Image.fromarray(smooth(200, 200)).convert("L").save(d / "gray.jpg",
                                                         quality=92)
    return d


def _roi(center, scale, margin=1.0):
    if center is None:
        return np.zeros((1, 2), np.float32), np.float32([-1.0])
    wxy = np.asarray(scale, np.float32) * 200.0 * margin
    half = float(np.hypot(wxy[0], wxy[1])) / 2.0 + 4.0
    return np.asarray([center], np.float32), np.float32([half])


# (image, canvas, center, scale): full fit, far-corner ROI, full downscale,
# the direct path's iMCU spill, grayscale
_WX = (31.0 - 4.0) * 2.0 / np.sqrt(2.0) / 200.0
CASES = [("small.jpg", (512, 512), None, None),
         ("big.jpg", (512, 512), [900, 700], [1.2, 1.2]),
         ("big.jpg", (512, 512), [640, 480], [10.0, 10.0]),
         ("small.jpg", (64, 64), [36, 50], [_WX, _WX]),
         ("gray.jpg", (512, 512), None, None)]
IDS = ["fit", "roi", "downscale", "spill", "gray"]


@pytest.mark.parametrize("name,canvas,center,scale", CASES, ids=IDS)
def test_decode_equals_jax_native_bit_for_bit(imgdir, name, canvas, center,
                                              scale):
    centers, halves = _roi(center, scale)
    got = native.decode_roi_batch([str(imgdir / name)], canvas, centers,
                                  halves, n_threads=2)
    want = jax_native.decode_roi_batch([str(imgdir / name)], canvas,
                                       centers, halves, n_threads=2)
    assert got[3][0] == 0
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("name,canvas,center,scale", CASES, ids=IDS)
def test_decode_keeps_the_python_geometry(imgdir, name, canvas, center,
                                          scale):
    """Offsets and scales exactly ``_load_image``'s; pixels exact where the
    whole image fits, else within the chroma block edges (max 8, mean 0.1)
    or, after the two-stage downscale, mean 3 and correlation 0.98."""
    path = str(imgdir / name)
    ref, roff, rsc = _load_image(
        path, canvas,
        center=None if center is None else np.float32(center),
        scale=None if scale is None else np.float32(scale), margin=1.0)
    canv, off, sc, st = native.decode_roi_batch([path], canvas,
                                                *_roi(center, scale),
                                                n_threads=2)
    assert st[0] == 0
    np.testing.assert_array_equal(off[0], roff)
    np.testing.assert_array_equal(sc[0], rsc)
    d = np.abs(canv[0].astype(int) - ref.astype(int))
    if name == "small.jpg" and center is None:
        np.testing.assert_array_equal(canv[0], ref)
    elif name == "gray.jpg":
        assert d.max() <= 2
    elif sc[0][0] < 1.0:
        assert d.mean() < 3.0
        assert np.corrcoef(canv[0].reshape(-1).astype(np.float32),
                           ref.reshape(-1).astype(np.float32))[0, 1] > 0.98
    else:
        assert d.max() <= 8 and d.mean() < 0.1


def test_png_reports_a_status(imgdir):
    *_, st = native.decode_roi_batch([str(imgdir / "mid.png")], (512, 512),
                                     *_roi(None, None))
    assert st[0] != 0


def test_library_is_built_beside_the_package_not_in_it():
    path = native.library_path()
    assert os.path.isfile(path)
    assert os.path.dirname(path) == native.BUILD_DIR
    assert native.BUILD_DIR.endswith(os.path.join("build",
                                                  "litehandnet_tpu_torch"))
    pkg = os.path.dirname(native.__file__)
    assert not [f for f in os.listdir(pkg) if f.endswith(".so")]


def test_disabled_native_is_unavailable():
    code = ("from litehandnet_tpu_torch import native, data; "
            "import sys; print(native.available(), "
            "'torch' in sys.modules)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ, LHN_DISABLE_NATIVE="1"))
    assert out.stdout.split() == ["False", "False"], out.stderr


def _mixed_dataset(tmp_path):
    """Eight images, JPEGs and one PNG, half larger than the canvas."""
    from PIL import Image

    rng = np.random.RandomState(3)
    images, annotations = [], []
    for i in range(8):
        w, h = (640, 480) if i % 2 else (320, 320)
        ext = "png" if i == 5 else "jpg"
        base = rng.randint(0, 255, (24, 24, 3), np.uint8)
        arr = np.asarray(Image.fromarray(base).resize((w, h), Image.BILINEAR),
                         np.uint8)
        fn = f"{i:03d}.{ext}"
        Image.fromarray(arr).save(tmp_path / fn,
                                  **(dict(quality=92) if ext == "jpg" else {}))
        images.append(dict(id=i, file_name=fn, width=w, height=h))
        kpts = [v for x, y in rng.uniform(0.25, 0.75, (21, 2)) * [w, h]
                for v in (float(x), float(y), 1)]
        annotations.append(dict(
            id=i, image_id=i, category_id=1, iscrowd=0, keypoints=kpts,
            bbox=[w * 0.2, h * 0.2, w * 0.6, h * 0.6], area=w * h * 0.36))
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=annotations,
                                   categories=[dict(id=1, name="hand")])))
    return config_from_dict(dict(
        MODEL=dict(name="litehandnet", output_channel=21),
        DATASET=dict(name="freihand", num_joints=21, image_size=[256, 256],
                     heatmap_size=[64, 64],
                     test=dict(ann_file=str(ann),
                               img_prefix=str(tmp_path) + os.sep)),
        PIPELINE=dict(flip_prob=0, rot_prob=0, scale_factor=0, sigma=2,
                      encoding="MSRA"),
        TRAIN=dict(batch_per_gpu=8), EVAL=dict(metric=["PCK"])))


GEOMETRY = ("joints_canvas", "center_canvas", "scale_canvas", "offset",
            "img_scale")


@pytest.mark.parametrize("decode_procs", [0, 2])
def test_dataloader_native_matches_python(tmp_path, decode_procs):
    cfg = _mixed_dataset(tmp_path)

    def grab(use_native):
        with DataLoader(cfg, "test", batch_size=8, use_device_pipeline=False,
                        num_workers=2, drop_last=False,
                        decode_procs=decode_procs,
                        use_native=use_native) as loader:
            assert loader.use_native == use_native
            return next(iter(loader.batches(0)))

    b_nat, b_py = grab(True), grab(False)
    for k in GEOMETRY:
        np.testing.assert_allclose(b_nat[k], b_py[k], rtol=0, atol=1e-5,
                                   err_msg=k)
    d = np.abs(b_nat["img_raw"].astype(np.float32)
               - b_py["img_raw"].astype(np.float32))
    assert d.mean() < 3.0
    # the PNG took the Python path inside the native batch: exact
    np.testing.assert_array_equal(b_nat["img_raw"][5], b_py["img_raw"][5])


def test_dataloader_defaults_to_the_native_decoder(tmp_path):
    cfg = _mixed_dataset(tmp_path)
    loader = DataLoader(cfg, "test", batch_size=8, use_device_pipeline=False)
    assert loader.use_native is True


def test_pool_native_decode_equals_in_process_native(imgdir):
    paths = [str(imgdir / n) for n in
             ("small.jpg", "big.jpg", "mid.png", "gray.jpg")]
    centers = np.float32([[150, 130], [640, 480], [320, 240], [100, 100]])
    scales = np.float32([[0.8, 0.7], [2.0, 1.5], [1.0, 1.0], [0.5, 0.5]])
    canvas, margin = (128, 128), 1.1
    wxy = scales * 200.0 * margin
    halves = (np.hypot(wxy[:, 0], wxy[:, 1]) / 2.0 + 4.0).astype(np.float32)
    want = native.decode_roi_batch(paths, canvas, centers, halves)
    pool = ProcessDecodePool(2, 4, canvas, roi_margin=margin)
    try:
        canv, off, fsc = pool.decode(paths, centers, scales)
        for i in (0, 1, 3):
            np.testing.assert_array_equal(canv[i], want[0][i])
            np.testing.assert_array_equal(off[i], want[1][i])
            np.testing.assert_array_equal(fsc[i], want[2][i])
        ref = _load_image(paths[2], canvas, center=centers[2],
                          scale=scales[2], margin=margin)
        np.testing.assert_array_equal(canv[2], ref[0])   # the PNG
    finally:
        pool.close()
