"""The port's host transform pipeline (``litehandnet_tpu_torch/data/
transforms.py``) against the JAX package's, transform by transform and as
``build_train_pipeline``, on the same record and the same ``RandomState``
draws. Images and targets are held to the tolerances of
``tests/torch_parity.assert_pipeline_batch``: crops to ``PIXEL_ATOL`` plus
what the measured gap between the two frameworks' crop coordinates
explains, targets to ``TARGET_ATOL`` plus the joint gap. The port's targets
are ``[K, h, w]``, JAX's ``[h, w, K]``.

The HSV gains are drawn from a seed that both take from the
``RandomState``; JAX turns it into a PRNG key, the port into a torch
generator, so the gains differ: the HSV math is held to JAX's on the
port's gains, and in the whole pipeline JAX's ``hsv_augment`` is given the
port's gains for the same seed."""

import copy
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.data import device_pipeline as JDP
from litehandnet_tpu.data import transforms as J
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data import dataset_info as DI
from litehandnet_tpu_torch.data import transforms as T
from tests.torch_parity import (
    COORD_ULP,
    JOINT_ATOL,
    PIXEL_ATOL,
    TARGET_ATOL,
    one_torch_thread,  # noqa: F401  (autouse fixture)
    pipeline_coordinate_gap,
)

SIZE, HM, K = 64, 16, 21


@pytest.fixture
def record(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    path = tmp_path / "img.jpg"
    Image.fromarray(rng.randint(0, 255, (96, 80, 3), np.uint8)).save(path)
    joints = np.zeros((K, 3), np.float32)
    joints[:, :2] = rng.uniform(10, 70, (K, 2))
    vis = np.zeros((K, 3), np.float32)
    vis[:, :2] = (rng.rand(K) > 0.2)[:, None]
    info = DI.DatasetInfo(DI.freihand2d_info)
    return dict(
        image_file=str(path), joints_3d=joints, joints_3d_visible=vis,
        center=np.float32([40.0, 48.0]), scale=np.float32([0.35, 0.35]),
        rotation=0,
        ann_info=dict(image_size=np.array([SIZE, SIZE]),
                      heatmap_size=np.array([HM, HM]), num_joints=K,
                      flip_index=info.flip_index))


def jax_hsv(img, gains):
    """JAX's ``hsv_augment`` on given gains."""
    h, s, v = JDP._rgb_to_hsv_cv(jnp.asarray(img, jnp.float32))
    h = (h + gains[0]) % 180.0
    s = jnp.clip(s + gains[1], 0.0, 255.0)
    v = jnp.clip(v + gains[2], 0.0, 255.0)
    return np.asarray(JDP._hsv_to_rgb_cv(h, s, v))


def test_load_image(record):
    got = T.LoadImageFromFile()(dict(record))
    want = J.LoadImageFromFile()(dict(record))
    np.testing.assert_array_equal(got["img"], want["img"])
    assert got["img"].dtype == np.uint8 and got["img"].shape == (96, 80, 3)


def test_hsv_aug(record):
    img = T.LoadImageFromFile()(dict(record))["img"]
    rng_t, rng_j = np.random.RandomState(7), np.random.RandomState(7)
    got = T.HSVRandomAug(rng=rng_t)(dict(record, img=img.copy()))["img"]
    J.HSVRandomAug(rng=rng_j)(dict(record, img=img.copy()))
    # one integer drawn from the RandomState by each
    assert rng_t.randint(2**31) == rng_j.randint(2**31)
    gains = T.hsv_gains(np.random.RandomState(7).randint(2**31)).numpy()
    assert np.array_equal(gains, np.trunc(gains))
    assert (np.abs(gains) <= (5, 30, 30)).all()
    want_f = jax_hsv(img, gains)
    got_f = T.hsv_augment(torch.from_numpy(img.astype(np.float32))[None],
                          torch.from_numpy(gains)[None])[0].numpy()
    np.testing.assert_allclose(got_f, want_f, rtol=0, atol=PIXEL_ATOL)
    want = want_f.clip(0, 255).astype(np.uint8)
    # float32 rounding can put a value on the other side of an integer
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_random_flip(record, seed):
    rec = T.LoadImageFromFile()(dict(record))
    got = T.TopDownRandomFlip(0.5, np.random.RandomState(seed))(copy.deepcopy(rec))
    want = J.TopDownRandomFlip(0.5, np.random.RandomState(seed))(copy.deepcopy(rec))
    for k in ("img", "joints_3d", "joints_3d_visible", "center"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_scale_rotation(record, seed):
    args = (40, 0.3, 0.6)
    got = T.TopDownGetRandomScaleRotation(
        *args, rng=np.random.RandomState(seed))(dict(record))
    want = J.TopDownGetRandomScaleRotation(
        *args, rng=np.random.RandomState(seed))(dict(record))
    np.testing.assert_array_equal(got["scale"], want["scale"])
    assert got["rotation"] == want["rotation"]


def _assert_crop(got, want, rec, use_udp):
    pipe = types.SimpleNamespace(image_size=(SIZE, SIZE), use_udp=use_udp)
    params = {"rot": torch.tensor([float(rec["rotation"])]),
              "s_mult": torch.ones(1)}
    gap = pipeline_coordinate_gap(pipe, rec["center"][None].astype(np.float32),
                                  rec["scale"][None].astype(np.float32),
                                  None, params)
    assert gap < 1e-4, gap
    assert got["img"].shape == want["img"].shape == (SIZE, SIZE, 3)
    np.testing.assert_allclose(got["img"], want["img"], rtol=0,
                               atol=PIXEL_ATOL + 2 * 255.0 * (gap + COORD_ULP))
    np.testing.assert_allclose(got["joints_3d"], want["joints_3d"], rtol=0,
                               atol=JOINT_ATOL)


@pytest.mark.parametrize("rotation", [0.0, 27.5])
@pytest.mark.parametrize("use_udp", [False, True])
def test_affine(record, use_udp, rotation):
    rec = T.LoadImageFromFile()(dict(record, rotation=rotation))
    got = T.TopDownAffine(use_udp)(copy.deepcopy(rec))
    want = J.TopDownAffine(use_udp)(copy.deepcopy(rec))
    _assert_crop(got, want, rec, use_udp)


def test_to_tensor_and_normalize(record):
    img = np.random.RandomState(3).uniform(0, 255, (8, 8, 3)).astype(np.float32)
    for t, j in [(T.ToTensor(), J.ToTensor()),
                 (T.NormalizeTensor(), J.NormalizeTensor())]:
        np.testing.assert_array_equal(t(dict(img=img))["img"],
                                      j(dict(img=img))["img"])


@pytest.mark.parametrize("encoding,unbiased,sigma", [
    ("MSRA", False, 2), ("MSRA", True, 2), ("UDP", False, 2),
    ("MSRA", True, [3, 2]),
])
def test_generate_target(record, encoding, unbiased, sigma):
    got = T.TopDownGenerateTarget(sigma, encoding, unbiased)(dict(record))
    want = J.TopDownGenerateTarget(sigma, encoding, unbiased)(dict(record))
    wt = np.moveaxis(want["target"], -1, -3)   # [.., h, w, K] -> [.., K, h, w]
    assert got["target"].shape == wt.shape
    np.testing.assert_allclose(got["target"], wt, rtol=0, atol=TARGET_ATOL)
    np.testing.assert_array_equal(got["target_weight"], want["target_weight"])
    assert got["target"].max() > 0.5


@pytest.mark.parametrize("k", [0, 1, 2])
def test_generate_simdr(record, k):
    got = T.GenerateSimDR(2, k)(dict(record))
    want = J.GenerateSimDR(2, k)(dict(record))
    if k == 0:
        assert "simdr_x" not in got and "simdr_x" not in want
        return
    for key in ("simdr_x", "simdr_y"):
        np.testing.assert_allclose(got[key], want[key], rtol=0,
                                   atol=TARGET_ATOL)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
@pytest.mark.parametrize("branch", ["classic_simdr", "udp"])
def test_build_train_pipeline(record, monkeypatch, branch, seed):
    """The whole pipeline, with JAX's HSV on the port's gains (JAX's key
    for seed s is ``[0, s]``)."""
    monkeypatch.setattr(JDP, "hsv_augment", lambda img, key: jax_hsv(
        img, T.hsv_gains(int(np.asarray(key)[1])).numpy()))
    pipeline = dict(sigma=2, flip_prob=0.5, rot_factor=30, rot_prob=0.6,
                    scale_factor=0.25)
    if branch == "udp":
        pipeline.update(use_udp=True, encoding="UDP")
    else:
        pipeline.update(unbiased_encoding=True, simdr_split_ratio=2)
    d = dict(PIPELINE=pipeline)
    got_p = T.build_train_pipeline(config_from_dict(d), np.random.RandomState(seed))
    want_p = J.build_train_pipeline(jax_cfg(d), np.random.RandomState(seed))
    assert repr(got_p) == repr(want_p)
    got, want = got_p(copy.deepcopy(record)), want_p(copy.deepcopy(record))
    assert got["rotation"] == want["rotation"]
    np.testing.assert_array_equal(got["scale"], want["scale"])
    np.testing.assert_array_equal(got["center"], want["center"])
    gap = pipeline_coordinate_gap(
        types.SimpleNamespace(image_size=(SIZE, SIZE),
                              use_udp=branch == "udp"),
        got["center"][None].astype(np.float32),
        np.asarray(got["scale"], np.float32)[None], None,
        {"rot": torch.tensor([float(got["rotation"])]), "s_mult": torch.ones(1)})
    img_atol = (PIXEL_ATOL + 2 * 255.0 * (gap + COORD_ULP)) / (255.0 * 0.224)
    np.testing.assert_allclose(got["img"], want["img"], rtol=0, atol=img_atol)
    joint_gap = float(np.abs(got["joints_3d"] - want["joints_3d"]).max())
    assert joint_gap <= JOINT_ATOL
    np.testing.assert_allclose(got["target"],
                               np.moveaxis(want["target"], -1, -3), rtol=0,
                               atol=TARGET_ATOL + joint_gap)
    np.testing.assert_array_equal(got["target_weight"], want["target_weight"])
    for key in ("simdr_x", "simdr_y"):
        assert (key in got) == (key in want)
        if key in want:
            np.testing.assert_allclose(got[key], want[key], rtol=0,
                                       atol=TARGET_ATOL + joint_gap)
