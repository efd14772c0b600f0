"""The port's ``data/device_pipeline.py`` against
``litehandnet_tpu.data.device_pipeline`` on the CPU: the bilinear gather,
the HSV round trip and ``hsv_augment`` with given gains, ``apply`` fed JAX's
own draws against JAX's whole train-mode call on every branch, and the
eval-mode call (which draws nothing) against JAX's."""

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.data import device_pipeline as JP
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data import device_pipeline as TP
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    PIXEL_ATOL,
    assert_pipeline_batch,
    jax_pipeline_draws,
    pipeline_coordinate_gap,
    pipeline_to_port_layout,
)

B, K = 6, 21
W, H = 48, 64                # crop (w, h)
CANVAS = (128, 96)           # (h, w), twice the crop as the loader makes it
FLIP_INDEX = list(range(K))[::-1]


def _cfg(**pipeline):
    model = pipeline.pop("model", {"name": "litehandnet"})
    hm = pipeline.pop("heatmap_size", [W // 4, H // 4])
    p = dict(flip_prob=0.5, rot_prob=0.6, rot_factor=40, scale_factor=0.3,
             use_udp=False, sigma=2, encoding="MSRA", unbiased_encoding=True,
             simdr_split_ratio=0)
    p.update(pipeline)
    return dict(MODEL=model,
                DATASET=dict(name="freihand", num_joints=K, image_size=[W, H],
                             heatmap_size=hm),
                PIPELINE=p)


def _inputs(seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, size=(B,) + CANVAS + (3,), dtype=np.uint8)
    centers = np.stack([rng.uniform(30, 66, B), rng.uniform(40, 88, B)],
                       -1).astype(np.float32)
    scales = (np.stack([np.full(B, W), np.full(B, H)], -1) / 200.0
              * rng.uniform(0.8, 1.3, (B, 1))).astype(np.float32)
    joints = (centers[:, None] + rng.uniform(-0.45, 0.45, (B, K, 2))
              * scales[:, None] * 200.0).astype(np.float32)
    vis = (rng.rand(B, K) > 0.1).astype(np.float32)
    rotations = rng.uniform(-20, 20, B).astype(np.float32)
    # bboxes off the crop center (see test_region_patch_at_the_crop_center)
    bboxes = np.concatenate([centers - rng.uniform(8, 22, (B, 2)),
                             rng.uniform(20, 40, (B, 2))], -1).astype(np.float32)
    return images, joints, vis, centers, scales, rotations, bboxes


BRANCHES = {
    "classic": {},
    "biased": dict(unbiased_encoding=False),
    "udp": dict(use_udp=True, encoding="UDP"),
    "stacked_sigma": dict(sigma=[2, 3, 4]),
    "multiscale_region": dict(
        model={"name": "srhandnet", "pred_bbox": True},
        heatmap_size=[[6, 8], [12, 16], [24, 32]], sigma=[2, 2, 3]),
    "region_gen1_simdr": dict(
        model={"name": "mynet_stacked", "with_region_map": True},
        simdr_split_ratio=2),
    "region_stacked_sigma": dict(
        model={"name": "hourglass", "pred_bbox": True}, sigma=[2, 3]),
    "simdr_k1": dict(simdr_split_ratio=1, unbiased_encoding=False),
}


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_apply_equals_jax_call(branch):
    d = _cfg(**BRANCHES[branch])
    jpipe = JP.DevicePipeline(jax_cfg(d), FLIP_INDEX, is_train=True)
    tpipe = TP.DevicePipeline(config_from_dict(d), FLIP_INDEX, is_train=True,
                              device="cpu")
    images, joints, vis, centers, scales, rotations, bboxes = _inputs()
    key = jax.random.PRNGKey(3)
    want = pipeline_to_port_layout(jpipe(images, joints, vis, centers, scales,
                                         rotations, key, bboxes=bboxes))
    params = jax_pipeline_draws(jpipe, key, B)
    flips = params["do_flip"].tolist()
    assert True in flips and False in flips, flips
    got = tpipe.apply(images, joints, vis, centers, scales, rotations, bboxes,
                      params)
    assert_pipeline_batch(got, want, pipeline_coordinate_gap(tpipe, centers, scales,
                                             rotations, params))


@pytest.mark.parametrize("branch", ["classic", "udp", "region_gen1_simdr"])
def test_eval_call_equals_jax_call(branch):
    d = _cfg(**BRANCHES[branch])
    jpipe = JP.DevicePipeline(jax_cfg(d), FLIP_INDEX, is_train=False)
    tpipe = TP.DevicePipeline(config_from_dict(d), FLIP_INDEX, is_train=False,
                              device="cpu")
    images, joints, vis, centers, scales, rotations, bboxes = _inputs(1)
    want = pipeline_to_port_layout(jpipe(
        images, joints, vis, centers, scales, rotations,
        jax.random.PRNGKey(0), bboxes=bboxes))
    got = tpipe(images, joints, vis, centers, scales, rotations, bboxes=bboxes)
    params = tpipe.sample_params(B)
    assert_pipeline_batch(got, want, pipeline_coordinate_gap(tpipe, centers, scales,
                                             rotations, params))


def test_sample_params_shapes_and_ranges():
    d = _cfg()
    pipe = TP.DevicePipeline(config_from_dict(d), FLIP_INDEX, device="cpu")
    p = pipe.sample_params(4096, torch.Generator().manual_seed(0))
    assert ((p["s_mult"] >= 0.7) & (p["s_mult"] <= 1.3)).all()
    assert (p["rot"].abs() <= 80).all()
    assert 0.3 < float((p["rot"] != 0).float().mean()) < 0.7  # rot_prob 0.6
    assert 0.45 < float(p["do_flip"].float().mean()) < 0.55
    g = p["hsv_gains"]
    assert torch.equal(g, torch.trunc(g))
    assert (g.abs() <= torch.tensor([5.0, 30.0, 30.0])).all()
    # each gain is gated off with p=1/2 (plus truncation of |gain| < 1)
    assert 0.45 < float((g == 0).float().mean()) < 0.65
    again = pipe.sample_params(4096, torch.Generator().manual_seed(0))
    assert all(torch.equal(p[k], again[k]) for k in p)


def test_bilinear_sample_off_the_border():
    rng = np.random.RandomState(5)
    image = rng.randint(0, 256, size=(2, 9, 7, 3), dtype=np.uint8)
    coords = rng.uniform(-2.5, 10.5, size=(2, 11, 13, 2)).astype(np.float32)
    got = TP._bilinear_sample(torch.from_numpy(image),
                              torch.from_numpy(coords[..., 0]),
                              torch.from_numpy(coords[..., 1]))
    want = np.stack([np.asarray(JP._bilinear_sample(
        image[b].astype(np.float32), coords[b])) for b in range(2)])
    assert (coords < 0).any() and (coords[..., 0] > 7).any()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PIXEL_ATOL)


def _rgb(seed, shape=(2, 17, 19, 3)):
    rng = np.random.RandomState(seed)
    img = rng.uniform(0, 255, size=shape).astype(np.float32)
    img[0, 0, :4] = [[0, 0, 0], [255, 255, 255], [10, 10, 10], [200, 0, 0]]
    return img


def test_hsv_round_trip_equals_jax():
    img = _rgb(6)
    h, s, v = TP._rgb_to_hsv_cv(torch.from_numpy(img))
    jh, js, jv = JP._rgb_to_hsv_cv(img)
    for got, want in ((h, jh), (s, js), (v, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-4)
    back = TP._hsv_to_rgb_cv(h, s, v)
    np.testing.assert_allclose(back.numpy(), np.asarray(
        JP._hsv_to_rgb_cv(jh, js, jv)), rtol=0, atol=PIXEL_ATOL)
    np.testing.assert_allclose(back.numpy(), img, rtol=0, atol=PIXEL_ATOL)


def test_hsv_augment_with_given_gains():
    img = _rgb(7)
    keys = jax.random.split(jax.random.PRNGKey(8), 2)

    def gains(k):
        k_gain, k_gate = jax.random.split(k)
        g = jax.random.uniform(k_gain, (3,), minval=-1.0, maxval=1.0) \
            * np.float32([5.0, 30.0, 30.0])
        gate = jax.random.randint(k_gate, (3,), 0, 2).astype(np.float32)
        return jax.numpy.trunc(g * gate)

    g = np.stack([np.asarray(gains(k)) for k in keys])
    want = np.stack([np.asarray(JP.hsv_augment(img[b], keys[b]))
                     for b in range(2)])
    got = TP.hsv_augment(torch.from_numpy(img), torch.from_numpy(g))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=PIXEL_ATOL)


def test_negative_hue_wraps_like_jax():
    img = np.float32([[[[255, 0, 40], [255, 40, 0], [0, 0, 255]]]])
    g = np.float32([[-5.0, 0.0, 0.0]])
    got = TP.hsv_augment(torch.from_numpy(img), torch.from_numpy(g))
    h, _, _ = TP._rgb_to_hsv_cv(torch.from_numpy(img))
    assert float(h.min()) >= 0.0 and float(h.max()) < 180.0
    want = np.asarray(JP._hsv_to_rgb_cv(*[
        (c + d) for c, d in zip(JP._rgb_to_hsv_cv(img[0]), (-5.0, 0.0, 0.0))]))
    np.testing.assert_allclose(got[0].numpy(), want, rtol=0, atol=PIXEL_ATOL)


def test_region_patch_at_the_crop_center():
    """A bbox centred on the crop's center (FreiHAND's whole-image bbox, or
    any record without center jitter) maps to the crop center, where the
    region patch's first row ``trunc(cy * stride - 2)`` is an integer in
    exact arithmetic: JAX and the port each round it to one side. Each edge
    of their patches then differs by one heatmap row or column at most, with
    the same value within 1e-6; everything else agrees."""
    d = _cfg(**BRANCHES["region_stacked_sigma"])
    jpipe = JP.DevicePipeline(jax_cfg(d), FLIP_INDEX, is_train=True)
    tpipe = TP.DevicePipeline(config_from_dict(d), FLIP_INDEX, is_train=True,
                              device="cpu")
    images, joints, vis, centers, scales, rotations, _ = _inputs()
    bboxes = np.concatenate([centers - 15.0, np.full((B, 2), 30.0)],
                            -1).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = pipeline_to_port_layout(jpipe(images, joints, vis, centers, scales,
                                         rotations, key, bboxes=bboxes))
    params = jax_pipeline_draws(jpipe, key, B)
    got = tpipe.apply(images, joints, vis, centers, scales, rotations, bboxes,
                      params)
    np.testing.assert_allclose(got["bbox"].numpy(), want["bbox"], rtol=0,
                               atol=1e-4)
    cy = (got["bbox"][:, 1] + got["bbox"][:, 3] / 2).numpy()
    np.testing.assert_allclose(cy, np.full(B, H / 2), rtol=0, atol=1e-4)
    t, w = got["target"].numpy(), want["target"]
    np.testing.assert_allclose(t[:, :, :K + 1], w[:, :, :K + 1], rtol=0,
                               atol=1e-5)
    shifted = 0
    for b in range(B):
        for c in (K + 1, K + 2):
            gt, wt = t[b, 0, c], w[b, 0, c]
            assert abs(gt.max() - wt.max()) <= 1e-6
            ig, iw = np.argwhere(gt > 0), np.argwhere(wt > 0)
            edges_g = np.concatenate([ig.min(0), ig.max(0)])
            edges_w = np.concatenate([iw.min(0), iw.max(0)])
            assert np.abs(edges_g - edges_w).max() <= 1
            shifted += int((edges_g != edges_w).any())
    assert shifted > 0  # the boundary is hit on these inputs
