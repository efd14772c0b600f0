"""Port ``eval/heatmap_parser`` against JAX's on the same seeded scenes, on
the CPU: boxes and keypoints within 1e-5 px (the parse is comparisons,
top-k, gathers and a few float32 divides), the same top-k tie order on the
zero plateaus of peak-NMS'ed maps."""

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.eval import heatmap_parser as JH
from litehandnet_tpu.ops.encode import msra_heatmaps, region_map
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.eval import heatmap_parser as TH

TOL = 1e-5  # px


def _cfgs(img=256, hm=64):
    d = dict(DATASET=dict(num_joints=21, image_size=[img, img],
                          heatmap_size=[hm, hm]))
    return jax_cfg(d), config_from_dict(d)


def scene(hands, seed, img=256, hm=64, K=21, tag_channels=1):
    """Center, size, joint and tag maps of ``hands`` ((cx, cy, w, h) in
    image px), as JAX's ``tests/test_heatmap_parser.py`` builds them: one
    region map and MSRA joint maps per hand, a constant tag in each hand's
    region (noise in the per-joint tags)."""
    rng = np.random.RandomState(seed)
    center = np.zeros((hm, hm, 1), np.float32)
    size_m = np.zeros((hm, hm, 2), np.float32)
    joint_hm = np.zeros((hm, hm, K), np.float32)
    tag = np.zeros((hm, hm, tag_channels), np.float32)
    for n, (cx, cy, w, h) in enumerate(hands):
        bbox = np.array([cx - w / 2, cy - h / 2, w, h], np.float32)
        rm = np.asarray(region_map(bbox, (img, img), (hm, hm), 2.0))
        center[..., 0] = np.maximum(center[..., 0], rm[..., 0])
        size_m = np.maximum(size_m, rm[..., 1:])
        joints = np.stack([rng.uniform(cx - w * 0.3, cx + w * 0.3, K),
                           rng.uniform(cy - h * 0.3, cy + h * 0.3, K)],
                          axis=1).astype(np.float32)
        hm_i, _ = msra_heatmaps(joints, np.ones(K), (img, img), (hm, hm),
                                2.0, unbiased=True)
        joint_hm = np.maximum(joint_hm, np.asarray(hm_i))
        ys, xs = np.mgrid[0:hm, 0:hm]
        inside = ((np.abs(xs * img / hm - cx) < w * 0.7)
                  & (np.abs(ys * img / hm - cy) < h * 0.7))
        value = 1.0 + 4.0 * n + rng.uniform(-0.3, 0.3, tag.shape)
        tag = np.where(inside[..., None], value, tag).astype(np.float32)
    return center, size_m, joint_hm, tag


def batch(scenes):
    return [np.stack(parts) for parts in zip(*scenes)]


HANDS = [((60, 70, 90, 90), (180, 180, 80, 80)),
         ((128, 100, 120, 100),),
         ((40, 40, 60, 60), (200, 60, 70, 50), (120, 200, 90, 80)),
         ((8, 250, 40, 40), (250, 8, 30, 30))]   # boxes over the borders


@pytest.mark.parametrize("adjust", [True, False])
@pytest.mark.parametrize("tag_channels", [1, 21])
@pytest.mark.parametrize("bbox_k", [1, 3, 8])
def test_parse_matches_jax(adjust, tag_channels, bbox_k):
    maps = batch([scene(h, s, tag_channels=tag_channels)
                  for s, h in enumerate(HANDS)])
    jc, tc = _cfgs()
    want_boxes, want_kpts = JH.HeatmapParser(
        jc, max_num_bbox=4, bbox_k=bbox_k).parse(*maps, adjust=adjust)
    got_boxes, got_kpts = TH.HeatmapParser(
        tc, max_num_bbox=4, bbox_k=bbox_k, device="cpu").parse(
            *maps, adjust=adjust)
    assert got_boxes.shape == (4, 4, 5) and got_kpts.shape == (4, 4, 21, 4)
    assert (got_boxes[..., 4] > 0).sum() == 8
    np.testing.assert_allclose(got_boxes, want_boxes, rtol=0, atol=TOL)
    np.testing.assert_allclose(got_kpts, want_kpts, rtol=0, atol=TOL)


def test_parse_uses_pcfg_defaults():
    maps = batch([scene(HANDS[0], 0)])
    jc, tc = _cfgs()
    parser = TH.HeatmapParser(tc, device="cpu")
    assert (parser.num_candidates, parser.bbox_k, parser.max_num_bbox,
            parser.bbox_factor) == (10, 3, 1, 1.3)
    want = JH.HeatmapParser(jc).parse(*maps)
    for g, w in zip(parser.parse(*maps), want):
        np.testing.assert_allclose(g, w, rtol=0, atol=TOL)


def test_tie_order_on_plateaus_matches_jax():
    """Joint maps that are 0 nearly everywhere and per-cell random tags: the
    top-k of each window is mostly zero cells, so which cells fill it (lower
    flat index first) decides the keypoint."""
    rng = np.random.RandomState(7)
    B, H, W, K = 2, 16, 16, 5
    hm = np.zeros((B, H, W, K), np.float32)
    hm[0, 3, 4, 0] = 0.9
    hm[1, 10, 2, 3] = 0.5
    hm[1, 10, 3, 3] = 0.5          # a plateau of two peaks
    tags = rng.uniform(0, 2, (B, H, W, K)).astype(np.float32)
    boxes = np.array([[[32, 32, 40, 40, 0.9], [10, 50, 30, 20, 0.4]],
                      [[20, 40, 64, 64, 0.7], [40, 40, 8, 8, 0.0]]],
                     np.float32)
    for k in (1, 3, 6):
        want = np.asarray(JH._group_by_tags(hm, tags, boxes, 1.3, 4.0,
                                            bbox_k=k))
        got = TH._group_by_tags(torch.from_numpy(hm), torch.from_numpy(tags),
                                torch.from_numpy(boxes), 1.3, 4.0,
                                bbox_k=k).numpy()
        np.testing.assert_array_equal(got, want)
    # the box of confidence 0 gives a zero row
    assert not got[1, 1].any()


def test_adjust_quarter_matches_jax():
    rng = np.random.RandomState(8)
    hm = rng.uniform(0, 1, (2, 12, 10, 3)).astype(np.float32)
    hm[0, :, :, 1] = 0.5           # equal neighbours: strict > gives -0.25
    kp = np.concatenate([
        rng.uniform(-1, 11, (2, 4, 3, 2)),            # off the map, clamped
        rng.choice([0.0, 0.7], (2, 4, 3, 1)),          # conf 0 rows untouched
        rng.uniform(0, 1, (2, 4, 3, 1))], -1).astype(np.float32)
    want = np.asarray(JH._adjust_quarter(kp, hm))
    got = TH._adjust_quarter(torch.from_numpy(kp), torch.from_numpy(hm))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("adjust", [True, False])
def test_parse_single_matches_jax(adjust):
    rng = np.random.RandomState(3)
    hms = []
    for _ in range(3):
        joints = rng.uniform(8, 248, size=(21, 2)).astype(np.float32)
        hm_i, _ = msra_heatmaps(joints, np.ones(21), (256, 256), (64, 64),
                                2.0, unbiased=True)
        hms.append(np.asarray(hm_i))
    hms = np.stack(hms)
    jc, tc = _cfgs()
    want = JH.HeatmapParserSH(jc).parse_single(hms, adjust=adjust)
    got = TH.HeatmapParserSH(tc, device="cpu").parse_single(hms,
                                                            adjust=adjust)
    assert got.shape == (3, 21, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TH.HeatmapParser(_cfgs()[1])
