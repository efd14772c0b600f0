"""Center-map detection ops (``ops/detect.py``) and the Gen-1 offset
refinement (``ops/decode.refine_offset_gen1``) against the JAX package on
the same numpy inputs, float32 on the CPU (``blur_log`` runs as its plain
twin here). Exact where the op only selects or compares (peak NMS, top-k,
the NMS's keep set); coordinates within 1e-4 input px (1e-5 heatmap px at
stride 4 and beyond: DARK's Newton step on Gaussian peaks); box sizes and
IoUs at rtol 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.ops import decode as JD
from litehandnet_tpu.ops import detect as J
from litehandnet_tpu.ops.encode import msra_heatmaps as jax_msra
from litehandnet_tpu_torch.ops import decode as TD
from litehandnet_tpu_torch.ops import detect as T
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)


def _t(a):
    return torch.from_numpy(np.array(a))


def _center_scene(B=2, H=48, W=48, seed=0, plateau=False):
    """Center maps ``[B, H, W, 1]`` of Gaussian peaks of distinct heights on
    zero, and U(0.5, 8) size maps ``[B, H, W, 2]``; ``plateau`` adds a flat
    top two cells wide (equal maxima in one NMS window)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    center = np.zeros((B, H, W, 1), np.float32)
    for b in range(B):
        for i, (py, px) in enumerate([(10, 12), (30, 8), (22, 35), (40, 40)]):
            amp = 0.95 - 0.17 * i + 0.01 * b
            g = amp * np.exp(-((xx - px) ** 2 + (yy - py) ** 2) / 12.5)
            center[b, ..., 0] += np.where(g > 1e-3, g, 0.0)
    if plateau:
        center[:, 20, 20:22, 0] = 0.5
    size = rng.uniform(0.5, 8.0, (B, H, W, 2)).astype(np.float32)
    return center, size


@pytest.mark.parametrize("kernel", [3, 11])
def test_heatmap_nms(kernel):
    center, _ = _center_scene(plateau=True)
    x = np.concatenate([center, center[..., ::-1] * 0.5], axis=-1)
    want = np.asarray(J.heatmap_nms(jnp.asarray(x), kernel))
    np.testing.assert_array_equal(T.heatmap_nms(_t(x), kernel).numpy(), want)


def test_vector_and_avg_pool():
    rng = np.random.RandomState(1)
    v = rng.randint(0, 6, (2, 21, 40)).astype(np.float32)  # many equal
    np.testing.assert_array_equal(
        T.vector_nms(_t(v), 5).numpy(), np.asarray(J.vector_nms(v, 5)))
    x = rng.uniform(size=(2, 16, 12, 2)).astype(np.float32)
    np.testing.assert_allclose(T.smooth_avg_pool(_t(x), 3).numpy(),
                               np.asarray(J.smooth_avg_pool(x, 3)),
                               rtol=1e-6, atol=1e-7)


def test_top_k_ties_in_jax_order():
    """A peak-NMS'ed map is mostly zeros: among equal values ``top_k``
    returns the lower flat index first, as ``jax.lax.top_k`` does."""
    rng = np.random.RandomState(2)
    x = np.zeros((3, 400), np.float32)
    x[:, rng.choice(400, 12, replace=False)] = 0.5       # a tied level
    x[:, rng.choice(400, 3, replace=False)] = rng.uniform(0.6, 1.0, 3)
    for k in (5, 20, 40):
        want_v, want_i = jax.lax.top_k(jnp.asarray(x), k)
        got_v, got_i = T.top_k(_t(x), k)
        np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
        np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("refine", ["dark", "offset", "none"])
@pytest.mark.parametrize("plateau", [False, True], ids=["peaks", "plateau"])
def test_candidate_bboxes(refine, plateau):
    """Peak-NMS'ed center map with fewer peaks than candidates (the rest are
    zeros, taken in index order), w/h at the raw cell, centers refined as
    the keypoints are (DARK at 19 taps)."""
    center, size = _center_scene(plateau=plateau)
    nmsed = np.asarray(J.heatmap_nms(jnp.asarray(center), 11))
    kw = dict(num_candidates=10, feature_stride=4.0, refine=refine, kernel=19)
    want = np.asarray(J.candidate_bboxes(jnp.asarray(nmsed),
                                         jnp.asarray(size), **kw))
    got = T.candidate_bboxes(_t(nmsed), _t(size), **kw).numpy()
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got[..., 2:4], want[..., 2:4], rtol=1e-5)
    np.testing.assert_array_equal(got[..., 4], want[..., 4])
    # image-size w/h scale and a clip, as ResultParser and HeatmapParser
    kw.update(wh_scale=(192.0, 160.0), wh_clip=(0.0, 0.99))
    want = np.asarray(J.candidate_bboxes(
        jnp.asarray(nmsed), jnp.asarray(size / 8.0),
        **dict(kw, wh_scale=jnp.asarray(kw["wh_scale"]))))
    got = T.candidate_bboxes(_t(nmsed), _t(size / 8.0), **kw).numpy()
    np.testing.assert_allclose(got[..., 2:4], want[..., 2:4], rtol=1e-5)


def _boxes(seed, n=6):
    rng = np.random.RandomState(seed)
    b = np.concatenate([rng.uniform(20, 100, (2, n, 2)),
                        rng.uniform(1, 60, (2, n, 2))], axis=-1)
    return b.astype(np.float32)


@pytest.mark.parametrize("variant", ["iou", "giou", "diou", "ciou", "xyxy"])
def test_bbox_iou(variant):
    b = _boxes(3)
    box1, boxes2 = b[0, 0], b[1]
    if variant == "xyxy":
        box1, boxes2 = np.asarray(J.xywh2xyxy(box1)), np.asarray(J.xywh2xyxy(boxes2))
    kw = {variant: True} if variant != "iou" and variant != "xyxy" else {}
    kw["xyxy"] = variant == "xyxy"
    want = np.asarray(J.bbox_iou(jnp.asarray(box1), jnp.asarray(boxes2), **kw))
    got = T.bbox_iou(_t(box1), _t(boxes2), **kw).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("max_out", [3, 10])
def test_masked_nms(max_out):
    """Overlapping, tiny and low-confidence boxes, two confidences tied."""
    b = _boxes(4, n=8)
    conf = np.random.RandomState(5).uniform(0.05, 1.0, (2, 8)).astype(np.float32)
    conf[:, 3] = conf[:, 1]
    b[:, 2] = b[:, 0] + np.float32(1.5)       # near-duplicates of box 0
    b[0, 5, 2:4] = 1.0                        # too small
    cand = np.concatenate([b, conf[..., None]], axis=-1)
    want = np.asarray(J.masked_nms(jnp.asarray(cand), 0.4, 0.1, max_out))
    got = T.masked_nms(_t(cand), 0.4, 0.1, max_out).numpy()
    np.testing.assert_array_equal(got, want)


def test_box_helpers():
    b = _boxes(6)
    xyxy = np.asarray(J.xywh2xyxy(b))
    np.testing.assert_allclose(T.xywh2xyxy(_t(b)).numpy(), xyxy, rtol=1e-6)
    np.testing.assert_allclose(T.xyxy2xywh(_t(xyxy)).numpy(),
                               np.asarray(J.xyxy2xywh(xyxy)), rtol=1e-6)
    np.testing.assert_array_equal(T.clip_boxes(_t(xyxy), 90.0, 70.0).numpy(),
                                  np.asarray(J.clip_boxes(xyxy, 90.0, 70.0)))
    np.testing.assert_array_equal(T.rescale_boxes(_t(xyxy), 0.5).numpy(),
                                  np.asarray(J.rescale_boxes(xyxy, 0.5)))
    np.testing.assert_array_equal(T.flip_boxes(_t(xyxy), 128.0).numpy(),
                                  np.asarray(J.flip_boxes(xyxy, 128.0)))


@pytest.mark.parametrize("half_shift", [True, False])
def test_refine_offset_gen1(half_shift):
    """Gaussian peaks, some on the border (clamped neighbours), plus
    argmax -1 of an all-zero map."""
    rng = np.random.RandomState(7)
    joints = rng.uniform(0, 63, (2, 21, 2)).astype(np.float32)
    joints[0, :3] = [[0.0, 10.0], [63.0, 63.0], [30.0, 0.0]]
    hm = np.stack([np.asarray(jax_msra(j, np.ones(21), (256, 256), (64, 64),
                                       2.0, unbiased=True)[0]) for j in joints])
    hm[1, ..., 4] = 0.0
    preds, _ = JD.argmax_coords(jnp.asarray(hm))
    want = np.asarray(JD.refine_offset_gen1(jnp.asarray(hm), preds, half_shift))
    got = TD.refine_offset_gen1(_t(hm), _t(np.asarray(preds)), half_shift)
    np.testing.assert_array_equal(got.numpy(), want)
