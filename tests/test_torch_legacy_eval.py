"""Gen-1 evaluation (``eval/legacy_eval.py`` and ``eval/ap.py``) against the
JAX package on the same numpy inputs, on the CPU: PCK, NMS and AP equal
(rtol 1e-6), candidate boxes within rtol 1e-5 (window means summed in
another order), including the Gen-1 scale bridge's ground-truth round trip
and a tie-heavy center map."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.eval import ap as JAP
from litehandnet_tpu.eval import legacy_eval as J
from litehandnet_tpu.ops.encode import region_map as jax_region_map
from litehandnet_tpu_torch.eval import ap as TAP
from litehandnet_tpu_torch.eval import legacy_eval as T
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize("weights", [True, False])
def test_heatmap_pck(weights):
    rng = np.random.RandomState(0)
    B, K, H, W = 4, 21, 32, 32
    pred = rng.uniform(0, 1, (B, H, W, K)).astype(np.float32)
    gt = rng.uniform(0, 1, (B, H, W, K)).astype(np.float32)
    pred[0, ..., 3] = -pred[0, ..., 3]   # max <= 0: coordinates zeroed
    gt[1, ..., 5] = 0.0
    bbox = rng.uniform(40, 200, (B, 2, 4)).astype(np.float32)
    tw = ((rng.uniform(size=(B, K, 1)) > 0.25).astype(np.float32)
          if weights else None)
    kw = dict(image_size=128, target_weight=tw, thr=0.2 if weights else 0.3)
    assert T.heatmap_pck(pred, gt, bbox, **kw) == pytest.approx(
        J.heatmap_pck(pred, gt, bbox, **kw), rel=1e-6)


@pytest.mark.parametrize("case", ["uniform", "ties", "sigma3"])
def test_cs_from_region_map(case):
    rng = np.random.RandomState(1)
    region = rng.uniform(0, 1, (2, 48, 48, 3)).astype(np.float32)
    sigma = 3 if case == "sigma3" else 2
    if case == "ties":   # a quantized center map: most values tied
        region[..., 0] = np.round(region[..., 0] * 4) / 4
    want = np.asarray(J.cs_from_region_map(jnp.asarray(region), 192.0, 8,
                                           0.9, heatmap_sigma=sigma))
    got = T.cs_from_region_map(region, 192.0, 8, 0.9, heatmap_sigma=sigma)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_non_max_suppression():
    rng = np.random.RandomState(2)
    cands = rng.uniform(0, 1, (3, 12, 5)).astype(np.float32)
    cands[..., :2] = rng.uniform(20, 200, (3, 12, 2))
    cands[..., 2:4] = rng.uniform(5, 120, (3, 12, 2))
    cands[0, 3, 2] = 1.0      # too narrow: the size gate
    cands[1, :, 4] = 0.05     # nothing above the threshold: None
    cands[2, 4, 4] = cands[2, 7, 4]   # tied confidences
    want = J.non_max_suppression(cands, 0.6, 0.1, 4)
    got = T.non_max_suppression(cands, 0.6, 0.1, 4)
    assert [g is None for g in got] == [w is None for w in want] == [
        False, True, False]
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(np.array(g), np.array(w))


def test_evaluate_ap_gt_round_trip_through_the_scale_bridge():
    """Ground-truth Gen-1 region maps (ratio w/h over the ±3σ patch) times
    the heatmap size, as ``evaluate_multihand_pck`` hands them over, score
    AP50 1.0 in both packages; unbridged they score 0."""
    size, hm = 64, 32
    bboxes = np.array([[8.0, 8.0, 48.0, 48.0], [20.0, 12.0, 24.0, 40.0]],
                      np.float32)
    maps = np.stack([np.asarray(jax_region_map(
        jnp.asarray(b), (size, size), (hm, hm), 2.0, patch="gen1"))
        for b in bboxes])
    bridged = maps.copy()
    bridged[..., 1:] *= np.float32(hm)
    gt = [[[b[0] + b[2] / 2, b[1] + b[3] / 2, b[2], b[3]]] for b in bboxes]
    for region, want_ap50 in ((bridged, 1.0), (maps, 0.0)):
        ap50, ap, preds = T.evaluate_ap(torch.from_numpy(region), gt, size)
        j50, jap, jpreds = J.evaluate_ap(region, gt, size)
        assert (ap50, ap) == pytest.approx((j50, jap), rel=1e-6)
        assert ap50 == want_ap50
        assert [p is None for p in preds] == [q is None for q in jpreds]
        for p, q in zip(preds, jpreds):
            if q is not None:
                np.testing.assert_allclose(np.array(p), np.array(q),
                                           rtol=1e-5)


def test_count_ap():
    rng = np.random.RandomState(3)
    gt = [rng.uniform(20, 200, (n, 4)).tolist() for n in (2, 1, 3, 0)]
    preds = []
    for g in gt:
        rows = [list(np.asarray(b) + rng.normal(0, 6, 4)) + [rng.uniform()]
                for b in g] + [[100, 100, 30, 30, 0.3]]
        preds.append(np.array(rows, np.float32))
    preds[1] = None
    preds[2][0, 4] = 0.0        # padding row
    for thr in (None, 0.5, [0.5, 0.75]):
        assert TAP.count_ap(preds, gt, thr) == pytest.approx(
            JAP.count_ap(preds, gt, thr), rel=1e-6, abs=1e-9)
    assert TAP.count_ap([None, None], gt[:2]) == (0.0, 0.0)
