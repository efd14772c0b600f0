"""Port decode (blur, blur_log, argmax/DARK/UDP decode, unwarp, SimDR,
TopDownDecoder) against the JAX package on the same numpy inputs, on the
CPU. The JAX Pallas ``blur_log`` runs in interpret mode here."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.eval.decoder import TopDownDecoder as JaxDecoder
from litehandnet_tpu.ops import blur as JB
from litehandnet_tpu.ops import decode as JD
from litehandnet_tpu.ops.affine import transform_preds as jax_transform_preds
from litehandnet_tpu.ops.encode import msra_heatmaps
from litehandnet_tpu.ops.pallas_kernels import blur_log as jax_blur_log
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.eval.decoder import TopDownDecoder
from litehandnet_tpu_torch.kernels.blur_log import blur_log, blur_log_reference
from litehandnet_tpu_torch.ops import blur as TB
from litehandnet_tpu_torch.ops import decode as TD
from litehandnet_tpu_torch.ops.affine import transform_preds
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    small_model_cfg,
)


def T(a):
    return torch.from_numpy(np.array(a))


def _encoded(B=4, K=21, size=256, hm=64, seed=0):
    """DARK-encoded maps (unbiased MSRA, sigma 2); the first joints of each
    image sit inside the kernel-11 halo of the border."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(24, size - 24, size=(B, K, 2)).astype(np.float32)
    stride = size / hm
    joints[:, 0] = rng.uniform(0, 5 * stride, size=(B, 2))             # top-left
    joints[:, 1] = size - 1 - rng.uniform(0, 5 * stride, size=(B, 2))  # bottom-right
    joints[:, 2, 0] = rng.uniform(0, 2 * stride, size=B)               # left edge
    encode = functools.partial(msra_heatmaps, image_size=(size, size),
                               heatmap_size=(hm, hm), sigma=2.0, unbiased=True)
    maps, _ = jax.vmap(encode)(joints, np.ones((B, K), np.float32))
    return np.asarray(maps, np.float32)


def _cs(B, seed=0):
    rng = np.random.RandomState(seed)
    center = rng.uniform(100, 300, size=(B, 2)).astype(np.float32)
    scale = rng.uniform(0.8, 2.0, size=(B, 2)).astype(np.float32)
    return center, scale


def _random_maps(shape, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, size=shape).astype(np.float32)


@pytest.mark.parametrize("shape", [(2, 32, 32, 21), (3, 17, 23, 5)])
def test_blur_log_matches_pallas_interpret(shape):
    hm = _random_maps(shape)
    want = np.asarray(jax_blur_log(hm, kernel=11))
    np.testing.assert_allclose(blur_log(T(hm), 11).numpy(), want,
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel", [3, 11, 19])
def test_blur_log_matches_xla_blur_then_log(kernel):
    """The function the JAX serve path computes with XLA ops
    (decode.py:106-107), including an all-zero map and border spikes."""
    hm = _random_maps((2, 24, 20, 6))
    hm[0, :, :, 0] = 0.0
    hm[1, :, :, 1] = 0.0
    hm[1, 0, 0, 1] = 1.0
    hm[1, 23, 19, 2] = 5.0
    want = np.log(np.maximum(np.asarray(JB.gaussian_blur(
        hm, kernel, border="constant", preserve_max=True)), 1e-10))
    np.testing.assert_allclose(blur_log(T(hm), kernel).numpy(), want,
                               rtol=1e-4, atol=1e-5)


def test_blur_log_takes_strided_views():
    """A [B, H, W, K] view of NCHW memory gives the same as a copy."""
    nchw = T(_random_maps((2, 5, 16, 16)))
    view = nchw.permute(0, 2, 3, 1)
    np.testing.assert_array_equal(blur_log(view).numpy(),
                                  blur_log(view.contiguous()).numpy())


def test_blur_log_rejects_bad_input():
    x = torch.zeros(1, 8, 8, 2)
    with pytest.raises(ValueError):
        blur_log(x, kernel=10)
    with pytest.raises(TypeError):
        blur_log(x.double())
    with pytest.raises(ValueError):
        blur_log(x[0])
    with pytest.raises(TypeError):
        blur_log(x.to("meta"))


def test_blur_log_plain_path_counts_no_launch():
    before = blur_log.launches
    blur_log(torch.ones(1, 8, 8, 2))
    blur_log_reference(torch.ones(1, 8, 8, 2))
    assert blur_log.launches == before


@pytest.mark.parametrize("ksize", [1, 3, 5, 7, 9, 11, 19])
def test_cv2_gaussian_kernel_tables(ksize):
    got = TB.cv2_gaussian_kernel(ksize, 0.0)
    np.testing.assert_array_equal(got, JB.cv2_gaussian_kernel(ksize, 0.0))
    assert got.dtype == np.float32 and abs(float(got.sum()) - 1.0) < 1e-6


@pytest.mark.parametrize("border,preserve_max", [
    ("constant", True), ("constant", False), ("reflect", False)])
def test_gaussian_blur_parity(border, preserve_max):
    hm = _random_maps((2, 20, 18, 4))
    want = np.asarray(JB.gaussian_blur(hm, 11, border, preserve_max))
    got = TB.gaussian_blur(T(hm), 11, border, preserve_max).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def _blur_scene(kind, shape=(2, 64, 64, 21), seed=3):
    """Maps of the kinds that showed a process-dependent plain blur: all
    zero, corner and border spikes on a zero field, and noise; at the
    serve decode's size, where torch splits an elementwise op over
    threads."""
    B, H, W, K = shape
    rng = np.random.RandomState(seed)
    hm = np.zeros(shape, np.float32)
    if kind == "spikes":
        hm[0, 0, 0, 0] = 1.0
        hm[0, H - 1, W // 2, 1] = 3.0
        hm[1, H // 2, W - 1, 2] = 0.5
        hm[1, H - 1, W - 1, 3] = 2.0
    elif kind == "noise":
        hm[:] = rng.uniform(0, 1, size=shape)
        hm[0, :, :, 0] = 0.0
    return hm


def _blur64(padded, taps):
    """Float64 valid-mode separable blur of padded maps [N, H, W]."""
    k = len(taps)
    t = taps.astype(np.float64)
    p = padded.astype(np.float64)
    h = sum(t[i] * p[:, :, i:i + p.shape[2] - k + 1] for i in range(k))
    return sum(t[i] * h[:, i:i + h.shape[1] - k + 1] for i in range(k))


@pytest.mark.parametrize("kernel", [11, 19])
@pytest.mark.parametrize("kind", ["zero", "spikes", "noise"])
def test_plain_blur_is_independent_of_the_cpu_conv_backend(kind, kernel):
    """``separable_blur`` and ``blur_log_reference`` give the same bits with
    oneDNN on and off, are within 1e-6 relative of a float64 blur (the log
    values within 3e-6 of the float64 blur's: a few float32 roundings of
    the sum and one of the log), and are exactly 0 (log 1e-10) where every
    tap reads a 0."""
    hm = _blur_scene(kind)
    B, H, W, K = hm.shape
    pad = kernel // 2
    maps = hm.transpose(0, 3, 1, 2).reshape(B * K, H, W)
    padded = np.pad(maps, ((0, 0), (pad, pad), (pad, pad)))
    taps = TB.cv2_gaussian_kernel(kernel, 0.0)
    want = _blur64(padded, taps)
    zero = want == 0.0
    scale = maps.max(axis=(1, 2), keepdims=True).astype(np.float64) \
        / np.maximum(want.max(axis=(1, 2), keepdims=True), 1e-20)
    want_log = np.log(np.maximum(want * scale, 1e-10))
    runs = []
    saved = torch.backends.mkldnn.enabled, torch.get_num_threads()
    torch.set_num_threads(4)   # elementwise ops split over threads
    try:
        for enabled in (True, False):
            torch.backends.mkldnn.enabled = enabled
            blurred = TB.separable_blur(T(padded), taps).numpy()
            logs = blur_log_reference(T(hm), kernel).numpy()
            runs.append((blurred, logs))
    finally:
        torch.backends.mkldnn.enabled = saved[0]
        torch.set_num_threads(saved[1])
    for blurred, logs in runs:
        np.testing.assert_allclose(blurred, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
        assert np.all(blurred[zero] == 0.0)
        floor = np.float32(np.log(np.float32(1e-10)))
        logs_bkhw = logs.transpose(0, 3, 1, 2).reshape(B * K, H, W)
        assert np.all(logs_bkhw[zero] == floor)
        np.testing.assert_allclose(logs_bkhw, want_log, rtol=0, atol=3e-6)
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][1], runs[1][1])


def test_argmax_ties_and_empty_maps():
    hm = np.zeros((1, 4, 5, 3), np.float32)
    hm[0, 1, 3, 0] = hm[0, 2, 0, 0] = 0.5   # tie: first flat index wins
    hm[0, :, :, 2] = -1.0                     # max <= 0 -> -1
    want_p, want_v = JD.argmax_coords(hm)
    got_p, got_v = TD.argmax_coords(T(hm))
    np.testing.assert_array_equal(got_p.numpy(), np.asarray(want_p))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    assert got_p[0, 0].tolist() == [3.0, 1.0]
    assert got_p[0, 1].tolist() == got_p[0, 2].tolist() == [-1.0, -1.0]


DECODES = [
    dict(post_process=None), dict(post_process="default"),
    dict(post_process="unbiased", kernel=11),
    dict(post_process="unbiased", use_udp=True, kernel=3),
]


@pytest.mark.parametrize("kw", DECODES,
                         ids=["argmax", "default", "dark", "udp"])
@pytest.mark.parametrize("maps", ["encoded", "random", "zero"])
def test_keypoints_from_heatmaps_parity(kw, maps):
    if maps == "encoded":
        hm = _encoded()
    elif maps == "random":
        hm = _random_maps((2, 16, 16, 21))
    else:
        hm = np.zeros((2, 16, 16, 21), np.float32)
    center, scale = _cs(hm.shape[0])
    want = JD.keypoints_from_heatmaps(hm, center, scale, **kw)
    got = TD.keypoints_from_heatmaps(T(hm), T(center), T(scale), **kw)
    # on noise, DARK's Newton step meets near-singular Hessians that scale
    # float32 rounding of the log values up to ~1e-4 relative
    rtol = 1e-3 if maps == "random" else 1e-4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=rtol, atol=1e-4)
    if maps == "zero" and not kw.get("use_udp"):
        assert (got[0] == -1.0).all()


def test_dark_refines_encoded_interior_joints():
    """On encoded maps DARK recovers interior centers to well under a
    heatmap pixel (the kernel-11 halo of the border excluded)."""
    hm = _encoded(B=2, K=21, seed=3)
    center, scale = _cs(2)
    hm_preds, _, _ = TD.keypoints_from_heatmaps(
        T(hm), T(center), T(scale), post_process="unbiased", kernel=11)
    argmax, _ = TD.argmax_coords(T(hm))
    interior = hm_preds[:, 3:]
    assert (interior - argmax[:, 3:]).abs().max() <= 0.5 + 1e-6
    np.testing.assert_allclose(hm_preds.numpy(), np.asarray(
        JD.keypoints_from_heatmaps(hm, center, scale, post_process="unbiased",
                                   kernel=11)[0]), atol=1e-4)


def test_dark_conditioning():
    """Encoded interior joints are well conditioned, and the step length is
    the distance ``refine_dark`` moves them; a map lifted far above zero
    (a flat log) and an empty map are not."""
    hm = T(_encoded(B=2, K=21, seed=3))
    well, det, step = TD.dark_conditioning(hm)
    assert well[:, 3:].all() and (det[:, 3:] >= TD.DARK_COND_DET).all()
    argmax, _ = TD.argmax_coords(hm)
    moved = (TD.refine_dark(hm, argmax) - argmax).norm(dim=-1)
    np.testing.assert_allclose(step[:, 3:].numpy(), moved[:, 3:].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert not TD.dark_conditioning(hm + 100.0)[0].any()
    assert not TD.dark_conditioning(torch.zeros_like(hm))[0].any()


@pytest.mark.parametrize("use_udp", [False, True])
def test_transform_preds_parity(use_udp):
    rng = np.random.RandomState(0)
    coords = rng.uniform(0, 64, size=(3, 21, 2)).astype(np.float32)
    center, scale = _cs(3)
    want = np.asarray(jax_transform_preds(coords, center, scale, (64, 48), use_udp))
    got = transform_preds(T(coords), T(center), T(scale), (64, 48), use_udp)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_keypoints_from_simdr_parity():
    rng = np.random.RandomState(0)
    x = rng.uniform(size=(2, 21, 128)).astype(np.float32)
    y = rng.uniform(size=(2, 21, 96)).astype(np.float32)
    center, scale = _cs(2)
    want = np.asarray(JD.keypoints_from_simdr(x, y, center, scale, 2))
    got = TD.keypoints_from_simdr(T(x), T(y), T(center), T(scale), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-4)


def test_top_down_decoder_parity():
    d = small_model_cfg()
    hm = _encoded(B=3)
    center, scale = _cs(3)
    meta = dict(center=center, scale=scale, bbox_id=np.arange(3),
                image_file=["a", "b", "c"])
    want = JaxDecoder(jax_cfg(d)).decode(meta, hm)
    got = TopDownDecoder(config_from_dict(d), device="cpu").decode(meta, hm)
    assert sorted(got) == sorted(want)
    for key in ("preds", "hm_preds", "boxes", "output_heatmap"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4,
                                   err_msg=key)
    assert got["image_paths"] == want["image_paths"]
    assert got["bbox_ids"] == want["bbox_ids"]
