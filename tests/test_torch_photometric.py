"""Port ``ops/photometric`` against JAX's on the same seeded numpy inputs, on
the CPU: every image within 1e-5 of 255, joints within 1e-4 px. The warps
sample smooth images, so a float32 ulp between the two frameworks' matrix
inverses and products (of order 1e-5 px at these sizes) moves a sample by
far less than the tolerance; ``mosaic4`` and the flip have no coordinate
arithmetic and take white noise. JAX's mosaic center comes from its key;
the test hands the same center to the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.ops import photometric as JP
from litehandnet_tpu_torch.ops import photometric as TP

IMG_TOL = 1e-5 * 255
PX_TOL = 1e-4


def smooth_images(B, H, W, seed):
    """Sums of a few broad Gaussians and a ramp, in [0, 255]."""
    rng = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    out = np.zeros((B, H, W, 3), np.float32)
    for b in range(B):
        for c in range(3):
            acc = rng.uniform(0, 40) + rng.uniform(0, 0.3) * xs
            for _ in range(3):
                cx, cy = rng.uniform(0, W), rng.uniform(0, H)
                s = rng.uniform(W / 8, W / 3)
                acc = acc + rng.uniform(50, 150) * np.exp(
                    -((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
            out[b, :, :, c] = np.clip(acc, 0, 255)
    return out


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("gamma", [0.3, 1.0, 2.0])
def test_gamma_and_sigmoid_match_jax(gamma):
    img = np.random.RandomState(0).uniform(-10, 265, (2, 16, 12, 3)) \
        .astype(np.float32)
    np.testing.assert_allclose(TP.adjust_gamma(T(img), gamma).numpy(),
                               np.asarray(JP.adjust_gamma(img, gamma)),
                               rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(
        TP.adjust_sigmoid(T(img), 0.4, 3.0 * gamma).numpy(),
        np.asarray(JP.adjust_sigmoid(img, 0.4, 3.0 * gamma)),
        rtol=0, atol=IMG_TOL)


def test_horizontal_flip_matches_jax():
    rng = np.random.RandomState(1)
    img = rng.uniform(0, 255, (3, 10, 14, 3)).astype(np.float32)
    joints = rng.uniform(0, 14, (3, 5, 2)).astype(np.float32)
    flip = [0, 2, 1, 4, 3]
    want_img, want_j = jax.vmap(
        lambda i, j: JP.horizontal_flip(i, j, flip))(img, joints)
    got_img, got_j = TP.horizontal_flip(T(img), T(joints), flip)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img))
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0,
                               atol=PX_TOL)
    # one image, JAX's own shapes
    got_img, got_j = TP.horizontal_flip(T(img[0]), T(joints[0]), flip)
    np.testing.assert_array_equal(got_img.numpy(), np.asarray(want_img[0]))


@pytest.mark.parametrize("scale", [0.7, 1.0, 1.4])
def test_central_scale_matches_jax(scale):
    img = smooth_images(2, 32, 40, 2)
    joints = np.random.RandomState(3).uniform(0, 40, (2, 6, 2)) \
        .astype(np.float32)
    want_img, want_j = jax.vmap(
        lambda i, j: JP.central_scale(i, j, scale))(img, joints)
    got_img, got_j = TP.central_scale(T(img), T(joints), scale)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=IMG_TOL)
    np.testing.assert_allclose(got_j.numpy(), np.asarray(want_j), rtol=0,
                               atol=PX_TOL)


def _homographies(B, H, W, seed):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(B):
        m = np.eye(3) + rng.normal(0, 0.05, (3, 3))
        m[2, :2] = rng.normal(0, 2e-3, 2)
        m[:2, 2] = rng.uniform(-5, 5, 2)
        out.append(m)
    # a plane at infinity inside the image: w crosses 0
    out[-1] = np.array([[1, 0, 0], [0, 1, 0], [-0.05, 0, 1.0]])
    return np.asarray(out, np.float32)


def test_homography_warp_matches_jax():
    B, H, W = 3, 32, 36
    img = smooth_images(B, H, W, 4)
    joints = np.random.RandomState(5).uniform(0, 32, (B, 7, 2)) \
        .astype(np.float32)
    mats = _homographies(B, H, W, 6)
    want_img, want_j = jax.vmap(JP.homography_warp)(img, joints, mats)
    got_img, got_j = TP.homography_warp(T(img), T(joints), T(mats))
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                               rtol=0, atol=IMG_TOL)
    want_j = np.asarray(want_j)
    np.testing.assert_allclose(got_j.numpy(), want_j, rtol=1e-6,
                               atol=PX_TOL)
    # the sign-preserving divide: joints beyond the vanishing line flip
    assert (want_j[-1] < 0).any()


def _jax_center(key, S):
    kx, ky = jax.random.split(key)
    return np.array([int(jax.random.randint(kx, (), S // 2, S + S // 2 + 1)),
                     int(jax.random.randint(ky, (), S // 2, S + S // 2 + 1))])


@pytest.mark.parametrize("S,out_size", [(16, 20), (16, 48), (15, 13),
                                        (15, 40), (16, 32)])
def test_mosaic4_matches_jax(S, out_size):
    """Below 2S (JAX antialiases), above it, and at it; odd S has the
    clamped placements."""
    rng = np.random.RandomState(S + out_size)
    B, K = 4, 5
    images = rng.randint(0, 256, (B, 4, S, S, 3)).astype(np.uint8)
    joints = rng.uniform(-2, S + 2, (B, 4, K, 2)).astype(np.float32)
    vis = rng.randint(0, 2, (B, 4, K)).astype(np.float32)
    keys = jax.random.split(jax.random.PRNGKey(S), B)
    centers = np.stack([_jax_center(k, S) for k in keys])
    # the extreme centers, where odd S clamps
    centers[0] = (S // 2, S // 2)
    centers[1] = (S + S // 2, S // 2)
    for b in range(B):
        want = JP.mosaic4(images[b], joints[b], vis[b], keys[b], out_size) \
            if b >= 2 else _jax_mosaic_at(images[b], joints[b], vis[b],
                                          centers[b], out_size)
        got = TP.mosaic4(T(images[b]), T(joints[b]), T(vis[b]), None,
                         out_size, center=T(centers[b]))
        _assert_mosaic(got, want)
    # the whole batch in one call
    got = TP.mosaic4(T(images), T(joints), T(vis), None, out_size,
                     center=T(centers))
    for b in range(2, B):
        want = JP.mosaic4(images[b], joints[b], vis[b], keys[b], out_size)
        _assert_mosaic([g[b] for g in got], want)


def _jax_mosaic_at(images, joints, vis, center, out_size):
    """JAX's mosaic4 with its two ``randint`` draws replaced by ``center``."""
    it = iter(center.tolist())
    orig = jax.random.randint
    try:
        jax.random.randint = lambda *a, **k: jnp.int32(next(it))
        return JP.mosaic4(images, joints, vis, jax.random.PRNGKey(0),
                          out_size)
    finally:
        jax.random.randint = orig


def _assert_mosaic(got, want):
    for g, w, tol in zip(got, want, (IMG_TOL, PX_TOL, 0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)


def test_mosaic4_draws_from_the_generator():
    S = 16
    images = torch.zeros(8, 4, S, S, 3)
    joints = torch.zeros(8, 4, 2, 2)
    vis = torch.ones(8, 4, 2)
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    a = TP.mosaic4(images, joints, vis, g1, 24)
    b = TP.mosaic4(images, joints, vis, g2, 24)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    c = TP.draw_mosaic_centers(S, (1000,), torch.Generator().manual_seed(0))
    assert int(c.min()) == S // 2 and int(c.max()) == S + S // 2
