"""The port's serve program (``Predictor``) against the JAX serve program
that bench.py times (``one_step``: normalize -> deploy forward -> DARK
decode), on the same uint8 batch and weights, in float32 on the CPU."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import litehandnet_tpu_torch
from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import fuse_params as jax_fuse
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.config import DEFAULT_CONFIG, config_from_dict, get_config
from litehandnet_tpu_torch.kernels import KERNELS
from litehandnet_tpu_torch.serve import Predictor
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_close_scaled,
    init_jax,
    small_model_cfg,
)

SIZE = 64


def _batch(B=2, seed=0):
    rng = np.random.RandomState(seed)
    images = rng.randint(0, 256, size=(B, SIZE, SIZE, 3), dtype=np.uint8)
    center = np.tile(np.float32([SIZE / 2, SIZE / 2]), (B, 1))
    scale = np.tile(np.float32([SIZE / 200.0, SIZE / 200.0]), (B, 1))
    return images, center, scale


def _jax_one_step(cfg, variables, images, center, scale):
    """bench.py:340-354 in float32, with the fusion inside the jit."""

    @jax.jit
    def one_step(variables, images, center, scale):
        mean = jnp.asarray([0.485, 0.456, 0.406], jnp.float32) * 255.0
        std = jnp.asarray([0.229, 0.224, 0.225], jnp.float32) * 255.0
        img = (images.astype(jnp.float32) - mean) / std
        fused = jax_fuse(variables)
        hm = jax_get_model(cfg, deploy=True).apply(fused, img, train=False)
        _, preds, maxvals = keypoints_from_heatmaps(
            hm, center, scale, post_process="unbiased", kernel=11)
        return hm, preds, maxvals, fused

    return jax.tree_util.tree_map(
        np.asarray, one_step(variables, images, center, scale))


@pytest.fixture(scope="module")
def served():
    d = small_model_cfg(size=SIZE)
    images, center, scale = _batch()
    variables = init_jax(jax_get_model(jax_cfg(d)), images.astype(np.float32),
                         train=False)
    hm, preds, maxvals, fused = _jax_one_step(jax_cfg(d), variables, images,
                                              center, scale)
    return dict(cfg=config_from_dict(d), variables=variables, images=images,
                center=center, scale=scale, hm=hm, preds=preds,
                maxvals=maxvals, fused=fused)


@pytest.mark.parametrize("graph", ["train", "deploy"])
def test_predictor_matches_jax_one_step(served, graph):
    """Train-graph variables are fused by the port; deploy-graph variables
    come fused by JAX."""
    variables = served["variables"] if graph == "train" else served["fused"]
    launches = {name: k.launches for name, k in KERNELS.items()}
    predictor = Predictor(served["cfg"], variables, device="cpu",
                          dtype=torch.float32)
    images = torch.from_numpy(served["images"])
    hm = predictor.heatmaps(images)
    assert_close_scaled(hm.numpy(), served["hm"], 1e-4, 1e-5)
    preds, maxvals = predictor(images, served["center"], served["scale"])
    assert preds.shape == (2, 21, 2) and maxvals.shape == (2, 21, 1)
    np.testing.assert_allclose(preds.numpy(), served["preds"], rtol=0, atol=1e-3)
    np.testing.assert_allclose(maxvals.numpy(), served["maxvals"], rtol=1e-5,
                               atol=1e-6 * np.abs(served["maxvals"]).max())
    # the plain path launches no kernel on the CPU
    assert {name: k.launches for name, k in KERNELS.items()} == launches


def test_predictor_seeded_random_weights_are_reproducible():
    cfg = config_from_dict(small_model_cfg(size=SIZE))
    images, center, scale = _batch(B=1, seed=1)
    a = Predictor(cfg, device="cpu", dtype=torch.float32, seed=3)
    b = Predictor(cfg, device="cpu", dtype=torch.float32, seed=3)
    images = torch.from_numpy(images)
    torch.testing.assert_close(a.heatmaps(images), b.heatmaps(images),
                               rtol=0, atol=0)
    assert torch.isfinite(a(images, center, scale)[0]).all()


def test_predictor_rejects_non_u8():
    predictor = Predictor(config_from_dict(small_model_cfg(size=SIZE)),
                          device="cpu", dtype=torch.float32)
    with pytest.raises(ValueError):
        predictor.heatmaps(torch.zeros(1, SIZE, SIZE, 3))


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor(config_from_dict(small_model_cfg(size=SIZE)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        litehandnet_tpu_torch.resolve_device()


def test_default_serve_config():
    cfg = get_config()
    assert DEFAULT_CONFIG == "litehandnet/freihand_256_dark_h4_ca_r4"
    assert cfg.MODEL.input_channel == 128 and cfg.MODEL.reduction == 4
    assert cfg.MODEL.ca_type == "ca" and cfg.MODEL.num_stage == 4
    assert cfg.DATASET.image_size == [256, 256]
    assert cfg.DATASET.heatmap_size == [64, 64]
    with pytest.raises(KeyError):
        get_config("litehandnet/unknown")
