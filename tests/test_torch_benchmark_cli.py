"""The port's model benchmark CLI (``litehandnet_tpu_torch.tools.
benchmark``) on the CPU at 64x64, B = 2, one rep: its rows, its parameter
counts against a flax ``init`` of the same configs (JAX's own CLI is
slow-marked), the train mode, and a model that fails. Then the serve
program (``Predictor``) of the multi-scale and the stacked family against a
JAX forward decoded by JAX's ``keypoints_from_heatmaps`` on the same cut:
SRHandNet's finest map without its region channels, the hourglass's last
stack."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.serve import Predictor
from litehandnet_tpu_torch.tools import benchmark
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    assert_close_scaled,
    init_jax,
    zoo_cfg,
)

ARGS = ["--device", "cpu", "--size", "64", "--batch", "2", "--reps", "1",
        "--models", "srhandnet", "hourglass", "nosuchmodel"]


def _jax_param_count(name, size=64):
    """The parameter count of JAX's CLI model for ``name``: its config
    dict, shapes from a flax ``init`` (``eval_shape``, nothing compiled)."""
    model_kw = dict(name=name, output_channel=21)
    if name == "srhandnet":
        model_kw.update(output_channel=24, pred_bbox=True)
    model = jax_get_model(jax_cfg(dict(
        MODEL=model_kw,
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=[size // 4, size // 4]),
        PIPELINE=dict(simdr_split_ratio=0))))
    shapes = jax.eval_shape(
        lambda x: model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, size, size, 3), np.float32))
    return sum(int(np.prod(a.shape))
               for a in jax.tree_util.tree_leaves(shapes["params"]))


@functools.lru_cache(maxsize=None)
def _run(*extra):
    return benchmark.main(ARGS + list(extra))


@pytest.mark.parametrize("name", ["srhandnet", "hourglass"])
def test_rows_count_jax_parameters(name, capsys):
    results = _run()
    row = results[name]["default"]
    assert set(row) == {"params_M", "gflops", "latency_ms", "fps"}
    n_jax = _jax_param_count(name)
    assert row["params_M"] > 0 and row["params_M"] == round(n_jax / 1e6, 3)
    model = get_model(benchmark.bench_config(name, 64), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax
    assert row["gflops"] > 0 and row["latency_ms"] > 0 and row["fps"] > 0


@pytest.mark.parametrize("name", ["litehandnet_msrb", "yolov6"])
def test_zoo_families_beyond_the_defaults(name):
    """``--models`` takes every registered family, as JAX's CLI does through
    its registry; each row counts JAX's parameters for the same config.
    ``DEFAULT_MODELS`` stays JAX's eight."""
    results = benchmark.main(["--device", "cpu", "--size", "64", "--batch",
                              "1", "--reps", "1", "--models", name])
    row = results[name]["default"]
    assert row["params_M"] == round(_jax_param_count(name) / 1e6, 3)
    model = get_model(benchmark.bench_config(name, 64), device="cpu")
    assert sum(p.numel() for p in model.parameters()) == _jax_param_count(
        name)
    assert row["gflops"] > 0 and row["latency_ms"] > 0
    from litehandnet_tpu.tools.benchmark import DEFAULT_MODELS

    assert benchmark.DEFAULT_MODELS == DEFAULT_MODELS


def test_unknown_model_fails_alone(capsys):
    benchmark.main(ARGS)
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split(":")[0] for ln in lines] == ["srhandnet", "hourglass",
                                                   "nosuchmodel"]
    assert lines[2].startswith("nosuchmodel: FAILED KeyError")
    assert "nosuchmodel" not in _run()


@pytest.mark.parametrize("mode", ["--train", "--throughput"])
def test_train_and_throughput_modes(mode):
    results = _run(mode)
    assert set(results) == {"srhandnet", "hourglass"}
    key = "ms_per_step" if mode == "--train" else "img_per_sec"
    assert all(row[key] > 0 for row in results.values())


def test_litehandnet_has_train_graph_and_deployed_rows():
    rows = benchmark.main(["--device", "cpu", "--size", "64", "--batch", "1",
                           "--reps", "1", "--models", "litehandnet"])
    rows = rows["litehandnet"]
    assert set(rows) == {"train_graph", "deployed"}
    assert rows["deployed"]["params_M"] < rows["train_graph"]["params_M"]


SIZE = 64


@pytest.mark.parametrize("family,model_kw", [
    ("srhandnet", dict(output_channel=24, pred_bbox=True)),
    ("hourglass", dict(num_stack=2, num_level=2, input_channel=32)),
])
def test_predictor_decodes_the_finest_map(family, model_kw):
    """``Predictor`` keypoints equal JAX's forward decoded by JAX on the
    map ``tools/test`` evaluates: the last entry of a tuple, the last
    stack, the first 21 channels."""
    d = zoo_cfg(family, size=SIZE, **model_kw)
    rng = np.random.RandomState(5)
    images = rng.randint(0, 256, size=(2, SIZE, SIZE, 3), dtype=np.uint8)
    center = np.tile(np.float32([SIZE / 2, SIZE / 2]), (2, 1))
    scale = np.tile(np.float32([SIZE / 200.0, SIZE / 200.0]), (2, 1))
    jax_model = jax_get_model(jax_cfg(d))
    variables = init_jax(jax_model, images.astype(np.float32), train=False)
    mean = np.float32([0.485, 0.456, 0.406]) * 255.0
    std = np.float32([0.229, 0.224, 0.225]) * 255.0
    out = jax_model.apply(variables, (images.astype(np.float32) - mean) / std,
                          train=False)
    hm = out[-1] if isinstance(out, tuple) else out[:, -1]
    hm = np.asarray(hm)[..., :21]
    _, want_preds, want_maxvals = keypoints_from_heatmaps(
        hm, center, scale, post_process="unbiased", kernel=11)
    predictor = Predictor(config_from_dict(d), variables, device="cpu",
                          dtype=torch.float32)
    images = torch.from_numpy(images)
    got = predictor.heatmaps(images)
    assert got.shape == (2, SIZE // 4, SIZE // 4, 21) and got.is_contiguous()
    assert_close_scaled(got.numpy(), hm, 1e-4, 1e-5)
    preds, maxvals = predictor(images, center, scale)
    np.testing.assert_allclose(preds.numpy(), np.asarray(want_preds), rtol=0,
                               atol=1e-3)
    np.testing.assert_allclose(maxvals.numpy(), np.asarray(want_maxvals),
                               rtol=1e-5, atol=1e-6 * np.abs(want_maxvals).max())
