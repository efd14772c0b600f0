"""Port ``utils/profiling`` against JAX's on the CPU: the FLOPs of a matrix
product and an unpadded convolution equal XLA's count, ``set_seeds`` leaves python's
and numpy's generators where JAX's does, ``parameter_histograms`` gives
JAX's counts and edges (mean and std within 1e-6 relative: JAX averages in
float32); ``trace`` writes a Chrome trace holding the profiled ops."""

import json
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from litehandnet_tpu.utils import profiling as JP
from litehandnet_tpu_torch.tools import analyze_weights
from litehandnet_tpu_torch.utils import profiling as TP


def test_trace_writes_the_profiled_ops(tmp_path):
    x = torch.randn(64, 64)
    with TP.trace(str(tmp_path / "t")) as prof:
        (x @ x).relu_()
    names = {e.name for e in prof.events()}
    assert "aten::mm" in names and "aten::relu_" in names
    assert TP.device_kernel_names(prof) == []
    doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    assert any(e.get("name") == "aten::mm" for e in doc["traceEvents"])


def test_default_trace_dir_is_inside_the_checkout():
    assert TP.DEFAULT_TRACE_DIR.endswith("build/litehandnet_tpu_torch/trace")


@pytest.mark.parametrize("m,k,n", [(8, 16, 4), (32, 7, 5)])
def test_cost_analysis_of_a_matmul_equals_xla(m, k, n):
    a = np.random.RandomState(0).randn(m, k).astype(np.float32)
    b = np.random.RandomState(1).randn(k, n).astype(np.float32)
    want = JP.cost_analysis(jnp.matmul, a, b)["flops"]
    got = TP.cost_analysis(torch.matmul, torch.from_numpy(a),
                           torch.from_numpy(b))
    assert got["flops"] == want == 2 * m * k * n
    assert got["flops_by_operator"] == {"aten.mm": 2 * m * k * n}


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
def test_cost_analysis_of_a_convolution(padding):
    """Unpadded, the count equals XLA's; 'SAME' counts every tap, the padded
    ones too, where XLA leaves those out."""
    x = np.random.RandomState(2).randn(2, 9, 11, 3).astype(np.float32)
    w = np.random.RandomState(3).randn(3, 3, 3, 8).astype(np.float32)

    def jax_conv(x, w):
        return jax.lax.conv_general_dilated(
            x, w, (1, 1), padding, dimension_numbers=("NHWC", "HWIO", "NHWC"))

    want = JP.cost_analysis(jax_conv, x, w)["flops"]
    pad = 1 if padding == "SAME" else 0
    got = TP.cost_analysis(
        lambda x, w: F.conv2d(x, w, padding=pad),
        torch.from_numpy(x).permute(0, 3, 1, 2),
        torch.from_numpy(w).permute(3, 2, 0, 1))["flops"]
    H, W = (9, 11) if pad else (7, 9)
    assert got == 2 * 2 * H * W * 8 * 3 * 9
    if pad:
        assert want < got
    else:
        assert got == want


@pytest.mark.parametrize("seed,rank", [(0, None), (5, 0), (5, 3)])
def test_set_seeds_matches_jax(seed, rank):
    assert JP.set_seeds(seed, rank) == TP.set_seeds(seed, rank) \
        or rank is None
    want = (random.random(), np.random.rand())
    effective = TP.set_seeds(seed, rank)
    assert effective == seed + 1 + (rank or 0)
    assert (random.random(), np.random.rand()) == want
    a = torch.rand(3)
    torch.manual_seed(effective)
    assert torch.equal(a, torch.rand(3))


def test_parameter_histograms_match_jax():
    rng = np.random.RandomState(4)
    params = {"conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32)},
              "bn": {"scale": rng.uniform(0.5, 2, 8).astype(np.float32),
                     "bias": np.zeros(8, np.float32)}}
    want = JP.parameter_histograms(params, bins=20)
    flat = {"conv/kernel": params["conv"]["kernel"],
            "bn/scale": params["bn"]["scale"], "bn/bias": params["bn"]["bias"]}
    got = TP.parameter_histograms(
        {k: torch.from_numpy(v) for k, v in flat.items()}, bins=20)
    assert sorted(got) == sorted(want)
    for name, h in got.items():
        assert h["hist"] == want[name]["hist"]
        np.testing.assert_array_equal(h["edges"], want[name]["edges"])
        for stat in ("mean", "std"):
            np.testing.assert_allclose(h[stat], want[name][stat], rtol=1e-6,
                                       atol=1e-7)
    # the tool takes it from here
    assert analyze_weights.parameter_histograms is TP.parameter_histograms
