"""Port ``utils/profiling`` against JAX's on the CPU: the FLOPs of a matrix
product and an unpadded convolution equal XLA's count, ``set_seeds`` leaves python's
and numpy's generators where JAX's does, ``parameter_histograms`` gives
JAX's counts and edges (mean and std within 1e-6 relative: JAX averages in
float32); ``trace`` writes a Chrome trace holding the profiled ops. The
serve path's spans record only under ``torch.profiler``, and the kernel
build counts its ``nvcc`` runs and seconds."""

import collections
import json
import os
import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from litehandnet_tpu.utils import profiling as JP
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.kernels import _build
from litehandnet_tpu_torch.serve import Predictor
from litehandnet_tpu_torch.tools import analyze_weights
from litehandnet_tpu_torch.utils import profiling as TP
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import small_model_cfg

# the serve path's spans and the span each sits in
SERVE_SPANS = {"lhn.serve": None, "lhn.serve.input": "lhn.serve",
               "lhn.serve.forward": "lhn.serve", "lhn.decode": "lhn.serve",
               "lhn.decode.refine": "lhn.decode"}


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
    assert TP.DEFAULT_TRACE_DIR == str(_build.BUILD_DIR / "trace")


def test_zero_counters_zeroes_each_declared_counter_in_place(monkeypatch):
    """An int goes to 0, a dict keeps its keys at 0; the dicts readers hold
    stay the ones the owner holds."""

    class Owner:
        n = 5
        paths = {"general": 1, "fast": 2}
        shapes = collections.Counter({(2, 8): 3})

    monkeypatch.setattr(TP, "_COUNTERS", [])
    TP.register_counters(Owner, "n", "paths", "shapes")
    assert TP.counters() == [(Owner, "n"), (Owner, "paths"),
                             (Owner, "shapes")]
    paths, shapes = Owner.paths, Owner.shapes
    TP.zero_counters()
    assert Owner.n == 0
    assert Owner.paths is paths and paths == {"general": 0, "fast": 0}
    assert Owner.shapes is shapes and shapes == {(2, 8): 0}


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


@pytest.fixture(scope="module")
def predictor():
    """A CPU ``Predictor`` at 64x64 (random weights, float32) and a batch."""
    served = Predictor(config_from_dict(small_model_cfg(size=64)),
                       device="cpu", dtype=torch.float32)
    images = torch.randint(0, 256, (2, 64, 64, 3), dtype=torch.uint8,
                           generator=torch.Generator().manual_seed(0))
    center = torch.full((2, 2), 32.0)
    scale = torch.full((2, 2), 64 / 200.0)
    return lambda: served(images, center, scale)


def _cpu_profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def test_span_is_one_shared_no_op_when_off(predictor):
    TP.reset()
    off = TP.span("lhn.serve")
    assert TP.span("other", torch.device("cpu")) is off
    with off:
        pass
    predictor()
    assert TP.spans() == []


def test_a_profiled_request_records_the_five_serve_spans(predictor):
    TP.reset()
    with _cpu_profile():
        predictor()
    got = TP.spans()
    assert sorted(s.name for s in got) == sorted(SERVE_SPANS)
    assert got[0].name == "lhn.serve"       # entered first, the root
    for s in got:
        assert s.parent == SERVE_SPANS[s.name], s
        assert s.host_ms > 0
        assert s.device_ms == s.host_ms     # the CPU runs its ops in turn
    assert TP.span("after") is TP.span("again")   # off once the session ends
    TP.reset()
    assert TP.spans() == []


def test_two_requests_give_one_gap(predictor):
    TP.reset()
    with _cpu_profile():
        predictor()
        predictor()
    roots = [s for s in TP.spans() if s.parent is None]
    assert [s.name for s in roots] == ["lhn.serve", "lhn.serve"]
    gaps = [s.device_gap_ms for s in TP.spans() if s.device_gap_ms is not None]
    assert len(gaps) == 1 and gaps[0] >= 0
    assert roots[1].device_gap_ms == gaps[0]
    # entries on one clock from the first: the gap is the first's exit to
    # the second's entry, and every nested span lies inside its request
    assert roots[0].device_start_ms == 0
    assert gaps[0] == pytest.approx(roots[1].device_start_ms
                                    - roots[0].device_ms)
    got = TP.spans()
    for root, nested in ((got[0], got[1:5]), (got[5], got[6:])):
        assert root.name == "lhn.serve" and len(nested) == 4
        for s in nested:
            assert root.device_start_ms <= s.device_start_ms
            assert (s.device_start_ms + s.device_ms
                    <= root.device_start_ms + root.device_ms)


def test_a_span_closes_when_its_body_raises():
    TP.reset()
    with _cpu_profile():
        with pytest.raises(ValueError):
            with TP.span("outer"):
                with TP.span("inner"):
                    raise ValueError("in the span")
        with TP.span("next"):
            pass
    got = {s.name: s for s in TP.spans()}
    assert got["inner"].parent == "outer" and got["outer"].parent is None
    assert got["next"].parent is None       # nothing was left open
    assert all(s.host_ms >= 0 for s in got.values())


def test_trace_holds_the_serve_span(predictor, tmp_path):
    """``trace``'s json holds the spans, and ``spans()`` then holds the
    block's alone: what an earlier session recorded is forgotten."""
    TP.reset()
    with _cpu_profile():
        with TP.span("earlier"):
            pass
    with TP.trace(str(tmp_path / "t")):
        predictor()
    doc = json.loads((tmp_path / "t" / "trace.json").read_text())
    names = {e.get("name") for e in doc["traceEvents"]}
    assert set(SERVE_SPANS) <= names
    assert sorted(s.name for s in TP.spans()) == sorted(SERVE_SPANS)
    TP.reset()


def test_build_counts_one_compile_and_its_seconds(tmp_path, monkeypatch):
    """A stand-in ``nvcc`` writes its ``-o`` file: the first ``build``
    compiles the source once, a second finds the library and compiles
    nothing; both add their seconds."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ $# -gt 0 ]; do\n'
                    '  if [ "$1" = "-o" ]; then shift; : > "$1"; fi\n'
                    '  shift\ndone\n')
    os.chmod(nvcc, 0o755)
    monkeypatch.setattr(_build, "_nvcc", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "compiles", {})
    monkeypatch.setattr(_build, "seconds", 0.0)
    _build.build(["blur_log"])
    assert _build.compiles == {"blur_log": 1}
    first = _build.seconds
    assert first > 0
    assert _build.library_path("blur_log").is_file()
    _build.build(["blur_log"])
    assert _build.compiles == {"blur_log": 1}
    assert _build.seconds > first
