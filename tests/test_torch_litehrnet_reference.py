"""Lite-HRNet (``litehrnet``) against the benchmark's plain reference
(``perfbench/reference/litehrnet30.py``, plain ``torch`` that imports
nothing of the port), and the port's spans and counter inside its forward.

At the published widths, depth 30 and 18, 64x64 inputs, B = 2, eval mode,
float32: the same state-dict names and shapes, one seeded dict loaded into
both, outputs within 2e-5 of the output's largest magnitude. Under
``torch.profiler`` one forward records a ``lhn.litehrnet.weighting`` span a
conditional channel weighting block and a ``lhn.litehrnet.fuse`` span a
module, and ``CrossResolutionWeighting.calls`` grows by one a block;
without a profiler nothing is recorded."""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.layers import resize_nearest
from litehandnet_tpu_torch.models.litehrnet import (
    CrossResolutionWeighting,
    resize_bilinear_align_corners,
)
from litehandnet_tpu_torch.utils import profiling
from perfbench.core.weights import seeded_state
from perfbench.reference import litehrnet30
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "perfbench" / "configs" / "litehrnet30.json")
                    .read_text())
# depth: (modules, so fuses; blocks of two weightings each)
DEPTHS = {30: 3 + 8 + 3, 18: 3 + 4 + 3}


def _pair(depth, seed=3):
    cfg = get_config(f"litehrnet/freihand_256_d{depth}")
    port = get_model(cfg, device="cpu")
    ref = litehrnet30.build(dict(cfg.MODEL))
    weights = seeded_state(ref, seed, torch.device("cpu"))
    ref.load_state_dict(weights, strict=False)
    port.load_state_dict(weights, strict=False)
    return port.eval(), ref.eval()


def _x(batch=2):
    return torch.randn(batch, 3, 64, 64,
                       generator=torch.Generator().manual_seed(1))


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_state_dict_names_and_shapes_match(depth):
    port, ref = _pair(depth)
    a, b = port.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    count = sum(p.numel() for p in ref.parameters())
    assert count == sum(p.numel() for p in port.parameters())
    if depth == CONFIG["config"]["MODEL"]["depth"]:
        assert count == CONFIG["parameters"]


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_eval_forward_equals_program(depth):
    port, ref = _pair(depth)
    x = _x()
    with torch.no_grad():
        want = ref(x)
        got = port(x)
    assert got.shape == want.shape == (2, 21, 16, 16)
    assert float((got - want).abs().max() / want.abs().max()) < 2e-5


@pytest.mark.parametrize("size", [(4, 4), (8, 8), (3, 5)])
def test_resizes_are_the_programs(size):
    x = torch.randn(2, 3, *size, generator=torch.Generator().manual_seed(4))
    big = (size[0] * 4, size[1] * 2)
    assert torch.equal(litehrnet30.repeat_pixels(x, big),
                       resize_nearest(x, big))
    torch.testing.assert_close(litehrnet30.bilinear_corners(x, big),
                               resize_bilinear_align_corners(x, big),
                               rtol=1e-5, atol=1e-5)


def test_the_reference_refuses_a_pool_over_partial_blocks():
    with pytest.raises(ValueError):
        litehrnet30.block_mean(torch.zeros(1, 2, 6, 6), (4, 4))


def test_the_reference_loads_neither_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "import perfbench.reference.litehrnet30, perfbench.core.weights; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code, str(ROOT)],
                         capture_output=True, text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=""))
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "torch" in top
    assert not top & {"jax", "jaxlib", "flax", "litehandnet_tpu",
                      "litehandnet_tpu_torch"}


def _names():
    return [s.name for s in profiling.spans()]


@pytest.mark.parametrize("depth", sorted(DEPTHS))
def test_a_profiled_forward_records_each_block_and_fuse(depth):
    from torch.profiler import ProfilerActivity, profile

    port, _ = _pair(depth)
    modules = DEPTHS[depth]
    profiling.reset()
    before = CrossResolutionWeighting.calls
    with torch.no_grad(), profile(activities=[ProfilerActivity.CPU]):
        port(_x(1))
    names = _names()
    profiling.reset()
    assert names.count("lhn.litehrnet.weighting") == 2 * modules
    assert names.count("lhn.litehrnet.fuse") == modules
    assert len(names) == 3 * modules
    assert CrossResolutionWeighting.calls - before == 2 * modules


def test_an_unprofiled_forward_records_no_span():
    port, _ = _pair(30)
    profiling.reset()
    before = CrossResolutionWeighting.calls
    with torch.no_grad():
        port(_x(1))
    assert _names() == []
    assert CrossResolutionWeighting.calls - before == 28
