"""The port imports neither JAX nor any module of the JAX package."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

PKG = pathlib.Path(__file__).resolve().parents[1] / "litehandnet_tpu_torch"
MODULES = sorted(
    ".".join(p.relative_to(PKG.parent).with_suffix("").parts).removesuffix(".__init__")
    for p in PKG.rglob("*.py")
)

_PROBE = """
import importlib, json, sys
for name in {modules!r}:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "flax") or m.startswith(("jax.", "flax.", "litehandnet_tpu."))
             or m == "litehandnet_tpu")
print(json.dumps(bad))
"""


def test_importing_every_module_loads_no_jax():
    assert len(MODULES) >= 10, MODULES
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=MODULES)],
        cwd=PKG.parent, capture_output=True, text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_sources_import_no_jax(path):
    pattern = re.compile(
        r"^\s*(import|from)\s+(jax|flax|litehandnet_tpu)(\.|\s|$)", re.M)
    assert pattern.search(path.read_text()) is None


JAX_PKG = PKG.parent / "litehandnet_tpu"
# JAX modules whose port lives under another name, or is still to come
# (tools/twin_accuracy.py drives the reference's own torch code, which the
# port does not copy)
ELSEWHERE = {"ops/pallas_kernels.py": "kernels/",
             "utils/torch_import.py": "utils/weights.py"}
NOT_YET = {"tools/twin_accuracy.py"}
SLICE_11 = ["eval/heatmap_parser.py", "utils/centermap.py",
            "data/od_dataset.py", "eval/wholebody.py",
            "tools/eval_wholebody.py", "ops/photometric.py",
            "utils/kmeans.py", "tools/split_testset.py",
            "utils/profiling.py", "tools/prepare_datasets.py",
            "tools/reproduce_auc.py", "native/__init__.py"]


def test_every_jax_module_has_a_port_twin():
    """Apart from the experiment files (one table in the port's
    ``config/experiments.py``) and the modules named above."""
    jax_mods = {str(p.relative_to(JAX_PKG)) for p in JAX_PKG.rglob("*.py")
                if "config/experiments/" not in str(p.relative_to(JAX_PKG))}
    port_mods = {str(p.relative_to(PKG)) for p in PKG.rglob("*.py")}
    missing = jax_mods - port_mods - set(ELSEWHERE) - NOT_YET
    assert missing == set()
    for target in ELSEWHERE.values():
        assert (PKG / target).exists(), target


@pytest.mark.parametrize("module", SLICE_11)
def test_new_module_imports_without_jax(module):
    name = "litehandnet_tpu_torch." + module.removesuffix(".py").replace(
        "/", ".").removesuffix(".__init__")
    assert name in MODULES
    out = subprocess.run(
        [sys.executable, "-c", _PROBE.format(modules=[name])],
        cwd=PKG.parent, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
