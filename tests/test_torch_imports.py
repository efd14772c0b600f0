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
