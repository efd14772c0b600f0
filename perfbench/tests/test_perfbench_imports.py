"""Nothing the harness runs loads JAX or the JAX package (top-level names
compared whole), and the references load nothing of the program."""

import os
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "litehandnet_tpu"}

DRIVE = r"""
import sys, tempfile
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
from pathlib import Path
from conftest import small_run
from perfbench.core import result
for name, trace in [("litehandnet.serve_b1", True), ("resnet50.serve_b128", False),
                    ("litehandnet.train_b32", False)]:
    result.execute(small_run(name, Path(tempfile.mkdtemp()), trace=trace,
                             seconds=0.2))
import run
print(sorted({{m.split(".")[0] for m in sys.modules}}))
print(run.forbidden_modules())
"""

REFERENCE = r"""
import sys
sys.path.insert(0, {root!r})
import perfbench.reference.litehandnet, perfbench.reference.resnet50
import perfbench.core.weights, perfbench.core.flops
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def loaded(code, tmp_path):
    # The trainer's metric log imports torch.utils.tensorboard, which
    # imports TensorFlow where it is installed, and its Keras loads JAX. The
    # card's machine has no TensorFlow; this one hides it as the repo's own
    # tests do (tests/torch_workers.py), with a package that fails to import.
    (tmp_path / "tensorflow").mkdir()
    (tmp_path / "tensorflow" / "__init__.py").write_text(
        "raise ImportError('TensorFlow is hidden from this test')\n")
    env = dict(os.environ, PYTHONPATH=str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code.format(
        root=str(ROOT), tests=str(ROOT / "perfbench" / "tests"))],
        capture_output=True, text=True, timeout=900,
        cwd=str(ROOT / "perfbench"), env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()


def test_a_run_loads_no_jax_module(tmp_path):
    lines = loaded(DRIVE, tmp_path)
    top = set(eval(lines[-2]))
    assert "litehandnet_tpu_torch" in top
    assert not top & FORBIDDEN
    assert lines[-1] == "[]"


def test_references_load_nothing_of_the_program(tmp_path):
    top = set(eval(loaded(REFERENCE, tmp_path)[-1]))
    assert not top & (FORBIDDEN | {"litehandnet_tpu_torch"})


def test_run_refuses_without_a_card(tmp_path):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload",
         "litehandnet.serve_b1", "--seed", "3", "--seconds", "1"],
        capture_output=True, text=True, timeout=300, cwd=str(ROOT),
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": "",
             "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
