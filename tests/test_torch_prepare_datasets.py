"""Port ``tools/prepare_datasets`` and ``tools/reproduce_auc`` against JAX's:
the four official layouts, generated in ``tmp_path`` as JAX's
``tests/test_reproduce_auc.py`` generates them, convert to the same JSON and
the same image links; the grid's tables and its SKIPPED(no data) cells equal
JAX's, and one cell trains and evaluates on the CPU through the port's
``tools/train`` and ``tools/test``."""

import json
import os

import numpy as np
import pytest

from litehandnet_tpu.tools import prepare_datasets as JPD
from litehandnet_tpu.tools import reproduce_auc as JRA
from litehandnet_tpu_torch.tools import prepare_datasets as TPD
from litehandnet_tpu_torch.tools import reproduce_auc as TRA
from tests.test_reproduce_auc import official_archives  # noqa: F401
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

ARCHIVES = {"freihand": "FreiHAND_pub_v2", "rhd": "RHD_published_v2",
            "panoptic": "hand_labels", "onehand10k": "OneHand10K"}


def _tree(root):
    """Every file under ``root``: JSON parsed, links as their targets."""
    out = {}
    for d, dirs, files in os.walk(root):
        for name in dirs + files:
            path = os.path.join(d, name)
            rel = os.path.relpath(path, root)
            if os.path.islink(path):
                out[rel] = ("link", os.readlink(path))
            elif name.endswith(".json"):
                out[rel] = json.loads(open(path).read())
    return out


@pytest.mark.parametrize("dataset", sorted(ARCHIVES))
def test_conversion_matches_jax(official_archives, tmp_path,  # noqa: F811
                                dataset, capsys):
    src = str(official_archives / ARCHIVES[dataset])
    argv = lambda dst: [dataset, "--src", src, "--dst", str(tmp_path / dst)]
    want = JPD.main(argv("jax"))
    jax_out = capsys.readouterr().out
    got = TPD.main(argv("port"))
    assert got == want
    assert capsys.readouterr().out == jax_out.replace(
        str(tmp_path / "jax"), str(tmp_path / "port"))
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")
    assert any(k.endswith(".json") for k in _tree(tmp_path / "port"))


def test_freihand_without_evaluation_reuses_val(official_archives,  # noqa: F811
                                                tmp_path):
    src = tmp_path / "fh"
    os.makedirs(src / "training")
    os.symlink(official_archives / "FreiHAND_pub_v2" / "training" / "rgb",
               src / "training" / "rgb")
    for name in ("training_K.json", "training_xyz.json"):
        os.symlink(official_archives / "FreiHAND_pub_v2" / name, src / name)
    want = JPD.prepare_freihand(str(src), str(tmp_path / "jax"), 0.1)
    got = TPD.prepare_freihand(str(src), str(tmp_path / "port"), 0.1)
    assert got == want and "val reused" in got["test"]
    assert _tree(tmp_path / "port") == _tree(tmp_path / "jax")


def test_grid_tables_match_jax():
    assert TRA.REFERENCE_AUC == JRA.REFERENCE_AUC
    assert TRA.CONFIGS == JRA.CONFIGS


def test_grid_without_data_matches_jax(tmp_path, capsys):
    argv = ["--data-root", str(tmp_path), "--models", "litehandnet",
            "resnet18", "--datasets", "rhd", "panoptic", "--eval-only"]
    want = JRA.main(argv + ["--out", str(tmp_path / "jax.json")])
    jax_out = capsys.readouterr().out
    got = TRA.main(argv + ["--out", str(tmp_path / "port.json"),
                           "--device", "cpu"])
    assert got == want
    assert capsys.readouterr().out == jax_out
    assert all(c["status"] == "SKIPPED(no data)"
               for row in got.values() for c in row.values())
    assert os.getcwd() != str(tmp_path)


_TINY = """
from litehandnet_tpu_torch.config.templates import make_cfg


def _get_cfg():
    return make_cfg("litehandnet", "freihand", exp_id=9, image_size=64, **{
        "MODEL.input_channel": 32,
        "TRAIN.batch_per_gpu": 4,
        "OPTIMIZER.warmup_steps": 2,
    })
"""


def test_grid_runs_a_cell_on_the_cpu(official_archives, tmp_path,  # noqa: F811
                                     monkeypatch):
    """litehandnet/freihand trains one epoch of a 32-channel, 64x64 model
    on a converted FreiHAND layout and evaluates its best checkpoint; the
    unconverted rhd cell is SKIPPED(no data)."""
    TPD.main(["freihand", "--src",
              str(official_archives / "FreiHAND_pub_v2"),
              "--dst", str(tmp_path / "data/handset/freihand")])
    cfg = tmp_path / "_9_tiny_litehandnet.py"
    cfg.write_text(_TINY)
    monkeypatch.setitem(TRA.CONFIGS, "litehandnet",
                        dict(TRA.CONFIGS["litehandnet"], freihand=str(cfg)))
    out = tmp_path / "auc_table.json"
    results = TRA.main(["--data-root", str(tmp_path), "--models",
                        "litehandnet", "--datasets", "freihand", "rhd",
                        "--epochs", "1", "--device", "cpu", "--out",
                        str(out)])
    cell = results["litehandnet"]["freihand"]
    assert cell["status"] == "ok", cell
    for m in ("PCK", "AUC", "EPE"):
        assert np.isfinite(cell[m]), cell
    assert cell["reference_auc"] == 82.5
    assert results["litehandnet"]["rhd"]["status"] == "SKIPPED(no data)"
    assert json.loads(out.read_text()) == results
    assert (tmp_path / "checkpoints/freihand/litehandnet/9/best.pt").exists()


def test_grid_defaults_to_cuda(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TRA.main(["--data-root", str(tmp_path), "--out",
                  str(tmp_path / "o.json")])
