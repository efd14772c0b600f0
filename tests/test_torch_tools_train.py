"""``python -m litehandnet_tpu_torch.tools.train`` on the CPU: a small
LiteHandNet (32 features, 64x64 input) trains for one epoch on a
FreiHAND-style fixture on disk, validates, and writes its checkpoints."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.tools import train as train_cli
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

_CFG = """
from litehandnet_tpu_torch.config.templates import make_cfg

SPLIT = dict(ann_file={ann!r}, img_prefix={prefix!r})


def _get_cfg():
    return make_cfg("litehandnet", "freihand", exp_id=9, image_size=64, **{{
        "MODEL.input_channel": 32,
        "DATASET.train": SPLIT, "DATASET.val": SPLIT, "DATASET.test": SPLIT,
        "TRAIN.batch_per_gpu": 4,
        "OPTIMIZER.warmup_steps": 2,
        "CHECKPOINT.save_root": {root!r},
        "CHECKPOINT.resume": False,
    }})
"""


@pytest.fixture
def fixture_cfg(tmp_path):
    from PIL import Image

    rng = np.random.RandomState(0)
    (tmp_path / "images").mkdir()
    images, anns = [], []
    for i in range(10):
        name = f"images/{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
            tmp_path / name)
        images.append(dict(id=i, file_name=name, width=64, height=64))
        kpts = [v for xy in rng.uniform(8, 56, (21, 2))
                for v in (float(xy[0]), float(xy[1]), 1)]
        anns.append(dict(id=i, image_id=i, category_id=1, iscrowd=0,
                         keypoints=kpts, bbox=[0.0, 0.0, 64.0, 64.0]))
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns,
                                   categories=[dict(id=1, name="hand")])))
    path = tmp_path / "_9_tiny_litehandnet.py"
    path.write_text(_CFG.format(ann=str(ann), prefix=str(tmp_path) + "/",
                                root=str(tmp_path / "ckpt") + "/"))
    return path


def test_train_cli_one_epoch_on_the_cpu(fixture_cfg, tmp_path, capsys):
    state = train_cli.main(["--cfg", str(fixture_cfg), "--device", "cpu",
                            "--epochs", "1", "--workers", "2", "--seed", "3"])
    out = capsys.readouterr().out
    # 10 records, batches of 4, the last partial one dropped in training
    assert "steps/epoch=2 train=10 val=10" in out
    assert "training complete" in out
    assert state.step == 2
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    run = tmp_path / "ckpt" / "freihand" / "litehandnet" / "9"
    for slot in ("checkpoint", "best"):
        for ext in (".pt", ".meta.json"):
            assert (run / (slot + ext)).exists(), slot + ext
    meta = json.loads((run / "best.meta.json").read_text())
    assert np.isfinite(meta["min_val_loss"])


def test_train_cli_defaults_to_cuda(fixture_cfg, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--cfg", str(fixture_cfg), "--epochs", "1"])


def test_train_module_help():
    out = subprocess.run(
        [sys.executable, "-m", "litehandnet_tpu_torch.tools.train", "--help"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--device" in out.stdout and "--cfg" in out.stdout
