"""The port's multi-device command lines on the CPU: ``tools/train
--num-devices 2`` and ``tools/train_center_simdr --num-devices 2`` (two
gloo ranks started by the command itself), ``tools/reproduce_auc
--num-devices 2`` (which passes it on to ``tools/train``) and ``tools/test
--data-parallel`` (one process, each batch split over the local devices).

A command that starts ranks waits for them; the rank body raises on any
fault and the command then raises too. Each spawning test runs under a
deadline and kills what it started when it passes (``run_with_deadline``).
"""

import json
import threading

import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.tools import reproduce_auc as reproduce_cli
from litehandnet_tpu_torch.tools import test as test_cli
from litehandnet_tpu_torch.tools import train as train_cli
from litehandnet_tpu_torch.tools import train_center_simdr as simdr_cli
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from tests.test_reproduce_auc import official_archives  # noqa: F401
from tests.test_torch_tools_test import (
    BATCH,
    hand,  # noqa: F401  (fixture)
    save_checkpoint,
    write_cfg,
)
from tests.test_torch_tools_train import fixture_cfg  # noqa: F401
from tests.test_torch_train_center_simdr import gen1_cfg  # noqa: F401
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_workers import JOIN_TIMEOUT
from tests.torch_workers import rank_env  # noqa: F401


def run_with_deadline(fn, *args, timeout=JOIN_TIMEOUT):
    """``fn(*args)`` on a thread; fails the test past ``timeout`` seconds,
    after killing every child process still alive."""
    import multiprocessing

    out = {}

    def target():
        try:
            out["value"] = fn(*args)
        except BaseException as e:  # surfaced below
            out["error"] = e

    thread = threading.Thread(target=target, daemon=True)
    thread.start()
    thread.join(timeout)
    if thread.is_alive():
        for child in multiprocessing.active_children():
            child.kill()
        pytest.fail(f"{fn.__module__}.main did not finish in {timeout} s")
    if "error" in out:
        raise out["error"]
    return out.get("value")


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


def test_train_two_ranks_on_the_cpu(fixture_cfg, tmp_path,  # noqa: F811
                                    rank_env, capsys):  # noqa: F811
    """10 records over 2 ranks: 5 each, one step of 4 an epoch; the chief
    alone prints, logs (one line each of train, lr, val) and writes both
    slots; the LR is twice the configuration's."""
    out = run_with_deadline(train_cli.main, [
        "--cfg", str(fixture_cfg), "--device", "cpu", "--num-devices", "2",
        "--epochs", "1", "--workers", "1", "--seed", "3"])
    assert out is None
    run = tmp_path / "ckpt" / "freihand" / "litehandnet" / "9"
    for slot in ("checkpoint", "best"):
        for ext in (".pt", ".meta.json"):
            assert (run / (slot + ext)).exists(), slot + ext
    saved = torch.load(run / "checkpoint.pt", weights_only=True)
    assert saved["step"] == 1
    assert all(torch.isfinite(v).all() for v in saved["model"].values())
    records = _jsonl(run / "metrics.jsonl")
    assert len(records) == 3
    lr = [r["lr"] for r in records if "lr" in r][0]
    _, schedule = make_optimizer_from_config(get_config(str(fixture_cfg)),
                                             steps_per_epoch=1)
    assert lr == pytest.approx(2 * schedule(1))
    meta = json.loads((run / "best.meta.json").read_text())
    assert np.isfinite(meta["min_val_loss"])


def test_train_refuses_more_devices_than_exist(fixture_cfg,  # noqa: F811
                                               monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1"):
        train_cli.main(["--cfg", str(fixture_cfg), "--num-devices", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_cli.main(["--cfg", str(fixture_cfg), "--num-devices", "1"])


def test_test_data_parallel_equals_the_plain_run(hand, monkeypatch):  # noqa: F811
    """Each batch of 4 split over 2 devices gives the plain run's metrics;
    a batch that the device count does not divide is refused."""
    root, ann, prefix = hand
    path = write_cfg(root / "cfg.py", root / "ckpt", ann, prefix)
    save_checkpoint(get_config(path), best=True)
    args = ["--cfg", path, "--device", "cpu", "--load-best", "--batch-size",
            str(BATCH)]
    chunks = []
    real_concat = test_cli._concat
    monkeypatch.setattr(test_cli, "_concat",
                        lambda outs: chunks.append(len(outs)) or real_concat(outs))
    base = test_cli.main(args)
    assert chunks == []
    monkeypatch.setattr(test_cli, "local_devices",
                        lambda device: [torch.device("cpu")] * 2)
    split = test_cli.main(args + ["--data-parallel"])
    assert chunks == [2] * 3   # 10 records: 3 batches of 4
    assert dict(split) == dict(base)
    bf16 = test_cli.main(args + ["--data-parallel", "--bf16"])
    assert set(bf16) == set(base) and all(np.isfinite(list(bf16.values())))
    monkeypatch.setattr(test_cli, "local_devices",
                        lambda device: [torch.device("cpu")] * 3)
    with pytest.raises(SystemExit, match="--batch-size 4 must divide the 3"):
        test_cli.main(args + ["--data-parallel"])


def test_train_center_simdr_two_ranks(gen1_cfg,  # noqa: F811
                                      rank_env):  # noqa: F811
    """8 records over 2 ranks, batches of 2: 2 full- and 2 half-resolution
    steps on each rank (the cycle-detection coin is shared); the chief
    alone evaluates, logs and writes the checkpoint."""
    path, root = gen1_cfg
    out = run_with_deadline(simdr_cli.main, [
        "--cfg", path, "--workers", "1", "--cd-prob", "1.0", "--device", "cpu",
        "--num-devices", "2"])
    assert out is None
    run = root / "ckpts" / "freihand" / "mynet_stacked" / "998"
    saved = torch.load(run / "checkpoint.pt", weights_only=True)
    assert saved["step"] == 4
    assert all(torch.isfinite(v).all() for v in saved["model"].values())
    records = _jsonl(run / "metrics.jsonl")
    val = [r for r in records if "val/pck" in r]
    assert len(val) == 1 and {"val/coor_pck", "val/ap"} <= set(val[0])
    train = [r for r in records if "train/loss" in r]
    assert len(train) == 1
    assert {"train/heatmap", "train/simdr", "train/cd_loss"} <= set(train[0])
    assert all(np.isfinite(v) for v in train[0].values())


def test_train_center_simdr_refuses_more_devices_than_exist(
        gen1_cfg, monkeypatch):  # noqa: F811
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1"):
        simdr_cli.main(["--cfg", gen1_cfg[0], "--num-devices", "2"])


_TINY = """
from litehandnet_tpu_torch.config.templates import make_cfg


def _get_cfg():
    return make_cfg("litehandnet", "freihand", exp_id=9, image_size=64, **{
        "MODEL.input_channel": 32,
        "TRAIN.batch_per_gpu": 2,
        "OPTIMIZER.warmup_steps": 2,
    })
"""


def test_reproduce_auc_passes_num_devices_on(
        official_archives, tmp_path, monkeypatch,  # noqa: F811
        rank_env):  # noqa: F811
    """One cell trained on 2 ranks by ``tools/train`` and evaluated; more
    devices than exist are refused before any cell runs."""
    from litehandnet_tpu_torch.tools import prepare_datasets

    prepare_datasets.main(["freihand", "--src",
                           str(official_archives / "FreiHAND_pub_v2"),
                           "--dst", str(tmp_path / "data/handset/freihand")])
    cfg = tmp_path / "_9_tiny_litehandnet.py"
    cfg.write_text(_TINY)
    monkeypatch.setitem(reproduce_cli.CONFIGS, "litehandnet",
                        dict(reproduce_cli.CONFIGS["litehandnet"],
                             freihand=str(cfg)))
    passed = []
    real_train = train_cli.main
    monkeypatch.setattr(train_cli, "main",
                        lambda argv: passed.append(argv) or real_train(argv))
    results = run_with_deadline(reproduce_cli.main, [
        "--data-root", str(tmp_path), "--models", "litehandnet",
        "--datasets", "freihand", "--epochs", "1", "--device", "cpu",
        "--num-devices", "2", "--out", str(tmp_path / "auc.json")])
    assert passed and passed[0][-2:] == ["--num-devices", "2"]
    cell = results["litehandnet"]["freihand"]
    assert cell["status"] == "ok", cell
    assert all(np.isfinite(cell[m]) for m in ("PCK", "AUC", "EPE"))
    run = tmp_path / "checkpoints/freihand/litehandnet/9"
    assert len(_jsonl(run / "metrics.jsonl")) == 3

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1"):
        reproduce_cli.main(["--data-root", str(tmp_path), "--num-devices",
                            "2", "--out", str(tmp_path / "o.json")])
