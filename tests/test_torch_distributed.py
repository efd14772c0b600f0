"""Data parallelism of the port (``train/distributed.py``'s multi-device
half, SyncBN in ``models/layers.TorchBatchNorm``, the loader's shard, the
trainer's chief gating) against the JAX package on the CPU.

Worlds of 2 gloo ranks run in new processes (``tests/torch_workers.py``);
the JAX side runs here, over ``make_mesh(2)`` of the 8-device CPU platform
that ``tests/conftest.py`` sets up. The model is the SE variant of JAX's
tiny LiteHandNet (``tests/test_multihost.py``'s config): it has no dropout,
whose per-rank draws differ from JAX's by design.
"""

import json
import os
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from litehandnet_tpu.config import config_from_dict as jax_config
from litehandnet_tpu.losses import get_loss as jax_get_loss
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.train import distributed as JD
from litehandnet_tpu.train.optim import (
    make_optimizer_from_config as jax_optimizer_from_config,
)
from litehandnet_tpu.train.state import TrainState as JaxTrainState
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models import layers as L
from litehandnet_tpu_torch.train import distributed as TD
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import init_jax
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_workers import Ranks, fit_rank, run_world, step_rank
from tests.torch_workers import rank_env  # noqa: F401  (fixture)

B, SIZE, HM, K = 8, 64, 16, 21
RULES = rules_for("litehandnet")


def _cfg_dict(sync_bn=True, **train):
    """``tests/test_multihost.py``'s tiny LiteHandNet, SE attention."""
    return dict(
        MODEL=dict(name="litehandnet", num_stage=3, num_block=[1, 1],
                   input_channel=32, ca_type="se", reduction=2,
                   activation="leakyrelu", output_channel=K),
        DATASET=dict(num_joints=K, image_size=[SIZE, SIZE],
                     heatmap_size=[HM, HM]),
        PIPELINE=dict(simdr_split_ratio=0),
        TRAIN=dict(total_epoches=2, batch_per_gpu=4, syncBN=sync_bn, **train),
        OPTIMIZER=dict(type="Adam", lr=1e-3, warmup_steps=0, step_epoch=[1]),
        LOSS=dict(type="TopdownHeatmapLoss", loss_weight=[1.0, 0.1],
                  auto_weight=False),
    )


def _batch(seed=3):
    """8 different rows: unit-normal images, each scaled and shifted on its
    own, U(0, 1) targets, target weights of 0 or 1."""
    rng = np.random.RandomState(seed)
    img = (rng.normal(size=(B, SIZE, SIZE, 3))
           * rng.uniform(0.5, 2.0, size=(B, 1, 1, 1))
           + rng.uniform(-1.0, 1.0, size=(B, 1, 1, 3))).astype(np.float32)
    target = rng.uniform(0, 1, size=(B, HM, HM, K)).astype(np.float32)
    weight = (rng.uniform(size=(B, K)) > 0.1).astype(np.float32)
    return {"img": img, "target": target, "target_weight": weight}


def _jax_step(cfg_dict, variables, batch, sync_bn):
    """JAX's 2-device step: (params, batch_stats, loss)."""
    cfg = jax_config(cfg_dict)
    model = jax_get_model(cfg, axis_name="data" if sync_bn else None)
    tx, _ = jax_optimizer_from_config(cfg, steps_per_epoch=10, world_size=1)
    state = JaxTrainState.create(variables, {}, tx)
    step = JD.make_train_step(model, jax_get_loss(cfg), tx, JD.make_mesh(2),
                              donate=False)
    new, metrics = step(state, {k: jnp.asarray(v) for k, v in batch.items()},
                        jax.random.PRNGKey(0))
    return (jax.tree.map(np.asarray, new.params),
            jax.tree.map(np.asarray, new.batch_stats), float(metrics["loss"]))


def _port_batch(batch):
    return {"img": torch.from_numpy(batch["img"]),
            "target": torch.from_numpy(
                np.ascontiguousarray(batch["target"].transpose(0, 3, 1, 2))),
            "target_weight": torch.from_numpy(batch["target_weight"])}


def _port_model(cfg_dict, variables):
    model = get_model(config_from_dict(cfg_dict), device="cpu")
    load_jax_variables(model, variables, RULES)
    return model


def assert_adam_step_close(got: dict, want: dict, init: dict, lr: float):
    """Parameters after one Adam step, to rtol 1e-3 / atol 1e-6. Adam's
    first step moves each element by ``lr * g / (|g| + eps)``: ±lr unless
    the gradient is within a few ``eps`` of 0, which float32 rounding alone
    decides for a gradient that is 0 in exact arithmetic (a bias that a
    BatchNorm follows). Elements that ``want`` moved by less than 0.9 lr are
    held to that bound only; they must be fewer than 5%."""
    loose, total = 0, 0
    for name, w in want.items():
        if name.endswith(("num_batches_tracked", "running_mean", "running_var")):
            continue
        g, w0 = got[name].double(), init[name].double()
        w = w.double()
        firm = (w - w0).abs() > 0.9 * lr
        np.testing.assert_allclose(g[firm].numpy(), w[firm].numpy(),
                                   rtol=1e-3, atol=1e-6, err_msg=name)
        assert float((g - w0).abs().max()) <= lr + 1e-6, name
        loose += int((~firm).sum())
        total += firm.numel()
    assert loose < 0.05 * total, (loose, total)


class ShardMeanLoss(torch.nn.Module):
    """``criterion`` on each of ``shards`` equal row blocks of the output
    and batch, averaged: what a world of ``shards`` ranks computes. The
    balanced heatmap loss scales by each batch's own positive count, so it
    is not a mean over rows."""

    def __init__(self, criterion, shards):
        super().__init__()
        self.criterion = criterion
        self.shards = shards

    def forward(self, out, batch):
        parts = [self.criterion(o, {k: v.chunk(self.shards)[i]
                                    for k, v in batch.items()})
                 for i, o in enumerate(out.chunk(self.shards))]
        loss = sum(p[0] for p in parts) / self.shards
        return loss, {k: sum(p[1][k] for p in parts) / self.shards
                      for k in parts[0][1]}


@pytest.mark.parametrize("sync_bn", [True, False], ids=["syncbn", "per_rank_bn"])
def test_world2_step_equals_jax_two_devices(sync_bn, tmp_path):
    """One Adam step of a world of 2 gloo ranks, rows 0-3 and 4-7, equals
    JAX's ``make_train_step`` over ``make_mesh(2)`` on the same 8 rows:
    loss to 1e-5, parameters to rtol 1e-3 / atol 1e-6 (JAX's own
    tolerance, ``tests/test_distributed.py:118-119``), BatchNorm running
    statistics (JAX's ``pmean`` of each device's, with SyncBN off) to
    float32 rounding. Both ranks end with the same state. With SyncBN on it
    also equals one process's step on all 8 rows of the same loss."""
    cfg_dict = _cfg_dict(sync_bn)
    batch = _batch()
    variables = init_jax(jax_get_model(jax_config(cfg_dict)),
                         batch["img"][:1], train=False)
    model = _port_model(cfg_dict, variables)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    torch.save({"model": model.state_dict(),
                "criterion": get_loss(config_from_dict(cfg_dict)).state_dict()},
               tmp_path / "init.pt")
    torch.save(_port_batch(batch), tmp_path / "batch.pt")
    ranks = Ranks(step_rank, 2, tmp_path, cfg_dict, str(tmp_path / "init.pt"),
                  str(tmp_path / "batch.pt"), sync_bn, str(tmp_path))
    params, stats, jax_loss = _jax_step(cfg_dict, variables, batch, sync_bn)
    ranks.join()
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=True)
             for r in range(2)]
    assert [r["rows"] for r in ranks] == [(0, 4), (4, 8)]
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k, v in ranks[0]["model"].items():
        assert torch.equal(v, ranks[1]["model"][k]), k
    got = ranks[0]["model"]
    assert ranks[0]["metrics"]["loss"] == pytest.approx(jax_loss, rel=1e-5)

    twin = _port_model(cfg_dict, {"params": params, "batch_stats": stats})
    lr = cfg_dict["OPTIMIZER"]["lr"]
    assert_adam_step_close(got, twin.state_dict(), init, lr)
    for name, want in twin.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(got[name], want, rtol=1e-5, atol=1e-6,
                                       msg=name)

    if sync_bn:
        cfg = config_from_dict(cfg_dict)
        single = _port_model(cfg_dict, variables)
        tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
        state = TrainState.create(single, ShardMeanLoss(get_loss(cfg), 2), tx)
        metrics = TD.make_train_step("cpu")(state, _port_batch(batch))
        assert float(metrics["loss"]) == pytest.approx(
            ranks[0]["metrics"]["loss"], rel=1e-5)
        assert_adam_step_close(got, single.state_dict(), init, lr)
        for name, want in single.state_dict().items():
            if name.endswith(("running_mean", "running_var")):
                torch.testing.assert_close(got[name], want, rtol=1e-5,
                                           atol=1e-6, msg=name)


def _records(root, n):
    """A FreiHAND-style COCO fixture of ``n`` 64x64 records."""
    from PIL import Image

    rng = np.random.RandomState(0)
    (root / "images").mkdir()
    images, anns = [], []
    for i in range(n):
        name = f"images/{i}.jpg"
        Image.fromarray(rng.randint(0, 255, (64, 64, 3), np.uint8)).save(
            root / name)
        images.append(dict(id=i, file_name=name, width=64, height=64))
        kpts = [v for xy in rng.uniform(8, 56, (K, 2))
                for v in (float(xy[0]), float(xy[1]), 1)]
        anns.append(dict(id=i, image_id=i, category_id=1, iscrowd=0,
                         keypoints=kpts, bbox=[0.0, 0.0, 64.0, 64.0]))
    ann = root / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=anns,
                                   categories=[dict(id=1, name="hand")])))
    split = dict(ann_file=str(ann), img_prefix=str(root) + "/")
    return dict(MODEL=dict(name="litehandnet"),
                DATASET=dict(name="freihand", num_joints=K,
                             image_size=[32, 32], heatmap_size=[8, 8],
                             train=split, val=split, test=split),
                PIPELINE=dict(), TRAIN=dict(batch_per_gpu=2))


def test_loader_shards_equal_jax(tmp_path, monkeypatch):
    """n = 10 records over a world of 3: each rank's indices, batch count and
    the records of its batches (train shuffled, val padded) equal JAX's
    loader in process r of 3, for every r."""
    from litehandnet_tpu.data.loader import DataLoader as JaxLoader
    from litehandnet_tpu_torch.data.loader import DataLoader

    cfg_dict = _records(tmp_path, 10)
    for rank in range(3):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        monkeypatch.setattr(jax, "process_count", lambda: 3)
        monkeypatch.setattr(TD, "process_index", lambda r=rank: r)
        monkeypatch.setattr(TD, "process_count", lambda: 3)
        for split in ("train", "val"):
            kw = dict(batch_size=2, use_device_pipeline=False, num_workers=1,
                      seed=5)
            want = JaxLoader(jax_config(cfg_dict), split, **kw)
            got = DataLoader(config_from_dict(cfg_dict), split,
                             use_native=False, **kw)
            assert list(got.local_indices) == list(want.local_indices)
            assert len(got.local_indices) == 4
            assert len(got) == len(want)
            ids = [list(b["bbox_id"]) for b in got.batches(1)]
            assert ids == [list(b["bbox_id"]) for b in want.batches(1)]
            got.close()
            want.close()
        every = DataLoader(config_from_dict(cfg_dict), "val", batch_size=2,
                           use_device_pipeline=False, shard=False)
        assert list(every.local_indices) == list(range(10))


def test_trainer_fit_world2_chief_writes_and_ranks_restore(tmp_path, rank_env):  # noqa: F811
    """``Trainer.fit`` at world 2 over two epochs of 2 batches (each rank
    its 4 of 8 rows): the LR schedule is JAX's at ``world_size=2``; the
    chief alone writes (every ``torch.save`` of the run is rank 0's); both
    ranks end with the same weights and best-loss floor, and both restore
    the best slot, onto their own state, equal to those weights."""
    cfg_dict = _cfg_dict(True)
    cfg_dict["CHECKPOINT"] = dict(interval=1)
    batches = []
    for seed in (3, 4):
        b = _port_batch(_batch(seed))
        batches.append(b)
    torch.save(batches, tmp_path / "batches.pt")
    log_dir = tmp_path / "run"
    run_world(fit_rank, 2, tmp_path, cfg_dict, str(tmp_path / "batches.pt"),
              str(log_dir), str(tmp_path))
    ranks = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
             for r in range(2)]
    assert [r["world"] for r in ranks] == [2, 2]
    assert ranks[0]["saves"] > 0 and ranks[1]["saves"] == 0
    assert ranks[0]["step"] == ranks[1]["step"] == 4
    assert ranks[0]["min_val_loss"] == ranks[1]["min_val_loss"]
    assert np.isfinite(ranks[0]["min_val_loss"])
    for r in ranks:
        assert r["meta"]["epoch"] in (0, 1)
        for k, v in ranks[0]["trained"].items():
            assert torch.equal(r["trained"][k], v), k
    for k in ranks[0]["restored"]:
        assert torch.equal(ranks[0]["restored"][k], ranks[1]["restored"][k]), k
    best = json.loads((log_dir / "best.meta.json").read_text())
    assert best["min_val_loss"] == pytest.approx(ranks[0]["min_val_loss"])
    assert len((log_dir / "metrics.jsonl").read_text().splitlines()) == 2 * 3

    _, jax_schedule = jax_optimizer_from_config(
        jax_config(cfg_dict), steps_per_epoch=2, world_size=2)
    want = [float(jax_schedule(t)) for t in range(6)]
    np.testing.assert_allclose(ranks[0]["lrs"], want, rtol=1e-6)
    assert ranks[0]["lrs"][0] == pytest.approx(2e-3)


@pytest.fixture
def world_of_one(tmp_path):
    """A gloo process group of this process alone; gone afterwards."""
    TD.initialize_multihost(f"file://{tmp_path}/store", 1, 0, device="cpu",
                            timeout=timedelta(seconds=30))
    try:
        yield TD.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_synced_batchnorm_in_a_world_of_one(world_of_one, monkeypatch):
    """A synced site computes the plain two-pass statistics through the
    all-reduce (no ``moments``, no fused depthwise producer), which at world
    1 are the per-rank ones; gradients flow through the all-reduce."""
    assert world_of_one.size == 1 and world_of_one.group is not None
    torch.manual_seed(0)
    x = torch.randn(4, 128, 5, 5, requires_grad=True)
    plain, synced = L.TorchBatchNorm(128), L.TorchBatchNorm(128)
    L.set_sync_bn(synced, world_of_one.group)
    calls = []
    real = L.moments
    monkeypatch.setattr(L, "moments", lambda t: calls.append(1) or real(t))
    y_plain = plain(x)
    assert calls == [1]
    xs = x.detach().clone().requires_grad_(True)
    y_synced = synced(xs)
    assert calls == [1]
    torch.testing.assert_close(y_synced, y_plain, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(synced.running_var, plain.running_var)
    y_plain.square().sum().backward()
    y_synced.square().sum().backward()
    torch.testing.assert_close(xs.grad, x.grad, rtol=1e-4, atol=1e-5)

    monkeypatch.setenv("LHN_FUSED_DW", "1")
    conv = L.RepConv(128, 128, 3, 1, 2, 2, groups=128).train()
    z = torch.randn(2, 128, 8, 8)
    assert conv._dw_fusable(z)
    L.set_sync_bn(conv, world_of_one.group)
    assert not conv._dw_fusable(z)


def test_world_helpers(tmp_path, monkeypatch):
    """Without a process group: a world of 1, the chief, no-op rendezvous,
    ranks refused in one process; on CUDA, more devices than exist are
    refused; ``batch_spec`` splits in rank order; rank 0's seed is the
    shared one; ``globalize_batch`` is the identity."""
    assert not dist.is_initialized()
    assert TD.initialize_multihost(None) is False
    assert TD.is_chief() and TD.process_count() == 1
    world = TD.make_mesh(device="cpu")
    assert (world.size, world.rank, world.group) == (1, 0, None)
    with pytest.raises(ValueError, match="process group"):
        TD.make_mesh(2, device="cpu")
    two = TD.World(2, 1, torch.device("cpu"))
    assert TD.batch_spec(two, 8) == slice(4, 8)
    with pytest.raises(ValueError):
        TD.batch_spec(two, 7)
    assert TD.rank_seed(1234, 0) == 1234 != TD.rank_seed(1234, 1)
    batch = {"img": np.zeros(1)}
    assert TD.globalize_batch(batch, world) is batch
    with pytest.raises(ValueError, match="num_processes"):
        TD.initialize_multihost("localhost:1", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 devices asked for, 1"):
        TD.make_mesh(2)
    with pytest.raises(ValueError, match="2 devices asked for, 1"):
        TD.run_ranks(fit_rank, 2)
    assert TD.local_devices("cuda") == [torch.device("cuda", 0)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        TD.make_mesh()
    assert TD.local_devices("cpu") == [torch.device("cpu")]
