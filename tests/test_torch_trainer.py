"""The port's ``Trainer`` (``litehandnet_tpu_torch.train.trainer``) on the
CPU, against the reference loop semantics that ``tests/test_trainer_loop.py``
holds the JAX trainer to:

- eval fires on ``epoch % EVAL.interval == 0``, the first epoch included;
- the periodic checkpoint saves on ``epoch % CHECKPOINT.interval == 0`` and
  at the last epoch; ``best`` saves on a validation loss ``<=`` the floor;
- a full resume restores the state, the epoch, the step and the best-loss
  floor;
- ``OPTIMIZER.resume=False`` reloads the weights only: a fresh optimizer,
  epoch 0, and the schedule rebuilt without warmup.

Batches are made with numpy from a seed, at 64x64 and 32 features."""

import json
import os

import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.ops.encode import msra_heatmaps
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager
from litehandnet_tpu_torch.train.trainer import Trainer
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

B, IMG, HM = 2, 64, 16


def _tiny_cfg(save_root, **updates):
    cfg = get_config()
    cfg.ID = 995
    cfg.MODEL.update(input_channel=32, num_stage=3, num_block=[1, 1])
    cfg.DATASET.update(image_size=[IMG, IMG], heatmap_size=[HM, HM])
    cfg.CHECKPOINT.update(save_root=str(save_root) + "/", interval=100,
                          resume=False)
    cfg.TRAIN.update(batch_per_gpu=B, total_epoches=5)
    cfg.EVAL.interval = 2
    cfg.OPTIMIZER.warmup_steps = 0
    for key, val in updates.items():
        sec, _, name = key.partition(".")
        cfg[sec][name] = val
    return cfg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    joints = torch.from_numpy(rng.uniform(8, IMG - 8, size=(B, 21, 2)))
    target, weight = msra_heatmaps(joints, torch.ones(B, 21), (IMG, IMG),
                                   (HM, HM), 2.0, unbiased=True)
    return {"img": rng.normal(size=(B, IMG, IMG, 3)).astype(np.float32),
            "target": target, "target_weight": weight}


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """One 5-epoch fit of one step each, with spies on eval and saves."""
    root = tmp_path_factory.mktemp("torch_trainer_loop")
    cfg = _tiny_cfg(root)
    batch = _batch()
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu")
    evals, periodic, bests = [], [], []
    orig_val = trainer.val_one_epoch

    def spy_val(state, batches, epoch):
        evals.append(epoch)
        return orig_val(state, batches, epoch)

    orig_save = trainer.ckpt.save

    def spy_save(state, epoch, min_val_loss=float("inf"), best=False):
        (bests if best else periodic).append(epoch)
        return orig_save(state, epoch, min_val_loss, best=best)

    trainer.val_one_epoch = spy_val
    trainer.ckpt.save = spy_save
    state = trainer.init_state(seed=0)
    state = trainer.fit(state, lambda epoch: [batch], lambda: [batch])
    trainer.close()
    return (root, cfg, state, evals, periodic, bests, trainer.min_val_loss,
            trainer.ckpt.directory)


def test_eval_and_save_cadence(trained):
    _, _, state, evals, periodic, bests, floor, directory = trained
    # 5 epochs, EVAL.interval=2 -> epochs 0, 2, 4 (reference cadence)
    assert evals == [0, 2, 4]
    # CHECKPOINT.interval=100 -> only epoch 0 periodically, plus the last
    # epoch's save
    assert periodic == [0, 4]
    # the first eval always beats the inf floor
    assert bests and bests[0] == 0 and set(bests) <= set(evals)
    assert state.step == 5
    assert np.isfinite(floor)
    # the run directory: both slots, their meta files, the config, the log
    for name in ("checkpoint.pt", "checkpoint.meta.json", "best.pt",
                 "best.meta.json", "config.json", "metrics.jsonl"):
        assert os.path.exists(os.path.join(directory, name)), name
    with open(os.path.join(directory, "checkpoint.meta.json")) as f:
        meta = json.load(f)
    assert meta == {"epoch": 4, "min_val_loss": pytest.approx(floor),
                    "step": 5}
    with open(os.path.join(directory, "config.json")) as f:
        assert json.load(f)["ID"] == 995
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    assert [r["step"] for r in records if "val/loss" in r] == [0, 2, 4]
    assert [r["step"] for r in records if "train/loss" in r] == list(range(5))
    assert all(np.isfinite(r["train/loss"]) for r in records
               if "train/loss" in r)


def test_full_resume_restores_epoch_step_floor(trained):
    root, _, state, _, _, _, floor, _ = trained
    cfg = _tiny_cfg(root, **{"CHECKPOINT.resume": True,
                             "OPTIMIZER.resume": True})
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu")
    resumed = trainer.maybe_resume(trainer.init_state(seed=1))
    # the `checkpoint` slot was written at the last epoch (4)
    assert trainer.start_epoch == 5
    assert resumed.step == 5
    # the true floor, where the reference resets it to 1e6
    assert trainer.min_val_loss == pytest.approx(floor)
    for (name, got), want in zip(resumed.model.state_dict().items(),
                                 state.model.state_dict().values()):
        assert torch.equal(got, want), name
    # Adam's moments and its step count come back too
    got_opt = resumed.optimizer.state_dict()["state"]
    want_opt = state.optimizer.state_dict()["state"]
    assert got_opt.keys() == want_opt.keys()
    for k in want_opt:
        for name in ("exp_avg", "exp_avg_sq", "step"):
            assert torch.equal(got_opt[k][name], want_opt[k][name]), (k, name)
    assert resumed.scheduler.last_epoch == 5
    # resumed past the last epoch: fit trains no further
    assert trainer.fit(resumed, lambda epoch: [_batch()]).step == 5
    trainer.close()


def test_weights_only_resume(trained):
    root, _, state, _, _, _, _, _ = trained
    # the optimizer type changes too (Adam -> SGD): a weights-only restart
    # does not read the checkpoint's optimizer state
    cfg = _tiny_cfg(root, **{"CHECKPOINT.resume": True,
                             "OPTIMIZER.resume": False,
                             "OPTIMIZER.type": "SGD",
                             "OPTIMIZER.warmup_steps": 50})
    trainer = Trainer(cfg, steps_per_epoch=1, device="cpu")
    base_lr = float(cfg.OPTIMIZER.lr)
    # before the resume the schedule starts on the warmup ramp
    assert trainer.schedule(0) == pytest.approx(base_lr / 50, rel=1e-12)
    resumed = trainer.maybe_resume(trainer.init_state(seed=1))
    # weights and BatchNorm statistics come back...
    for (name, got), want in zip(resumed.model.state_dict().items(),
                                 state.model.state_dict().values()):
        assert torch.equal(got, want), name
    # ...but the epoch, the step, the optimizer and the floor start fresh
    assert trainer.start_epoch == 0
    assert resumed.step == 0
    assert trainer.min_val_loss == float("inf")
    assert isinstance(resumed.optimizer, torch.optim.SGD)
    assert not resumed.optimizer.state
    # and the warmup is skipped like the reference (dist_train.py:145-147):
    # full LR from step 0, in the schedule and in the optimizer
    assert trainer.schedule(0) == pytest.approx(base_lr, rel=1e-12)
    assert resumed.optimizer.param_groups[0]["lr"] == pytest.approx(
        base_lr, rel=1e-12)
    trainer.close()


def test_fit_is_reproducible_with_dropout(tmp_path):
    """Channel dropout is on (ca_type 'ca', p = 0.3): the step generators
    come from ``seed + 1234``, one draw per step, so a seed fixes the run
    and another seed changes it."""
    batch = _batch(seed=3)

    def fit(seed, sub):
        cfg = _tiny_cfg(tmp_path / sub, **{"TRAIN.total_epoches": 1})
        trainer = Trainer(cfg, steps_per_epoch=2, device="cpu")
        state = trainer.init_state(seed=0)
        state = trainer.fit(state, lambda epoch: [batch, batch], seed=seed)
        trainer.close()
        return [p.detach().clone() for p in state.model.parameters()]

    a, b, c = fit(0, "a"), fit(0, "b"), fit(1, "c")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not all(torch.equal(x, y) for x, y in zip(a, c))


@pytest.mark.parametrize("name", ["mynet/freihand_256",
                                  "hourglass_ablation/freihand_256_cbam"])
def test_fit_trains_the_other_families(name, tmp_path):
    """``Trainer`` takes the other ported families unchanged, with the
    criterion their config names: one epoch of two steps at test size gives
    finite losses, moves the weights, and is fixed by its seed (mynet's
    gates draw element-wise dropout from the step generators)."""
    batch = _batch(seed=4)

    def fit(seed, sub):
        cfg = get_config(name)
        cfg.MODEL.update(input_channel=32, num_stage=3, num_block=[1, 1])
        cfg.DATASET.update(image_size=[IMG, IMG], heatmap_size=[HM, HM])
        cfg.CHECKPOINT.update(save_root=str(tmp_path / sub) + "/",
                              resume=False)
        cfg.TRAIN.total_epoches = 1
        trainer = Trainer(cfg, steps_per_epoch=2, device="cpu")
        state = trainer.init_state(seed=0)
        before = [p.detach().clone() for p in state.model.parameters()]
        losses = []
        step = trainer.train_step

        def recorded(*args):
            metrics = step(*args)
            losses.append(float(metrics["loss"]))
            return metrics

        trainer.train_step = recorded
        state = trainer.fit(state, lambda epoch: [batch, batch], seed=seed)
        trainer.close()
        after = [p.detach().clone() for p in state.model.parameters()]
        assert not all(torch.equal(x, y) for x, y in zip(before, after))
        return losses, after

    (la, a), (lb, b) = fit(0, "a"), fit(0, "b")
    assert len(la) == 2 and all(np.isfinite(v) for v in la)
    assert la == lb
    assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_run_directory_of_another_config_is_refused(trained):
    root, cfg, _, _, _, _, _, directory = trained
    other = _tiny_cfg(root)
    other.ID = 996
    with pytest.raises(ValueError, match="ID=995"):
        CheckpointManager(directory, other)
    # the refused config did not overwrite the run's config.json
    with open(os.path.join(directory, "config.json")) as f:
        assert json.load(f)["ID"] == cfg.ID


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="checks the refusal where no CUDA device exists")
def test_trainer_runs_on_cuda_unless_the_cpu_is_asked(tmp_path):
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(_tiny_cfg(tmp_path), steps_per_epoch=1)
