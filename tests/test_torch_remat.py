"""The rematerialized train step (``make_train_step(remat=...)``,
``LHN_REMAT``; ``train/distributed.Rematerialized``) on the CPU.

Held to JAX: the port's remat step against JAX's ``make_train_step(...,
remat=True)`` on JAX's own tiny LiteHandNet (``tests/test_distributed.py``'s
``_cfg``), one device, SyncBN off, dropout identity on both sides, at JAX's
own tolerances (``test_remat_matches_plain_step``).

Held to the port's plain step, from the same weights, batch and dropout
generator seed: the loss, every parameter after the Adam step, every buffer
(``num_batches_tracked`` included) and the generator's state after the
step, all bit for bit. The CPU runs the same ops on the same inputs in the
recompute, so the recomputed activations, and with them the gradients, are
the first forward's bits. Dropout is live in the flagship cases.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_config
from litehandnet_tpu.losses import get_loss as jax_get_loss
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import litehandnet as jax_litehandnet
from litehandnet_tpu.train import distributed as JD
from litehandnet_tpu.train.optim import (
    make_optimizer_from_config as jax_optimizer_from_config,
)
from litehandnet_tpu.train.state import TrainState as JaxTrainState
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.layers import ChannelDropout, TorchBatchNorm
from litehandnet_tpu_torch.ops import fused_bn
from litehandnet_tpu_torch.train import distributed as TD
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.precision import DynamicLossScaler
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.weights import (
    load_jax_variables,
    randomize_,
    rules_for,
)
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import init_jax, no_dropout  # noqa: F401  (fixture)
from tests.torch_parity import (
    STEP_LR,
    assert_step_matches_jax,
    jax_names,
    small_model_cfg,
    zoo_cfg,
)
from tests.torch_workers import remat_rank, run_world

B, SIZE, HM, K = 8, 64, 16, 21
TRAIN = dict(
    TRAIN=dict(total_epoches=2, batch_per_gpu=B),
    OPTIMIZER=dict(type="Adam", lr=1e-3, warmup_steps=0, step_epoch=[1]),
    LOSS=dict(type="TopdownHeatmapLoss", loss_weight=[1.0, 0.1],
              auto_weight=False),
)


def _jax_cfg_dict():
    """``tests/test_distributed.py``'s ``_cfg(sync_bn=False)``."""
    return dict(
        MODEL=dict(name="litehandnet", num_stage=3, num_block=[1, 1],
                   input_channel=32, ca_type="ca", reduction=2,
                   activation="leakyrelu", output_channel=K),
        DATASET=dict(num_joints=K, image_size=[SIZE, SIZE],
                     heatmap_size=[HM, HM]),
        PIPELINE=dict(simdr_split_ratio=0),
        TRAIN=dict(total_epoches=2, batch_per_gpu=2, syncBN=False),
        OPTIMIZER=dict(type="Adam", lr=1e-3, warmup_steps=0, step_epoch=[1]),
        LOSS=dict(type="TopdownHeatmapLoss", loss_weight=[1.0, 0.1],
                  auto_weight=False),
    )


def _batch(seed=0):
    """``test_remat_matches_plain_step``'s batch: unit-normal images and
    U(0, 1) targets, all weights 1."""
    rng = np.random.RandomState(seed)
    return {"img": rng.normal(size=(B, SIZE, SIZE, 3)).astype(np.float32),
            "target": rng.uniform(0, 1, size=(B, HM, HM, K)).astype(np.float32),
            "target_weight": np.ones((B, K), np.float32)}


def _port_batch(batch):
    return {"img": torch.from_numpy(batch["img"]),
            "target": torch.from_numpy(
                np.ascontiguousarray(batch["target"].transpose(0, 3, 1, 2))),
            "target_weight": torch.from_numpy(batch["target_weight"])}


def _steps(cfg_dict, batch, remat, gen_seed=7, steps=1, scaler=None):
    """``steps`` steps on ``batch`` of a fresh state, weights and statistics
    drawn from seed 0: (state, metrics of each step, the generator after
    them)."""
    cfg = config_from_dict(cfg_dict)
    model = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(0))
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    state = TrainState.create(model, get_loss(cfg), tx, loss_scaler=scaler)
    step = TD.make_train_step("cpu", remat=remat)
    gen = torch.Generator().manual_seed(gen_seed)
    return state, [step(state, batch, gen) for _ in range(steps)], gen


def assert_same_step(a, b):
    """Two ``_steps`` results equal bit for bit: every metric, parameter,
    gradient and buffer, the optimizer's moments and the generator."""
    (sa, ma, ga), (sb, mb, gb) = a, b
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k]), k
    for (name, v), w in zip(sa.model.state_dict().items(),
                            sb.model.state_dict().values()):
        assert torch.equal(v, w), name
    for (name, p), q in zip(sa.model.named_parameters(),
                            sb.model.parameters()):
        assert (p.grad is None) == (q.grad is None), name
        if p.grad is not None:   # NaN after an overflowing step
            torch.testing.assert_close(p.grad, q.grad, rtol=0, atol=0,
                                       equal_nan=True, msg=name)
    for s, t in zip(sa.optimizer.state.values(), sb.optimizer.state.values()):
        for k in s:
            assert torch.equal(torch.as_tensor(s[k]), torch.as_tensor(t[k])), k
    assert torch.equal(ga.get_state(), gb.get_state())
    assert sa.step == sb.step


def _flagship(features=32):
    cfg = small_model_cfg("ca", reduction=2, features=features)
    cfg["MODEL"]["num_stage"] = 3
    cfg["MODEL"]["num_block"] = [1, 1]
    return dict(cfg, **TRAIN)


# -- against JAX -------------------------------------------------------------

def test_remat_step_matches_jax_remat_step(no_dropout):  # noqa: F811
    """One Adam step with ``remat=True`` on both sides, from JAX's seeded
    variables carried in by ``utils.weights``, held as JAX holds its remat
    step to its plain one (``tests/test_distributed.py:144-152``): the loss
    to rtol 1e-5, the first parameter leaf to rtol 1e-3 / atol 1e-6, and
    every running statistic (JAX: the first) to rtol 1e-4 / atol 1e-7.
    Adam's first step moves an element whose gradient is 0 in exact
    arithmetic by what float32 rounding decides (``tests/
    test_torch_distributed.assert_adam_step_close``; the port's plain step
    misses JAX's plain step there just as its remat step misses JAX's remat
    step), so every gradient leaf is held in float64 below."""
    cfg_dict = _jax_cfg_dict()
    batch = _batch()
    cfg = jax_config(cfg_dict)
    jmodel = jax_get_model(cfg)
    variables = init_jax(jmodel, batch["img"][:1], train=False)
    tx, _ = jax_optimizer_from_config(cfg, steps_per_epoch=10, world_size=1)
    step = JD.make_train_step(jmodel, jax_get_loss(cfg), tx, JD.make_mesh(1),
                              donate=False, remat=True)
    jstate, jmetrics = step(JaxTrainState.create(variables, {}, tx),
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(0))

    rules = rules_for("litehandnet")
    model = no_dropout(get_model(config_from_dict(cfg_dict), device="cpu"))
    load_jax_variables(model, variables, rules)
    pcfg = config_from_dict(cfg_dict)
    ptx, _ = make_optimizer_from_config(pcfg, steps_per_epoch=10)
    state = TrainState.create(model, get_loss(pcfg), ptx)
    metrics = TD.make_train_step("cpu", remat=True)(state, _port_batch(batch))
    assert float(metrics["loss"]) == pytest.approx(float(jmetrics["loss"]),
                                                   rel=1e-5)

    twin = copy.deepcopy(model)
    load_jax_variables(twin, {"params": jax.tree.map(np.asarray, jstate.params),
                              "batch_stats": jax.tree.map(
                                  np.asarray, jstate.batch_stats)}, rules)
    want = twin.state_dict()
    path = jax.tree_util.tree_flatten_with_path(jstate.params)[0][0][0]
    first = "params/" + "/".join(p.key for p in path)
    (name,) = [k for k, v in jax_names(want, rules).items() if v == first]
    np.testing.assert_allclose(model.state_dict()[name].numpy(),
                               want[name].numpy(), rtol=1e-3, atol=1e-6,
                               err_msg=name)
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    assert stats
    for name in stats:
        np.testing.assert_allclose(model.state_dict()[name].numpy(),
                                   want[name].numpy(), rtol=1e-4, atol=1e-7,
                                   err_msg=name)


def test_remat_step_matches_jax_remat_step_float64(no_dropout, monkeypatch):  # noqa: F811
    """The same model on the batch's first two rows, one float64 SGD step
    rematerialized on both sides: the loss, every gradient leaf and every
    parameter and statistic after it to 1e-9
    (``torch_parity.assert_step_matches_jax``)."""
    cfg_dict = _jax_cfg_dict()
    cfg_dict["OPTIMIZER"] = dict(type="SGD", lr=STEP_LR, warmup_steps=0)
    batch = {k: v[:2] for k, v in _batch().items()}
    variables = init_jax(jax_get_model(jax_config(cfg_dict)),
                         batch["img"][:1], train=False)
    model = no_dropout(get_model(config_from_dict(cfg_dict), device="cpu"))
    jax_batch = dict(batch)
    port_batch = {k: v.numpy() for k, v in _port_batch(batch).items()}
    assert_step_matches_jax(cfg_dict, variables, jax_batch, port_batch,
                            monkeypatch, [jax_litehandnet],
                            rules_for("litehandnet"), port_model=model,
                            remat=True)


# -- against the port's plain step -------------------------------------------

def test_flagship_remat_equals_plain_with_live_dropout():
    """The flagship with ``ChannelDropout(0.3)`` live and an explicit
    generator, two steps: the remat step replays the generator, so it draws
    the plain step's masks; the generator leaves the step in the same
    state. Another seed draws other masks (the dropout is live)."""
    cfg_dict = _flagship()
    batch = _port_batch(_batch())
    plain = _steps(cfg_dict, batch, remat=False, steps=2)
    assert any(isinstance(m, ChannelDropout) and m.p == 0.3
               for m in plain[0].model.modules())
    assert_same_step(plain, _steps(cfg_dict, batch, remat=True, steps=2))
    other = _steps(cfg_dict, batch, remat=True, gen_seed=8)
    assert float(other[1][0]["loss"]) != float(plain[1][0]["loss"])


def test_litehrnet_fuse_batchnorms_move_twice_not_four_times():
    """Lite-HRNet's fuse BatchNorms run twice a forward (by design):
    under remat they still move twice a step, not four times."""
    cfg_dict = dict(zoo_cfg("litehrnet", depth=18), **TRAIN)
    batch = _port_batch(_batch())
    plain = _steps(cfg_dict, batch, remat=False)
    remat = _steps(cfg_dict, batch, remat=True)
    assert_same_step(plain, remat)
    tracked = {int(m.num_batches_tracked) for m in remat[0].model.modules()
               if isinstance(m, TorchBatchNorm)}
    assert tracked == {1, 2}


def test_fused_kernel_sites_launch_twice_under_remat(monkeypatch):
    """With ``LHN_FUSED_DW=1`` and ``LHN_FUSED_BN_SMALLC=1`` every
    ``moments`` and ``dw_conv3x3_stats`` site runs once in the forward and
    once in the recompute (their plain versions on the CPU): twice the
    plain step's calls, and the same step."""
    monkeypatch.setenv("LHN_FUSED_DW", "1")
    monkeypatch.setenv("LHN_FUSED_BN_SMALLC", "1")
    calls = {"moments": 0, "dw": 0}
    moments, dw = fused_bn.moments_kernel, fused_bn.dw_kernel

    def count(name, fn):
        def counted(*args):
            calls[name] += 1
            return fn(*args)
        return counted

    monkeypatch.setattr(fused_bn, "moments_kernel", count("moments", moments))
    monkeypatch.setattr(fused_bn, "dw_kernel", count("dw", dw))
    cfg_dict = _flagship()
    batch = _port_batch(_batch())
    plain = _steps(cfg_dict, batch, remat=False)
    once = dict(calls)
    assert once["moments"] > 0 and once["dw"] > 0
    remat = _steps(cfg_dict, batch, remat=True)
    assert {k: calls[k] - once[k] for k in calls} == {
        k: 2 * v for k, v in once.items()}
    assert_same_step(plain, remat)


def test_overflow_skip_under_remat_restores_buffers():
    """With a loss scaler, a non-finite remat step leaves every parameter
    and buffer as it was (the recompute moves no statistics, and the
    forward's moves are put back) and halves the scale; a finite one before
    it equals the plain step's."""
    cfg_dict = _flagship()
    batch = _port_batch(_batch())
    bad = dict(batch, img=torch.full_like(batch["img"], float("nan")))
    runs = {}
    for remat in (False, True):
        scaler = DynamicLossScaler(init_scale=2.0 ** 10)
        state, metrics, gen = _steps(cfg_dict, batch, remat, scaler=scaler)
        before = {k: v.clone() for k, v in state.model.state_dict().items()}
        step = TD.make_train_step("cpu", remat=remat)
        metrics.append(step(state, bad, gen))
        assert not np.isfinite(float(metrics[-1]["loss"]))
        for k, v in state.model.state_dict().items():
            assert torch.equal(v, before[k]), k
        assert state.loss_scaler.scale == 2.0 ** 9 and state.step == 2
        runs[remat] = (state, metrics[:1], gen)
    assert_same_step(runs[False], runs[True])


def test_lhn_remat_env_and_explicit_false(monkeypatch):
    """``remat=None`` reads ``LHN_REMAT == "1"`` when the step is built;
    an explicit ``False`` wins over it. The checkpoint runs exactly when
    remat is on, and every setting takes the same step."""
    used = []
    real = TD.checkpoint
    monkeypatch.setattr(TD, "checkpoint",
                        lambda *a, **kw: used.append(1) or real(*a, **kw))
    cfg_dict = _flagship()
    batch = _port_batch(_batch())
    want = _steps(cfg_dict, batch, remat=False)
    assert used == []
    monkeypatch.setenv("LHN_REMAT", "1")
    assert_same_step(want, _steps(cfg_dict, batch, remat=None))
    assert used == [1]
    assert_same_step(want, _steps(cfg_dict, batch, remat=False))
    assert used == [1]
    monkeypatch.setenv("LHN_REMAT", "0")
    assert_same_step(want, _steps(cfg_dict, batch, remat=None))
    assert used == [1]


def test_world2_syncbn_remat_equals_plain_on_every_rank(tmp_path):
    """A world of 2 gloo ranks with SyncBN and live dropout (each rank's
    generator from ``rank_seed``), under DDP: on every rank the remat step
    equals the plain step bit for bit, loss, parameters and buffers, and a
    remat step from another seed draws other masks. The
    recompute's SyncBN all-reduces run inside the backward beside DDP's
    gradient buckets; the ranks finish within the deadline."""
    cfg_dict = _flagship()
    cfg_dict["TRAIN"] = dict(cfg_dict["TRAIN"], syncBN=True)
    model = get_model(config_from_dict(cfg_dict), device="cpu")
    randomize_(model, torch.Generator().manual_seed(0))
    torch.save({"model": model.state_dict()}, tmp_path / "init.pt")
    torch.save(_port_batch(_batch()), tmp_path / "batch.pt")
    run_world(remat_rank, 2, tmp_path, cfg_dict, str(tmp_path / "init.pt"),
              str(tmp_path / "batch.pt"), str(tmp_path))
    ranks = [torch.load(tmp_path / f"remat_rank{r}.pt", weights_only=True)
             for r in range(2)]
    for r, got in enumerate(ranks):
        plain, remat = got["plain"], got["remat"]
        assert plain["metrics"] == remat["metrics"], r
        for k, v in plain["model"].items():
            assert torch.equal(v, remat["model"][k]), (r, k)
        assert got["other_seed_loss"] != plain["metrics"]["loss"], r
    for k, v in ranks[0]["plain"]["model"].items():
        assert torch.equal(v, ranks[1]["plain"]["model"][k]), k
