"""SRHandNet and ``SRHandNetLoss``: the port against JAX on the CPU. The
model (full widths, 24 output channels) on 64x64 inputs at B = 2: eval mode
in float32 (rtol 1e-4, atol 1e-5 of each output's largest magnitude), train
mode in float64 (rtol 1e-9) with the running statistics after the call; the
weight mapping both ways and the full-width parameter count. The loss in
float64 to 1e-9, with and without region channels, with one target weight
and a list per scale. One float64 train step (loss, gradients, statistics)
against JAX's ``make_train_step`` on per-scale targets, and one step from a
``DevicePipeline`` batch (lists of per-scale targets and weights)."""

import copy
import functools

import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.losses import get_loss as jax_get_loss
from litehandnet_tpu.losses import losses as jax_losses
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import srhandnet as jax_srhandnet
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.data.device_pipeline import DevicePipeline
from litehandnet_tpu_torch.losses import SRHandNetLoss, get_loss
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.train.distributed import (
    batch_to_device,
    make_train_step,
)
from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
from litehandnet_tpu_torch.train.state import TrainState
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    STEP_LR,
    assert_family_forward,
    assert_served_config,
    assert_step_matches_jax,
    assert_weights_round_trip,
    init_jax,
    jax_float64,
    step_batches,
    zoo_cfg,
)

RULES = rules_for("srhandnet")
SIZES = [(4, 4), (4, 4), (8, 8), (16, 16)]   # of a 64x64 input


def _x():
    return np.random.RandomState(2).normal(size=(2, 64, 64, 3)).astype(np.float32)


def _cfg():
    return zoo_cfg("srhandnet", output_channel=24, pred_bbox=True)


@functools.lru_cache(maxsize=None)
def _jax_side():
    model = jax_get_model(jax_cfg(_cfg()))
    return model, init_jax(model, _x(), seed=3, train=False)


def _port():
    model = get_model(config_from_dict(_cfg()), device="cpu")
    load_jax_variables(model, _jax_side()[1], RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
def test_forward_parity(mode, monkeypatch):
    model, variables = _jax_side()
    out = assert_family_forward(_port(), model, variables, _x(), mode, RULES,
                                monkeypatch, [jax_srhandnet])
    assert [tuple(o.shape) for o in out] == [(2, 24) + s for s in SIZES]


def test_import_torch_state_dict_round_trip_and_counts():
    assert_weights_round_trip("srhandnet", _port(), _jax_side()[1])


def test_served_config_matches_jax_template():
    assert_served_config("srhandnet/freihand_256", "srhandnet", 51)


def _loss_cfg(region):
    over = {} if region else {"MODEL.output_channel": 21,
                              "MODEL.pred_bbox": False}
    return make_cfg("srhandnet", "freihand", image_size=64, **over)


@pytest.mark.parametrize("weights", ["one", "per_scale"])
@pytest.mark.parametrize("region", [True, False], ids=["region", "no_region"])
def test_loss_matches_jax(region, weights, monkeypatch):
    """``get_loss`` builds ``SRHandNetLoss`` with the region split exactly
    when ``pred_bbox`` and 24 channels; the loss and its parts equal JAX's
    in float64 (the w/h term is L2, as the reference's)."""
    cfg = _loss_cfg(region)
    C = 24 if region else 21
    rng = np.random.RandomState(7)
    outs = [rng.normal(0.3, 0.4, (2, h, w, C)) for h, w in SIZES]
    targets = [rng.uniform(size=(2, h, w, C)) for h, w in SIZES]
    w = [(rng.uniform(size=(2, C)) > 0.2).astype(np.float64) for _ in SIZES]
    w = w if weights == "per_scale" else w[0]
    with jax_float64(monkeypatch, jax_losses):
        crit = jax_get_loss(jax_cfg(cfg))
        want, want_parts = crit.apply({}, outs, {"target": targets,
                                                 "target_weight": w})
        want = float(want)
        want_parts = {k: float(v) for k, v in want_parts.items()}
    port = get_loss(config_from_dict(cfg))
    assert isinstance(port, SRHandNetLoss) and port.with_region == region

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(np.moveaxis(a, -1, 1)))

    got, parts = port([t(o) for o in outs], {
        "target": [t(a) for a in targets],
        "target_weight": ([torch.from_numpy(a) for a in w]
                          if isinstance(w, list) else torch.from_numpy(w))})
    assert set(parts) == set(want_parts) == (
        {"kpt_loss", "wh_loss"} if region else {"kpt_loss"})
    assert float(got) == pytest.approx(want, rel=1e-9)
    for k, v in parts.items():
        assert float(v) == pytest.approx(want_parts[k], rel=1e-9), k


def test_train_step_matches_jax(monkeypatch):
    cfg = make_cfg("srhandnet", "freihand", image_size=64)
    cfg["OPTIMIZER"].update(type="SGD", lr=STEP_LR, warmup_steps=0)
    jax_batch, port_batch = step_batches(24, SIZES)
    variables = init_jax(jax_get_model(jax_cfg(cfg)), jax_batch["img"],
                         seed=5, train=False)
    assert_step_matches_jax(cfg, variables, jax_batch, port_batch,
                            monkeypatch, [jax_srhandnet], RULES)


def test_step_from_device_pipeline_batch():
    """A ``DevicePipeline`` batch of SRHandNet (a list per scale of targets
    and weights) goes through ``batch_to_device`` element by element and
    trains: the step's loss is the criterion's on the model before the
    step, and the BatchNorm statistics move."""
    cfg = config_from_dict(make_cfg("srhandnet", "freihand", image_size=64))
    rng = np.random.RandomState(0)
    B, K = 2, 21
    centers = np.full((B, 2), 64.0, np.float32)
    scales = np.full((B, 2), 64 / 200.0, np.float32)
    joints = (centers[:, None] + rng.uniform(-24, 24, (B, K, 2))).astype(
        np.float32)
    bboxes = np.concatenate([joints.min(1), np.ptp(joints, 1)], -1)
    pipe = DevicePipeline(cfg, list(range(K)), device="cpu")
    batch = pipe(rng.randint(0, 256, (B, 128, 128, 3), dtype=np.uint8),
                 joints, np.ones((B, K), np.float32), centers, scales,
                 np.zeros(B, np.float32), torch.Generator().manual_seed(1),
                 bboxes=bboxes)
    batch = {k: batch[k] for k in ("img", "target", "target_weight")}
    assert isinstance(batch["target"], list) and len(batch["target"]) == 4
    on_cpu = batch_to_device(batch, torch.device("cpu"))
    assert [tuple(t.shape) for t in on_cpu["target"]] == [
        (B, 24) + s for s in SIZES]
    assert all(torch.is_tensor(w) and w.shape == (B, 24)
               for w in on_cpu["target_weight"])

    model = get_model(cfg, device="cpu")
    before = copy.deepcopy(model).train()
    criterion = get_loss(cfg)
    with torch.no_grad():
        want, _ = criterion(before(on_cpu["img"]), on_cpu)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    state = TrainState.create(model, criterion, tx)
    metrics = make_train_step("cpu")(state, batch)
    assert set(metrics) == {"loss", "kpt_loss", "wh_loss"}
    assert float(metrics["loss"]) == pytest.approx(float(want), rel=1e-6)
    assert not torch.equal(model.block1[0].conv3x3[1].running_mean,
                           get_model(cfg, device="cpu")
                           .block1[0].conv3x3[1].running_mean)
