"""``tools/train_center_simdr`` (the Gen-1 center + SimDR trainer) on the
CPU: its sine-decay schedule against JAX's (within 1e-6 of the base LR: JAX
computes it in float32) and AdamW on it against optax (float64, 1e-8),
one float64 step of ``mynet_stacked`` + ``CenterSimdrLoss`` against JAX's
``make_train_step`` from the same weights and batch (loss 1e-9, gradients
1e-9 of their max; dropout identity on both sides), with and without the
SimDR targets (the half-resolution cycle-detection batch has none), and
the CLI for one epoch with the cycle-detection pass on every step, on a
tiny fixture like ``tests/test_train_center_simdr.py``'s (one source image
larger than the decode canvas)."""

import json

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from litehandnet_tpu.config.templates import make_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import ms_att_hourglass_stacked as jax_stacked
from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.tools import train_center_simdr as J
from litehandnet_tpu_torch.models import layers
from litehandnet_tpu_torch.tools import train_center_simdr as T
from litehandnet_tpu_torch.utils.weights import rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    STEP_LR,
    assert_step_matches_jax,
    init_jax,
    step_batches,
)


def test_sine_decay_schedule_equals_jax():
    """Near the end of a period the cosine is small and JAX's float32
    argument moves it by ~2e-6 of itself: held to 1e-6 of the base LR."""
    for spe, T_, gamma in ((10, 40, 0.5), (3, 7, 0.8)):
        mine = T.sine_decay_schedule(2e-3, spe, T_, gamma)
        theirs = J.sine_decay_schedule(2e-3, spe, T_, gamma)
        for step in (0, 1, 5, spe * 3 + 1, spe * T_ // 2, spe * T_,
                     spe * T_ * 3):
            assert mine(step) == pytest.approx(
                float(theirs(jnp.asarray(step))), rel=0, abs=2e-9), step


def test_adamw_on_the_schedule_equals_optax():
    """Five float64 updates of one parameter: torch AdamW through
    ``adamw_factory`` against ``optax.adamw`` on JAX's schedule (weight
    decay 1e-4 times the LR in both). In float32 optax's bias corrections
    (``1 - 0.999 ** t`` in float32) move an update by ~1e-5 of itself, and
    JAX's schedule gives float32 LRs even under x64: held to 1e-8."""
    import jax

    rng = np.random.RandomState(0)
    p0 = rng.normal(size=(7, 3))
    grads = rng.normal(size=(5, 7, 3))
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt, sched = T.adamw_factory(T.sine_decay_schedule(0.05, 2, T=3), 0.05)(
        [param])
    with jax.enable_x64(True):
        tx = optax.adamw(J.sine_decay_schedule(0.05, 2, T=3))
        p = jnp.asarray(p0)
        state = tx.init(p)
        for g in grads:
            upd, state = tx.update(jnp.asarray(g), state, p)
            p = optax.apply_updates(p, upd)
            param.grad = torch.from_numpy(g.copy())
            opt.step()
            sched.step()
        want = np.asarray(p)
    np.testing.assert_allclose(param.detach().numpy(), want, rtol=0,
                               atol=1e-8)


@pytest.mark.parametrize("simdr", [True, False], ids=["full", "cd_batch"])
def test_step_equals_jax(simdr, monkeypatch):
    from flax import linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)
    monkeypatch.setattr(layers.Dropout, "forward", lambda self, x: x)
    cfg = make_cfg("mynet_stacked", "freihand", exp_id=16, image_size=64, **{
        "MODEL.main_channels": 32, "MODEL.hg_depth": 3})
    cfg["OPTIMIZER"].update(type="SGD", lr=STEP_LR, warmup_steps=0)
    jax_batch, port_batch = step_batches(24, [(16, 16)])
    if simdr:
        rng = np.random.RandomState(9)
        for k in ("simdr_x", "simdr_y"):
            v = rng.uniform(size=(2, 21, 128)).astype(np.float32)
            jax_batch[k] = port_batch[k] = v
    variables = init_jax(jax_get_model(jax_cfg(cfg)), jax_batch["img"],
                         seed=5, train=False)
    assert_step_matches_jax(cfg, variables, jax_batch, port_batch,
                            monkeypatch, [jax_stacked],
                            rules_for("mynet_stacked"))


_CFG = """
from litehandnet_tpu_torch.config.templates import make_cfg


def _get_cfg():
    cfg = make_cfg("mynet_stacked", "freihand", exp_id=998, image_size=64,
                   **{{"MODEL.main_channels": 32, "MODEL.hg_depth": 3}})
    for split in ("train", "val", "test"):
        cfg["DATASET"][split] = dict(ann_file={ann!r}, img_prefix={prefix!r})
    cfg["CHECKPOINT"]["save_root"] = {root!r}
    cfg["TRAIN"]["batch_per_gpu"] = 2
    cfg["TRAIN"]["total_epoches"] = 1
    cfg["OPTIMIZER"]["lr"] = 1e-3
    return cfg
"""


@pytest.fixture
def gen1_cfg(tmp_path):
    from PIL import Image

    (tmp_path / "images").mkdir()
    rng = np.random.RandomState(0)
    images, annotations = [], []
    for i in range(8):
        # image 0 is larger than the 2x canvas (128): the loader's ROI
        # downscale path under the cycle-detection re-crop
        w = h = 320 if i == 0 else 64
        name = f"images/img_{i:03d}.jpg"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(
            tmp_path / name)
        images.append(dict(id=i, file_name=name, width=w, height=h))
        kpts = [v for x, y in rng.uniform(0.2, 0.8, (21, 2)) * [w, h]
                for v in (float(x), float(y), 1)]
        annotations.append(dict(
            id=i, image_id=i, category_id=1, iscrowd=0, keypoints=kpts,
            bbox=[w * 0.1, h * 0.1, w * 0.8, h * 0.8], area=w * h * 0.64))
    ann = tmp_path / "ann.json"
    ann.write_text(json.dumps(dict(images=images, annotations=annotations,
                                   categories=[dict(id=1, name="hand")])))
    path = tmp_path / "exp_cfg.py"
    path.write_text(_CFG.format(ann=str(ann), prefix=str(tmp_path) + "/",
                                root=str(tmp_path / "ckpts") + "/"))
    return str(path), tmp_path


def test_cli_one_epoch_with_cycle_detection(gen1_cfg):
    path, root = gen1_cfg
    calls = []
    real = T.DevicePipeline.__call__

    def spy(self, images, *a, **kw):
        out = real(self, images, *a, **kw)
        calls.append((tuple(out["img"].shape), "simdr_x" in out))
        return out

    T.DevicePipeline.__call__ = spy
    try:
        state = T.main(["--cfg", path, "--workers", "2", "--cd-prob", "1.0",
                        "--device", "cpu"])
    finally:
        T.DevicePipeline.__call__ = real
    # 4 batches of 2, each followed by its half-resolution pass
    assert state.step == 8
    cd = [c for c in calls if c[0][1] == 32]
    assert len(cd) == 4 and not any(s for _, s in cd)
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    run = root / "ckpts" / "freihand" / "mynet_stacked" / "998"
    assert (run / "checkpoint.pt").exists()
    records = [json.loads(line) for line in
               (run / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if "val/pck" in r]
    assert len(val) == 1 and {"val/coor_pck", "val/hm_pck", "val/ap50",
                              "val/ap"} <= set(val[0])
    train = [r for r in records if "train/loss" in r][0]
    assert {"train/heatmap", "train/simdr", "train/cd_loss"} <= set(train)
    assert all(np.isfinite(v) for v in train.values())


def test_refuses_several_devices_and_a_missing_card(gen1_cfg, monkeypatch):
    """More devices than the card count are refused before any rank starts
    (``tests/test_torch_multiprocess.py`` runs two ranks on the CPU);
    without CUDA the default device raises."""
    with monkeypatch.context() as m:
        m.setattr(torch.cuda, "is_available", lambda: True)
        m.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(ValueError, match="2 devices asked for, 1"):
            T.main(["--cfg", gen1_cfg[0], "--num-devices", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            T.main(["--cfg", gen1_cfg[0]])
