"""``tools/demo`` on the CPU at 64x64 inputs against JAX's ``tools/demo`` on
the same weights and the same seeded images, for each branch: the region
branch (``mynet_stacked``, ``ResultParser`` with ``--max-hands``) restoring
a port checkpoint written into the run directory, the top-down branch
(deploy-fused ``litehandnet``, ``TopDownDecoder``) and ``--pyramid``
(SRHandNet's two stages on the full frame). Both sides draw through
``utils.vis``; the boxes and keypoints handed to ``draw_bbox`` and
``draw_keypoints`` are recorded and held equal within 1e-4 px (the scores
within 1e-4 of their scale), call for call. Each side writes its images at
the frame's size. The weights are JAX variables drawn from a numpy seed,
carried into the port by ``utils.weights``; JAX's demo gets them through
its checkpoint manager's raw restore."""

import numpy as np
import pytest
import torch
from PIL import Image

from litehandnet_tpu.config import get_config as jax_get_config
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.tools import demo as jax_demo
from litehandnet_tpu.train import checkpoint as jax_checkpoint
from litehandnet_tpu.utils import vis as jax_vis
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.tools import demo
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import init_jax
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

_CFG = """
from {package}.config.templates import make_cfg


def _get_cfg():
    cfg = make_cfg({model!r}, "freihand", exp_id=997, image_size=64,
                   **{overrides!r})
    cfg["CHECKPOINT"]["save_root"] = {root!r}
    return cfg
"""

FRAMES = ((64, 64), (72, 96))


def _write(tmp_path, model, **overrides):
    """(port config path, JAX config path, image paths) of a test-size
    ``model``; the two configs are the same template of each package."""
    paths = []
    for package in ("litehandnet_tpu_torch", "litehandnet_tpu"):
        path = tmp_path / f"{model}_{package}_cfg.py"
        path.write_text(_CFG.format(
            package=package, model=model, overrides=overrides,
            root=str(tmp_path / package / "ckpt") + "/"))
        paths.append(str(path))
    rng = np.random.RandomState(0)
    images = []
    for i, (h, w) in enumerate(FRAMES):
        p = tmp_path / f"frame{i}.png"
        Image.fromarray(rng.randint(0, 255, (h, w, 3), np.uint8)).save(p)
        images.append(str(p))
    return paths[0], paths[1], images


def _variables(jax_cfg_path, seed):
    """numpy JAX variables of the config's model, drawn from ``seed``."""
    cfg = jax_get_config(jax_cfg_path)
    W, H = (int(v) for v in cfg.DATASET.image_size)
    return init_jax(jax_get_model(cfg), np.zeros((1, H, W, 3), np.float32),
                    seed=seed, train=False)


def _port_model(cfg, variables):
    model = get_model(cfg, device="cpu")
    load_jax_variables(model, variables, rules_for(cfg.MODEL.name))
    return model


def _recorder(monkeypatch, module, calls):
    """Record the boxes / keypoints of every ``draw_bbox`` and
    ``draw_keypoints`` call made through ``module``; the drawing still
    happens."""
    for name in ("draw_bbox", "draw_keypoints"):
        def record(img, arr, *args, _draw=getattr(module, name), _name=name,
                   **kwargs):
            calls.append((_name, np.array(arr, np.float64)))
            return _draw(img, arr, *args, **kwargs)

        monkeypatch.setattr(module, name, record)


class _Restored:
    """JAX's checkpoint manager with one run's variables to restore raw."""

    def __init__(self, variables):
        self.variables = variables

    def __call__(self, *args, read_only=False, **kwargs):
        assert read_only
        return self

    def restore_raw(self, best=False):
        return dict(self.variables), None


def _run(cfg_path, images, out, *extra):
    written = demo.main(["--cfg", cfg_path, "--inputs", *images, "--out-dir",
                         str(out), "--device", "cpu", *extra])
    assert [w.rsplit("/", 1)[-1] for w in written] == ["frame0.png",
                                                       "frame1.png"]
    return [np.asarray(Image.open(w)) for w in written]


def _assert_same_drawing(monkeypatch, tmp_path, port_cfg, jax_cfg, images,
                         variables, *extra):
    """The port's demo (its weights already in place) draws what JAX's
    demo draws on ``variables``; returns the port's images and the calls."""
    port_calls, jax_calls = [], []
    _recorder(monkeypatch, demo, port_calls)
    _recorder(monkeypatch, jax_vis, jax_calls)
    monkeypatch.setattr(jax_checkpoint, "CheckpointManager",
                        _Restored(variables))
    out = _run(port_cfg, images, tmp_path / "port", *extra)
    jax_demo.main(["--cfg", jax_cfg, "--inputs", *images, "--out-dir",
                   str(tmp_path / "jax"), *extra])
    assert [(n, c.shape) for n, c in port_calls] == [
        (n, c.shape) for n, c in jax_calls]
    for (name, got), (_, want) in zip(port_calls, jax_calls):
        # boxes (cx, cy, w, h, score), keypoints (x, y, score): pixels
        # within 1e-4, scores within 1e-4 of their largest magnitude
        px = got.shape[-1] - 1 if got.shape[-1] in (3, 5) else got.shape[-1]
        np.testing.assert_allclose(got[..., :px], want[..., :px], rtol=0,
                                   atol=1e-4, err_msg=name)
        scale = max(float(np.abs(want[..., px:]).max(initial=0.0)), 1.0)
        np.testing.assert_allclose(got[..., px:], want[..., px:], rtol=0,
                                   atol=1e-4 * scale, err_msg=name)
    return out, port_calls


def _drawn(calls, name):
    """The drawn rows of the ``name`` calls: boxes or keypoints with a
    positive score."""
    rows = [c.reshape(-1, c.shape[-1]) for n, c in calls if n == name]
    return sum(int((r[:, -1] > 0).sum()) for r in rows)


def test_region_branch_restores_the_checkpoint(tmp_path, capsys,
                                               monkeypatch):
    overrides = {"MODEL.main_channels": 32, "MODEL.hg_depth": 3}
    port_cfg, jax_cfg, images = _write(tmp_path, "mynet_stacked", **overrides)
    variables = _variables(jax_cfg, seed=5)
    cfg = get_config(port_cfg)
    model = _port_model(cfg, variables)

    class Saved:
        step = 0

        def state_dict(self):
            return {"model": model.state_dict()}

    CheckpointManager(run_dir(cfg), cfg).save(Saved(), 0)
    loaded = demo.load_model(cfg, False, torch.device("cpu"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(loaded.state_dict()[k], v)
    out, calls = _assert_same_drawing(monkeypatch, tmp_path, port_cfg,
                                      jax_cfg, images, variables,
                                      "--max-hands", "3")
    assert [o.shape for o in out] == [(64, 64, 3), (64, 64, 3)]
    assert "no checkpoint found" not in capsys.readouterr().out
    assert _drawn(calls, "draw_bbox") > 0
    assert _drawn(calls, "draw_keypoints") > 0


def test_top_down_branch_at_the_seed_0_init(tmp_path, capsys, monkeypatch):
    port_cfg, jax_cfg, images = _write(tmp_path, "litehandnet",
                                       **{"MODEL.input_channel": 32})
    cfg = get_config(port_cfg)
    # the seed-0 init: two loads give the same deploy weights
    a = demo.load_model(cfg, False, torch.device("cpu")).state_dict()
    b = demo.load_model(cfg, False, torch.device("cpu")).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert any(k.endswith(".rep.weight") for k in a)   # deploy-fused
    assert "no checkpoint found" in capsys.readouterr().out
    # the same weights on both sides: a port checkpoint of JAX's variables
    variables = _variables(jax_cfg, seed=6)
    monkeypatch.setattr(demo, "get_model", lambda c, device: _port_model(
        c, variables))
    out, calls = _assert_same_drawing(monkeypatch, tmp_path, port_cfg,
                                      jax_cfg, images, variables)
    assert [o.shape for o in out] == [(64, 64, 3), (64, 64, 3)]
    assert [n for n, _ in calls] == ["draw_keypoints"] * 2


def test_pyramid(tmp_path, monkeypatch):
    port_cfg, jax_cfg, images = _write(tmp_path, "srhandnet")
    with pytest.raises(ValueError, match="SRHandNet"):
        litehandnet, _, _ = _write(tmp_path, "litehandnet",
                                   **{"MODEL.input_channel": 32})
        demo.main(["--cfg", litehandnet, "--inputs", *images, "--out-dir",
                   str(tmp_path / "x"), "--device", "cpu", "--pyramid"])
    variables = _variables(jax_cfg, seed=7)
    # lift the finest head's maps, so that the random network's center map
    # has peaks above det_thr, its boxes have a size, and its crops find
    # keypoints above hand_thr: on the first frame both hands keep exactly
    # 16 of 21 (the most-5-missing rule at its edge), on the second one
    # hand keeps 16 and the other 15
    bias = variables["params"]["h7out"]["conv"]["bias"]
    bias += np.array([0.3] * 21 + [0.6, 0.9, 0.9], np.float32)
    monkeypatch.setattr(demo, "get_model", lambda c, device: _port_model(
        c, variables))
    out, calls = _assert_same_drawing(monkeypatch, tmp_path, port_cfg,
                                      jax_cfg, images, variables,
                                      "--pyramid", "--max-hands", "2")
    assert [o.shape for o in out] == [(64, 64, 3), (72, 96, 3)]
    assert _drawn(calls, "draw_bbox") == 3
    assert [n for n, _ in calls].count("draw_keypoints") == 3
