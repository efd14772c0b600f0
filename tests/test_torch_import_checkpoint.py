"""``tools/import_checkpoint``: a seeded ``litehandnet_msrb`` state dict
written as a reference ``.pth`` (``{epoch, state_dict, min_val_loss}`` with
DDP's ``module.`` keys) goes through JAX's CLI (orbax) and the port's
(``--device cpu``); JAX's checkpoint, carried across by the rules, equals
the port's saved state dict exactly, and the port's equals the source. The
run is what ``tools/test --load-best`` restores. Also a bare state dict, a
TorchScript archive, ``--family``, and the refusal to overwrite without
``--force``."""

import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.tools import import_checkpoint
from litehandnet_tpu_torch.tools import test as test_cli
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.utils.weights import (
    load_jax_variables,
    randomize_,
    rules_for,
)
from tests.test_torch_tools_test import write_cfg
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)

MSRB = {"MODEL.name": "litehandnet_msrb", "MODEL.num_stage": 3,
        "MODEL.msrb_ca": "ca", "MODEL.rbu_ca": "ca"}


def _cfg_files(tmp_path, extra=MSRB):
    ann = tmp_path / "ann.json"   # the DATASET paths are never read here
    port = write_cfg(tmp_path / "port_cfg.py", tmp_path / "port_run", ann,
                     str(tmp_path) + "/", extra=extra)
    jax_file = write_cfg(tmp_path / "jax_cfg.py", tmp_path / "jax_run", ann,
                         str(tmp_path) + "/", pkg="litehandnet_tpu",
                         extra=extra)
    return port, jax_file


def _seeded_model(cfg_file, seed=0):
    model = get_model(get_config(cfg_file), device="cpu")
    randomize_(model, torch.Generator().manual_seed(seed))
    for i, buf in enumerate(b for n, b in model.named_buffers()
                            if n.endswith("num_batches_tracked")):
        buf.fill_(i + 3)
    return model


def _saved_model(cfg_file, best=True):
    cfg = get_config(cfg_file)
    raw, meta = CheckpointManager(run_dir(cfg), cfg,
                                  read_only=True).restore_raw(best=best)
    return raw["model"], meta


def test_reference_pth_through_both_clis(tmp_path):
    from litehandnet_tpu.config import get_config as jax_get_config
    from litehandnet_tpu.tools.import_checkpoint import main as jax_main
    from litehandnet_tpu.train.checkpoint import (
        CheckpointManager as JaxCheckpointManager,
        run_dir as jax_run_dir,
    )

    port_cfg, jax_cfg = _cfg_files(tmp_path)
    source = _seeded_model(port_cfg).state_dict()
    pth = tmp_path / "best_model.pth"
    torch.save({"epoch": 37, "min_val_loss": 0.123, "optimizer": {},
                "state_dict": {f"module.{k}": v for k, v in source.items()}},
               pth)

    out_dir = import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pth),
                                      "--device", "cpu"])
    assert out_dir == run_dir(get_config(port_cfg))
    with pytest.raises(SystemExit, match="refusing to overwrite"):
        import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pth),
                                "--device", "cpu"])
    import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pth), "--device",
                            "cpu", "--force"])
    for best in (True, False):
        saved, meta = _saved_model(port_cfg, best)
        assert meta["epoch"] == 37 and meta["min_val_loss"] == pytest.approx(
            0.123)
        assert set(saved) == set(source)
        for k, v in source.items():
            assert torch.equal(saved[k], v), k

    jax_main(["--cfg", jax_cfg, "--pth", str(pth)])
    jcfg = jax_get_config(jax_cfg)
    jstate, jmeta = JaxCheckpointManager(jax_run_dir(jcfg), jcfg).restore_raw(
        best=True)
    assert jmeta["epoch"] == 37
    twin = get_model(get_config(port_cfg), device="cpu")
    load_jax_variables(twin, {"params": jstate["params"],
                              "batch_stats": jstate["batch_stats"]},
                       rules_for("litehandnet_msrb"))
    saved, _ = _saved_model(port_cfg)
    n = 0
    for k, v in twin.state_dict().items():
        if not k.endswith("num_batches_tracked"):   # JAX keeps no count
            assert torch.equal(saved[k], v), k
            n += 1
    assert n == sum(1 for k in source if not k.endswith("num_batches_tracked"))

    # what tools/test --load-best restores
    state = test_cli.restore_state(get_config(port_cfg), load_best=True,
                                   allow_init=False)
    for k, v in state.model.state_dict().items():
        assert torch.equal(v, source[k]), k


def test_bare_state_dict_and_family(tmp_path):
    """A bare state dict (no ``module.`` prefix, no epoch) into the
    ``best`` slot alone; ``--family`` names the model family to load into
    when the config names another."""
    port_cfg, _ = _cfg_files(tmp_path, extra={})    # names litehandnet
    (tmp_path / "msrb").mkdir()
    want = _seeded_model(_cfg_files(tmp_path / "msrb", extra={
        "MODEL.name": "litehandnet_msrb"})[0], seed=1)
    pth = tmp_path / "bare.pth"
    torch.save(want.state_dict(), pth)
    with pytest.raises(RuntimeError, match="state_dict"):
        import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pth),
                                "--device", "cpu", "--slot", "best"])
    out = import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pth),
                                  "--device", "cpu", "--slot", "best",
                                  "--family", "litehandnet_msrb"])
    cfg = get_config(port_cfg)
    cfg.MODEL.name = "litehandnet_msrb"
    assert out == run_dir(cfg)
    raw, meta = CheckpointManager(out, cfg, read_only=True).restore_raw(
        best=True)
    assert meta["epoch"] == 0 and meta["min_val_loss"] == float("inf")
    assert CheckpointManager(out, cfg, read_only=True).restore_raw(
        best=False) == (None, None)
    for k, v in want.state_dict().items():
        assert torch.equal(raw["model"][k], v), k


def test_torchscript_archive(tmp_path):
    """A traced, saved module (the route of the reference's published
    ``srhandnet.pts``) keeps its attribute names, so it loads the same."""
    port_cfg, _ = _cfg_files(tmp_path)
    model = _seeded_model(port_cfg, seed=2).eval()
    pts = tmp_path / "model.pts"
    with torch.no_grad():
        torch.jit.save(torch.jit.trace(model, torch.zeros(1, 3, 64, 64)),
                       str(pts))
    import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pts), "--device",
                            "cpu"])
    saved, _ = _saved_model(port_cfg)
    for k, v in model.state_dict().items():
        assert torch.equal(saved[k], v), k
    x = torch.from_numpy(np.random.RandomState(0).normal(
        size=(1, 3, 64, 64)).astype(np.float32))
    state = test_cli.restore_state(get_config(port_cfg), True, False)
    with torch.no_grad():
        torch.testing.assert_close(state.model.eval()(x), model(x))
