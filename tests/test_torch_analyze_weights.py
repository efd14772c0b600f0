"""``tools/analyze_weights``: the same weights in a JAX run and a port run
(both imported from one seeded reference ``.pth`` by the two
``tools/import_checkpoint`` CLIs) give the same per-parameter histogram,
mean and standard deviation (within 1e-6), matched through the family's
weight rules; the port's JSON covers every parameter and no buffer; with no
checkpoint it analyzes the seed-0 init."""

import json

import numpy as np
import pytest
import torch

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.tools import analyze_weights, import_checkpoint
from litehandnet_tpu_torch.utils.weights import rules_for
from tests.test_torch_import_checkpoint import _cfg_files, _seeded_model
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    jax_names,
)


def test_statistics_equal_jax_per_parameter(tmp_path, capsys):
    from litehandnet_tpu.tools.analyze_weights import main as jax_analyze
    from litehandnet_tpu.tools.import_checkpoint import main as jax_import

    port_cfg, jax_cfg = _cfg_files(tmp_path)
    model = _seeded_model(port_cfg)
    pth = tmp_path / "best_model.pth"
    torch.save({"epoch": 3, "state_dict": model.state_dict()}, pth)
    import_checkpoint.main(["--cfg", port_cfg, "--pth", str(pth), "--device",
                            "cpu"])
    jax_import(["--cfg", jax_cfg, "--pth", str(pth)])

    out = tmp_path / "port.json"
    got = analyze_weights.main(["--cfg", port_cfg, "--load-best", "--out",
                                str(out), "--top", "5", "--device", "cpu"])
    assert "analyzed restored checkpoint" in capsys.readouterr().out
    assert json.loads(out.read_text()) == got
    names = [n for n, _ in model.named_parameters()]
    assert sorted(got) == sorted(names)

    jax_out = tmp_path / "jax.json"
    jax_analyze(["--cfg", jax_cfg, "--load-best", "--out", str(jax_out)])
    want = json.loads(jax_out.read_text())
    to_jax = jax_names(names, rules_for("litehandnet_msrb"))
    assert len(to_jax) == len(names) == len(want)
    for name in names:
        jname = to_jax[name]
        assert jname.startswith("params/")
        w = want[jname[len("params/"):]]
        g = got[name]
        assert g["hist"] == w["hist"], name
        np.testing.assert_allclose(g["edges"], w["edges"], rtol=1e-6,
                                   atol=1e-7, err_msg=name)
        for k in ("mean", "std"):
            assert g[k] == pytest.approx(w[k], rel=1e-6, abs=1e-7), (name, k)
        p = dict(model.named_parameters())[name].detach().numpy()
        assert g["std"] == pytest.approx(float(p.std()), rel=1e-6, abs=1e-9)


def test_without_checkpoint_analyzes_the_init(tmp_path, capsys):
    port_cfg, _ = _cfg_files(tmp_path)
    got = analyze_weights.main(["--cfg", port_cfg, "--device", "cpu"])
    assert "no checkpoint; analyzing init" in capsys.readouterr().out
    torch.manual_seed(0)
    model = get_model(get_config(port_cfg), device="cpu")
    for name, p in model.named_parameters():
        assert got[name]["mean"] == pytest.approx(float(p.mean()), abs=1e-7)


def test_defaults_to_cuda(tmp_path, monkeypatch):
    """Without ``--device cpu`` the tool asks for CUDA and raises without
    it."""
    port_cfg, _ = _cfg_files(tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        analyze_weights.main(["--cfg", port_cfg])
