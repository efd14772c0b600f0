"""Each plain reference equals the program at a small size on the CPU: the
same state-dict names and shapes, the same forward in eval mode (the
deploy-fused graph included) and in train mode with the same dropout
masks, and the same first train steps."""

import pytest
import torch

from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.models.layers import set_dropout_generator
from perfbench.core import spec, train
from perfbench.core.weights import seeded_state
from perfbench.reference.common import set_generator

from conftest import small_run

CONFIGS = ["litehandnet", "resnet50"]


def pair(name, seed=3):
    cfg_file = spec.config(name)
    cfg = get_config(cfg_file["experiment"])
    ref = spec.reference(cfg_file["reference"]).build(cfg_file["config"]["MODEL"])
    port = get_model(cfg, device="cpu")
    weights = seeded_state(ref, seed, torch.device("cpu"))
    ref.load_state_dict(weights, strict=False)
    port.load_state_dict(weights, strict=False)
    return cfg, port, ref


@pytest.mark.parametrize("name", CONFIGS)
def test_state_dict_names_and_shapes_match(name):
    _, port, ref = pair(name)
    a, b = port.state_dict(), ref.state_dict()
    assert list(a) == list(b)
    assert all(a[k].shape == b[k].shape for k in a)
    assert sum(p.numel() for p in ref.parameters()) == spec.config(name)["parameters"]


@pytest.mark.parametrize("name", CONFIGS)
def test_eval_forward_equals_program(name):
    cfg, port, ref = pair(name)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = ref.eval()(x)
        got = port.eval()(x)
        scale = want.abs().max()
        assert float((got - want).abs().max() / scale) < 2e-5
        if spec.config(name)["serve"]["graph"] == "deploy":
            deploy = get_model(cfg, deploy=True, device="cpu")
            deploy.load_state_dict(fuse_params(port))
            assert float((deploy(x) - want).abs().max() / scale) < 2e-5


@pytest.mark.parametrize("name", CONFIGS)
def test_train_forward_equals_program_in_float64(name, monkeypatch):
    # the program's moments kernel takes float32 or bfloat16; its plain
    # two-pass statistics take float64
    monkeypatch.setenv("LHN_FUSED_BN", "0")
    _, port, ref = pair(name)
    port.double().train()
    ref.double().train()
    set_dropout_generator(port, torch.Generator().manual_seed(5))
    set_generator(ref, torch.Generator().manual_seed(5))
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1),
                    dtype=torch.float64)
    with torch.no_grad():
        assert torch.allclose(port(x), ref(x), rtol=1e-12, atol=1e-12)


def test_reference_steps_follow_the_program(tmp_path):
    r = small_run("litehandnet.train_b32", tmp_path)
    from perfbench.core import program

    cfg = r.cell.port_config(r.overrides)
    data = train.make_batches(r, cfg)
    weights = program.seeded_weights(r)
    tr, state = program.trainer(r, weights)

    def step(k):
        gen = torch.Generator(r.device).manual_seed(train.step_seed(r, k))
        return tr.train_step(state, train.batch(data, k), gen)

    prog = train.first_steps(r, step, state.model, state.optimizer,
                             weights, 3)
    ref = train.reference_steps(r, data, 3)
    numbers, still = train.judge(prog, ref)
    assert numbers["loss_gap"] < 1e-5 and numbers["grad_gap"] < 1e-4
    assert numbers["grad_median_gap"] < 1e-5
    assert numbers["change_gap"] < 2e-2
    assert "pre.conv1x1.bias" in still    # every use of it meets a BatchNorm


def test_reference_late_steps_follow_the_program(tmp_path):
    # the late steps start from the program's state after a few more steps
    # than the checked ones, Adam's moments included
    r = small_run("litehandnet.train_b32", tmp_path)
    from perfbench.core import program

    cfg = r.cell.port_config(r.overrides)
    data = train.make_batches(r, cfg)
    tr, state = program.trainer(r, program.seeded_weights(r))

    def step(k):
        gen = torch.Generator(r.device).manual_seed(train.step_seed(r, k))
        return tr.train_step(state, train.batch(data, k), gen)

    late = train.LateSteps(state.model, state.optimizer, 5, 2)
    for k in range(7):
        late.step(step, k)
    assert late.done
    late = late.result()
    numbers = train.judge_late(late, train.reference_late(
        r, data, late["snapshot"], 2))
    assert numbers["late_loss_gap"] < 1e-5
    assert numbers["late_update_gap"] < 5e-2
