"""The pieces of a run that touch the program under test, kept in one place:
building its served model and its train state from the benchmark's seeded
weights. Everything else the benchmark does is its own."""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from perfbench.core import spec
from perfbench.core.run_context import Run
from perfbench.core.weights import seeded_state


def seeded_weights(run: Run) -> Dict[str, torch.Tensor]:
    """The run's weights, on its device: the reference's layout (built on
    the meta device, so it costs no memory), drawn from ``--seed``. The same
    seed gives the same weights in every cell of a configuration."""
    with torch.device("meta"):
        layout = spec.reference(run.cell.config["reference"]).build(
            run.cell.model_spec(run.overrides))
    return seeded_state(layout, spec.sub_seed(run.seed, "weights"),
                        run.device)


def load(model: nn.Module, weights: Dict[str, torch.Tensor]) -> None:
    """``model.load_state_dict(weights)``; only the BatchNorm step counters
    may be left out, and nothing may be left over."""
    missing, unexpected = model.load_state_dict(weights, strict=False)
    missing = [k for k in missing if not k.endswith("num_batches_tracked")]
    if missing or unexpected:
        raise KeyError(f"weights do not fit the model: missing {missing[:5]}, "
                       f"unexpected {unexpected[:5]}")


def predictor(run: Run):
    """``serve.Predictor`` on the run's device, serving the configuration's
    graph built from the seeded weights: for a deploy-fused family the
    train graph's weights go through ``fuse_params`` into the deploy graph,
    as ``serve.deploy_model`` does; otherwise the train graph in eval mode;
    ``channels_last`` either way."""
    from litehandnet_tpu_torch.models import fuse_params, get_model
    from litehandnet_tpu_torch.serve import Predictor

    cfg = run.cell.port_config(run.overrides)
    dev = run.device
    with torch.device(dev):
        model = get_model(cfg, device=dev)
    load(model, seeded_weights(run))
    if run.cell.config["serve"]["graph"] == "deploy":
        with torch.device(dev):
            deploy = get_model(cfg, deploy=True, device=dev)
        deploy.load_state_dict(fuse_params(model))
        model = deploy
    dtype = getattr(torch, run.cell.config["serve"]["dtype"])
    served = Predictor(cfg, device=dev, dtype=dtype)
    served.model = model.to(memory_format=torch.channels_last).eval()
    return served


def trainer(run: Run, weights: Dict[str, torch.Tensor]):
    """``train.Trainer`` on the run's device and its ``TrainState`` holding
    ``weights`` (the optimizer over the same parameter objects)."""
    from litehandnet_tpu_torch.train.trainer import Trainer

    cfg = run.cell.port_config(run.overrides)
    log_dir = run.out_dir / "trainer" / run.cell.name
    trainer = Trainer(cfg, steps_per_epoch=int(run.cell.mix["steps_per_epoch"]),
                      log_dir=str(log_dir), device=run.device)
    state = trainer.init_state(seed=0)
    with torch.no_grad():
        load(state.model, weights)
    return trainer, state
