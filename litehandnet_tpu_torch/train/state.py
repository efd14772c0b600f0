"""Train state (port of ``litehandnet_tpu/train/state.py``).

One object carries the model (parameters and BatchNorm running statistics),
the criterion with its own trainable parameters, the optimizer over both (the
reference appends criterion parameters to the optimizer,
optimizer_scheduler.py:8-10), the LR scheduler, the optional loss scaler and
the step count.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, Optional

import torch
from torch import nn

from litehandnet_tpu_torch.train.optim import OptimizerFactory
from litehandnet_tpu_torch.train.precision import DynamicLossScaler


@dataclass
class TrainState:
    model: nn.Module
    criterion: nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    loss_scaler: Optional[DynamicLossScaler] = None
    step: int = 0

    @classmethod
    def create(cls, model: nn.Module, criterion: nn.Module,
               tx: OptimizerFactory,
               loss_scaler: Optional[DynamicLossScaler] = None) -> "TrainState":
        """A fresh optimizer (from ``tx``) over the model's and the
        criterion's parameters, at step 0."""
        params = list(model.parameters()) + list(criterion.parameters())
        optimizer, scheduler = tx(params)
        return cls(model, criterion, optimizer, scheduler, loss_scaler)

    def state_dict(self) -> Dict[str, Any]:
        return {
            "step": self.step,
            "model": self.model.state_dict(),
            "criterion": self.criterion.state_dict(),
            "optimizer": self.optimizer.state_dict(),
            "scheduler": self.scheduler.state_dict(),
            "loss_scaler": (None if self.loss_scaler is None
                            else self.loss_scaler.state_dict()),
        }

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.step = int(state["step"])
        self.model.load_state_dict(state["model"])
        self.criterion.load_state_dict(state["criterion"])
        self.optimizer.load_state_dict(state["optimizer"])
        self.scheduler.load_state_dict(state["scheduler"])
        if self.loss_scaler is not None and state["loss_scaler"] is not None:
            self.loss_scaler.load_state_dict(state["loss_scaler"])
