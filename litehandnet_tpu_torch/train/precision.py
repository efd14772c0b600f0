"""Dynamic loss scaling (port of ``litehandnet_tpu/train/precision.py::
DynamicLossScaler``; reference train/fp16_utils/loss_scaler.py:81-212).

The scale doubles after ``window`` consecutive finite steps and halves (not
below 1) on a non-finite gradient; the train step then skips the update.
"""

from __future__ import annotations

from typing import Dict, Iterable

import torch


class DynamicLossScaler:
    def __init__(self, init_scale: float = 2.0 ** 15, window: int = 1000,
                 factor: float = 2.0):
        self.scale = float(init_scale)
        self.good_steps = 0
        self.window = window
        self.factor = factor

    def scale_loss(self, loss: torch.Tensor) -> torch.Tensor:
        return loss * self.scale

    def unscale(self, grads: Iterable[torch.Tensor]) -> None:
        """Divide each gradient by the scale, in place."""
        for g in grads:
            g.div_(self.scale)

    def update(self, grads: Iterable[torch.Tensor]) -> bool:
        """Move the scale; returns whether every gradient is finite (the
        reference's overflow skip, fp16_optimizer.py:336-489)."""
        grads = list(grads)
        finite = bool(torch.stack([torch.isfinite(g).all() for g in grads])
                      .all()) if grads else True
        grew = self.good_steps + 1 >= self.window
        if finite:
            self.scale = self.scale * self.factor if grew else self.scale
            self.good_steps = 0 if grew else self.good_steps + 1
        else:
            self.scale = max(self.scale / self.factor, 1.0)
            self.good_steps = 0
        return finite

    def state_dict(self) -> Dict[str, float]:
        return {"scale": self.scale, "good_steps": self.good_steps,
                "window": self.window, "factor": self.factor}

    def load_state_dict(self, state: Dict[str, float]) -> None:
        self.scale = float(state["scale"])
        self.good_steps = int(state["good_steps"])
        self.window = int(state["window"])
        self.factor = float(state["factor"])
