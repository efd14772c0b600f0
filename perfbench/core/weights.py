"""Weights from a seed, made on the device in two draws.

The layout (which leaf, its shape and its distribution) is the reference
model's (``reference.common.seeded_layout``); the program's train graph has
the same state-dict names, so the one dict loads into both sides.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from perfbench.reference.common import seeded_layout


def seeded_state(model: nn.Module, seed: int,
                 device: torch.device) -> Dict[str, torch.Tensor]:
    """float32 tensors on ``device`` for every seeded leaf of ``model``:
    one ``randn`` for all the normal leaves and one ``rand`` for the uniform
    ones, each drawn from a generator on ``device`` seeded with ``seed``,
    then cut into leaves and scaled."""
    layout = seeded_layout(model)
    sizes = {"normal": 0, "uniform": 0}
    for _, shape, draw, _, _ in layout:
        sizes[draw] += math.prod(shape)
    gen = torch.Generator(device).manual_seed(seed)
    pools = {"normal": torch.randn(sizes["normal"], generator=gen,
                                   device=device),
             "uniform": torch.rand(sizes["uniform"], generator=gen,
                                   device=device)}
    offset = {"normal": 0, "uniform": 0}
    state = {}
    for key, shape, draw, scale, shift in layout:
        n = math.prod(shape)
        chunk = pools[draw][offset[draw]:offset[draw] + n].view(shape)
        offset[draw] += n
        state[key] = chunk * scale + shift
    return state
