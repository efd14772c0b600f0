"""Weight initializers (port of ``litehandnet_tpu/models/weight_init.py``;
reference ``models/weight_init.py:3-32``).

Each initializer fills a tensor in place from a ``torch.Generator`` and
returns it: ``kaiming_init`` (normal, fan_out, gain^2 = 2), ``normal_init``
(std 0.001) and ``constant_init(value)``. ``reinit_params`` re-draws every
conv, transposed-conv and linear weight of a module or state dict.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Union

import torch
from torch import nn

Initializer = Callable[[torch.Tensor, Optional[torch.Generator]], torch.Tensor]

_WEIGHTED = (nn.Conv1d, nn.Conv2d, nn.Conv3d, nn.ConvTranspose1d,
             nn.ConvTranspose2d, nn.ConvTranspose3d, nn.Linear)


def _normal_(t: torch.Tensor, std: float, generator) -> torch.Tensor:
    # drawn on the CPU, so a seed gives the same weights on every machine
    with torch.no_grad():
        t.copy_(torch.randn(t.shape, generator=generator) * std)
    return t


def _fan_out(t: torch.Tensor) -> int:
    """Output units times the receptive field: dim 0 of an OIHW kernel or a
    Linear ``[out, in]`` weight, times the kernel's spatial size."""
    return t.shape[0] * math.prod(t.shape[2:])


def kaiming_init(t: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, 2 / fan_out) in place (flax ``variance_scaling(2.0, 'fan_out',
    'normal')``)."""
    return _normal_(t, math.sqrt(2.0 / _fan_out(t)), generator)


def normal_init(t: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """N(0, 0.001^2) in place."""
    return _normal_(t, 0.001, generator)


def constant_init(value: float = 1.0) -> Initializer:
    """An initializer that fills with ``value``."""
    def init(t: torch.Tensor, generator=None) -> torch.Tensor:
        with torch.no_grad():
            return t.fill_(value)
    return init


def reinit_params(params: Union[nn.Module, Mapping[str, torch.Tensor]],
                  generator: torch.Generator,
                  init: Initializer = normal_init):
    """Re-draw every conv, transposed-conv and linear weight with ``init``
    from ``generator``, in the module's order; biases, BatchNorm and other
    tensors stay. A module is changed in place and returned; a state dict
    gives a new dict whose weights of rank 2 and more are re-drawn copies
    (the others are the same tensors)."""
    if isinstance(params, nn.Module):
        for mod in params.modules():
            if isinstance(mod, _WEIGHTED):
                init(mod.weight.data, generator)
        return params
    out: Dict[str, torch.Tensor] = {}
    for key, value in params.items():
        if key.rpartition(".")[2] == "weight" and value.dim() >= 2:
            value = init(value.detach().clone(), generator)
        out[key] = value
    return out
