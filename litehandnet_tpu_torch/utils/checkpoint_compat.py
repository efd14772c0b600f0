"""Fuzzy checkpoint loading (port of
``litehandnet_tpu/utils/checkpoint_compat.py``; reference
``utils/training_kits.py:33-52``, ``load_pretrained_state``).

Loads weights into a model even where keys were renamed or reordered, by
matching tensors of identical shapes in order; used to carry checkpoints
between train and deploy graphs or across refactors.
"""

from __future__ import annotations

from typing import Any, Mapping, MutableMapping, Union

import numpy as np
import torch
from torch import nn

from litehandnet_tpu_torch.utils.tree import flatten


def load_pretrained_state(target: Union[nn.Module, MutableMapping[str, Any]],
                          source: Mapping) -> bool:
    """Fill ``target``'s tensors from ``source`` in place.

    ``target`` is a module (its ``state_dict``) or a state dict; ``source``
    a state dict or a nested tree of tensors or arrays, named by
    ``utils.tree.flatten``. Exact name-and-shape matches are reserved first,
    so an earlier target's shape fallback never takes a source tensor that
    names a later target exactly; the rest are matched greedily by shape in
    order (the reference's fallback). Unmatched targets keep their values.

    Returns:
        whether every target tensor was filled.
    """
    src_items = flatten(source)
    src_by_name = dict(src_items)
    state = target.state_dict() if isinstance(target, nn.Module) else target
    tgt_items = list(state.items())

    def shape(v):
        return tuple(np.shape(v))

    used = {name for name, leaf in tgt_items
            if name in src_by_name and shape(src_by_name[name]) == shape(leaf)}
    filled = {}
    for name, leaf in tgt_items:
        if name in used:
            filled[name] = src_by_name[name]
            continue
        found = next(((n, v) for n, v in src_items
                      if n not in used and shape(v) == shape(leaf)), None)
        if found is not None:
            used.add(found[0])
            filled[name] = found[1]
    new = {name: (value if torch.is_tensor(value)
                  else torch.as_tensor(np.asarray(value))).to(
                      dtype=state[name].dtype, device=state[name].device)
           for name, value in filled.items()}
    if isinstance(target, nn.Module):
        target.load_state_dict(new, strict=False)
    else:
        target.update(new)
    return len(filled) == len(tgt_items)
