"""Names of the leaves of nested checkpoint trees (port of
``litehandnet_tpu/utils/tree.py``).

A torch ``state_dict`` is already flat, its keys dotted names; a checkpoint
may nest such dicts (``{'model': state_dict, ...}``) or lists.
:func:`flatten` names each tensor leaf by its path, list indices included,
so entries of a list never collapse into one name.
"""

from __future__ import annotations

from typing import Any, List, Mapping, Tuple


def keypath_name(parts) -> str:
    """``'/'``-joined path of dict keys and list indices."""
    return "/".join(str(p) for p in parts)


def flatten(tree: Any, prefix: Tuple = ()) -> List[Tuple[str, Any]]:
    """``(name, leaf)`` in order for every leaf of nested mappings, lists
    and tuples (a leaf is anything else, such as a tensor)."""
    if isinstance(tree, Mapping):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return [(keypath_name(prefix), tree)]
    out: List[Tuple[str, Any]] = []
    for key, sub in items:
        out += flatten(sub, prefix + (key,))
    return out
