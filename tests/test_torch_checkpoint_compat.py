"""Fuzzy checkpoint loading (``utils/checkpoint_compat.py``) and leaf names
(``utils/tree.py``): JAX's cases (``tests/test_compat_and_sharding.py``) on
the port, and the JAX function's result on the same inputs; then a module
filled from a state dict whose keys were renamed."""

import jax
import numpy as np
import torch

from litehandnet_tpu.utils.checkpoint_compat import (
    load_pretrained_state as jax_load_pretrained_state,
)
from litehandnet_tpu_torch.models.yolov6 import RepStage
from litehandnet_tpu_torch.utils.checkpoint_compat import load_pretrained_state
from litehandnet_tpu_torch.utils.tree import flatten, keypath_name


def test_exact_names_are_reserved_before_the_shape_fallback():
    """'a' has no exact match and the only shape-(3,) source is reserved
    for 'b', which names it exactly: 'a' stays, not every leaf was
    filled; JAX gives the same."""
    trained_b = torch.arange(3.0)
    target = {"a": torch.zeros(3), "b": torch.zeros(3)}
    assert not load_pretrained_state(target, {"b": trained_b})
    assert torch.equal(target["b"], trained_b)
    assert torch.equal(target["a"], torch.zeros(3))
    new, full = jax_load_pretrained_state({"a": np.zeros(3), "b": np.zeros(3)},
                                          {"b": np.arange(3.0)})
    assert not full
    for k in ("a", "b"):
        np.testing.assert_array_equal(target[k].numpy(), new[k])


def test_shape_fallback_fills_renamed_keys():
    target = {"x": torch.zeros(3)}
    assert load_pretrained_state(target, {"renamed": np.arange(3.0)})
    assert torch.equal(target["x"], torch.arange(3.0))
    new, full = jax_load_pretrained_state({"x": np.zeros(3)},
                                          {"renamed": np.arange(3.0)})
    assert full
    np.testing.assert_array_equal(new["x"], target["x"].numpy())


def test_greedy_order_matches_jax():
    """Several leaves of one shape fill in order; a leaf of a shape the
    source lacks stays."""
    src = {"p": np.full(2, 1.0), "q": np.full(2, 2.0), "r": np.full(4, 3.0)}
    target = {"u": torch.zeros(2), "v": torch.zeros(2), "w": torch.zeros(5)}
    full = load_pretrained_state(target, src)
    new, jfull = jax_load_pretrained_state(
        {k: np.zeros(v.shape) for k, v in target.items()}, src)
    assert full == jfull is False
    for k in target:
        np.testing.assert_array_equal(target[k].numpy(), new[k])


def test_module_filled_from_a_renamed_state_dict():
    """A module's parameters and statistics from another model's state
    dict with other keys, same shapes in the same order."""
    gen = torch.Generator().manual_seed(0)
    src_model = RepStage(8, 8, n=2)
    source = {f"renamed_{i}": torch.randn(v.shape, generator=gen).to(v.dtype)
              for i, v in enumerate(src_model.state_dict().values())}
    model = RepStage(8, 8, n=2)
    assert load_pretrained_state(model, source)
    for got, want in zip(model.state_dict().values(), source.values()):
        assert torch.equal(got, want)


def test_list_entries_get_their_index():
    """List-indexed entries do not collapse into one name (JAX
    ``keypath_name`` on SequenceKey)."""
    tree = {"scales": [torch.zeros(1), torch.ones(1)], "w": {"k": 1}}
    names = [n for n, _ in flatten(tree)]
    assert names == ["scales/0", "scales/1", "w/k"]
    flat = jax.tree_util.tree_flatten_with_path(
        {"scales": [np.zeros(1), np.ones(1)], "w": {"k": 1}})[0]
    from litehandnet_tpu.utils.tree import keypath_name as jax_keypath_name

    assert [jax_keypath_name(p) for p, _ in flat] == names
    assert keypath_name(("a", 0, "b")) == "a/0/b"
