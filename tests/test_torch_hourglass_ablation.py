"""``hourglass_ablation``: the port against JAX for every ``ca_type`` x
``msrb`` x ``rca``, in eval mode and in train mode (batch statistics, running
statistics after the call; dropout identity on both sides), plus the weight
mapping both ways and the parameter count. On the CPU, ``input_channel`` 32,
64x64 inputs, B = 2. Eval mode in float32: rtol 1e-4, atol 1e-5 of the
output's largest magnitude (``assert_close_scaled``). Train mode in float64
on both sides: rtol 1e-9, atol 1e-10 of the largest magnitude; running
statistics rtol 1e-9."""

import functools

import jax
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import hourglass_ablation as jax_ablation
from litehandnet_tpu.models import ms_att_hourglass as jax_mynet
from litehandnet_tpu.utils.torch_import import import_torch_state_dict
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models.hourglass_ablation import CA_TYPES
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    no_dropout,  # noqa: F401  (fixture)
    apply_jax,
    assert_close_scaled,
    assert_served_config,
    assert_state_matches,
    family_cfg,
    init_jax,
    jax_float64,
    to_float64,
    to_nchw,
    to_nhwc,
)

RTOL, ATOL = 1e-4, 1e-5
RULES = rules_for("hourglass_ablation")


def _x():
    return np.random.RandomState(1).normal(size=(2, 64, 64, 3)).astype(np.float32)


def _cfg(ca_type, msrb, rca):
    # num_block has num_stage - 1 entries with the ME_att blocks, num_stage
    # without; the decoder's towers hold two blocks (``blocks.0/1``)
    return family_cfg("hourglass_ablation", ca_type=ca_type, msrb=msrb,
                      rca=rca, num_block=(1, 1, 1) if msrb else (1, 1, 1, 1))


def _jax_key(ca_type, msrb, rca):
    """Without the ME_att blocks ``ca_type`` is unused: one JAX model."""
    return (ca_type if msrb else "ca", msrb, rca)


@functools.lru_cache(maxsize=None)
def _jax_cached(ca_type, msrb, rca):
    model = jax_get_model(jax_cfg(_cfg(ca_type, msrb, rca)))
    return model, init_jax(model, _x(), train=False)


def _jax_side(ca_type, msrb, rca):
    """(flax model, numpy variables) of a case."""
    return _jax_cached(*_jax_key(ca_type, msrb, rca))


def _variables(ca_type, msrb, rca):
    return _jax_side(ca_type, msrb, rca)[1]


@functools.lru_cache(maxsize=None)
def _jax_out(key, mode):
    """JAX's (output, batch statistics) of a case: eval mode in float32,
    train mode in float64 (see ``test_forward_parity``); made identity
    dropout and float64 by the caller's context."""
    model, variables = _jax_cached(*key)
    if mode == "eval":
        return apply_jax(model, variables, _x(), False)
    return apply_jax(model, to_float64(variables), _x().astype(np.float64),
                     True)


def _port(ca_type, msrb, rca):
    model = get_model(config_from_dict(_cfg(ca_type, msrb, rca)), device="cpu")
    load_jax_variables(model, _variables(ca_type, msrb, rca), RULES)
    return model


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("rca", [False, True], ids=["rca0", "rca1"])
@pytest.mark.parametrize("msrb", [True, False], ids=["msrb1", "msrb0"])
@pytest.mark.parametrize("ca_type", CA_TYPES)
def test_forward_parity(ca_type, msrb, rca, mode, no_dropout, monkeypatch):
    key = _jax_key(ca_type, msrb, rca)
    model = no_dropout(_port(ca_type, msrb, rca))
    if mode == "eval":
        want, _ = _jax_out(key, mode)
        with torch.no_grad():
            out = model(to_nchw(_x()))
        assert out.shape == (2, 21, 16, 16) and out.dtype == torch.float32
        assert_close_scaled(to_nhwc(out), want, RTOL, ATOL)
        return
    # train mode in float64: batch statistics over the small maps of the
    # deep levels amplify float32 rounding to ~1e-3 of the output in both
    # frameworks (each against its own float64 run), so the function is
    # compared where rounding does not hide it
    with jax_float64(monkeypatch, jax_ablation, jax_mynet):
        want, stats = _jax_out(key, mode)
    model = model.double().train()
    with torch.no_grad():
        out = model(to_nchw(_x()).double())
    assert out.dtype == torch.float64
    assert_close_scaled(to_nhwc(out), want, 1e-9, 1e-10)
    assert_state_matches(model, _variables(ca_type, msrb, rca), stats, RULES,
                         rtol=1e-9)


@pytest.mark.parametrize("ca_type", CA_TYPES)
def test_import_torch_state_dict_round_trip(ca_type):
    """The JAX package's own reference-name rules read the port's
    state_dict back into the very variables it was loaded from, and both
    sides count the same parameters and statistics."""
    variables = _variables(ca_type, True, True)
    model = _port(ca_type, True, True)
    back = import_torch_state_dict("hourglass_ablation", model.state_dict(),
                                   variables)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(got[path], leaf)
    n_params = sum(p.numel() for p in model.parameters())
    assert n_params == sum(a.size for a in jax.tree_util.tree_leaves(
        variables["params"]))
    n_stats = sum(b.numel() for name, b in model.named_buffers()
                  if not name.endswith("num_batches_tracked"))
    assert n_stats == sum(a.size for a in jax.tree_util.tree_leaves(
        variables["batch_stats"]))


def test_served_config_matches_jax_template():
    """``hourglass_ablation/freihand_256_cbam`` is JAX exp 48 in every field
    the port reads, and its full-width model counts JAX's parameters."""
    assert_served_config("hourglass_ablation/freihand_256_cbam",
                         "hourglass_ablation", 48, **{"MODEL.ca_type": "cbam"})


def test_bad_ca_type_and_num_block_raise():
    with pytest.raises(ValueError, match="ca_type"):
        get_model(config_from_dict(_cfg("eca", True, False)), device="cpu")
    bad = family_cfg("hourglass_ablation", msrb=False, num_block=(2, 2, 2))
    with pytest.raises(ValueError, match="num_block"):
        get_model(config_from_dict(bad), device="cpu")
