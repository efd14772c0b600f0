"""Weight initializers (``models/weight_init.py``) against JAX's: the same
tensors change under ``reinit_params`` (every conv and linear weight; biases
and BatchNorm stay), for a module and for a state dict, on the classifier's
weights carried from JAX; the draws' standard deviations within 5% at
n >= 10^4 (kaiming: fan_out, gain^2 = 2; normal: 0.001), beside JAX's own
draws. The draws come from a ``torch.Generator``, not a JAX key (a decided
deviation): the same distribution, other numbers."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.config import config_from_dict as jax_cfg
from litehandnet_tpu.models import get_model as jax_get_model
from litehandnet_tpu.models import weight_init as jwi
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.models import weight_init as twi
from litehandnet_tpu_torch.utils.weights import load_jax_variables, rules_for
from tests.torch_parity import (
    one_torch_thread,  # noqa: F401  (autouse fixture)
    init_jax,
    zoo_cfg,
)

CFG = zoo_cfg("classifier", size=32, num_classes=10, widen_factor=0.25)


def _jax_vars():
    x = np.zeros((1, 32, 32, 3), np.float32)
    return init_jax(jax_get_model(jax_cfg(CFG)), x, seed=3, train=False)


def _port(variables):
    model = get_model(config_from_dict(CFG), device="cpu")
    load_jax_variables(model, variables, rules_for("classifier"))
    return model


def _jax_changed_keys(variables):
    """The port's state-dict keys of the leaves JAX's ``reinit_params``
    re-draws: a 1 in every changed leaf, a 0 elsewhere, carried across by
    the rules."""
    new = jwi.reinit_params(variables["params"], jax.random.PRNGKey(0))
    flags = jax.tree_util.tree_map(
        lambda a, b: np.full(np.shape(a), float(not np.array_equal(a, b)),
                             np.float32), variables["params"], new)
    stats = jax.tree_util.tree_map(np.zeros_like, variables["batch_stats"])
    twin = _port(variables)
    load_jax_variables(twin, {"params": flags, "batch_stats": stats},
                       rules_for("classifier"))
    return {k for k, v in twin.state_dict().items()
            if v.is_floating_point() and bool((v == 1).all())}


@pytest.mark.parametrize("as_module", [True, False],
                         ids=["module", "state_dict"])
def test_reinit_changes_what_jax_changes(as_module):
    variables = _jax_vars()
    model = _port(variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator().manual_seed(0)
    if as_module:
        assert twi.reinit_params(model, gen) is model
        after = model.state_dict()
    else:
        after = twi.reinit_params(model.state_dict(), gen)
        # a state dict is copied, the module untouched
        assert all(torch.equal(v, before[k])
                   for k, v in model.state_dict().items())
    changed = {k for k in before if not torch.equal(before[k], after[k])}
    want = _jax_changed_keys(variables)
    assert changed == want
    assert any(k.startswith("head.") for k in changed)
    # biases and BatchNorm (affine, statistics) stay
    assert all(k.endswith(".weight") and after[k].dim() >= 2 for k in changed)
    for k in changed:
        assert float(after[k].std()) == pytest.approx(0.001, rel=0.2), k


def test_draw_statistics_match_jax():
    """n = 64 * 32 * 3 * 3 = 18,432 draws each: kaiming N(0, 2 / fan_out)
    with fan_out = 64 * 9, normal N(0, 0.001^2), within 5% of the target
    std, as JAX's draws for the HWIO kernel of the same conv are."""
    gen = torch.Generator().manual_seed(1)
    shape = (64, 32, 3, 3)
    hwio = (3, 3, 32, 64)
    target = {"kaiming": math.sqrt(2.0 / (64 * 9)), "normal": 0.001}
    for name, init, jinit in (("kaiming", twi.kaiming_init, jwi.kaiming_init),
                              ("normal", twi.normal_init, jwi.normal_init)):
        t = init(torch.empty(shape), gen)
        j = np.asarray(jinit(jax.random.PRNGKey(1), hwio, jnp.float32))
        assert float(t.std()) == pytest.approx(target[name], rel=0.05), name
        assert float(j.std()) == pytest.approx(target[name], rel=0.05), name
        assert abs(float(t.mean())) < 0.05 * target[name], name
    linear = twi.kaiming_init(torch.empty(200, 100), gen)
    assert float(linear.std()) == pytest.approx(math.sqrt(2.0 / 200),
                                                rel=0.05)


def test_constant_init_and_generator_reproducibility():
    t = twi.constant_init(0.5)(torch.empty(3, 4))
    assert torch.equal(t, torch.full((3, 4), 0.5))
    want = np.asarray(jwi.constant_init(0.5)(jax.random.PRNGKey(0), (3, 4)))
    np.testing.assert_array_equal(t.numpy(), want)
    a = twi.normal_init(torch.empty(100), torch.Generator().manual_seed(5))
    b = twi.normal_init(torch.empty(100), torch.Generator().manual_seed(5))
    assert torch.equal(a, b)
