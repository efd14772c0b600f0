"""Port optimizers, LR schedule and loss scaler
(``litehandnet_tpu_torch.train.optim`` / ``precision``) against the JAX
package's optax versions: the LR at every step, and single updates, float32
on the CPU."""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from litehandnet_tpu.train import optim as J
from litehandnet_tpu.train.precision import DynamicLossScaler as JaxScaler
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.train import optim as T
from litehandnet_tpu_torch.train.precision import DynamicLossScaler

# optax evaluates schedules in float32, the port in float64: 1e-6 relative,
# plus 1e-6 of the base LR where a cosine period ends (1 + cos -> 0 cancels
# in float32)
LR_RTOL = 1e-6
LR_ATOL = 1e-6 * 5e-4


def _cfg(opt_type, warmup, lr=5e-4, step_epoch=(2, 4), total=70):
    return config_from_dict(dict(
        OPTIMIZER=dict(type=opt_type, lr=lr, warmup_steps=warmup,
                       step_epoch=list(step_epoch)),
        TRAIN=dict(total_epoches=total),
    ))


@pytest.mark.parametrize("opt_type,warmup,steps_per_epoch,n_steps", [
    ("Adam", 5, 3, 30),      # warmup, then x0.1 at epochs 2 and 4, shifted
    ("Adam", 0, 3, 20),
    ("AdamW", 4, 2, 20),
    ("SGD", 3, 2, 150),      # cosine restarts at 10, 30 and 70 epochs
    ("SGD", 0, 1, 75),
])
def test_lr_schedule_equal_at_every_step(opt_type, warmup, steps_per_epoch,
                                         n_steps):
    """The schedule function and the LambdaLR it drives give optax's LR at
    every step: step t of training uses schedule(t)."""
    jax_sched = J.make_lr_schedule(5e-4, opt_type, warmup, (2, 4),
                                   steps_per_epoch, 70)
    port_sched = T.make_lr_schedule(5e-4, opt_type, warmup, (2, 4),
                                    steps_per_epoch, 70)
    tx, sched = T.make_optimizer_from_config(_cfg(opt_type, warmup),
                                             steps_per_epoch)
    param = torch.nn.Parameter(torch.zeros(3))
    optimizer, scheduler = tx([param])
    for t in range(n_steps):
        want = float(jax_sched(t))
        for got in (port_sched(t), sched(t), optimizer.param_groups[0]["lr"]):
            assert got == pytest.approx(want, rel=LR_RTOL, abs=LR_ATOL), t
        param.grad = torch.ones(3)
        optimizer.step()
        scheduler.step()


def test_lr_scales_with_world_size():
    _, sched = T.make_optimizer_from_config(_cfg("Adam", 0), 3, world_size=4)
    assert sched(0) == pytest.approx(4 * 5e-4)


def _updates(opt_type, steps=2):
    """Two updates of one parameter tree through optax and the port."""
    rng = np.random.RandomState(0)
    p0 = {"a": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32)
              for k, v in p0.items()} for _ in range(steps)]
    lr = 1e-2
    tx = J.make_optimizer(opt_type, optax.constant_schedule(lr))
    params = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(params)
    for g in grads:
        upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                               state, params)
        params = optax.apply_updates(params, upd)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in p0.items()}
    optimizer = T.make_optimizer(opt_type, list(torch_params.values()), lr)
    for g in grads:
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
    return params, torch_params


@pytest.mark.parametrize("opt_type", ["Adam", "AdamW", "SGD"])
def test_optimizer_updates_equal_optax(opt_type):
    """Adam (eps 1e-8), AdamW (weight decay 1e-4) and SGD (momentum 0.9,
    decayed weights 1e-8) move parameters as optax does, to float32
    rounding (rtol 1e-6, atol 1e-7)."""
    want, got = _updates(opt_type)
    for k in want:
        np.testing.assert_allclose(got[k].detach().numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-7)


def test_adai_is_not_ported_yet():
    with pytest.raises(KeyError):
        T.make_optimizer("Adai", [torch.nn.Parameter(torch.zeros(1))], 1e-3)


def test_loss_scaler_follows_jax():
    """Scale doubles after ``window`` finite steps and halves (floor 1) on a
    non-finite gradient; the finite flag matches."""
    jax_s = JaxScaler.create(init_scale=8.0, window=2)
    port = DynamicLossScaler(init_scale=8.0, window=2)
    finite_g = [torch.ones(3), torch.zeros(2)]
    bad_g = [torch.ones(3), torch.tensor([1.0, float("inf")])]
    for grads in [finite_g, finite_g, finite_g, bad_g, bad_g, bad_g, bad_g,
                  finite_g]:
        jax_s, want_finite = jax_s.update([jnp.asarray(g.numpy()) for g in grads])
        assert port.update(grads) == bool(want_finite)
        assert port.scale == float(jax_s.scale)
        assert port.good_steps == int(jax_s.good_steps)
    g = [torch.full((2,), 4.0)]
    port.unscale(g)
    assert torch.equal(g[0], torch.full((2,), 4.0 / port.scale))
    restored = DynamicLossScaler()
    restored.load_state_dict(port.state_dict())
    assert restored.state_dict() == port.state_dict()
