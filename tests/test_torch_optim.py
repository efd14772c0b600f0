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
    ("AdaiW", 2, 1, 40),     # Adai takes SGD's cosine restarts
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
    """Adai and AdaiW are built now, with the reference factory's
    hyper-parameters; an unknown name is refused."""
    p = [torch.nn.Parameter(torch.zeros(1))]
    for name, decoupled in (("Adai", False), ("AdaiW", True)):
        opt = T.make_optimizer(name, p, 1e-3)
        assert isinstance(opt, T.Adai)
        group = opt.param_groups[0]
        assert group["betas"] == (0.1, 0.99) and group["eps"] == 1e-3
        assert group["weight_decay"] == 1e-8
        assert group["decoupled"] is decoupled
    with pytest.raises(KeyError):
        T.make_optimizer("Lamb", p, 1e-3)


@pytest.mark.parametrize("steps", [1, 5])
@pytest.mark.parametrize("opt_type", ["Adai", "AdaiW"])
def test_adai_updates_equal_optax(opt_type, steps):
    """``steps`` Adai / AdaiW updates of a three-leaf tree in float64 equal
    JAX's ``adai`` (1e-12 relative); a weight decay of 0.05 makes the two
    decay placements differ, and the tree's global mean of the second
    moments couples the leaves."""
    import jax

    rng = np.random.RandomState(1)
    p0 = {"a": rng.normal(size=(4, 3)), "b": rng.normal(size=(5,)) * 3.0,
          "c": rng.normal(size=(2, 2, 2)) * 0.1}
    grads = [{k: rng.normal(size=v.shape) * rng.choice([0.01, 1.0, 10.0])
              for k, v in p0.items()} for _ in range(steps)]
    lr, wd, decoupled = 0.05, 0.05, opt_type == "AdaiW"
    with jax.enable_x64(True):
        tx = J.adai(optax.constant_schedule(lr), weight_decay=wd,
                    decoupled=decoupled)
        params = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(params)
        for g in grads:
            upd, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, params)
            params = optax.apply_updates(params, upd)
        want = {k: np.asarray(v) for k, v in params.items()}
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for k, v in p0.items()}
    optimizer = T.Adai(list(torch_params.values()), lr=lr, weight_decay=wd,
                       decoupled=decoupled)
    for g in grads:
        for k, p in torch_params.items():
            p.grad = torch.from_numpy(g[k])
        optimizer.step()
    for k in want:
        assert want[k].dtype == np.float64
        np.testing.assert_allclose(torch_params[k].detach().numpy(), want[k],
                                   rtol=1e-12, atol=1e-15)
        assert not np.allclose(want[k], p0[k])


def test_adai_counts_a_missing_gradient_as_zero():
    """A parameter without a gradient takes part as a zero gradient (as a
    leaf of the optax tree would): it still counts in the mean of the
    second moments and decays."""
    a = torch.nn.Parameter(torch.ones(3, dtype=torch.float64))
    b = torch.nn.Parameter(torch.ones(2, dtype=torch.float64))
    ref_a = torch.nn.Parameter(a.detach().clone())
    ref_b = torch.nn.Parameter(b.detach().clone())
    opt = T.Adai([a, b], lr=0.1, weight_decay=0.5)
    ref = T.Adai([ref_a, ref_b], lr=0.1, weight_decay=0.5)
    a.grad = ref_a.grad = torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    ref_b.grad = torch.zeros(2, dtype=torch.float64)
    opt.step()
    ref.step()
    assert torch.equal(a, ref_a) and torch.equal(b, ref_b)
    assert (b < 1).all()


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
