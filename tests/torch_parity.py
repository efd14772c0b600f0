"""Helpers for the port's parity tests: small configs, JAX variables with
non-trivial weights and BatchNorm statistics, and layout conversion.

Inputs and weights are made with numpy from a seed and handed to both the JAX
package and the port as numpy arrays.
"""

from __future__ import annotations

import contextlib
import copy
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.ops import affine as JA
from litehandnet_tpu_torch.ops import affine as TA
from litehandnet_tpu_torch.utils.weights import load_jax_variables


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the port on one CPU thread. The models here are tiny, and the
    test workers share the machine's cores: with a thread per core in each
    worker a 64x64 forward measured seconds instead of milliseconds.
    Imported by a test module, this applies to that module's tests."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_model_cfg(ca_type="ca", reduction=4, features=32, size=64):
    """A LiteHandNet config dict at test size (the serve config's keys)."""
    return dict(
        MODEL=dict(
            name="litehandnet", num_stage=4, num_block=[2, 2, 2],
            input_channel=features, ca_type=ca_type, reduction=reduction,
            activation="leakyrelu", output_channel=21,
        ),
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=[size // 4, size // 4]),
        PIPELINE=dict(use_udp=False, kernel=(11, 11), unbiased_encoding=True),
    )


def family_cfg(name, features=32, size=64, num_block=(2, 2, 2), **model):
    """A config dict of model family ``name`` at test size; ``model`` adds
    ``cfg.MODEL`` keys (``ca_type``, ``msrb``, ...)."""
    return dict(
        MODEL=dict(name=name, num_stage=4, num_block=list(num_block),
                   input_channel=features, output_channel=21, **model),
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=[size // 4, size // 4]),
        PIPELINE=dict(use_udp=False, kernel=(11, 11), unbiased_encoding=True),
    )


def assert_served_config(name, family, exp_id, **overrides):
    """The port's config ``name`` equals the JAX template's experiment
    (``make_cfg(family, 'freihand', exp_id, 256, **overrides)``) in every
    field the port reads, and its full-width model counts the JAX model's
    parameters (shapes only: nothing is run)."""
    from litehandnet_tpu.config import config_from_dict as jax_cfg
    from litehandnet_tpu.config.templates import make_cfg
    from litehandnet_tpu.models import get_model as jax_get_model
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model

    want = make_cfg(family, "freihand", exp_id=exp_id, image_size=256,
                    **overrides)
    cfg = get_config(name)
    assert cfg.ID == exp_id and dict(cfg.MODEL) == want["MODEL"]
    for section in ("CHECKPOINT", "EVAL", "TRAIN", "OPTIMIZER", "LOSS"):
        assert dict(cfg[section]) == want[section], section
    for key in ("image_size", "heatmap_size", "num_joints", "name"):
        assert cfg.DATASET[key] == want["DATASET"][key], key
    for key, value in cfg.PIPELINE.items():
        assert want["PIPELINE"][key] == value, key
    jax_model = jax_get_model(jax_cfg(want))
    shapes = jax.eval_shape(
        lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
        jax.ShapeDtypeStruct((1, 256, 256, 3), np.float32))
    n_jax = sum(int(np.prod(a.shape))
                for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = get_model(cfg, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == n_jax


def apply_jax(module, variables, x_nhwc, train):
    """(output, batch statistics after the call) of a flax module as numpy;
    in eval mode the statistics are the given ones. Dropout must be made
    identity by the caller (flax and torch draw different bits)."""
    if not train:
        out = module.apply(variables, x_nhwc, train=False)
        return jax.tree_util.tree_map(np.asarray, out), variables.get(
            "batch_stats", {})
    out, new = module.apply(variables, x_nhwc, train=True,
                            mutable=["batch_stats"])
    return (jax.tree_util.tree_map(np.asarray, out),
            jax.tree_util.tree_map(np.asarray, new.get("batch_stats", {})))


# ``jax.numpy`` as the JAX model modules see it inside ``jax_float64``: their
# float32 casts (BatchNorm statistics, the heads' outputs) become float64
_JNP64 = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp)
                                  if not k.startswith("__")})
_JNP64.float32 = jnp.float64


@contextlib.contextmanager
def jax_float64(monkeypatch, *modules):
    """Run the JAX side in float64 throughout: ``jax.enable_x64``, the
    float32 casts of ``modules`` (and of ``models.layers``) mapped to
    float64, and the plain BatchNorm statistics (the Pallas ``moments``
    path computes in float32 by design). Callers pass float64 inputs and
    variables."""
    from litehandnet_tpu.models import layers

    with monkeypatch.context() as mp, jax.enable_x64(True):
        for mod in (layers, *modules):
            mp.setattr(mod, "jnp", _JNP64)
        mp.setenv("LHN_FUSED_BN", "0")
        yield


def to_float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


@pytest.fixture
def no_dropout(monkeypatch):
    """Dropout as identity on both sides: flax ``Dropout`` monkeypatched,
    and ``dropout_off(model)`` for the port's modules."""
    from flax import linen as fnn

    monkeypatch.setattr(fnn.Dropout, "__call__", lambda self, x, *a, **kw: x)

    def dropout_off(model):
        from litehandnet_tpu_torch.models.layers import Dropout

        for mod in model.modules():
            if isinstance(mod, Dropout):
                mod.p = 0.0
        return model

    return dropout_off


def assert_state_matches(model, variables, batch_stats, rules, rtol=1e-5):
    """The port model's BatchNorm running statistics equal ``batch_stats``
    (JAX's after the same call), loaded through ``rules``; ``variables``
    gives the params the loader also needs."""
    twin = copy.deepcopy(model)
    load_jax_variables(twin, {"params": variables["params"],
                              "batch_stats": batch_stats}, rules)
    want = twin.state_dict()
    n = 0
    for name, value in model.state_dict().items():
        if name.endswith(("running_mean", "running_var")):
            n += 1
            scale = float(want[name].abs().max())
            torch.testing.assert_close(value, want[name], rtol=rtol,
                                       atol=rtol * scale, msg=name)
    assert n > 0


def jax_names(keys, rules):
    """The JAX variable each port state-dict key maps to through
    ``rules``, as ``'collection/module/.../leaf'``, for every key a rule
    maps (not ``num_batches_tracked`` or a ``skip`` rule's buffers)."""
    from litehandnet_tpu_torch.utils import weights

    compiled = weights._compile(rules)
    out = {}
    for key in keys:
        if key.endswith("num_batches_tracked"):
            continue
        hit = weights._jax_key(key, compiled)
        if hit is not None:
            out[key] = "/".join(hit[0])
    return out


def init_jax(module, x_nhwc, seed=0, **apply_kw):
    """numpy variables of a flax module for input ``x_nhwc``, drawn from a
    numpy seed: conv kernels N(0, 1/fan_in), every bias and running mean
    N(0, 0.1^2), BN scales and running variances U(0.5, 1.5), relative
    position embeddings N(0, 1), so that fusion and the weight mapping are
    exercised. Only the variables' shapes come
    from flax (``eval_shape``, no compile)."""
    shapes = jax.eval_shape(
        lambda x: module.init(jax.random.PRNGKey(0), x, **apply_kw), x_nhwc)
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = str(path[-1].key)
        if name == "kernel":
            fan_in = int(np.prod(leaf.shape[:-1]))
            out = rng.normal(0.0, fan_in ** -0.5, leaf.shape)
        elif name in ("bias", "mean"):
            out = rng.normal(0.0, 0.1, leaf.shape)
        elif name in ("scale", "var"):
            out = rng.uniform(0.5, 1.5, leaf.shape)
        elif name in ("key_rel_w", "key_rel_h"):
            out = rng.normal(0.0, 1.0, leaf.shape)
        else:
            raise KeyError(f"unexpected variable {name}")
        return out.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def load_layer(layer: torch.nn.Module, variables, rules_fn) -> torch.nn.Module:
    """Load a flax layer's variables into the port layer ``layer``, through
    rules built by ``rules_fn(torch_prefix, jax_prefix)``."""
    holder = torch.nn.Module()
    holder.add_module("m", layer)
    nested = {c: {"m": tree} for c, tree in variables.items()}
    load_jax_variables(holder, nested, rules_fn(r"m", r"m"))
    return layer.eval()


def assert_close_scaled(got, want, rtol, atol):
    """``assert_allclose`` with ``atol`` in units of the output's largest
    magnitude (at least 1). Random weights grow the activations to O(100)
    through the residual stack, and float32 summation-order error grows with
    them, so an absolute floor in raw units would fail only where an output
    crosses zero."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol * scale)


def to_nchw(x_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def to_nhwc(x_nchw: torch.Tensor) -> np.ndarray:
    return x_nchw.detach().permute(0, 2, 3, 1).numpy()


def jax_pipeline_draws(pipe, key, B):
    """The augmentation draws of JAX's ``DevicePipeline`` call for ``key``
    (``per_sample`` :200-210 and ``hsv_augment`` :117-122), as the port's
    ``sample_params`` dict of tensors, so that ``apply`` reproduces JAX's
    whole call."""
    def draws(k):
        k_s, k_r, k_rot, k_flip, k_hsv = jax.random.split(k, 5)
        sf, rf = pipe.scale_factor, pipe.rot_factor
        s_mult = jnp.clip(jax.random.normal(k_s) * sf + 1.0, 1.0 - sf,
                          1.0 + sf)
        rot = jnp.clip(jax.random.normal(k_r) * rf, -2.0 * rf, 2.0 * rf)
        rot = jnp.where(jax.random.uniform(k_rot) <= pipe.rot_prob, rot, 0.0)
        do_flip = jax.random.uniform(k_flip) <= pipe.flip_prob
        k_gain, k_gate = jax.random.split(k_hsv)
        gains = jax.random.uniform(k_gain, (3,), minval=-1.0, maxval=1.0) \
            * jnp.float32([5.0, 30.0, 30.0])
        gate = jax.random.randint(k_gate, (3,), 0, 2).astype(jnp.float32)
        return s_mult, rot, do_flip, jnp.trunc(gains * gate)

    if not pipe.is_train:
        return dict(s_mult=torch.ones(B), rot=None,
                    do_flip=torch.zeros(B, dtype=torch.bool), hsv_gains=None)
    s_mult, rot, do_flip, gains = (
        torch.from_numpy(np.array(a))
        for a in jax.jit(jax.vmap(draws))(jax.random.split(key, B)))
    return dict(s_mult=s_mult, rot=rot, do_flip=do_flip, hsv_gains=gains)


def pipeline_to_port_layout(out: dict) -> dict:
    """JAX ``DevicePipeline`` outputs (channels-last targets) as numpy in the
    port's layout: targets ``[B, K, h, w]`` (``[B, S, K, h, w]``)."""
    res = {}
    for k, v in out.items():
        if k == "target":
            res[k] = ([np.moveaxis(np.asarray(t), -1, -3) for t in v]
                      if isinstance(v, (list, tuple))
                      else np.moveaxis(np.asarray(v), -1, -3))
        elif isinstance(v, (list, tuple)):
            res[k] = [np.asarray(t) for t in v]
        else:
            res[k] = np.asarray(v)
    return res


# -- the device pipeline's tolerances ------------------------------------

IMAGENET_STD = (0.229, 0.224, 0.225)
PIXEL_ATOL = 1e-3            # crops in 0..255
TARGET_ATOL = 1e-6
JOINT_ATOL = 1e-3            # px
# Float32 rounding that no framework shares: XLA contracts the crop
# matrices' arithmetic and the grid einsum into FMAs, and solves the 3x3
# system its own way, so its crop matrices and source coordinates differ from
# the port's by one or two ulp (about 1e-5 px below 128 px). On a uint8
# canvas of white noise (up to 255 per px) that moves a pixel by up to
# 255 * (|dx| + |dy|), several times PIXEL_ATOL. So whole-batch images are
# held to PIXEL_ATOL plus 2 * 255 * (delta + 2**-16), where delta is the
# largest gap between JAX's and the port's source coordinates computed from
# their own matrices on these inputs and 2**-16 one more ulp of the
# multiply-add (coordinates below 256 px). Targets are held to TARGET_ATOL
# plus the largest joint gap: a Gaussian of sigma >= 2 changes by less than
# 0.31 per heatmap px, so by less than 1 per input px even at SimDR k = 2.
COORD_ULP = 2.0 ** -16


def pipeline_coordinate_gap(pipe, centers, scales, rotations,
                            params) -> float:
    """Largest gap in px between JAX's and the port's crop source
    coordinates, each from its own inverse matrix, over the crop grid."""
    rot = rotations if params["rot"] is None else params["rot"].numpy()
    scale = scales * params["s_mult"].numpy()[:, None]
    W, H = pipe.image_size
    if pipe.use_udp:
        jinv = jax.vmap(lambda r, c, s: JA.invert_affine(JA.get_warp_matrix(
            r, c * 2.0, (W - 1.0, H - 1.0), s * 200.0)))(rot, centers, scale)
        tinv = TA.invert_affine(TA.get_warp_matrix(
            torch.from_numpy(rot), torch.from_numpy(centers * 2.0),
            (W - 1.0, H - 1.0), torch.from_numpy(scale * 200.0)))
    else:
        jinv = JA.get_affine_transform(centers, scale, rot, (W, H), inv=True)
        tinv = TA.get_affine_transform(
            torch.from_numpy(centers), torch.from_numpy(scale),
            torch.from_numpy(rot), (W, H), inv=True)
    d = np.asarray(jinv, np.float64) - tinv.numpy().astype(np.float64)
    xs, ys = np.arange(W)[None, None, :], np.arange(H)[None, :, None]
    return max(float(np.abs(d[:, i, 0, None, None] * xs
                            + d[:, i, 1, None, None] * ys
                            + d[:, i, 2, None, None]).max()) for i in (0, 1))


def assert_pipeline_batch(got: dict, want: dict, coord_gap: float):
    """The port's pipeline batch ``got`` (tensors) equals JAX's ``want``
    (``pipeline_to_port_layout``) within the bounds above."""
    assert set(got) == set(want), (set(got), set(want))
    img_atol = (PIXEL_ATOL + 2 * 255.0 * (coord_gap + COORD_ULP)) / (
        255.0 * min(IMAGENET_STD))
    assert coord_gap < 1e-4, coord_gap
    np.testing.assert_allclose(got["img"].numpy(), want["img"], rtol=0,
                               atol=img_atol)
    joint_gap = float(np.abs(got["joints"].numpy() - want["joints"]).max())
    assert joint_gap <= JOINT_ATOL, joint_gap
    for key in ("target", "target_weight", "simdr_x", "simdr_y"):
        if key not in want:
            continue
        g, w = got[key], want[key]
        for gi, wi in (zip(g, w) if isinstance(w, list) else [(g, w)]):
            assert gi.shape == wi.shape, key
            np.testing.assert_allclose(gi.numpy(), wi, rtol=0,
                                       atol=TARGET_ATOL + joint_gap,
                                       err_msg=key)
    for key in ("center", "scale", "bbox"):
        if key in want:
            np.testing.assert_allclose(got[key].numpy(), want[key], rtol=1e-5,
                                       atol=JOINT_ATOL, err_msg=key)


# -- the model zoo: forward, weights and one train step against JAX ---------

def zoo_cfg(name, size=64, **model):
    """A config dict of zoo family ``name`` at test size; ``model`` sets
    ``cfg.MODEL`` keys (``depth``, ``widen_factor``, ``num_stack`` ...)."""
    model.setdefault("output_channel", 21)
    return dict(
        MODEL=dict(name=name, **model),
        DATASET=dict(num_joints=21, image_size=[size, size],
                     heatmap_size=[size // 4, size // 4]),
        PIPELINE=dict(use_udp=False, kernel=(11, 11), unbiased_encoding=True),
    )


def to_jax_layout(out):
    """A port output (a map ``[..., C, H, W]`` or a tuple of them) as numpy
    in JAX's channels-last layout."""
    if isinstance(out, (tuple, list)):
        return [to_jax_layout(o) for o in out]
    return np.moveaxis(out.detach().numpy(), -3, -1)


def assert_outputs_close(got, want, rtol, atol):
    """``assert_close_scaled`` over an output or a tuple of outputs."""
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.shape == np.shape(w)
            assert_close_scaled(g, w, rtol, atol)
        return
    assert got.shape == np.shape(want)
    assert_close_scaled(got, want, rtol, atol)


def assert_family_forward(model, jax_model, variables, x_nhwc, mode, rules,
                          monkeypatch, jax_modules):
    """The port model (weights loaded from ``variables``) against the flax
    model: eval in float32 (rtol 1e-4, atol 1e-5 of the output's max), or
    train in float64 on both sides (rtol 1e-9, atol 1e-10 of the max) with
    the BatchNorm running statistics after the call (rtol 1e-9).
    ``jax_modules`` are the JAX model modules whose float32 casts become
    float64 in train mode. Returns the port's output."""
    if mode == "eval":
        want, _ = apply_jax(jax_model, variables, x_nhwc, False)
        with torch.no_grad():
            out = model.eval()(to_nchw(x_nhwc))
        assert all(o.dtype == torch.float32 for o in
                   (out if isinstance(out, tuple) else [out]))
        assert_outputs_close(to_jax_layout(out), want, 1e-4, 1e-5)
        return out
    with jax_float64(monkeypatch, *jax_modules):
        want, stats = apply_jax(jax_model, to_float64(variables),
                                x_nhwc.astype(np.float64), True)
    monkeypatch.setenv("LHN_FUSED_BN", "0")   # moments takes float32/bf16
    model = model.double().train()
    with torch.no_grad():
        out = model(to_nchw(x_nhwc).double())
    assert_outputs_close(to_jax_layout(out), want, 1e-9, 1e-10)
    assert_state_matches(model, variables, stats, rules, rtol=1e-9)
    return out


def assert_weights_round_trip(family, model, variables):
    """JAX's ``import_torch_state_dict`` takes the port's state dict (loaded
    from ``variables`` through the port's rules) with no
    ``ConversionError`` and gives ``variables`` back leaf for leaf; the
    parameter counts agree."""
    from litehandnet_tpu.utils.torch_import import import_torch_state_dict

    back = import_torch_state_dict(family, model.state_dict(), variables)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(got) == len(leaves)
    for path, leaf in leaves:
        np.testing.assert_array_equal(got[path], leaf)
    assert sum(p.numel() for p in model.parameters()) == sum(
        a.size for a in jax.tree_util.tree_leaves(variables["params"]))


STEP_LR = 1e-3


def record_grads():
    """An optax transform that keeps the gradients it is given as its
    state and passes them on unchanged."""
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def assert_step_matches_jax(cfg_dict, variables, jax_batch, port_batch,
                            monkeypatch, jax_modules, rules, jax_model=None,
                            port_model=None):
    """One float64 SGD step of the port (``train.distributed.
    make_train_step``) against JAX's ``make_train_step`` from the same
    weights (BatchNorm statistics included) and batch: the loss and its
    parts to 1e-9, every gradient leaf to 1e-9 of its max (plus 1e-11 of
    the largest gradient, for leaves that are zero in exact arithmetic), the
    parameters after the update and the running statistics. ``cfg_dict``
    sets an SGD optimizer at ``STEP_LR`` without warmup; the batches are in
    each side's layout (lists per scale where the family takes them).
    ``jax_model`` / ``port_model`` replace the models ``cfg_dict`` names
    (a cut-down model of the family)."""
    import optax

    from litehandnet_tpu.config import config_from_dict as jax_config
    from litehandnet_tpu.losses import get_loss as jax_get_loss
    from litehandnet_tpu.models import get_model as jax_get_model
    from litehandnet_tpu.train import distributed as JD
    from litehandnet_tpu.train.optim import make_optimizer as jax_optimizer
    from litehandnet_tpu.train.state import TrainState as JaxTrainState
    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.state import TrainState

    jcfg = jax_config(cfg_dict)
    tx = optax.chain(record_grads(),
                     jax_optimizer("SGD", optax.constant_schedule(STEP_LR)))
    with jax_float64(monkeypatch, *jax_modules):
        state = JaxTrainState.create(to_float64(variables), {}, tx)
        step = JD.make_train_step(jax_model or jax_get_model(jcfg),
                                  jax_get_loss(jcfg),
                                  tx, JD.make_mesh(1), donate=False)
        f64 = lambda v: jnp.asarray(v, jnp.float64)  # noqa: E731
        jstate, jmetrics = step(state, jax.tree.map(f64, jax_batch),
                                jax.random.PRNGKey(2))
        jstate = jax.tree.map(np.asarray, jstate)
        jmetrics = {k: float(v) for k, v in jmetrics.items()}
    jgrads = jstate.opt_state[0]["model"]

    monkeypatch.setenv("LHN_FUSED_BN", "0")   # moments takes float32/bf16
    cfg = config_from_dict(cfg_dict)
    model = port_model or get_model(cfg, device="cpu")
    load_jax_variables(model, variables, rules)
    tx_port, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    pstate = TrainState.create(model.double(), get_loss(cfg).double(), tx_port)
    metrics = make_train_step("cpu")(pstate, jax.tree.map(
        lambda a: torch.from_numpy(np.ascontiguousarray(a)).double(),
        port_batch))
    assert set(metrics) == set(jmetrics)
    for k, v in metrics.items():
        assert float(v) == pytest.approx(jmetrics[k], rel=1e-9), k

    twin = copy.deepcopy(pstate.model)
    load_jax_variables(twin, {"params": jgrads,
                              "batch_stats": jstate.batch_stats}, rules)
    want_grads = {k: v.detach() for k, v in twin.named_parameters()}
    gmax = max(float(g.abs().max()) for g in want_grads.values())
    for name, p in pstate.model.named_parameters():
        want = want_grads[name]
        tol = 1e-9 * (float(want.abs().max()) + 1e-2 * gmax)
        # no gradient: the loss does not read the parameter (JAX's is 0)
        grad = torch.zeros_like(p) if p.grad is None else p.grad
        assert float((grad - want).abs().max()) <= tol, name
    load_jax_variables(twin, {"params": jstate.params,
                              "batch_stats": jstate.batch_stats}, rules)
    want_sd = twin.state_dict()
    for name, value in pstate.model.state_dict().items():
        if not name.endswith("num_batches_tracked"):
            scale = float(want_sd[name].abs().max())
            torch.testing.assert_close(value, want_sd[name], rtol=1e-9,
                                       atol=1e-10 * scale, msg=name)
    assert pstate.step == int(jstate.step) == 1


def step_batches(channels, sizes, B=2, size=64, seed=0):
    """(JAX batch, port batch) for a train step: images of unit-normal noise,
    each sample scaled and shifted on its own; U(0, 1) targets of
    ``channels`` maps per (h, w) in ``sizes`` (one map, or a list per scale
    when ``sizes`` holds several) in each side's layout; target weights of
    0 or 1 (about 10% zero)."""
    rng = np.random.RandomState(seed)
    img = (rng.normal(size=(B, size, size, 3))
           * rng.uniform(0.5, 2.0, size=(B, 1, 1, 1))
           + rng.uniform(-1.0, 1.0, size=(B, 1, 1, 3))).astype(np.float32)
    targets = [rng.uniform(size=(B, h, w, channels)).astype(np.float32)
               for h, w in sizes]
    weight = (rng.uniform(size=(B, channels)) > 0.1).astype(np.float32)
    port = [np.ascontiguousarray(t.transpose(0, 3, 1, 2)) for t in targets]
    if len(sizes) == 1:
        targets, port = targets[0], port[0]
    return ({"img": img, "target": targets, "target_weight": weight},
            {"img": img, "target": port, "target_weight": weight})
