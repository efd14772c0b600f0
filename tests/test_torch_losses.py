"""Port losses and targets (``litehandnet_tpu_torch.losses`` and
``ops.encode.msra_heatmaps``) against the JAX package, values and
gradients, float32 on the CPU. The port's heatmaps are ``[B, K, H, W]``;
the JAX side's ``[B, H, W, K]``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from litehandnet_tpu.losses import losses as J
from litehandnet_tpu.ops.encode import msra_heatmaps as jax_msra
from litehandnet_tpu_torch.config import config_from_dict
from litehandnet_tpu_torch.losses import get_loss
from litehandnet_tpu_torch.losses import losses as T
from litehandnet_tpu_torch.ops.encode import msra_heatmaps
from tests.torch_parity import one_torch_thread  # noqa: F401  (autouse)
from tests.torch_parity import to_nchw, to_nhwc

# values: float32 means over ~10^4 terms in two orders, 1e-5 relative;
# gradients: elementwise, 1e-5 relative plus 1e-6 of their magnitude
RTOL = 1e-5


def _heatmap_batch(B=2, K=21, HM=16, seed=0):
    """Targets from the JAX encoder (with positives above the balance
    threshold), raw outputs, and weights with some joints off."""
    rng = np.random.RandomState(seed)
    joints = rng.uniform(4, 4 * HM - 4, size=(B, K, 2)).astype(np.float32)
    target = np.stack([np.asarray(jax_msra(j, np.ones(K), (4 * HM, 4 * HM),
                                           (HM, HM), 1.5, unbiased=True)[0])
                       for j in joints])
    output = (target + rng.normal(0, 0.1, size=target.shape)).astype(np.float32)
    weight = (rng.uniform(size=(B, K)) > 0.2).astype(np.float32)
    return output, target, weight


@pytest.mark.parametrize("balance", [True, False])
@pytest.mark.parametrize("loss_type", ["L2", "L1", "SmoothL1"])
def test_distance_loss_heatmaps(loss_type, balance):
    out, tgt, w = _heatmap_batch()
    jfn = lambda o: J.distance_loss(o, jnp.asarray(tgt), jnp.asarray(w),
                                    loss_type, balance)
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(out))
    ot = to_nchw(out).requires_grad_()
    got = T.distance_loss(ot, to_nchw(tgt), torch.from_numpy(w), loss_type,
                          balance)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(to_nhwc(ot.grad), want_g, rtol=RTOL,
                               atol=1e-6 * np.abs(want_g).max())


def test_distance_loss_coordinates_and_reductions():
    rng = np.random.RandomState(1)
    out = rng.uniform(0, 1, (2, 21, 2)).astype(np.float32)
    tgt = rng.uniform(0, 1, (2, 21, 2)).astype(np.float32)
    w = (rng.uniform(size=(2, 21)) > 0.2).astype(np.float32)
    for reduction in ("mean", "sum", "none"):
        want = np.asarray(J.distance_loss(jnp.asarray(out), jnp.asarray(tgt),
                                          jnp.asarray(w), "L2", True,
                                          reduction=reduction))
        got = T.distance_loss(torch.from_numpy(out), torch.from_numpy(tgt),
                              torch.from_numpy(w), "L2", True,
                              reduction=reduction)
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=1e-7)


def test_distance_loss_stacked_output_shares_target():
    """[B, S, K, H, W] stacked outputs against one [B, K, H, W] target."""
    out, tgt, w = _heatmap_batch(seed=2)
    stacked = np.stack([out, out * 0.9], axis=1)              # [B,S,H,W,K]
    want = J.distance_loss(jnp.asarray(stacked), jnp.asarray(tgt),
                           jnp.asarray(w))
    got = T.distance_loss(torch.from_numpy(stacked.transpose(0, 1, 4, 2, 3)),
                          to_nchw(tgt), torch.from_numpy(w))
    np.testing.assert_allclose(float(got), float(want), rtol=RTOL)


@pytest.mark.parametrize("auto_weight", [False, True])
def test_topdown_heatmap_loss(auto_weight):
    """Value and gradients (output and ``mtl_p``) of the criterion, with
    ``mtl_p`` moved off its ones init."""
    out, tgt, w = _heatmap_batch(seed=3)
    crit = J.TopdownHeatmapLoss(loss_weight=(1.0, 0.1), auto_weight=auto_weight)
    jb = {"target": jnp.asarray(tgt), "target_weight": jnp.asarray(w)}
    variables = crit.init(jax.random.PRNGKey(0), jnp.asarray(out), jb)
    params = {k: np.asarray(v) * 0 + np.array([0.7, 1.3], np.float32)
              for k, v in variables.get("params", {}).items()}

    def jloss(o, p):
        total, parts = crit.apply({"params": p} if p else {}, o, jb)
        return total, parts

    (want, want_parts), (want_go, want_gp) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(out), params)

    port = T.TopdownHeatmapLoss(loss_weight=(1.0, 0.1), auto_weight=auto_weight)
    if auto_weight:
        with torch.no_grad():
            port.mtl_p.copy_(torch.tensor([0.7, 1.3]))
    ot = to_nchw(out).requires_grad_()
    got, parts = port(ot, {"target": to_nchw(tgt),
                           "target_weight": torch.from_numpy(w)})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=RTOL)
    assert set(parts) == set(want_parts) == {"heatmap"}
    np.testing.assert_allclose(float(parts["heatmap"].detach()),
                               float(want_parts["heatmap"]), rtol=RTOL)
    want_go = np.asarray(want_go)
    np.testing.assert_allclose(to_nhwc(ot.grad), want_go, rtol=RTOL,
                               atol=1e-6 * np.abs(want_go).max())
    if auto_weight:
        np.testing.assert_allclose(port.mtl_p.grad.numpy(),
                                   np.asarray(want_gp["mtl_p"]), rtol=RTOL,
                                   atol=1e-7)
    else:
        assert not list(port.parameters()) and not params


def _cfg(loss_type, simdr_split_ratio=0):
    return config_from_dict(dict(
        MODEL=dict(name="litehandnet"),
        DATASET=dict(image_size=[64, 48], heatmap_size=[16, 12],
                     num_joints=21),
        PIPELINE=dict(simdr_split_ratio=simdr_split_ratio),
        LOSS=dict(type=loss_type, loss_weight=[1.0, 0.1], auto_weight=True),
    ))


def test_get_loss_builds_the_ported_criterion_and_refuses_the_rest():
    crit = get_loss(_cfg("TopdownHeatmapLoss"))
    assert isinstance(crit, T.TopdownHeatmapLoss) and crit.auto_weight
    assert crit.loss_weight == (1.0, 0.1) and crit.simdr is None
    assert isinstance(get_loss(_cfg("SRHandNetLoss")), T.SRHandNetLoss)
    assert isinstance(get_loss(_cfg("CenterSimdrLoss")), T.CenterSimdrLoss)
    for name in ("SimDRLoss", "nope"):
        with pytest.raises(KeyError):
            get_loss(_cfg(name))
    # SimDR supervision: decoders from the flattened [K, 12 * 16] heatmaps
    # to 2 * 64 x bins and 2 * 48 y bins
    crit = get_loss(_cfg("TopdownHeatmapLoss", simdr_split_ratio=2))
    assert crit.simdr.x_decoder.weight.shape == (128, 192)
    assert crit.simdr.y_decoder.weight.shape == (96, 192)
    assert sorted(crit.state_dict()) == [
        "mtl_p", "simdr.x_decoder.bias", "simdr.x_decoder.weight",
        "simdr.y_decoder.bias", "simdr.y_decoder.weight"]


# -- SimDR ---------------------------------------------------------------

SIMDR_K, SIMDR_IMG, SIMDR_HM = 2, (64, 48), (16, 12)   # (w, h)


def _simdr_batch(dtype, B=3, K=21, seed=5):
    """Heatmap outputs ``[B, h, w, K]``, targets, weights and SimDR target
    vectors (from the JAX encoder at joints inside the image)."""
    from litehandnet_tpu.ops.encode import simdr_targets as jax_simdr

    rng = np.random.RandomState(seed)
    W, H = SIMDR_IMG
    out = rng.normal(0, 0.3, (B, SIMDR_HM[1], SIMDR_HM[0], K))
    tgt = np.clip(out + rng.normal(0, 0.1, out.shape), 0, 1)
    weight = (rng.uniform(size=(B, K)) > 0.2).astype(np.float64)
    joints = rng.uniform(2, (W - 2, H - 2), (B, K, 2))
    sx, sy = zip(*[jax_simdr(j, w, SIMDR_IMG, SIMDR_K, 2.0)
                   for j, w in zip(joints.astype(np.float32),
                                   weight.astype(np.float32))])
    sx = np.stack([np.asarray(a) for a in sx])
    sy = np.stack([np.asarray(a) for a in sy])
    return {k: v.astype(dtype) for k, v in dict(
        output=out, target=tgt, target_weight=weight, simdr_x=sx,
        simdr_y=sy).items()}


def _dense_params(rng, n_in, n_out, dtype):
    return {"kernel": rng.normal(0, 2.0 * n_in ** -0.5, (n_in, n_out)).astype(dtype),
            "bias": rng.normal(0, 0.5, (n_out,)).astype(dtype)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_kl_discret_loss(dtype, monkeypatch):
    """Value (float32, 1e-6 relative) and gradient of both predictions
    (float64, 1e-9 relative) of the per-joint SimDR loss."""
    rng = np.random.RandomState(6)
    B, K = 3, 21
    px = rng.normal(0, 1.5, (B, K, 128)).astype(dtype)
    py = rng.normal(0, 1.5, (B, K, 96)).astype(dtype)
    tx = rng.uniform(0, 1, px.shape).astype(dtype)
    ty = rng.uniform(0, 1, py.shape).astype(dtype)
    w = (rng.uniform(size=(B, K)) > 0.3).astype(dtype)
    with jax.enable_x64(dtype == "float64"):
        want, (wgx, wgy) = jax.value_and_grad(J.kl_discret_loss, (0, 1))(
            jnp.asarray(px), jnp.asarray(py), jnp.asarray(tx),
            jnp.asarray(ty), jnp.asarray(w))
        want, wgx, wgy = float(want), np.asarray(wgx), np.asarray(wgy)
    tpx = torch.from_numpy(px).requires_grad_()
    tpy = torch.from_numpy(py).requires_grad_()
    got = T.kl_discret_loss(tpx, tpy, torch.from_numpy(tx),
                            torch.from_numpy(ty), torch.from_numpy(w))
    got.backward()
    rtol = 1e-6 if dtype == "float32" else 1e-9
    np.testing.assert_allclose(float(got.detach()), want, rtol=rtol)
    assert float(T.KLDiscretLoss()(tpx.detach(), tpy.detach(),
                                   torch.from_numpy(tx), torch.from_numpy(ty),
                                   torch.from_numpy(w))) == float(got.detach())
    if dtype == "float64":
        for g, wg in ((tpx.grad, wgx), (tpy.grad, wgy)):
            np.testing.assert_allclose(g.numpy(), wg, rtol=1e-9,
                                       atol=1e-9 * np.abs(wg).max())


def _port_layout(b):
    """The batch as the port's criterion reads it: heatmaps [B, K, h, w],
    the output in channels_last memory (the flatten must not depend on
    it)."""
    t = {k: torch.from_numpy(v) for k, v in b.items()}
    for k in ("output", "target"):
        t[k] = t[k].permute(0, 3, 1, 2)
    t["output"] = t["output"].contiguous(memory_format=torch.channels_last)
    return t


@pytest.mark.parametrize("auto_weight", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_topdown_heatmap_loss_with_simdr(dtype, auto_weight):
    """``TopdownHeatmapLoss`` with SimDR (loss_weight [1.0, 0.5]): JAX's
    Dense weights carried across by ``load_jax_criterion``; the value and
    parts in float32 (1e-6 relative), and in float64 the value and the
    gradients of the output, both decoders and ``mtl_p`` (1e-9)."""
    from litehandnet_tpu_torch.utils.weights import load_jax_criterion

    b = _simdr_batch(dtype)
    n_in = SIMDR_HM[0] * SIMDR_HM[1]
    rng = np.random.RandomState(7)
    params = {"simdr": {
        "x_decoder": _dense_params(rng, n_in, SIMDR_K * SIMDR_IMG[0], dtype),
        "y_decoder": _dense_params(rng, n_in, SIMDR_K * SIMDR_IMG[1], dtype)}}
    if auto_weight:
        params["mtl_p"] = np.array([0.7, 1.3], dtype)
    jcrit = J.TopdownHeatmapLoss(
        loss_weight=(1.0, 0.5), auto_weight=auto_weight,
        simdr_split_ratio=SIMDR_K, simdr_width=SIMDR_K * SIMDR_IMG[0],
        simdr_height=SIMDR_K * SIMDR_IMG[1])
    with jax.enable_x64(dtype == "float64"):
        jb = {k: jnp.asarray(v) for k, v in b.items() if k != "output"}
        # the JAX variables' structure is the one init gives
        init = jcrit.init(jax.random.PRNGKey(0), jnp.asarray(b["output"]), jb)
        assert (jax.tree_util.tree_structure(init["params"])
                == jax.tree_util.tree_structure(params))

        def jloss(o, p):
            return jcrit.apply({"params": p}, o, jb)

        (want, want_parts), (wgo, wgp) = jax.value_and_grad(
            jloss, (0, 1), has_aux=True)(jnp.asarray(b["output"]), params)
        want = float(want)
        want_parts = {k: float(v) for k, v in want_parts.items()}
        wgo = np.asarray(wgo)
        wgp = jax.tree_util.tree_map(np.asarray, wgp)

    port = T.TopdownHeatmapLoss(
        loss_weight=(1.0, 0.5), auto_weight=auto_weight,
        simdr=T.SimDRLoss(SIMDR_K * SIMDR_IMG[0], SIMDR_K * SIMDR_IMG[1],
                          n_in)).to(getattr(torch, dtype))
    load_jax_criterion(port, params)
    t = _port_layout(b)
    out = t.pop("output").requires_grad_()
    got, parts = port(out, t)
    got.backward()
    rtol = 1e-6 if dtype == "float32" else 1e-9
    np.testing.assert_allclose(float(got.detach()), want, rtol=rtol)
    assert set(parts) == set(want_parts) == {"heatmap", "simdr"}
    for k in parts:
        np.testing.assert_allclose(float(parts[k].detach()), want_parts[k],
                                   rtol=rtol)
    if dtype == "float32":
        return
    np.testing.assert_allclose(out.grad.permute(0, 2, 3, 1).numpy(), wgo,
                               rtol=1e-9, atol=1e-9 * np.abs(wgo).max())
    for name in ("x_decoder", "y_decoder"):
        lin = getattr(port.simdr, name)
        want_k = wgp["simdr"][name]["kernel"]
        np.testing.assert_allclose(lin.weight.grad.numpy(), want_k.T,
                                   rtol=1e-9, atol=1e-9 * np.abs(want_k).max())
        np.testing.assert_allclose(lin.bias.grad.numpy(),
                                   wgp["simdr"][name]["bias"], rtol=1e-9,
                                   atol=1e-12)
    if auto_weight:
        np.testing.assert_allclose(port.mtl_p.grad.numpy(), wgp["mtl_p"],
                                   rtol=1e-9)


def test_load_jax_criterion_transposes_dense_kernels():
    """A Dense ``kernel`` [in, out] lands in ``nn.Linear.weight`` [out, in],
    its ``bias`` unchanged; a missing or extra leaf and a wrong shape are
    refused."""
    from litehandnet_tpu_torch.utils.weights import load_jax_criterion

    rng = np.random.RandomState(8)
    params = {"simdr": {"x_decoder": _dense_params(rng, 6, 4, "float32"),
                        "y_decoder": _dense_params(rng, 6, 3, "float32")}}
    crit = T.TopdownHeatmapLoss(simdr=T.SimDRLoss(4, 3, 6))
    load_jax_criterion(crit, params)
    for name in ("x_decoder", "y_decoder"):
        lin = getattr(crit.simdr, name)
        np.testing.assert_array_equal(lin.weight.detach().numpy(),
                                      params["simdr"][name]["kernel"].T)
        np.testing.assert_array_equal(lin.bias.detach().numpy(),
                                      params["simdr"][name]["bias"])
    with pytest.raises(KeyError):
        load_jax_criterion(crit, {"simdr": {"x_decoder":
                                            params["simdr"]["x_decoder"]}})
    with pytest.raises(KeyError):
        load_jax_criterion(crit, dict(params, mtl_p=np.ones(2, np.float32)))
    bad = {"simdr": dict(params["simdr"],
                         y_decoder=_dense_params(rng, 6, 5, "float32"))}
    with pytest.raises(ValueError):
        load_jax_criterion(crit, bad)


@pytest.mark.parametrize("unbiased", [False, True])
def test_msra_heatmaps_batched(unbiased):
    """Biased (quantized centre, windowed) and unbiased encodings, batched,
    with joints past every border (weight 0, empty map), invisible joints
    and joint weights."""
    rng = np.random.RandomState(4)
    B, K, IMG, HM = 3, 21, 64, 16
    joints = rng.uniform(0, IMG, size=(B, K, 3)).astype(np.float32)
    joints[0, 0, :2] = (-40.0, 30.0)      # far left: window off the map
    joints[0, 1, :2] = (30.0, 95.0)       # far below
    joints[1, 2, :2] = (-40.0, -40.0)     # off a corner
    joints[1, 3, :2] = (66.0, 10.0)       # past the right edge, window in
    vis = (rng.uniform(size=(B, K)) > 0.1).astype(np.float32)
    jw = rng.uniform(0.5, 1.5, size=K).astype(np.float32)
    target, weight = msra_heatmaps(torch.from_numpy(joints),
                                   torch.from_numpy(vis), (IMG, IMG),
                                   (HM, HM), 2.0, unbiased, torch.from_numpy(jw))
    assert target.shape == (B, K, HM, HM) and weight.shape == (B, K)
    for b in range(B):
        want_t, want_w = jax_msra(joints[b], vis[b], (IMG, IMG), (HM, HM),
                                  2.0, unbiased, jw)
        np.testing.assert_allclose(target[b].numpy(),
                                   np.asarray(want_t).transpose(2, 0, 1),
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(weight[b].numpy(), np.asarray(want_w),
                                   rtol=1e-6)
    assert weight[0, 0] == weight[0, 1] == weight[1, 2] == 0
    assert float(target[0, 0].abs().max()) == float(target[1, 2].abs().max()) == 0


# -- the Gen-1 losses (CenterSimdrLoss and the loss functions JAX exports) --

def _value_and_grad(jfn, tfn, out_nhwc, *args_nhwc, to_port=to_nchw):
    """JAX's and the port's value and gradient w.r.t. the output, on the
    same numpy inputs (heatmaps NHWC on the JAX side)."""
    want, want_g = jax.value_and_grad(jfn)(jnp.asarray(out_nhwc),
                                           *map(jnp.asarray, args_nhwc))
    ot = to_port(out_nhwc).requires_grad_()
    got = tfn(ot, *[to_port(a) if a.ndim == 4 else torch.from_numpy(a)
                    for a in args_nhwc])
    got.backward()
    return got, float(want), ot.grad, np.asarray(want_g)


def _assert_value_and_grad(got, want, grad, want_g, to_jax=to_nhwc,
                           grad_atol=1e-6):
    """Values at RTOL; gradients at RTOL plus ``grad_atol`` of their max."""
    np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=1e-7)
    scale = max(float(np.abs(want_g).max()), 1e-30)
    np.testing.assert_allclose(to_jax(grad), want_g, rtol=RTOL,
                               atol=grad_atol * scale)


@pytest.mark.parametrize("weighted", [True, False])
@pytest.mark.parametrize("name", ["joints_distance_loss", "kl_focal_loss",
                                  "focal_loss"])
def test_weighted_heatmap_losses(name, weighted):
    out, tgt, w = _heatmap_batch(seed=4)
    # focal_loss reads probabilities; off the clip's edges, where the two
    # frameworks' clip gradients differ by definition
    out = np.clip(out, 0.01, 0.99)
    if name == "focal_loss":
        tgt[0, ..., 3] = 0.0     # a map with no positive: the -neg branch
    args = (tgt, w) if weighted else (tgt,)
    got = _value_and_grad(getattr(J, name), getattr(T, name), out, *args)
    # kl_focal_loss's gradient is softmax(output) - softmax(target) per
    # pixel: float32 cancellation leaves ~1e-6 of the largest entry
    _assert_value_and_grad(*got, grad_atol=1e-5 if name == "kl_focal_loss"
                           else 1e-6)


@pytest.mark.parametrize("empty", [False, True], ids=["pos", "no_pos"])
@pytest.mark.parametrize("name", ["mask_loss", "region_loss",
                                  "centernet_focal_loss"])
def test_unweighted_map_losses(name, empty):
    """The three losses on [B, H, W, C] maps; ``no_pos`` zeroes the target
    (``n_pos == 0``: region_loss 0, the others their negative term)."""
    rng = np.random.RandomState(5)
    C = 2 if name == "region_loss" else 3
    tgt = np.zeros((2, 16, 16, C), np.float32)
    if not empty:
        tgt[:, 4:9, 5:11] = rng.uniform(0.1, 1.0, (2, 5, 6, C))
        tgt[0, 6, 7] = 1.0       # CenterNet's positives: exactly 1
        tgt[1, 5, 9] = 1.0
    out = rng.uniform(0.01, 0.99, tgt.shape).astype(np.float32)
    got = _value_and_grad(getattr(J, name), getattr(T, name), out, tgt)
    _assert_value_and_grad(*got)
    if empty and name == "region_loss":
        assert got[0].item() == 0.0


@pytest.mark.parametrize("empty", [False, True], ids=["mask", "no_mask"])
def test_reg_l1_loss(empty):
    rng = np.random.RandomState(6)
    out, tgt = rng.normal(size=(2, 2, 8, 8)).astype(np.float32), \
        rng.normal(size=(2, 2, 8, 8)).astype(np.float32)
    mask = np.zeros_like(out) if empty else (
        rng.uniform(size=out.shape) > 0.7).astype(np.float32)
    got = _value_and_grad(J.reg_l1_loss, T.reg_l1_loss, out, tgt, mask,
                          to_port=lambda a: torch.from_numpy(a.copy()))
    _assert_value_and_grad(*got, to_jax=lambda g: g.numpy())


@pytest.mark.parametrize("simdr", [True, False], ids=["simdr", "no_simdr"])
def test_center_simdr_loss(simdr):
    """``CenterSimdrLoss`` from the exp 16 config at test size: two stacks
    on K + 3 channels (balanced L2 on the joints and center, SmoothL1 on
    w/h) plus the SimDR term when the batch has SimDR targets; value, parts
    and the gradient of every input against JAX."""
    from litehandnet_tpu.config import config_from_dict as jax_cfg
    from litehandnet_tpu.config.templates import make_cfg
    from litehandnet_tpu.losses import get_loss as jax_get_loss

    cfg = make_cfg("mynet_stacked", "freihand", exp_id=16, image_size=64,
                   **{"MODEL.hm_loss_factor": [1.0, 0.5]})
    crit = get_loss(config_from_dict(cfg))
    jcrit = jax_get_loss(jax_cfg(cfg))
    assert isinstance(crit, T.CenterSimdrLoss)
    assert not list(crit.parameters())
    rng = np.random.RandomState(7)
    K = 21
    out, tgt, w = _heatmap_batch(K=K + 3, seed=8)
    hms = [out, (out * 0.7 + 0.05).astype(np.float32)]
    px, py = (rng.normal(size=(2, K, 128)).astype(np.float32) for _ in "xy")
    batch = {"target": tgt, "target_weight": w}
    if simdr:
        batch["simdr_x"], batch["simdr_y"] = (
            rng.uniform(size=(2, K, 128)).astype(np.float32) for _ in "xy")

    def jfn(h0, h1, x, y):
        loss, parts = jcrit.apply({}, ([h0, h1], x, y),
                                  jax.tree.map(jnp.asarray, batch))
        return loss, parts

    (want, want_parts), want_g = jax.value_and_grad(
        jfn, argnums=(0, 1, 2, 3), has_aux=True)(*map(jnp.asarray, hms + [px, py]))
    ins = [to_nchw(h).requires_grad_() for h in hms] + [
        torch.from_numpy(a).requires_grad_() for a in (px, py)]
    tb = {"target": to_nchw(tgt), "target_weight": torch.from_numpy(w)}
    for k in ("simdr_x", "simdr_y"):
        if k in batch:
            tb[k] = torch.from_numpy(batch[k])
    got, parts = crit((ins[:2], ins[2], ins[3]), tb)
    got.backward()
    assert set(parts) == set(want_parts) == (
        {"heatmap", "simdr"} if simdr else {"heatmap"})
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for k, v in parts.items():
        np.testing.assert_allclose(v.item(), float(want_parts[k]), rtol=RTOL)
    for g, wg, layout in zip([t.grad if t.grad is not None
                              else torch.zeros_like(t) for t in ins], want_g,
                             [to_nhwc, to_nhwc, torch.Tensor.numpy,
                              torch.Tensor.numpy]):
        wg = np.asarray(wg)
        np.testing.assert_allclose(layout(g), wg, rtol=RTOL,
                                   atol=1e-6 * max(np.abs(wg).max(), 1e-30))
