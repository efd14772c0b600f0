"""The port's ``dw_conv_bias_act`` kernel on the card (marked ``card``, skips
without one): against its plain version at each shape of the benchmarked
LiteHandNet's 17 depthwise convolutions, in bfloat16 and float32; the
served heatmaps through the route against the same model with the route
switched off, and the other deploy convs' weights cast once against
autocast's casts; and 17 launches per forward."""

import sys

import pytest
import torch

from perfbench.core import spec

BATCH = 128
# (C, H, W, k, dilation, act) of the served deploy graph's "same" depthwise
# convolutions at 256², and how many of each a forward runs
CELL_SITES = {
    (32, 128, 128, 7, 1, "leaky_relu"): 1,
    (64, 64, 64, 3, 1, "relu"): 4, (64, 64, 64, 3, 2, "relu"): 2,
    (32, 64, 64, 3, 1, "relu"): 2,
    (64, 32, 32, 3, 1, "relu"): 4, (64, 32, 32, 3, 2, "relu"): 2,
    (32, 32, 32, 3, 1, "relu"): 2,
}


def _dw():
    import litehandnet_tpu_torch.kernels  # noqa: F401  (binds the modules)

    return sys.modules["litehandnet_tpu_torch.kernels.dw_conv_bias_act"]


@pytest.fixture(autouse=True)
def exact_fp32():
    """cuDNN's float32 convolutions in float32, not TF32, for the plain
    version and the unrouted model."""
    was = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32 = was


@pytest.mark.card
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("site", sorted(CELL_SITES))
def test_kernel_matches_plain_version_at_the_cell_shapes(site, dtype, card):
    DW = _dw()
    C, H, W, k, d, act = site
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(C * H + k * 10 + d)
    x = torch.randn(BATCH, C, H, W, generator=g, device=dev).to(dtype)
    x = x.contiguous(memory_format=torch.channels_last)
    w = torch.randn(C, 1, k, k, generator=g, device=dev) * 0.3
    b = torch.randn(C, generator=g, device=dev)
    y = DW.dw_conv_bias_act(x, w, b, d, act)
    again = DW.dw_conv_bias_act(x, w, b, d, act)
    ref = DW.dw_conv_bias_act_reference(x, w, b, d, act)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert y.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(y, again)
    diff = (y.float() - ref.float()).abs()
    if dtype == torch.float32:
        # float32 sums of k^2 + 1 terms in two orders
        bound = 1e-5 * ref.abs().max() + 1e-5 * ref.abs()
    else:
        # each rounded once from float32 sums that differ in the last bits:
        # at most one bfloat16 unit apart
        bound = 2.0 ** -7 * ref.float().abs() + 1e-6
    assert (diff <= bound).all(), float(diff.max())


def _served():
    """The benchmarked LiteHandNet deploy graph on the card, seeded
    weights, channels_last, and a batch of 8 normalized crops."""
    from litehandnet_tpu_torch.models import fuse_params, get_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    cfg = spec.Cell("litehandnet.serve_b128").port_config()
    train = get_model(cfg, device="cpu")
    randomize_(train, torch.Generator().manual_seed(11))
    model = get_model(cfg, deploy=True, device="cpu")
    model.load_state_dict(fuse_params(train))
    model = model.to("cuda", memory_format=torch.channels_last)
    g = torch.Generator("cuda").manual_seed(5)
    x = torch.randn(8, 3, 256, 256, generator=g, device="cuda").contiguous(
        memory_format=torch.channels_last)
    return model, x


def _forward(model, x, dtype):
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16,
                                         enabled=dtype == torch.bfloat16):
        return model(x).float()


@pytest.mark.card
def test_route_gives_the_served_heatmaps_within_bf16_rounding(card,
                                                              monkeypatch):
    """The served bfloat16 forward through the route against the same model
    with the route off (cuDNN's grouped conv under autocast, its bias pass
    and the activation).

    At each routed site, on the input the served forward gives it, the
    kernel's output is the float32 result (taps, bias and sums in float32)
    rounded once, within half a bfloat16 unit, and its mean error is no
    larger than cuDNN's path's, which rounds the taps, the conv and the bias
    sum. End to end, the routed heatmaps lie as near the float32 forward as
    the unrouted bfloat16 ones do, within twice their mean gap (the gaps of
    these random-weight maps, 0.2 to 1.2% of their largest value, differ
    by up to a third between two bfloat16 computations); the float32
    forward through the route equals the unrouted one to float32 sums. The
    other deploy convs, their weights cast to bfloat16 once, give the bits
    of autocast's own casts."""
    from litehandnet_tpu_torch.models import layers as L

    DW = _dw()
    model, x = _served()
    sites = []

    def check_site(module, args, out):
        if L.dw_kernel_spec(module) is None:
            return
        k, d, act, slope = module._dw_spec
        conv, xin = module.rep, args[0]
        exact = DW.dw_conv_bias_act_reference(xin.float(), conv.weight,
                                              conv.bias, d, act, slope)
        with torch.autocast("cuda", dtype=torch.bfloat16):
            cudnn = conv(xin)
            cudnn = cudnn if module.act is None else module.act(cudnn)
        err = (out.float() - exact).abs()
        sites.append((float((err - 2.0 ** -8 * exact.abs()).max()
                            / exact.abs().max()),
                      float(err.mean()),
                      float((cudnn.float() - exact).abs().mean())))

    hooks = [m.register_forward_hook(check_site) for m in model.modules()
             if isinstance(m, (L.RepConv, L.RepBlock))]
    before = DW.dw_conv_bias_act.launches
    routed = _forward(model, x, torch.bfloat16)
    for h in hooks:
        h.remove()
    routed32 = _forward(model, x, torch.float32)
    torch.cuda.synchronize()
    assert DW.dw_conv_bias_act.launches == before + 34
    assert len(sites) == 17
    for over_half_unit, mean_err, cudnn_err in sites:
        assert over_half_unit <= 1e-6
        assert mean_err <= cudnn_err
    monkeypatch.setattr(L, "dw_kernel_route", lambda module, x: None)
    plain = _forward(model, x, torch.bfloat16)
    plain32 = _forward(model, x, torch.float32)
    # the weights cast once give autocast's own casts' bits
    monkeypatch.setattr(L, "deploy_conv", lambda module, x: module.rep(x))
    assert torch.equal(_forward(model, x, torch.bfloat16), plain)
    torch.cuda.synchronize()
    assert DW.dw_conv_bias_act.launches == before + 34
    scale = plain32.abs().max()
    assert float((routed32 - plain32).abs().max()) <= 1e-4 * float(scale)
    gap_routed = float((routed - plain32).abs().mean() / scale)
    gap_plain = float((plain - plain32).abs().mean() / scale)
    assert gap_routed <= 2 * gap_plain, (gap_routed, gap_plain)


@pytest.mark.card
def test_seventeen_launches_per_served_forward(card):
    DW = _dw()
    model, x = _served()
    x = torch.cat([x] * (BATCH // x.shape[0])).contiguous(
        memory_format=torch.channels_last)
    launches = DW.dw_conv_bias_act.launches
    shapes = DW.dw_conv_bias_act.shapes.copy()
    for _ in range(2):
        _forward(model, x, torch.bfloat16)
    torch.cuda.synchronize()
    assert DW.dw_conv_bias_act.launches == launches + 2 * 17
    new = DW.dw_conv_bias_act.shapes - shapes
    want = {(BATCH, C, H, W, k, d, 2): 2 * n
            for (C, H, W, k, d, _), n in CELL_SITES.items()}
    assert dict(new) == want
