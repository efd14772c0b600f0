"""The depthwise conv with bias and activation of the deploy graph
(``kernels/dw_conv_bias_act.py``, ``csrc/dw_conv_bias_act.cu``) and its
route (``models.layers.dw_kernel_route``), on the CPU.

The plain version is held to ``F.conv2d`` plus the bias and the activation
in float64. The launch plan is pure Python: its tiles, thread by thread as
the CUDA source maps them, write every output exactly once, read only
inside the staged tile and halo, fit shared memory, and the emulated
arithmetic (tiles staged with their zero halo, each thread's rows spaced d
apart) gives the plain version's result. The route picks exactly the 17
"same" depthwise convolutions of the benchmarked LiteHandNet's deploy graph
at 256², nothing of ResNet-50, and on the CPU nothing at all; the other
deploy convs' weights are cast once per weight version. The kernel
itself runs only on the card (``perfbench/tests/
test_dw_conv_bias_act_card.py``).
"""

import sys
from collections import Counter

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import litehandnet_tpu_torch.kernels  # noqa: F401  (binds the submodules)
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.models import fuse_params, get_model
from litehandnet_tpu_torch.models import layers as L
from litehandnet_tpu_torch.utils.weights import randomize_

DW = sys.modules["litehandnet_tpu_torch.kernels.dw_conv_bias_act"]

ACTS = {"none": lambda y: y, "relu": F.relu,
        "leaky_relu": lambda y: F.leaky_relu(y, 0.01)}
LITEHANDNET = "litehandnet/freihand_256_dark_h4_ca_r4"
RESNET50 = "resnet/freihand_256_r50"
# the benchmarked deploy graph's "same" depthwise convs at 256², batch 1:
# (C, H, W, k, dilation, act) and how many
CELL_SITES = Counter({
    (32, 128, 128, 7, 1, "leaky_relu"): 1,
    (64, 64, 64, 3, 1, "relu"): 4, (64, 64, 64, 3, 2, "relu"): 2,
    (32, 64, 64, 3, 1, "relu"): 2,
    (64, 32, 32, 3, 1, "relu"): 4, (64, 32, 32, 3, 2, "relu"): 2,
    (32, 32, 32, 3, 1, "relu"): 2,
})
SM_COUNTS = (132, 4)


def _strides(shape, memory_format=torch.channels_last):
    return torch.empty(shape, device="meta").contiguous(
        memory_format=memory_format).stride()


def _probe(shape, dtype=torch.float64, seed=0):
    g = torch.Generator().manual_seed(seed)
    N, C, H, W = shape
    return torch.randn(shape, generator=g, dtype=torch.float64).to(dtype)


def _taps(C, k, seed=1):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(C, 1, k, k, generator=g, dtype=torch.float64) * 0.3,
            torch.randn(C, generator=g, dtype=torch.float64))


# -- the plain version ------------------------------------------------------

@pytest.mark.parametrize("act", sorted(ACTS))
@pytest.mark.parametrize("C", [8, 32, 64])
@pytest.mark.parametrize("dilation", [1, 2])
@pytest.mark.parametrize("k", [3, 7])
def test_plain_version_is_conv_plus_bias_then_act_in_float64(k, dilation, C,
                                                             act):
    x = _probe((2, C, 9, 11), seed=k * 10 + dilation)
    w, b = _taps(C, k)
    got = DW.dw_conv_bias_act_reference(x, w, b, dilation, act)
    pad = dilation * (k // 2)
    want = ACTS[act](F.conv2d(x, w, padding=pad, dilation=dilation, groups=C)
                     + b.view(1, -1, 1, 1))
    assert got.dtype == torch.float64
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_takes_the_plain_version_on_the_cpu(dtype):
    x = _probe((2, 16, 7, 5), dtype)
    w, b = _taps(16, 5)
    before = DW.dw_conv_bias_act.launches
    got = DW.dw_conv_bias_act(x, w, b, 2, "leaky_relu", 0.2)
    want = DW.dw_conv_bias_act_reference(x, w, b, 2, "leaky_relu", 0.2)
    assert got.dtype == dtype and torch.equal(got, want)
    assert DW.dw_conv_bias_act.launches == before
    # one rounding, from the float32 sum
    f32 = F.leaky_relu(F.conv2d(x.float(), w.float(), padding=4, dilation=2,
                                groups=16) + b.float().view(1, -1, 1, 1), 0.2)
    assert torch.equal(got, f32.to(dtype))


@pytest.mark.parametrize("bad, error", [
    (dict(shape=(2, 8, 5)), ValueError),
    (dict(k=4), ValueError),
    (dict(k=9), ValueError),
    (dict(dilation=5), ValueError),
    (dict(dilation=0), ValueError),
    (dict(act="silu"), ValueError),
    (dict(bias_c=4), ValueError),
    (dict(dtype=torch.float16), TypeError),
    (dict(dtype=torch.float64), TypeError),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, error):
    shape = bad.get("shape", (2, 8, 6, 6))
    x = torch.zeros(shape, dtype=bad.get("dtype", torch.float32))
    k = bad.get("k", 3)
    w = torch.zeros(8, 1, k, k)
    b = torch.zeros(bad.get("bias_c", 8))
    with pytest.raises(error):
        DW.dw_conv_bias_act(x, w, b, bad.get("dilation", 1),
                            bad.get("act", "none"))


# -- the launch plan, thread by thread as the CUDA source maps it ----------

def _thread_outputs(p, k):
    """Every (thread, residue, row) of every item and group as the kernel
    maps it: arrays n, first channel, output row and column, the tile rows
    and columns its taps read, and whether it stores."""
    lanes, rows, segs = DW.LANES[k], DW.ROWS[k], DW.SEGS[k]
    d, vec = p["d"], p["vec"]
    tid = np.arange(DW.THREADS)
    lane = tid % lanes
    col = (tid // lanes) % DW.TILE_W
    seg = tid // (lanes * DW.TILE_W)
    # blocks walk the items blockIdx.x, + grid_x: every item once
    walked = np.concatenate([np.arange(bx, p["items"], p["grid_x"])
                             for bx in range(p["grid_x"])])
    item = np.sort(walked)
    assert np.array_equal(item, np.arange(p["items"]))
    per_image = p["tiles_x"] * p["tiles_y"]
    n = item // per_image
    ty = (item % per_image) // p["tiles_x"]
    tx = item % p["tiles_x"]
    grp = np.arange(p["groups"])
    rho = np.arange(d)
    m = np.arange(rows)
    # axes: item, group, thread, residue, row
    sh = lambda a, ax: np.expand_dims(a, [i for i in range(5) if i != ax])
    c = sh(grp, 1) * p["group"] + sh(lane, 2) * vec
    oy = (sh(ty, 0) * p["tile_h"] + sh(rho, 3)
          + d * (sh(seg, 2) * rows + sh(m, 4)))
    ox = sh(tx, 0) * DW.TILE_W + sh(col, 2)
    full = np.broadcast_shapes(c.shape, oy.shape, ox.shape)
    c, oy, ox = (np.broadcast_to(a, full) for a in (c, oy, ox))
    nn_ = np.broadcast_to(sh(n, 0), full)
    stores = (c < p["C"]) & (oy < p["H"]) & (ox < p["W"])
    # tile rows and columns of the first and last taps
    t_row = sh(rho, 3) + d * (sh(seg, 2) * rows + sh(m, 4))
    t_col = sh(col, 2)
    return dict(n=nn_, c=c, oy=oy, ox=ox, stores=stores,
                row_lo=t_row, row_hi=t_row + d * (k - 1),
                col_lo=t_col, col_hi=t_col + d * (k - 1), vec=vec)


def _covered(p, k):
    t = _thread_outputs(p, k)
    count = np.zeros((p["N"], p["C"], p["H"], p["W"]), np.int64)
    s = t["stores"]
    for e in range(t["vec"]):
        np.add.at(count, (t["n"][s], t["c"][s] + e, t["oy"][s], t["ox"][s]), 1)
    pad = p["d"] * (k // 2)
    assert t["row_hi"].max() < p["tile_h"] + 2 * pad
    assert t["col_hi"].max() < DW.TILE_W + 2 * pad
    return count


PLAN_CASES = (
    [((2,) + s[:3], s[3], s[4]) for s in CELL_SITES]
    + [((2, c, h, w), k, d) for c in (8, 24, 40) for h, w in ((17, 23),
                                                              (1, 70))
       for k in (3, 5, 7) for d in (1, 2, 3, 4)]
)


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape, k, d", PLAN_CASES)
def test_plan_writes_every_output_once_within_shared_memory(shape, k, d,
                                                            dtype, sm_count):
    p = DW.plan(shape, dtype, _strides(shape), k, d, sm_count)
    assert p is not None
    assert p["smem_bytes"] <= DW.MAX_SMEM_BYTES
    assert p["stages"] * p["stage_bytes"] == p["smem_bytes"]
    assert 1 <= p["stages"] <= DW.MAX_STAGES
    assert p["groups"] * p["grid_x"] <= max(sm_count, p["groups"])
    assert DW.SEGS[k] * DW.ROWS[k] * p["d"] == p["tile_h"]
    assert DW.LANES[k] * DW.TILE_W * DW.SEGS[k] == DW.THREADS
    assert p["vec"] * dtype.itemsize * DW.LANES[k] == DW.GROUP_BYTES[k]
    assert (_covered(p, k) == 1).all()


@pytest.mark.parametrize("why, shape, dtype, fmt, k, d, aligned", [
    ("C not a multiple of 8", (2, 12, 8, 8), torch.bfloat16,
     torch.channels_last, 3, 1, True),
    ("NCHW memory", (2, 16, 8, 8), torch.bfloat16, torch.contiguous_format,
     3, 1, True),
    ("unaligned", (2, 16, 8, 8), torch.float32, torch.channels_last, 3, 1,
     False),
    ("float16", (2, 16, 8, 8), torch.float16, torch.channels_last, 3, 1,
     True),
    ("k = 9", (2, 16, 8, 8), torch.float32, torch.channels_last, 9, 1, True),
    ("dilation 5", (2, 16, 8, 8), torch.float32, torch.channels_last, 3, 5,
     True),
    ("empty", (0, 16, 8, 8), torch.float32, torch.channels_last, 3, 1, True),
])
def test_plan_declines_what_it_cannot_tile(why, shape, dtype, fmt, k, d,
                                           aligned):
    assert DW.plan(shape, dtype, _strides(shape, fmt), k, d, 132,
                   aligned) is None, why


def test_plan_declines_a_halo_that_does_not_fit(monkeypatch):
    monkeypatch.setattr(DW, "MAX_SMEM_BYTES", DW.stage_bytes(7, 4) - 1)
    shape = (2, 32, 64, 64)
    assert DW.plan(shape, torch.bfloat16, _strides(shape), 7, 4, 132) is None
    assert DW.plan(shape, torch.bfloat16, _strides(shape), 7, 1, 132)


def _emulate(x, w, b, d, act, slope, dtype):
    """The kernel's arithmetic in float32, tile by tile: each tile of each
    group staged with its zero halo, each thread's rows spaced d apart and
    summed over ky, then kx, the bias and activation, one rounding."""
    N, C, H, W = x.shape
    k = w.shape[-1]
    p = DW.plan(x.shape, dtype, _strides(x.shape), k, d, 132)
    pad = d * (k // 2)
    xs = x.to(dtype).float().numpy()
    ws, bs = w.float().numpy(), b.float().numpy()
    y = np.full((N, C, H, W), np.nan, np.float32)
    rows_in, cols_in = p["tile_h"] + 2 * pad, DW.TILE_W + 2 * pad
    for item in range(p["items"]):
        per_image = p["tiles_x"] * p["tiles_y"]
        n, rem = divmod(item, per_image)
        ty, tx = divmod(rem, p["tiles_x"])
        y0, x0 = ty * p["tile_h"], tx * DW.TILE_W
        for g in range(p["groups"]):
            c0 = g * p["group"]
            cs = slice(c0, min(c0 + p["group"], C))
            tile = np.zeros((rows_in, cols_in, cs.stop - cs.start),
                            np.float32)
            gy = np.arange(rows_in) + y0 - pad
            gx = np.arange(cols_in) + x0 - pad
            iy, ix = (gy >= 0) & (gy < H), (gx >= 0) & (gx < W)
            tile[np.ix_(iy, ix)] = xs[n, cs][:, gy[iy]][:, :, gx[ix]].transpose(
                1, 2, 0)
            out = np.zeros((p["tile_h"], DW.TILE_W, tile.shape[2]),
                           np.float32)
            for ky in range(k):
                for kx in range(k):
                    tap = ws[cs, 0, ky, kx]
                    out = out + tile[ky * d:ky * d + p["tile_h"],
                                     kx * d:kx * d + DW.TILE_W] * tap
            out = out + bs[cs]
            if act == "relu":
                out = np.where(out < 0, 0, out)
            elif act == "leaky_relu":
                out = np.where(out < 0, out * np.float32(slope), out)
            hy, hx = min(p["tile_h"], H - y0), min(DW.TILE_W, W - x0)
            y[n, cs, y0:y0 + hy, x0:x0 + hx] = out[:hy, :hx].transpose(2, 0, 1)
    assert not np.isnan(y).any()
    return torch.from_numpy(y).to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape, k, d, act", [
    ((2, 32, 37, 41), 3, 1, "relu"), ((1, 64, 33, 35), 3, 2, "relu"),
    ((2, 16, 40, 34), 7, 1, "leaky_relu"), ((1, 8, 21, 19), 5, 3, "none"),
    ((1, 24, 18, 70), 7, 4, "relu"), ((1, 40, 17, 33), 3, 4, "leaky_relu"),
])
def test_emulated_tiles_give_the_plain_version(shape, k, d, act, dtype):
    x = _probe(shape, torch.float32, seed=sum(shape) + k)
    w, b = (t.float() for t in _taps(shape[1], k, seed=d))
    got = _emulate(x, w, b, d, act, 0.01, dtype)
    want = DW.dw_conv_bias_act_reference(x.to(dtype), w, b, d, act)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    else:
        # float32 sums in two orders, each rounded once to bfloat16: at
        # most one unit apart
        diff = (got.float() - want.float()).abs()
        assert (diff <= want.float().abs() * 2.0 ** -7 + 1e-6).all()


# -- the route ----------------------------------------------------------------

def _deploy(name, seed=0):
    cfg = get_config(name)
    train = get_model(cfg, device="cpu")
    randomize_(train, torch.Generator().manual_seed(seed))
    if name == RESNET50:
        return cfg, train
    deploy = get_model(cfg, deploy=True, device="cpu")
    deploy.load_state_dict(fuse_params(train))
    return cfg, deploy


def _sites(model, size):
    """Every conv the forward at ``size`` runs, with its module, and the
    Rep modules the route would send to the kernel on a card (bfloat16
    channels_last input of that shape)."""
    seen, picked = [], Counter()
    hooks = []

    def rep_hook(mod, args):
        x = args[0]
        spec = L.dw_kernel_spec(mod)
        if spec is None:
            return
        shape = tuple(x.shape)
        if DW.plan(shape, torch.bfloat16, _strides(shape), spec[0], spec[1],
                   132) is not None:
            picked[(shape[1], shape[2], shape[3], spec[0], spec[1],
                    spec[2])] += 1

    def conv_hook(mod, args):
        seen.append(mod)

    for mod in model.modules():
        if isinstance(mod, (L.RepConv, L.RepBlock)):
            hooks.append(mod.register_forward_pre_hook(rep_hook))
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
            hooks.append(mod.register_forward_pre_hook(conv_hook))
    with torch.no_grad():
        model(torch.zeros(1, 3, size, size).contiguous(
            memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    return seen, picked


def test_route_picks_the_17_depthwise_convs_of_the_deploy_graph():
    _, model = _deploy(LITEHANDNET)
    model = model.to(memory_format=torch.channels_last)
    convs, picked = _sites(model, 256)
    assert picked == CELL_SITES and sum(picked.values()) == 17
    picked_convs = [m.rep for m in model.modules()
                    if isinstance(m, (L.RepConv, L.RepBlock))
                    and L.dw_kernel_spec(m) is not None]
    assert len(picked_convs) == 17
    assert len(convs) == 103 and sum(c.groups > 1 for c in convs) == 19
    # the gates' valid 3x3 and every dense conv keep cuDNN
    rest = [c for c in convs if all(c is not p for p in picked_convs)]
    assert sum(c.groups > 1 for c in rest) == 2
    assert all(c.padding == (0, 0) for c in rest if c.groups > 1)


def test_route_takes_nothing_of_resnet50():
    _, model = _deploy(RESNET50)
    convs, picked = _sites(model, 256)
    assert len(convs) == 57 and not picked
    assert not any(L.dw_kernel_spec(m) for m in model.modules())


@pytest.mark.parametrize("build, spec", [
    (lambda: L.RepConv(16, 16, 3, 1, 1, groups=16, act=L.relu, deploy=True),
     (3, 1, "relu", 0.01)),
    (lambda: L.RepConv(16, 16, 3, 1, 2, 2, groups=16, act=None, deploy=True),
     (3, 2, "none", 0.01)),
    (lambda: L.RepBlock(32, 32, 7, 1, 3, groups=32, deploy=True),
     (7, 1, "leaky_relu", 0.01)),
    (lambda: L.RepConv(16, 16, 3, 2, 1, groups=16, act=None, deploy=True),
     None),                                           # stride 2
    (lambda: L.RepConv(16, 16, 3, 1, 1, groups=16, act=F.silu, deploy=True),
     None),                                           # SiLU
    (lambda: L.RepConv(16, 16, 3, 1, 0, groups=16, deploy=True), None),
    (lambda: L.RepConv(16, 16, 3, 1, 1, deploy=True), None),  # dense
    (lambda: L.RepConv(16, 32, 3, 1, 1, groups=16, deploy=True), None),
    (lambda: L.RepConv(16, 16, 3, 1, 5, 5, groups=16, deploy=True), None),
    (lambda: L.RepConv(16, 16, 3, 1, 1, groups=16, act=L.relu), None),
])
def test_spec_of_a_module(build, spec):
    assert L.dw_kernel_spec(build()) == spec


def test_the_cpu_never_routes(monkeypatch):
    """The deploy forward on the CPU runs ``rep`` and the activation, as
    with the route switched off, and never calls the kernel."""
    _, model = _deploy(LITEHANDNET, seed=3)
    model = model.to(memory_format=torch.channels_last)
    x = torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(0))
    x = x.contiguous(memory_format=torch.channels_last)

    def refuse(*args, **kwargs):
        raise AssertionError("the CPU forward reached the kernel")

    monkeypatch.setattr(L, "dw_conv_bias_act", refuse)
    with torch.no_grad():
        routed = model(x)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            routed_bf16 = model(x)
    monkeypatch.setattr(L, "dw_kernel_route", lambda module, x: None)
    with torch.no_grad():
        plain = model(x)
        with torch.autocast("cpu", dtype=torch.bfloat16):
            plain_bf16 = model(x)
    assert torch.equal(routed, plain)
    assert torch.equal(routed_bf16, plain_bf16)


def test_deploy_params_are_cast_once_per_weight_version():
    m = L.RepConv(16, 16, 3, 1, 1, groups=16, deploy=True)
    w32, b32 = L.deploy_params(m, torch.float32)
    assert w32 is m.rep.weight and b32 is m.rep.bias
    w, b = L.deploy_params(m, torch.bfloat16)
    assert w.dtype == b.dtype == torch.bfloat16
    assert torch.equal(w, m.rep.weight.detach().to(torch.bfloat16))
    again = L.deploy_params(m, torch.bfloat16)
    assert again[0] is w and again[1] is b
    with torch.no_grad():
        m.rep.weight.mul_(2)
    w2, _ = L.deploy_params(m, torch.bfloat16)
    assert w2 is not w
    assert torch.equal(w2, m.rep.weight.detach().to(torch.bfloat16))


def test_deploy_conv_off_the_card_is_the_conv():
    m = L.RepConv(16, 8, 1, deploy=True)
    x = torch.randn(2, 16, 5, 5)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        assert torch.equal(L.deploy_conv(m, x), m.rep(x))
    assert "_deploy_casts" not in m.__dict__


def test_conv_dtype_follows_autocast():
    x = torch.zeros(1, 8, 4, 4)
    assert L.conv_dtype(x) == torch.float32
    with torch.autocast("cpu", dtype=torch.bfloat16):
        assert L.conv_dtype(x) == torch.bfloat16
        assert L.conv_dtype(x.double()) == torch.float64
