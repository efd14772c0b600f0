"""Lite-HRNet's fuse through ``kernels/fuse_sum_relu`` against the eager fuse.

On the CPU: the plain version, which follows the kernel's arithmetic (a
float32 partial sum rounded after each op to the dtype PyTorch's promotion
gives it), equals a ``StageModule``'s eager fuse bit for bit, in dtype and
layout, at Lite-HRNet-30's widths for 2, 3 and 4 branches and three dtype
mixes: all bfloat16, all float32 and the card's (CUDA autocast hands every
upsample on as float32; the module's inputs are float32 but the last
branch's, the chains bfloat16), which CPU autocast does not give and is
built here by hand. The route declines on the CPU, in train mode and with
gradients; forced on the CPU it sums the 42 rows of a depth-30 forward
through the plain version and changes no bit. ``plan`` is pure Python and
is held to the kernel's layout, dtype and alignment rules.

The cases marked ``card`` hold the kernel to the eager fuse with
``torch.equal`` on a CUDA card at the benchmark cell's shapes and others,
and the predictor's captured Lite-HRNet-30 forward to the eager forward
without the kernel; they skip elsewhere (on the card: ``python -m pytest
--noconftest -m card tests/test_torch_litehrnet_fuse.py``). This file
imports nothing of JAX.
"""

import sys

import pytest
import torch

import litehandnet_tpu_torch.kernels  # noqa: F401  (binds the submodules)
from litehandnet_tpu_torch.models import layers, litehrnet
from litehandnet_tpu_torch.models.litehrnet import LiteHRNet, StageModule
from litehandnet_tpu_torch.utils.weights import randomize_

FSR = sys.modules["litehandnet_tpu_torch.kernels.fuse_sum_relu"]
WIDTHS = (40, 80, 160, 320)        # Lite-HRNet-30's branches
BF16, F32 = torch.bfloat16, torch.float32
MIXES = ("bf16", "f32", "card")
ROWS_D30 = 3 * 2 + 8 * 3 + 3 * 4   # rows of a depth-30 forward


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _fuse_module(n, device="cpu", seed=0):
    """An eval-mode ``StageModule`` of n branches with no weighting blocks:
    its forward is the fuse alone."""
    m = StageModule(WIDTHS[:n], num_blocks=0)
    randomize_(m, torch.Generator().manual_seed(seed))
    return m.eval().to(device=device, memory_format=torch.channels_last)


def _inputs(n, mix, B=2, size=(16, 16), device="cpu", seed=0):
    """The module's inputs as the channel shuffle leaves them (NCHW), in the
    mix's dtypes: on the card the branches are float32 but the last."""
    g = torch.Generator().manual_seed(seed)
    xs = []
    for j in range(n):
        x = torch.randn(B, WIDTHS[j], size[0] >> j, size[1] >> j, generator=g)
        dtype = {"bf16": BF16, "f32": F32}.get(mix, BF16 if j == n - 1 else F32)
        xs.append(x.to(device=device, dtype=dtype))
    return xs


def _card_rules(monkeypatch):
    """CUDA autocast's upsample on the CPU: a resized bfloat16 term comes
    back float32."""
    def resize(x, size):
        if tuple(x.shape[2:]) == tuple(size):
            return x
        return layers.resize_nearest(x.float(), size)

    monkeypatch.setattr(litehrnet, "resize_nearest", resize)
    monkeypatch.setattr(litehrnet, "resize_dtype",
                        lambda x: F32 if x.dtype == BF16 else x.dtype)


def _force_route(monkeypatch):
    """A plan that takes any terms: the route then sums on the CPU through
    the plain version, as on the card through the kernel."""
    monkeypatch.setattr(litehrnet, "launch_plan", lambda *args: ("plan",))


def _rows_terms(m, xs, s0_of):
    """Each row's terms as the route builds them; row 0's sum from
    ``s0_of(terms)``."""
    n, rows, s0 = len(xs), [], None
    for i in range(n):
        terms = [m.fuse_layers[i][j](s0 if i and not j else xs[j])
                 for j in range(n)]
        rows.append(terms)
        if not i:
            s0 = s0_of(terms)
    return rows


def _same(a, b):
    return (a.dtype == b.dtype and a.shape == b.shape
            and a.stride() == b.stride() and torch.equal(a, b))


def _autocast(mix, device="cpu"):
    return torch.autocast(device, dtype=BF16, enabled=mix != "f32")


# -- on the CPU ---------------------------------------------------------------

@pytest.mark.parametrize("mix", MIXES)
@pytest.mark.parametrize("n", [2, 3, 4])
def test_plain_version_equals_the_eager_fuse(n, mix, monkeypatch):
    if mix == "card":
        _card_rules(monkeypatch)
    m, xs = _fuse_module(n), _inputs(n, mix)
    with torch.no_grad(), _autocast(mix):
        eager = m(xs)
        rows = _rows_terms(m, xs, lambda t: litehrnet.eager_fuse_row(t)[1])
        for i, terms in enumerate(rows):
            size = terms[0].shape[2:]
            dtypes = [t.dtype if t.shape[2:] == size
                      else litehrnet.resize_dtype(t) for t in terms]
            want, want_s = litehrnet.eager_fuse_row(terms)
            got, got_s = FSR.fuse_sum_relu_reference(terms, dtypes, True)
            assert _same(got, want) and _same(got, eager[i]), (n, mix, i)
            assert _same(got_s, want_s), (n, mix, i)
    dtypes = [y.dtype for y in eager]
    if mix == "card":   # every row float32 but the last, as on the card
        assert dtypes == [F32] * (n - 1) + [BF16]
        assert eager[0].is_contiguous()
        assert all(y.is_contiguous(memory_format=torch.channels_last)
                   for y in eager[1:])
    else:
        assert dtypes == [{"bf16": BF16, "f32": F32}[mix]] * n


@pytest.mark.parametrize("mix", MIXES)
def test_forced_route_sums_through_the_plain_version(mix, monkeypatch):
    if mix == "card":
        _card_rules(monkeypatch)
    m, xs = _fuse_module(4, seed=1), _inputs(4, mix, seed=1)
    with torch.no_grad(), _autocast(mix):
        want = m(xs)
        _force_route(monkeypatch)
        rows = FSR.fuse_sum_relu.rows
        got = m(xs)
    assert FSR.fuse_sum_relu.rows == rows + 4
    assert all(_same(a, b) for a, b in zip(got, want))


def _depth30(seed=0):
    m = LiteHRNet(21, 30)
    randomize_(m, torch.Generator().manual_seed(seed))
    return m.eval().to(memory_format=torch.channels_last)


def test_route_counts_42_rows_a_depth30_forward_and_declines_otherwise(
        monkeypatch):
    m = _depth30()
    x = torch.randn(1, 3, 64, 64, generator=torch.Generator().manual_seed(3)
                    ).contiguous(memory_format=torch.channels_last)
    monkeypatch.setattr(FSR.fuse_sum_relu, "rows", 0)
    with torch.autocast("cpu", dtype=BF16):
        with torch.no_grad():
            want = m(x)                     # the CPU: the plan declines
        assert FSR.fuse_sum_relu.rows == 0
        _force_route(monkeypatch)
        got = m(x)                          # gradients recorded
        assert FSR.fuse_sum_relu.rows == 0
        with torch.no_grad():
            got = m(x)
        assert FSR.fuse_sum_relu.rows == ROWS_D30
        assert torch.equal(got, want) and got.dtype == want.dtype
        m.train()
        with torch.no_grad():
            m(x)                            # train mode keeps its own fuse
        assert FSR.fuse_sum_relu.rows == ROWS_D30


def test_route_declines_cpu_terms_and_gradients():
    terms = [torch.zeros(1, 8, 4, 4), torch.zeros(1, 8, 2, 2)]
    with torch.no_grad():
        assert FSR.launch_plan(terms, (F32, F32)) is None
        assert not litehrnet.fuse_kernel_route(terms, (F32, F32), False)
    assert not litehrnet.fuse_kernel_route(terms, (F32, F32), False)


def _nchw(N, C, H, W, dtype=F32, aligned=True):
    return ((N, C, H, W), (C * H * W, H * W, W, 1), dtype, aligned)


def _nhwc(N, C, H, W, dtype=BF16, aligned=True):
    return ((N, C, H, W), (H * W * C, 1, W * C, C), dtype, aligned)


def test_plan_of_the_cells_rows():
    B, sms = 512, 132
    # row 0 of a 4-branch module: NCHW identity, coarse channels_last terms
    # entering as float32
    p = FSR.plan([_nchw(B, 40, 64, 64), _nhwc(B, 40, 32, 32),
                  _nhwc(B, 40, 16, 16), _nhwc(B, 40, 8, 8)],
                 (F32, F32, F32, F32), True, sms)
    assert (p["Q"], p["out_w_inner"], p["out_dtype"], p["bf16_steps"]) == (
        4, 1, F32, 0)
    assert [p[f"t{j}_shift"] for j in range(4)] == [0, 1, 2, 3]
    assert [p[f"t{j}_w_inner"] for j in range(4)] == [1, 0, 0, 0]
    assert p["items"] == B * 64 * 16 * 5 and p["write_sum"]
    assert p["grid_x"] <= sms * FSR.BLOCKS_PER_SM
    # the last row: bfloat16 chains and identity, bfloat16 at every step
    p = FSR.plan([_nhwc(B, 320, 8, 8), _nhwc(B, 320, 8, 8),
                  _nhwc(B, 320, 8, 8), _nchw(B, 320, 8, 8, BF16)],
                 (BF16,) * 4, False, sms)
    assert (p["out_w_inner"], p["out_dtype"], p["bf16_steps"]) == (
        0, BF16, 0b1111)
    # a bfloat16 chain then a float32 identity: bfloat16 until it enters
    p = FSR.plan([_nhwc(B, 80, 32, 32), _nchw(B, 80, 32, 32),
                  _nhwc(B, 80, 16, 16)], (BF16, F32, F32), False, sms)
    assert (p["out_dtype"], p["bf16_steps"]) == (F32, 0b001)
    # a 256 x 192 crop's coarsest branch is 6 wide: two pixels an item
    p = FSR.plan([_nhwc(3, 320, 8, 6), _nchw(3, 320, 8, 6)], (BF16, F32),
                 False, sms)
    assert p["Q"] == 2


@pytest.mark.parametrize("case", [
    "coarse_nchw", "c_not_8", "factor_3", "unaligned", "float64",
    "bf16_entering_f32_stored", "ambiguous_layout", "five_terms",
    "mixed_batch", "strided_channels"])
def test_plan_declines(case):
    B, terms, dtypes = 4, [_nchw(4, 40, 16, 16), _nhwc(4, 40, 8, 8)], [F32, F32]
    if case == "coarse_nchw":       # a coarse term must be channels_last
        terms[1] = _nchw(B, 40, 8, 8, BF16)
    elif case == "c_not_8":
        terms = [_nchw(B, 12, 16, 16), _nhwc(B, 12, 8, 8)]
    elif case == "factor_3":
        terms = [_nchw(B, 40, 12, 12), _nhwc(B, 40, 4, 4)]
    elif case == "unaligned":
        terms[1] = _nhwc(B, 40, 8, 8, aligned=False)
    elif case == "float64":
        terms[0], dtypes[0] = _nchw(B, 40, 16, 16, torch.float64), torch.float64
    elif case == "bf16_entering_f32_stored":
        dtypes[0] = BF16
    elif case == "ambiguous_layout":
        terms = [_nchw(B, 40, 1, 1)]
        dtypes = [F32]
    elif case == "five_terms":
        terms, dtypes = terms * 3, dtypes * 3
        terms = terms[:5]
        dtypes = dtypes[:5]
    elif case == "mixed_batch":
        terms[1] = _nhwc(B + 1, 40, 8, 8)
    elif case == "strided_channels":   # neither channels nor w innermost
        terms[0] = ((B, 40, 16, 16), (40 * 16 * 32, 16 * 32, 32, 2), F32, True)
    assert FSR.plan(terms, dtypes, False, 132) is None


def test_plain_version_rounds_each_step():
    # 1 + 2^-8 is not a bfloat16: an all-bfloat16 sum rounds it away at the
    # add, a float32 term keeps it
    one = torch.ones(1, 8, 2, 2, dtype=BF16)
    small = torch.full((1, 8, 1, 1), 2.0 ** -8, dtype=BF16)
    out, s = FSR.fuse_sum_relu_reference([one * 0.5, small], None, True)
    assert out.dtype == BF16 and torch.equal(out, torch.ones_like(one))
    out, _ = FSR.fuse_sum_relu_reference([one * 0.5, small], (BF16, F32))
    assert out.dtype == F32 and torch.all(out == 1 + 2.0 ** -8)
    # the ReLU keeps the sum's NaN and zeroes its negatives
    out, s = FSR.fuse_sum_relu_reference(
        [torch.tensor([[[[float("nan"), -1.0]]]]).expand(1, 8, 1, 2)], None,
        True)
    assert torch.isnan(out[..., 0]).all() and torch.equal(
        out[..., 1], torch.zeros(1, 8, 1))
    assert torch.equal(s[..., 1], torch.full((1, 8, 1), -2.0))


@pytest.mark.parametrize("bad", ["no_terms", "shape", "factor", "dtype",
                                 "dtypes_len"])
def test_wrapper_rejects(bad):
    t0, t1 = torch.zeros(1, 8, 4, 4), torch.zeros(1, 8, 2, 2)
    terms, dtypes, err = [t0, t1], None, ValueError
    if bad == "no_terms":
        terms = []
    elif bad == "shape":
        terms = [t0, torch.zeros(1, 16, 2, 2)]
    elif bad == "factor":
        terms = [torch.zeros(1, 8, 6, 6), torch.zeros(1, 8, 4, 4)]
    elif bad == "dtype":
        dtypes, err = (BF16, F32), TypeError   # float32 cannot enter as bf16
    elif bad == "dtypes_len":
        dtypes = (F32,)
    with pytest.raises(err):
        FSR.fuse_sum_relu(terms, dtypes)


def test_resize_dtype_off_the_card():
    x = torch.zeros(1, 8, 2, 2, dtype=BF16)
    with torch.autocast("cpu", dtype=BF16):
        assert layers.resize_dtype(x) == BF16
        assert layers.resize_nearest(x, (4, 4)).dtype == BF16
    assert layers.resize_dtype(x.float()) == F32


# -- on a CUDA card -------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _no_kernel(monkeypatch):
    monkeypatch.setattr(litehrnet, "fuse_kernel_route", lambda *a: False)


@pytest.mark.card
@pytest.mark.parametrize("n", [2, 3, 4])
@pytest.mark.parametrize("B,size", [(512, (64, 64)), (1, (64, 64)),
                                    (3, (64, 64)), (2, (64, 48))])
def test_kernel_equals_the_eager_fuse_on_the_card(n, B, size, card,
                                                  monkeypatch):
    dev = torch.device("cuda")
    m = _fuse_module(n, dev, seed=n)
    xs = _inputs(n, "card", B, size, dev, seed=B)
    with torch.no_grad(), torch.autocast("cuda", dtype=BF16):
        launches, rows = FSR.fuse_sum_relu.launches, FSR.fuse_sum_relu.rows
        got = m(xs)
        assert FSR.fuse_sum_relu.launches == launches + n
        assert FSR.fuse_sum_relu.rows == rows + n
        # row 0's pre-ReLU sum too, which rows >= 1's chains take
        row0 = [m.fuse_layers[0][j](xs[j]) for j in range(n)]
        s0 = litehrnet.fuse_row(row0, True)[1]
        with monkeypatch.context() as mp:
            _no_kernel(mp)
            want = m(xs)
        want_s0 = litehrnet.eager_fuse_row(row0)[1]
    torch.cuda.synchronize()
    assert [y.dtype for y in want] == [F32] * (n - 1) + [BF16]
    for i, (a, b) in enumerate(zip(got, want)):
        assert _same(a, b), (n, B, size, i)
    assert _same(s0, want_s0)


@pytest.mark.card
def test_plan_declines_channels_not_innermost_on_the_card(card):
    dev = torch.device("cuda")
    t0 = torch.randn(2, 40, 16, 16, device=dev)
    coarse = torch.randn(2, 40, 8, 8, device=dev, dtype=BF16)
    assert FSR.launch_plan([t0, coarse.contiguous(
        memory_format=torch.channels_last)], (F32, F32)) is not None
    assert FSR.launch_plan([t0, coarse], (F32, F32)) is None
    with pytest.raises(ValueError, match="does not take"):
        FSR.fuse_sum_relu([t0, coarse], (F32, F32))
    with torch.no_grad():
        assert not litehrnet.fuse_kernel_route([t0, coarse], (F32, F32), False)
        # the route sums it by the eager ops instead
        y, _ = litehrnet.fuse_row([t0, coarse], False)
    want = torch.relu(2.0 * t0 + layers.resize_nearest(coarse.float(),
                                                       (16, 16)))
    assert torch.equal(y, want)


@pytest.mark.card
def test_captured_litehrnet30_forward_equals_the_eager_one_without_the_kernel(
        card, monkeypatch):
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.serve import Predictor

    dev = torch.device("cuda")
    p = Predictor(get_config("litehrnet/freihand_256_d30"), device=dev,
                  dtype=BF16, seed=0)
    g = torch.Generator().manual_seed(5)
    batches = [torch.randint(0, 256, (8, 256, 256, 3), generator=g,
                             dtype=torch.uint8).to(dev) for _ in range(2)]
    with monkeypatch.context() as mp:
        _no_kernel(mp)
        want = [p.heatmaps(x).clone() for x in batches]
    p.graphs.clear()      # the graphs captured without the kernel
    rows = FSR.fuse_sum_relu.rows
    captures = Predictor.graph_captures
    got = [p.heatmaps(x).clone() for x in batches + batches + batches]
    torch.cuda.synchronize()
    assert Predictor.graph_captures == captures + 1
    assert FSR.fuse_sum_relu.rows == rows + ROWS_D30 * len(got)
    for i, out in enumerate(got):
        assert torch.equal(out, want[i % 2]), i
