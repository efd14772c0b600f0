"""Launch plans of the port's kernels (``plan`` of ``kernels/moments.py``,
``dw_conv3x3_stats.py``, ``blur_log.py`` and ``softpool_2x2.py``), the
arithmetic of ``csrc/moments.cu``'s partition and fixed-order Chan merge
emulated in float32, and ``csrc/blur_log.cu``'s fast path (row tiles of a
cluster, maxima merged across it) emulated in float32.

The plans are pure Python, so their coverage is checked here at every train
site shape of LiteHandNet and ``hourglass_ablation``-cbam (B = 32) and at
ragged shapes: each row, pixel and channel is covered exactly once, the
scalar path (NCHW memory) gets the same partition as the vector path
(channels_last), and the scratch holds every partial. The emulation follows
the plan thread by thread (two-pass per tile, Chan fold over a block's
tiles, the block's slot tree, the last block's merge of the partials) and is
held to the JAX package's ``moments`` and to a float64 two-pass. The
``blur_log`` plan must pick its fast path for the serve layout only, cover
each output row once with every halo row owned by a CTA of the cluster, and
fit shared memory; its emulation is held to the JAX Pallas kernel in
interpret mode and to the plain twin. The ``softpool_2x2`` plan must pick
its fast path only for 2 x 2 stride-2 windows on aligned channels-innermost
memory of whole 16-byte vectors, and its walks must write each output once.
The CUDA kernels themselves run only on the card (``chip_smoke.py``).
"""

import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import litehandnet_tpu_torch.kernels  # noqa: F401  (binds the submodules)
from litehandnet_tpu.ops import fused_bn as J
from litehandnet_tpu.ops.pallas_kernels import blur_log as pallas_blur_log
from litehandnet_tpu_torch.ops.blur import cv2_gaussian_kernel
from tests.test_fused_bn import _interp_moments

MM = sys.modules["litehandnet_tpu_torch.kernels.moments"]
DW = sys.modules["litehandnet_tpu_torch.kernels.dw_conv3x3_stats"]
BL = sys.modules["litehandnet_tpu_torch.kernels.blur_log"]
SP = sys.modules["litehandnet_tpu_torch.kernels.softpool_2x2"]

# the train sites at B = 32 (chip_smoke.site_shapes): LiteHandNet's 33
# BatchNorms and 16 fused depthwise convs, hourglass_ablation-cbam's 37
# BatchNorms (the same shapes but the 1x1 maps)
MOMENTS_SITES = [(32, 128, s, s) for s in (64, 32, 16, 8, 1)]
DW_SITES = [((32, 64, 64, 64), 1), ((32, 64, 64, 64), 2),
            ((32, 32, 64, 64), 1), ((32, 64, 32, 32), 1),
            ((32, 64, 32, 32), 2), ((32, 32, 32, 32), 1)]
MOMENTS_RAGGED = [(1, 128, 1, 1), (1, 21, 1, 1), (3, 21, 17, 23),
                  (2, 1, 5, 7), (5, 128, 9, 7), (2, 256, 3, 3)]
DW_RAGGED = [((2, c, h, w), d) for c in (32, 64, 128, 24, 21)
             for h, w in ((64, 64), (17, 23)) for d in (1, 2)]
DTYPES = [torch.float32, torch.bfloat16]
SM_COUNTS = [132, 4]      # the H100's, and few, so blocks walk many tiles


def _strides(shape, memory_format):
    return torch.empty(shape, device="meta").contiguous(
        memory_format=memory_format).stride()


def _channels_last(shape):
    return _strides(shape, torch.channels_last)


def _nchw(shape):
    return _strides(shape, torch.contiguous_format)


def _scratch_ok(p, groups, parts, width):
    """Regions in order, aligned, not overlapping, inside nbytes."""
    regions = [(p["scratch_tickets"], 4 * groups),
               (p["scratch_n"], 8 * groups * parts),
               (p["scratch_mean"], 4 * groups * parts * width),
               (p["scratch_m2"], 4 * groups * parts * width)]
    for (start, size), (nxt, _) in zip(regions, regions[1:] + [
            (p["scratch_nbytes"], 0)]):
        assert start % 16 == 0 and start + size <= nxt


# ---------------------------------------------------------------------------
# moments
# ---------------------------------------------------------------------------


def _moments_rows(p):
    """Every row index the plan's threads read, as (block, tile, slot, k)
    enumerate them: block b walks tiles b, b + grid_x, ...; row = tile *
    tile_rows + k * slots + slot."""
    tiles = np.arange(p["tiles"])
    assert set(tiles % p["grid_x"]) == set(range(min(p["grid_x"],
                                                     p["tiles"])))
    k, slot = np.meshgrid(np.arange(MM.ROWS_PER_THREAD), np.arange(p["slots"]),
                          indexing="ij")
    rows = (tiles[:, None] * p["tile_rows"]
            + (k * p["slots"] + slot).reshape(-1)[None, :]).reshape(-1)
    return rows[rows < p["rows"]]


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MOMENTS_SITES + MOMENTS_RAGGED)
def test_moments_plan_covers_each_row_and_channel_once(shape, dtype,
                                                       sm_count):
    N, C, H, W = shape
    p = MM.plan(shape, dtype, _channels_last(shape), sm_count)
    assert p["lanes"] * p["slots"] == MM.THREADS
    assert p["lanes"] == 1 << p["lanes_log2"] <= MM.MAX_LANES
    assert p["vec"] * dtype.itemsize == 16
    rows = _moments_rows(p)
    np.testing.assert_array_equal(np.sort(rows), np.arange(N * H * W))
    # channel (group g, lane l, element e) = (g * lanes + l) * vec + e
    channels = np.arange(p["groups"] * p["lanes"] * p["vec"])
    assert len(channels) >= C and p["width"] == p["lanes"] * p["vec"]
    assert (p["groups"] - 1) * p["width"] < C
    # no more blocks than tiles, and no more than the SMs ask for
    assert 1 <= p["grid_x"] <= p["tiles"]
    assert p["grid_x"] <= max(1, MM.BLOCKS_PER_SM * sm_count)
    _scratch_ok(p, p["groups"], p["grid_x"], p["width"])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", MOMENTS_SITES + MOMENTS_RAGGED)
def test_moments_scalar_path_gets_the_vector_paths_partition(shape, dtype):
    """NCHW memory (or an unaligned start) takes the scalar path with the
    same partition and summation order, so it gives the same bits."""
    N, C, H, W = shape
    layout = ("sn", "sc", "sh", "sw", "row_stride")
    vec = MM.plan(shape, dtype, _channels_last(shape), 132)
    for strides, aligned in ((_nchw(shape), True),
                             (_channels_last(shape), False)):
        scalar = MM.plan(shape, dtype, strides, 132, aligned)
        assert ({k: v for k, v in scalar.items() if k not in layout}
                == {k: v for k, v in vec.items() if k not in layout})
        assert [scalar[k] for k in layout[:4]] == list(strides)
        if not aligned or H * W > 1:
            assert scalar["row_stride"] == 0
    # channels_last takes the vector path wherever C is a whole number of
    # 16-byte vectors
    assert (vec["row_stride"] == C) == (C % vec["vec"] == 0)


def test_moments_row_stride():
    assert MM.row_stride((2, 8, 3, 5), (120, 1, 40, 8)) == 8
    # a channel slice of a wider channels_last tensor: rows 16 apart
    x = torch.empty(2, 16, 3, 5).contiguous(memory_format=torch.channels_last)
    assert MM.row_stride(x[:, :8].shape, x[:, :8].stride()) == 16
    assert MM.row_stride((2, 8, 3, 5), (120, 15, 5, 1)) is None
    assert MM.row_stride((4, 8, 1, 1), (8, 1, 1, 1)) == 8


def _chan(n_a, mean_a, m2_a, n_b, mean_b, m2_b):
    """Chan's update as csrc/stats_merge.cuh computes it: float32 statistics,
    float64 counts and ratios; a part with no values is skipped."""
    tot = n_a + n_b
    rb = np.where(n_b > 0, n_b / np.maximum(tot, 1.0), 0.0)
    fb = rb.astype(np.float32)[..., None]
    fab = (n_a * rb).astype(np.float32)[..., None]
    delta = (mean_b - mean_a).astype(np.float32)
    take = (n_b > 0)[..., None]
    mean = np.where(take, mean_a + delta * fb, mean_a).astype(np.float32)
    m2 = np.where(take, m2_a + m2_b + delta * delta * fab, m2_a)
    return np.where(n_b > 0, tot, n_a), mean, m2.astype(np.float32)


def _tree(n, mean, m2):
    """The slot tree along axis 1: slot i < half takes slot i + half."""
    slots = n.shape[1]
    half = slots // 2
    while half >= 1:
        n_a, mean_a, m2_a = _chan(n[:, :half], mean[:, :half], m2[:, :half],
                                  n[:, half:2 * half], mean[:, half:2 * half],
                                  m2[:, half:2 * half])
        n, mean, m2 = (np.concatenate([n_a, n[:, half:]], 1),
                       np.concatenate([mean_a, mean[:, half:]], 1),
                       np.concatenate([m2_a, m2[:, half:]], 1))
        half //= 2
    return n[:, 0], mean[:, 0], m2[:, 0]


def emulate_moments(x_nchw: np.ndarray, dtype=torch.float32, sm_count=132):
    """``csrc/moments.cu`` in float32, thread by thread as ``plan`` cuts the
    work: per tile an exact two-pass over a thread's rows, the Chan fold over
    its block's tiles in order, the block's slot tree, then the last block's
    merge of the partials (slot i takes partials i, i + slots, ... in turn,
    then the tree). Returns (mean, var) of channels 0..C-1."""
    N, C, H, W = x_nchw.shape
    p = MM.plan(x_nchw.shape, dtype, _channels_last(x_nchw.shape), sm_count)
    U, slots, tiles, G = (MM.ROWS_PER_THREAD, p["slots"], p["tiles"],
                          p["grid_x"])
    width = p["groups"] * p["width"]
    M = N * H * W
    rows = np.zeros((tiles * p["tile_rows"], width), np.float32)
    rows[:M, :C] = x_nchw.transpose(0, 2, 3, 1).reshape(M, C)
    # [tile, k, slot, channel]: row = tile * tile_rows + k * slots + slot
    v = rows.reshape(tiles, U, slots, width)
    index = (np.arange(tiles)[:, None, None] * p["tile_rows"]
             + np.arange(U)[None, :, None] * slots
             + np.arange(slots)[None, None, :])
    valid = (index < M)[..., None]
    cnt = valid[..., 0].sum(1)                                # [tile, slot]
    inv = (np.float32(1.0) / np.maximum(cnt, 1).astype(np.float32))
    total = np.zeros((tiles, slots, width), np.float32)
    for k in range(U):                                        # in order
        total = np.where(valid[:, k], total + v[:, k], total)
    mean_t = (total * inv[..., None]).astype(np.float32)
    m2_t = np.zeros_like(mean_t)
    for k in range(U):
        d = v[:, k] - mean_t
        m2_t = np.where(valid[:, k], m2_t + d * d, m2_t)
    # each block folds its tiles b, b + G, ... in order
    rounds = -(-tiles // G)
    n = np.zeros((G, slots))
    mean = np.zeros((G, slots, width), np.float32)
    m2 = np.zeros_like(mean)
    for j in range(rounds):
        t = np.arange(G) + j * G
        ok = t < tiles
        tt = np.minimum(t, tiles - 1)
        n, mean, m2 = _chan(n, mean, m2,
                            np.where(ok[:, None], cnt[tt], 0).astype(float),
                            mean_t[tt], m2_t[tt])
    n, mean, m2 = _tree(n, mean, m2)                          # [G, width]
    # the last block: slot i merges partials i, i + slots, ... in order
    per = -(-G // slots)
    pn = np.zeros((per * slots,))
    pn[:G] = n
    pmean = np.zeros((per * slots, width), np.float32)
    pm2 = np.zeros_like(pmean)
    pmean[:G], pm2[:G] = mean, m2
    pn, pmean, pm2 = (pn.reshape(per, slots), pmean.reshape(per, slots, width),
                      pm2.reshape(per, slots, width))
    rn = np.zeros((1, slots))
    rmean = np.zeros((1, slots, width), np.float32)
    rm2 = np.zeros_like(rmean)
    for q in range(per):
        rn, rmean, rm2 = _chan(rn, rmean, rm2, pn[q][None], pmean[q][None],
                               pm2[q][None])
    rn, rmean, rm2 = _tree(rn, rmean, rm2)
    var = (rm2[0].astype(np.float64) / rn[0]).astype(np.float32)
    return rmean[0, :C], var[:C]


EMULATED = [(4, 128, 16, 16), (2, 128, 64, 64), (32, 128, 1, 1),
            (32, 128, 8, 8), (3, 21, 17, 23), (2, 1, 5, 7), (5, 128, 9, 7),
            (2, 256, 3, 3)]


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", EMULATED)
def test_emulated_partition_matches_jax_moments(shape, dtype, sm_count):
    """The kernel's partition and merge order, emulated in float32, agree
    with the JAX package's ``moments`` (mean 1e-6 relative plus 1e-6 of the
    data's magnitude, var 1e-5 relative, as tests/test_torch_fused_bn.py)."""
    rng = np.random.RandomState(sum(shape))
    x = (rng.randn(*shape) * 3.0 + 1.0).astype(np.float32)
    mean, var = emulate_moments(x, dtype, sm_count)
    want_mean, want_var = J.moments(jnp.asarray(x.transpose(0, 2, 3, 1)))
    scale = float(np.abs(x).max())
    np.testing.assert_allclose(mean, np.asarray(want_mean), rtol=1e-6,
                               atol=1e-6 * scale)
    np.testing.assert_allclose(var, np.asarray(want_var), rtol=1e-5)


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
def test_emulated_partition_keeps_precision_at_mean_over_std_250(dtype,
                                                                 sm_count):
    """|mean| / std = 250 (tests/test_fused_bn.py's probe): the emulation
    keeps a float64 two-pass to mean rtol 1e-6 and var rtol 1e-4, as the
    Pallas kernel does in interpret mode."""
    x = (np.random.RandomState(7).randn(64 * 16, 128) + 250.0).astype(
        np.float32)
    mean, var = emulate_moments(x.reshape(64 * 16, 128, 1, 1), dtype,
                                sm_count)
    x64 = x.astype(np.float64)
    np.testing.assert_allclose(mean, x64.mean(0), rtol=1e-6)
    np.testing.assert_allclose(var, x64.var(0), rtol=1e-4)
    pallas_mean, pallas_var = _interp_moments(jnp.asarray(x), block_rows=64)
    np.testing.assert_allclose(mean, np.asarray(pallas_mean), rtol=1e-6)
    np.testing.assert_allclose(var, np.asarray(pallas_var), rtol=1e-4)


# ---------------------------------------------------------------------------
# dw_conv3x3_stats
# ---------------------------------------------------------------------------


def _dw_pixels(shape, p):
    """Every output pixel (n, y, x) the plan's threads write and count, as
    (block, item, segment, row, column) enumerate them."""
    N, C, H, W = shape
    items = np.arange(p["items"])
    assert set(items % p["grid_x"]) == set(range(min(p["grid_x"],
                                                     p["items"])))
    per_image = p["tiles_y"] * p["tiles_x"]
    n, rem = items // per_image, items % per_image
    y0 = (rem // p["tiles_x"]) * DW.TILE_H
    x0 = (rem % p["tiles_x"]) * DW.TILE_W
    seg, m, col = np.meshgrid(np.arange(DW.TILE_H // DW.SEG_ROWS),
                              np.arange(DW.SEG_ROWS), np.arange(DW.TILE_W),
                              indexing="ij")
    ys = (y0[:, None] + (seg * DW.SEG_ROWS + m).reshape(-1)[None]).reshape(-1)
    xs = (x0[:, None] + col.reshape(-1)[None]).reshape(-1)
    ns = np.repeat(n, seg.size)
    keep = (ys < H) & (xs < W)
    return (ns * H + ys)[keep] * W + xs[keep]


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dilation", DW_SITES + DW_RAGGED)
def test_dw_plan_covers_each_pixel_and_channel_once(shape, dilation, dtype,
                                                    sm_count):
    N, C, H, W = shape
    p = DW.plan(shape, dtype, _channels_last(shape), dilation, sm_count)
    threads = (DW.GROUP // 4) * DW.TILE_W * (DW.TILE_H // DW.SEG_ROWS)
    assert threads == MM.THREADS
    np.testing.assert_array_equal(np.sort(_dw_pixels(shape, p)),
                                  np.arange(N * H * W))
    # channel (group g, quad q, element e) = g * GROUP + 4 q + e
    assert p["groups"] * DW.GROUP >= C > (p["groups"] - 1) * DW.GROUP
    assert 1 <= p["grid_x"] <= p["items"]
    # the ring and the merge fit one block, two blocks fit an SM where two
    # stages do
    assert p["smem_bytes"] <= DW.MAX_SMEM_BYTES
    assert p["stage_bytes"] % 16 == 0
    if p["stages"] == 2:
        assert 2 * p["smem_bytes"] <= 228 * 1024
    _scratch_ok(p, p["groups"], p["grid_x"], DW.GROUP)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,dilation", DW_SITES + DW_RAGGED)
def test_dw_scalar_path_gets_the_vector_paths_tiles(shape, dilation, dtype):
    layout = ("xn", "xc", "xh", "xw", "vector")
    vec = DW.plan(shape, dtype, _channels_last(shape), dilation, 132)
    scalar = DW.plan(shape, dtype, _nchw(shape), dilation, 132)
    assert scalar["vector"] == 0
    assert vec["vector"] == int(shape[1] % (16 // dtype.itemsize) == 0)
    assert ({k: v for k, v in scalar.items() if k not in layout}
            == {k: v for k, v in vec.items() if k not in layout})


@pytest.mark.parametrize("dilation", range(1, DW.MAX_DILATION + 1))
def test_dw_every_admitted_dilation_fits_one_block(dilation):
    for dtype in DTYPES:
        p = DW.plan((2, 64, 64, 64), dtype, _channels_last((2, 64, 64, 64)),
                    dilation, 132)
        assert p["smem_bytes"] <= DW.MAX_SMEM_BYTES
        two = 2 * p["stage_bytes"] + DW.MERGE_SMEM_BYTES <= DW.MAX_SMEM_BYTES
        assert p["stages"] == (2 if two else 1)
    # the model zoo's dilations take the 2-stage ring
    assert DW.plan((2, 64, 64, 64), torch.float32,
                   _channels_last((2, 64, 64, 64)), 2, 132)["stages"] == 2
    assert DW.dilation_supported(dilation)
    assert not DW.dilation_supported(DW.MAX_DILATION + 1)


# ---------------------------------------------------------------------------
# blur_log
# ---------------------------------------------------------------------------

def _contiguous(shape):
    return _strides(shape, torch.contiguous_format)


def _bkhw_view(shape):
    """Strides of the [B, H, W, K] view of [B, K, H, W] memory."""
    B, H, W, K = shape
    return torch.empty(B, K, H, W, device="meta").permute(0, 2, 3, 1).stride()


# the serve shape, the sizes chip_smoke.py checks on each path, and ragged
# ones; (shape, kernel, fast on contiguous memory)
BLUR_CASES = [((128, 64, 64, 21), 11, True), ((4, 56, 56, 21), 11, True),
              ((2, 5, 8, 4), 11, True), ((3, 17, 24, 6), 11, True),
              ((1, 64, 64, 24), 11, True), ((2, 64, 8, 21), 11, True),
              ((1, 1, 4, 1), 11, True), ((2, 9, 16, 3), 11, True),
              ((3, 17, 23, 5), 11, False),     # W * K = 115: rows unaligned
              ((2, 64, 64, 64), 11, False),    # 1,024 quads: over 384 threads
              ((1, 65, 64, 21), 11, False),    # 9 rows a CTA: over 8
              ((2, 64, 64, 21), 7, False),     # kernel 7
              ((2, 32, 32, 21), 3, False)]


@pytest.mark.parametrize("shape,kernel,fast", BLUR_CASES)
def test_blur_log_plan_picks_the_fast_path_for_the_serve_layout(shape, kernel,
                                                                fast):
    p = BL.plan(shape, _contiguous(shape), kernel)
    assert p["path"] == int(fast)
    # a [B, K, H, W]-memory view and an unaligned start take the general path
    assert BL.plan(shape, _bkhw_view(shape), kernel)["path"] == (
        int(fast) if shape[3] == 1 else 0)
    assert BL.plan(shape, _contiguous(shape), kernel, aligned=False)["path"] == 0
    # y is contiguous, as the wrapper allocates it
    assert (p["yb"], p["yh"], p["yw"], p["yk"]) == _contiguous(shape)
    assert len(BL.PLAN_FIELDS) == len(set(BL.PLAN_FIELDS))
    assert set(BL.PLAN_FIELDS) <= set(p)


@pytest.mark.parametrize("shape,kernel,fast",
                         [c for c in BLUR_CASES if c[2]])
def test_blur_log_cluster_rows_cover_each_row_once_with_its_halo(shape,
                                                                kernel, fast):
    B, H, W, K = shape
    p = BL.plan(shape, _contiguous(shape), kernel)
    R, n = p["rows"], p["cluster"]
    assert 1 <= n <= BL.MAX_CLUSTER and 1 <= R <= BL.MAX_ROWS
    owned = np.concatenate([np.arange(r * R, min((r + 1) * R, H))
                            for r in range(n)])
    np.testing.assert_array_equal(owned, np.arange(H))
    assert (n - 1) * R < H <= n * R            # no CTA without a row
    pad = kernel // 2
    for rank in range(n):
        r0 = rank * R
        # source rows of the vertical pass: r0 - pad .. r0 + R - 1 + pad;
        # those inside the image live in CTA owner as its row local
        for gs in range(r0 - pad, r0 + R + pad):
            if 0 <= gs < H:
                owner, local = divmod(gs, R)
                assert 0 <= owner < n and 0 <= local < R
                assert owner * R + local == gs
    # one thread per horizontal-pass task and per 16-byte quad of a row
    tasks = R * -(-W // BL.RUN) * K
    assert p["threads"] % 32 == 0 and p["threads"] <= BL.FAST_MAX_THREADS
    assert p["threads"] >= max(tasks, W * K // 4)


@pytest.mark.parametrize("shape,kernel,fast",
                         [c for c in BLUR_CASES if c[2]])
def test_blur_log_grid_takes_each_image_row_once(shape, kernel, fast):
    """CTA i of the grid takes image i // cluster and rows from rank
    i % cluster: every (image, row) pair exactly once."""
    B, H = shape[:2]
    p = BL.plan(shape, _contiguous(shape), kernel)
    R, n = p["rows"], p["cluster"]
    taken = [b * H + r
             for i in range(B * n)
             for b, rank in [divmod(i, n)]
             for r in range(rank * R, min(rank * R + R, H))]
    np.testing.assert_array_equal(np.sort(taken), np.arange(B * H))


@pytest.mark.parametrize("shape,kernel,fast", BLUR_CASES)
def test_blur_log_shared_memory_fits(shape, kernel, fast):
    for strides in (_contiguous(shape), _bkhw_view(shape)):
        p = BL.plan(shape, strides, kernel)
        assert p["smem"] <= BL.MAX_SMEM_BYTES
        if p["path"] == 1:
            assert p["smem"] == BL.fast_smem_bytes(p["rows"], shape[2],
                                                   shape[3])
            # three CTAs an SM at the serve shape (228 KB an SM, 1 KB of
            # it reserved per CTA; 2,048 threads)
            if shape == (128, 64, 64, 21):
                assert 3 * (p["smem"] + 1024) <= 228 * 1024
                assert 3 * p["threads"] <= 2048
        else:
            assert p["smem"] == BL.smem_bytes(shape[1], shape[2], kernel)


def _fma(a, b, c):
    """float32 fmaf: the float64 product of two float32 values is exact."""
    return (a.astype(np.float64) * b + c).astype(np.float32)


def emulate_blur_log_fast(x, kernel=11):
    """``csrc/blur_log.cu``'s fast path in float32, CTA by CTA as ``plan``
    cuts the image: each CTA passes its rows horizontally (taps in ascending
    order, an FMA with zero outside the map), then vertically over its rows
    and the neighbours' (zero outside the image); its input and blurred
    maxima per map are merged across the cluster; the scale is one divide
    and the output log(max(v * scale, 1e-10))."""
    B, H, W, K = x.shape
    p = BL.plan(x.shape, _contiguous(x.shape), kernel)
    assert p["path"] == 1
    R, n = p["rows"], p["cluster"]
    taps = cv2_gaussian_kernel(kernel, 0.0)
    pad = kernel // 2
    out = np.empty_like(x)
    for b in range(B):
        # horizontal pass of every CTA's rows (each CTA its own rows)
        h = np.zeros((n * R, W, K), np.float32)
        xin = np.zeros((n * R, W + 2 * pad, K), np.float32)
        xin[:H, pad:pad + W] = x[b]
        for t in range(kernel):
            h = _fma(taps[t], xin[:, t:t + W], h)
        in_max = np.full((n, K), -np.inf, np.float32)
        bl_max = np.full((n, K), -np.inf, np.float32)
        blurred = np.zeros((H, W, K), np.float32)
        for rank in range(n):
            r0, rows = rank * R, min(R, H - rank * R)
            in_max[rank] = x[b, r0:r0 + rows].max(axis=(0, 1))
            acc = np.zeros((rows, W, K), np.float32)
            for t in range(kernel):
                src = np.zeros((rows, W, K), np.float32)
                for o in range(rows):
                    gs = r0 + o + t - pad
                    if 0 <= gs < H:
                        src[o] = h[gs]        # row gs % R of CTA gs // R
                acc = _fma(taps[t], src, acc)
            blurred[r0:r0 + rows] = acc
            bl_max[rank] = acc.max(axis=(0, 1))
        scale = (in_max.max(0) / np.maximum(bl_max.max(0), np.float32(1e-20))
                 ).astype(np.float32)
        out[b] = np.log(np.maximum((blurred * scale).astype(np.float32),
                                   np.float32(1e-10)))
    return out


def _heatmaps(shape, seed):
    """Gaussian peaks at random sub-pixel centres with noise, an all-zero
    map, spikes on the borders and in the corner."""
    B, H, W, K = shape
    rng = np.random.RandomState(seed)
    cx = rng.uniform(0, W - 1, size=(B, 1, 1, K))
    cy = rng.uniform(0, H - 1, size=(B, 1, 1, K))
    ys = np.arange(H)[None, :, None, None]
    xs = np.arange(W)[None, None, :, None]
    hm = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0)
    hm += rng.uniform(0, 1e-3, size=hm.shape)
    hm = hm.astype(np.float32)
    hm[0, :, :, 0] = 0.0                               # all-zero map
    if K > 2:
        hm[0, :, :, 1] = 0.0
        hm[0, 0, 0, 1] = 1.0                           # corner spike
        hm[-1, :, :, 2] = 0.0
        hm[-1, H - 1, W // 2, 2] = 3.0                 # bottom-edge spike
    return hm


@pytest.mark.parametrize("shape", [(2, 64, 64, 21), (2, 56, 56, 21),
                                   (2, 5, 8, 4), (3, 17, 24, 6)])
def test_emulated_fast_path_matches_pallas_and_plain_twin(shape):
    """The fast path's partition, emulated in float32, agrees with the JAX
    package's Pallas ``blur_log`` (interpret mode) and with the port's plain
    twin at rtol 1e-5 on the log values (atol 1e-6 where they cross 0)."""
    x = _heatmaps(shape, sum(shape))
    got = emulate_blur_log_fast(x)
    want = np.asarray(pallas_blur_log(x, kernel=11, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    plain = BL.blur_log_reference(torch.from_numpy(x), 11).numpy()
    np.testing.assert_allclose(got, plain, rtol=1e-5, atol=1e-6)
    # the all-zero map: log(1e-10) everywhere
    np.testing.assert_array_equal(got[0, :, :, 0],
                                  np.float32(np.log(np.float32(1e-10))))


# ---------------------------------------------------------------------------
# softpool_2x2
# ---------------------------------------------------------------------------

# (shape, kernel, stride, fast for float32 / bfloat16 on channels_last)
SOFTPOOL_CASES = [((128, 128, 64, 64), 2, 2, (True, True)),
                  ((1, 128, 64, 64), 2, 2, (True, True)),
                  ((2, 32, 17, 23), 2, 2, (True, True)),
                  ((2, 8, 8, 8), 2, 2, (True, True)),
                  ((2, 20, 16, 16), 2, 2, (True, False)),
                  ((2, 24, 16, 16), 2, 2, (True, True)),
                  ((4, 21, 64, 64), 2, 2, (False, False)),
                  ((3, 21, 17, 23), 2, 2, (False, False)),
                  ((2, 128, 65, 63), 3, 2, (False, False)),
                  ((2, 24, 16, 16), 2, 1, (False, False)),
                  ((2, 16, 9, 9), 3, 3, (False, False))]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kernel,stride,fast", SOFTPOOL_CASES)
def test_softpool_plan_picks_the_fast_path(shape, kernel, stride, fast,
                                           dtype):
    want = fast[DTYPES.index(dtype)]
    p = SP.plan(shape, dtype, _channels_last(shape), kernel, stride, 132)
    assert p["path"] == int(want)
    # NCHW memory and an unaligned start take the general path
    assert SP.plan(shape, dtype, _nchw(shape), kernel, stride, 132)["path"] == 0
    assert SP.plan(shape, dtype, _channels_last(shape), kernel, stride, 132,
                   aligned=False)["path"] == 0
    if want:
        # a thread's 16 bytes of channels: whole vectors, one warp at most
        # across a pixel
        vec = 16 // dtype.itemsize
        assert shape[1] % vec == 0
        assert p["lanes"] == min(shape[1] // vec, SP.MAX_LANES)
    assert len(SP.PLAN_FIELDS) == len(set(SP.PLAN_FIELDS))
    assert set(SP.PLAN_FIELDS) <= set(p)


def test_softpool_plan_takes_channel_slices_of_channels_last_memory():
    """A channel slice keeps channels innermost and 16-byte strides: fast."""
    x = torch.empty(2, 128, 16, 16, device="meta").contiguous(
        memory_format=torch.channels_last)[:, 32:96]
    for dtype in DTYPES:
        p = SP.plan(x.shape, dtype, x.stride(), 2, 2, 132)
        assert p["path"] == 1 and p["xw"] == 128 and p["xh"] == 16 * 128


def _softpool_outputs(p, B):
    """Every output (b, c, ho, wo) the plan's walk writes, as a flat index
    of [B, C, Ho, Wo], in the order blocks and threads reach them."""
    C, Ho, Wo, lanes, slots = p["C"], p["Ho"], p["Wo"], p["lanes"], p["slots"]
    assert lanes * slots <= SP.THREADS
    out = []
    for block in range(p["grid"]):
        for t in range(lanes * slots):
            tx, ty = t % lanes, t // lanes
            if p["path"] == 1:
                v = 8 if p["dtype"] else 4        # channels in 16 bytes
                cvs = C // v
                for u in range(block, p["units"], p["grid"]):
                    b, ho = divmod(u, Ho)
                    for wo in range(ty, Wo, 2 * slots):
                        for w in (wo, wo + slots):
                            if w >= Wo:
                                continue
                            for cv in range(tx, cvs, lanes):
                                for c in range(cv * v, cv * v + v):
                                    out.append(((b * C + c) * Ho + ho) * Wo + w)
            elif p["channels_fastest"]:
                for u in range(block, p["units"], p["grid"]):
                    b, ho = divmod(u, Ho)
                    for wo in range(ty, Wo, slots):
                        for c in range(tx, C, lanes):
                            out.append(((b * C + c) * Ho + ho) * Wo + wo)
            else:
                for u in range(block * slots + ty, p["units"],
                               p["grid"] * slots):
                    bc, ho = divmod(u, Ho)
                    for wo in range(tx, Wo, lanes):
                        out.append((bc * Ho + ho) * Wo + wo)
    return np.array(out)


@pytest.mark.parametrize("sm_count", SM_COUNTS)
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,kernel,stride",
                         [((2, 32, 17, 23), 2, 2), ((3, 21, 17, 23), 2, 2),
                          ((2, 20, 16, 16), 2, 2), ((2, 8, 9, 8), 3, 2),
                          ((1, 64, 8, 70), 2, 2)])
def test_softpool_walk_writes_each_output_once(shape, kernel, stride, dtype,
                                               layout, sm_count):
    strides = (_channels_last if layout == "channels_last" else _nchw)(shape)
    p = SP.plan(shape, dtype, strides, kernel, stride, sm_count)
    B, C = shape[:2]
    got = _softpool_outputs(p, B)
    np.testing.assert_array_equal(np.sort(got),
                                  np.arange(B * C * p["Ho"] * p["Wo"]))
    assert 1 <= p["grid"] <= max(1, SP.BLOCKS_PER_SM * sm_count)
    # y's strides are those of the tensor the wrapper allocates
    fmt = (torch.channels_last if layout == "channels_last"
           else torch.contiguous_format)
    y = torch.empty((B, C, p["Ho"], p["Wo"]), device="meta",
                    memory_format=fmt)
    assert (p["yb"], p["yc"], p["yh"], p["yw"]) == y.stride()
