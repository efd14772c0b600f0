"""Height-sharded serving, the batch-1 latency mode (port of
``litehandnet_tpu/eval/spatial_serving.py``).

Data parallelism cannot bring one request below one device's forward time.
The JAX package partitions the image's height over the mesh instead and
lets GSPMD derive the halo exchanges (:1-28, 72-84). PyTorch has no such
partitioner for these models: ``torch.distributed.tensor`` shards a
convolution along its last axis only and refuses dilated and strided padded
ones. So the exchanges are written here, one rule per op kind and per
class, for the served graphs of the hand families: the deploy graphs of
``litehandnet`` and ``litehandnet_msrb``, and the eval-mode graphs of
``mynet`` and ``hourglass_ablation`` (every gate, CBAM included):

* a map is a :class:`Band`, this rank's rows of a map ``height`` rows high,
  in GSPMD's layout (:func:`spatial_spec`) at every level of the network;
* a convolution, the ceil-mode max pool and the nearest resize compute their
  output band from the input rows it reads: the rows other ranks hold come
  in one halo fetch, rows outside the map are the op's padding (zeros, and
  -inf for the max pool);
* eval-mode BatchNorm, the activations and eval dropout run on the band
  alone, as do channel splits and per-pixel channel statistics;
* the adaptive average pools and the gates' means sum over each rank's own
  rows and all-reduce the partial sums; CBAM's global maximum takes each
  rank's maximum (-inf for a rank without rows) and all-reduces by max; the
  channel gates then run on the replicated pooled map;
* the head's bands are gathered into the whole map on every rank, which the
  DARK decode (the ``blur_log`` kernel) reads as one device would.

Ranks are processes (``train.distributed``: NCCL across GPUs, gloo on the
CPU). Every exchange is an ``all_reduce``: a fetch, a sum or the gather over
a zero buffer in which each rank fills the rows it owns, so a fetch or
gather is exact (x + 0 = x), and the maximum by max. Every rank gets the
same outputs, bit for bit. A world of one runs the modules' own ops.

Deviations from JAX: ranks instead of a mesh; a height that does not divide
over the ranks raises ``ValueError`` where JAX asserts (:70); only the
families above have sharded rules, and any other module raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.eval.decoder import unpack_outputs
from litehandnet_tpu_torch.models import attention as AT
from litehandnet_tpu_torch.models import hourglass_ablation as HA
from litehandnet_tpu_torch.models import layers as L
from litehandnet_tpu_torch.models import litehandnet as LH
from litehandnet_tpu_torch.models import litehandnet_msrb as MR
from litehandnet_tpu_torch.models import ms_att_hourglass as MS
from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
from litehandnet_tpu_torch.train.distributed import World


def spatial_spec(height: int, world) -> list:
    """The rows of a map ``height`` rows high that each rank holds, as
    ``range``s: with ``m = ceil(height / n)``, rank r holds ``[r * m,
    min((r + 1) * m, height))``, so trailing ranks may hold fewer rows or
    none. GSPMD's layout of JAX's ``PartitionSpec(None, axis, None, None)``.
    ``world`` is a :class:`World` or its size."""
    n = world if isinstance(world, int) else world.size
    m = -(-height // n)
    return [range(min(r * m, height), min((r + 1) * m, height))
            for r in range(n)]


@dataclass(frozen=True)
class Band:
    """This rank's rows ``t`` (``[B, C, rows, W]``) of a map ``height`` rows
    high: the rows ``spatial_spec(height, n)[rank]``."""

    t: torch.Tensor
    height: int

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]) -> "Band":
        return Band(fn(self.t), self.height)


def _join(fn, a: Band, b: Band) -> Band:
    """An elementwise op of two bands of one map height."""
    if a.height != b.height:
        raise ValueError(f"bands of heights {a.height} and {b.height}")
    return Band(fn(a.t, b.t), a.height)


def _whole(t: torch.Tensor) -> Band:
    """The band of a rank that holds every row (a world of one)."""
    return Band(t, t.shape[2])


def _act(x: Band, act: L.Activation) -> Band:
    return x if act is None else x.map(act)


@functools.lru_cache(maxsize=None)
def _halo_plan(height: int, n: int, windows: tuple) -> tuple:
    """The static plan of one halo fetch over a map ``height`` rows high:
    rank r reads input rows ``windows[r] = (a, b)`` (None when its output
    band is empty), which may reach past the map.

    Returns ``(fetched, exports, pieces)``: the rows some rank reads from
    another, in order (the exchange buffer's slots); for each rank the runs
    ``(slot, local row, count)`` it fills in the buffer; for each rank the
    runs ``(kind, start, stop)`` that make its window, ``kind`` "pad" (the
    op's padding), "own" (local rows) or "fetched" (buffer slots).
    """
    bands = spatial_spec(height, n)
    fetched = sorted({q for band, w in zip(bands, windows) if w is not None
                      for q in range(max(w[0], 0), min(w[1], height))
                      if q not in band})
    slot = {q: i for i, q in enumerate(fetched)}

    def runs(items):
        out = []
        for kind, i in items:
            if out and out[-1][0] == kind and out[-1][2] == i:
                out[-1][2] = i + 1
            else:
                out.append([kind, i, i + 1])
        return tuple(tuple(run) for run in out)

    exports, pieces = [], []
    for band, w in zip(bands, windows):
        # consecutive rows hold consecutive slots: fetched is sorted
        exports.append(tuple(
            (slot[band.start + l0], l0, l1 - l0) for _, l0, l1 in
            runs(("own", q - band.start) for q in band if q in slot)))
        if w is None:
            pieces.append(None)
            continue
        items = []
        for pad, q in enumerate(range(*w)):
            if not 0 <= q < height:
                items.append(("pad", pad))
            elif q in band:
                items.append(("own", q - band.start))
            else:
                items.append(("fetched", slot[q]))
        pieces.append(runs(items))
    return tuple(fetched), tuple(exports), tuple(pieces)


@functools.lru_cache(maxsize=None)
def _nearest_rows(in_h: int, out_h: int) -> tuple:
    """The input row of each output row of a nearest-exact resize from
    ``in_h`` to ``out_h`` rows: ``min(floor((i + 0.5) * in_h / out_h),
    in_h - 1)`` in float32, as PyTorch's kernels compute it."""
    scale = np.float32(in_h) / np.float32(out_h)
    src = np.floor((np.arange(out_h, dtype=np.float32) + np.float32(0.5))
                   * scale)
    return tuple(int(q) for q in np.minimum(src, in_h - 1))


def _pool_regions(size: int, out: int) -> list:
    """Adaptive pooling's input span of each of ``out`` outputs over
    ``size`` inputs: ``[floor(i * size / out), ceil((i + 1) * size / out))``."""
    return [((i * size) // out, -(-((i + 1) * size) // out))
            for i in range(out)]


class ShardedOps:
    """The ops of the served graphs on height bands of ``world``'s ranks.
    ``counts`` tallies the exchanges: ``halo`` fetches, ``reduce``
    (partial sums of a pool or mean), ``max`` (a global maximum) and
    ``gather``, each one ``all_reduce``."""

    def __init__(self, world: World):
        self.world = world
        self.n, self.rank = world.size, world.rank
        self.counts: Counter = Counter()

    def _all_reduce(self, t: torch.Tensor, kind: str,
                    op=dist.ReduceOp.SUM) -> None:
        dist.all_reduce(t, op=op, group=self.world.group)
        self.counts[kind] += 1

    def rows(self, height: int) -> range:
        """This rank's rows of a map ``height`` rows high."""
        return spatial_spec(height, self.n)[self.rank]

    def _halo(self, x: Band, windows: tuple, pad_value: float
              ) -> Optional[torch.Tensor]:
        """The input rows this rank's window ``windows[rank]`` spans (None
        for an empty output band), after the fetch every rank joins when
        one of them reads rows it does not hold."""
        fetched, exports, pieces = _halo_plan(x.height, self.n, windows)
        t = x.t
        B, C, _, W = t.shape
        if fetched:
            buf = t.new_zeros((B, C, len(fetched), W))
            for s0, l0, count in exports[self.rank]:
                buf[:, :, s0:s0 + count] = t[:, :, l0:l0 + count]
            self._all_reduce(buf, "halo")
        if pieces[self.rank] is None:
            return None
        parts = []
        for kind, i0, i1 in pieces[self.rank]:
            if kind == "pad":
                parts.append(t.new_full((B, C, i1 - i0, W), pad_value))
            else:
                parts.append((t if kind == "own" else buf)[:, :, i0:i1])
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)

    def conv(self, x: Band, conv: nn.Conv2d) -> Band:
        """``conv(x)``: each output row from the input rows its taps read."""
        if self.n == 1:
            return _whole(conv(x.t))
        (k, kw), (s, sw) = conv.kernel_size, conv.stride
        (p, pw), (d, dw) = conv.padding, conv.dilation
        out_h = (x.height + 2 * p - d * (k - 1) - 1) // s + 1
        windows = tuple(
            (o.start * s - p, (o.stop - 1) * s - p + d * (k - 1) + 1)
            if o else None for o in spatial_spec(out_h, self.n))
        win = self._halo(x, windows, 0.0)
        if win is None:
            B, _, _, W = x.t.shape
            out_w = (W + 2 * pw - dw * (kw - 1) - 1) // sw + 1
            return Band(x.t.new_empty((B, conv.out_channels, 0, out_w)), out_h)
        return Band(F.conv2d(win, conv.weight, conv.bias, (s, sw), (0, pw),
                             (d, dw), conv.groups), out_h)

    def max_pool2(self, x: Band) -> Band:
        """``layers.max_pool2(x)``: 2x2 stride 2, ceil mode; rows past the
        map are -inf."""
        if self.n == 1:
            return _whole(L.max_pool2(x.t))
        out_h = -(-x.height // 2)
        windows = tuple((2 * o.start, 2 * o.stop) if o else None
                        for o in spatial_spec(out_h, self.n))
        win = self._halo(x, windows, float("-inf"))
        if win is None:
            B, C, _, W = x.t.shape
            return Band(x.t.new_empty((B, C, 0, -(-W // 2))), out_h)
        return Band(L.max_pool2(win), out_h)

    def resize_nearest(self, x: Band, size) -> Band:
        """``layers.resize_nearest(x, size)``: each output row copies the
        input row the nearest-exact rule picks."""
        h, w = size
        if (x.height, x.t.shape[3]) == (h, w):
            return x
        if self.n == 1:
            return _whole(L.resize_nearest(x.t, size))
        src = _nearest_rows(x.height, h)
        windows = tuple((src[o.start], src[o.stop - 1] + 1) if o else None
                        for o in spatial_spec(h, self.n))
        win = self._halo(x, windows, 0.0)
        out = self.rows(h)
        if win is None:
            B, C, _, _ = x.t.shape
            return Band(x.t.new_empty((B, C, 0, w)), h)
        pick = torch.as_tensor([src[i] - src[out.start] for i in out],
                               device=win.device)
        rows = win.index_select(2, pick)
        return Band(F.interpolate(rows, size=(len(out), w),
                                  mode="nearest-exact"), h)

    def adaptive_avg_pool(self, x: Band, size, banded: bool):
        """``layers.adaptive_avg_pool(x, size)`` over the whole map: column
        means of each local row, summed over each output row's span of
        rows and divided by the span, all-reduced. A :class:`Band` of the
        output when ``banded``, else the whole output on every rank."""
        out_h, out_w = size
        if self.n == 1:
            y = L.adaptive_avg_pool(x.t, size)
            return _whole(y) if banded else y
        own = self.rows(x.height)
        B, C = x.t.shape[:2]
        cols = (F.adaptive_avg_pool2d(x.t, (len(own), out_w)) if own
                else x.t.new_zeros((B, C, 0, out_w)))
        means = []
        for lo, hi in _pool_regions(x.height, out_h):
            a, b = max(lo, own.start) - own.start, min(hi, own.stop) - own.start
            means.append(cols[:, :, a:max(a, b)].sum(dim=2) / (hi - lo))
        y = torch.stack(means, dim=2).contiguous()
        self._all_reduce(y, "reduce")
        if not banded:
            return y
        out = self.rows(out_h)
        return Band(y[:, :, out.start:out.stop], out_h)

    def mean(self, x: Band) -> torch.Tensor:
        """``x.mean(dim=(2, 3), keepdim=True)`` over the whole map, on every
        rank."""
        if self.n == 1:
            return x.t.mean(dim=(2, 3), keepdim=True)
        return self.adaptive_avg_pool(x, (1, 1), banded=False)

    def amax(self, x: Band) -> torch.Tensor:
        """``x.amax(dim=(2, 3), keepdim=True)`` over the whole map, on every
        rank: each rank's maximum over its own rows, all-reduced by max. A
        rank without rows puts in -inf, so a map of negative values keeps
        its maximum."""
        if self.n == 1:
            return x.t.amax(dim=(2, 3), keepdim=True)
        B, C, rows, _ = x.t.shape
        y = (x.t.amax(dim=(2, 3), keepdim=True).contiguous() if rows
             else x.t.new_full((B, C, 1, 1), float("-inf")))
        self._all_reduce(y, "max", dist.ReduceOp.MAX)
        return y

    def gather(self, x: Band) -> torch.Tensor:
        """The whole map on every rank."""
        if self.n == 1:
            return x.t
        B, C, _, W = x.t.shape
        own = self.rows(x.height)
        full = x.t.new_zeros((B, C, x.height, W))
        full[:, :, own.start:own.stop] = x.t
        self._all_reduce(full, "gather")
        return full

    def run(self, module: nn.Module, x: Band) -> Band:
        """``module(x)`` on bands, by the rule of the module's class."""
        rule = RULES.get(type(module))
        if rule is None:
            raise NotImplementedError(
                f"no height-sharded rule for {type(module).__name__}")
        return rule(self, module, x)


# -- the sharded forwards, one per class, each mirroring its forward ---------

def _sequential(sh: ShardedOps, m: nn.Sequential, x: Band) -> Band:
    for layer in m:
        x = sh.run(layer, x)
    return x


def _pointwise(sh: ShardedOps, m: nn.Module, x: Band) -> Band:
    """A module of one pixel at a time: eval-mode BatchNorm, an activation,
    eval dropout."""
    return x.map(m)


def _rep(sh: ShardedOps, m, x: Band) -> Band:
    """``RepConv`` and ``RepBlock`` of the deploy graph (layers.py
    ``forward``: ``self.rep(x)``, then the activation)."""
    return _act(sh.conv(x, m.rep), m.act)


def _dwconv(sh: ShardedOps, m, x: Band) -> Band:
    """``litehandnet.DWConv`` and ``ms_att_hourglass.PlainDWConv``."""
    return sh.run(m.pointwise_conv, sh.run(m.depthwise_conv, x))


def _bottleneck(sh: ShardedOps, m: LH.BottleNeck, x: Band) -> Band:
    return _act(_join(torch.add, x, sh.run(m.conv, x)), m.act)


def _basic_block(sh: ShardedOps, m: LH.BasicBlock, x: Band) -> Band:
    skip = x if m.skip_layer is None else sh.run(m.skip_layer, x)
    return _act(_join(torch.add, skip, sh.run(m.conv, x)), m.act)


def _plain_bottleneck(sh: ShardedOps, m: MS.PlainBottleNeck, x: Band
                      ) -> Band:
    return _act(_join(torch.add, x, sh.run(m.conv, x)), F.relu)


def _plain_basic_block(sh: ShardedOps, m: MS.PlainBasicBlock, x: Band
                       ) -> Band:
    skip = x if m.skip_layer is None else sh.run(m.skip_layer, x)
    return _act(_join(torch.add, skip, sh.run(m.conv, x)), F.relu)


def _residual(sh: ShardedOps, m, x: Band) -> Band:
    """``litehandnet.Residual`` and ``ms_att_hourglass.PlainResidual``."""
    return sh.run(m.blocks, sh.run(m.conv1, x))


def _ablation_residual(sh: ShardedOps, m: HA.AblationResidual, x: Band
                       ) -> Band:
    x = _residual(sh, m, x)
    return x if m.att is None else sh.run(m.att, x)


def _cat(a: Band, b: Band) -> Band:
    return _join(lambda u, v: torch.cat([u, v], dim=1), a, b)


def _split(x: Band, c: int) -> Tuple[Band, Band]:
    """The channels before ``c`` and from ``c`` on."""
    return x.map(lambda t: t[:, :c]), x.map(lambda t: t[:, c:])


def _trunk(sh: ShardedOps, m, x: Band) -> Band:
    """The multi-scale trunk of ``litehandnet.MSAB`` and
    ``ms_att_hourglass.MEAttBody.trunk``: ``conv1``, rounds of two branches
    concatenated, ``conv2`` of the residual."""
    y = sh.run(m.conv1, x)
    for p1, p2 in zip(m.mid1_conv, m.mid2_conv):
        y = _cat(sh.run(p1, y), sh.run(p2, y))
    return sh.run(m.conv2, _join(torch.add, y, x))


def _msab(sh: ShardedOps, m: LH.MSAB, x: Band) -> Band:
    out = _trunk(sh, m, x)
    return out if m.ca is None else sh.run(m.ca, out)


def _me_att(sh: ShardedOps, m: MS.MEAttBody, x: Band) -> Band:
    """``MEAtt`` and ``AblationMEAtt``: the trunk, then the gate ``att``
    where there is one."""
    out = _trunk(sh, m, x)
    return out if m.att is None else sh.run(m.att, out)


def _brc(sh: ShardedOps, m: MS.BRC, x: Band) -> Band:
    return sh.run(m.conv, _act(sh.run(m.bn, x), m.act))


def _channel_attention(sh: ShardedOps, m: L.ChannelAttention, x: Band
                       ) -> Band:
    """The 3x3 pool is a reduce; ``att_rep`` and the gate MLP run on the
    replicated pooled map."""
    y = sh.adaptive_avg_pool(x, (3, 3), banded=False)
    gate = torch.sigmoid(m.conv1x1(m.att_rep(y)))
    return x.map(lambda t: t * gate)


def _se_block(sh: ShardedOps, m: L.SEBlock, x: Band) -> Band:
    s = m.up(F.relu(m.down(sh.mean(x))))
    return x.map(lambda t: t * torch.sigmoid(s))


def _pooled_gate(sh: ShardedOps, m: nn.Sequential, x: Band) -> Band:
    """``RCAGate`` and ``SEGate``, Sequentials that open with an adaptive
    average pool: the pool is a reduce, the rest of the Sequential (BN,
    convolution, ``Linear``, ...) runs on the replicated pooled map, and
    the band is multiplied by the gate."""
    pool, *rest = m
    y = sh.adaptive_avg_pool(x, _pair(pool.output_size), banded=False)
    for layer in rest:
        y = layer(y)
    return x.map(lambda t: t * y[:, :, None, None])


def _region_channel_attention(sh: ShardedOps,
                              m: AT.RegionChannelAttention, x: Band
                              ) -> torch.Tensor:
    """CBAM's channel gate ``[B, C, 1, 1]``, on every rank: the mean and the
    maximum are exchanges, the shared MLP runs on the replicated maps."""
    mlp = m.sharedMLP
    return torch.sigmoid(mlp(sh.mean(x)) + mlp(sh.amax(x)))


def _region_spatial_attention(sh: ShardedOps,
                              m: AT.RegionSpatialAttention, x: Band) -> Band:
    """CBAM's spatial gate ``[B, 1, rows, W]``: the per-pixel channel mean
    and maximum on the band, then the 7x7 convolution's halo."""
    s = x.map(lambda t: torch.cat([t.mean(dim=1, keepdim=True),
                                   t.amax(dim=1, keepdim=True)], dim=1))
    return sh.conv(s, m.conv).map(torch.sigmoid)


def _cbam(sh: ShardedOps, m: AT.CBAM, x: Band) -> Band:
    out = sh.run(m.pre, x)
    gate = sh.run(m.ca, out)
    out = out.map(lambda t: gate * t)
    out = _join(torch.mul, sh.run(m.sa, out), out)
    return _act(_join(torch.add, out, sh.run(m.residual_conv, x)), F.relu)


def _msrb(sh: ShardedOps, m: MR.MSRB, x: Band) -> Band:
    out = x
    for i in range(2):
        left, right = _split(out, m.half)
        merged = _cat(sh.run(m.branch1[i], left), sh.run(m.branch2[i], right))
        if m.ca is not None:
            merged = sh.run(m.ca[i], merged)
        out = _join(torch.add, out, merged)
    return sh.run(m.conv, _join(torch.add, out, x))


def _rep_basic_unit(sh: ShardedOps, m: MR.RepBasicUnit, x: Band) -> Band:
    left, right = _split(x, m.left_part)
    out = _cat(left, sh.run(m.conv, right))
    return out if m.ca is None else sh.run(m.ca, out)


def _stem(sh: ShardedOps, m, x: Band) -> Band:
    """``litehandnet.Stem`` and ``ms_att_hourglass.PeleeStem``."""
    x = sh.run(m.conv1, x)
    out = _cat(sh.run(m.branch1, x), sh.max_pool2(x))
    return sh.run(m.conv1x1, out)


def _msrb_stem(sh: ShardedOps, m: MR.Stem, x: Band) -> Band:
    x = sh.run(m.conv1, x)
    return sh.run(m.conv2, _cat(sh.run(m.branch1, x), sh.max_pool2(x)))


def _size(x: Band) -> Tuple[int, int]:
    return x.height, x.t.shape[3]


def _hourglass(sh: ShardedOps, encoder, decoder, x: Band) -> tuple:
    """``ms_att_hourglass.hourglass_forward`` (and ``litehandnet.
    EncoderDecoder``'s pass): the decoder outputs."""
    out_encoder = []
    for layer in encoder:
        x = sh.run(layer, x)
        out_encoder.append(x)
    last = out_encoder[-1]
    shortcut = sh.adaptive_avg_pool(out_encoder[0], _size(last), banded=True)
    out_decoder = []
    for i, layer in enumerate(decoder):
        counterpart = out_encoder[len(encoder) - 1 - i]
        if i == 0:
            x = _join(torch.add, sh.run(layer, counterpart), shortcut)
        else:
            up = sh.resize_nearest(sh.run(layer, x), _size(counterpart))
            x = _join(torch.add, up, counterpart)
        out_decoder.append(x)
    return tuple(out_decoder)


def _last_of_hourglass(sh: ShardedOps, m, x: Band) -> Band:
    """``litehandnet.EncoderDecoder`` and ``AblationEncoderDecoder``."""
    return _hourglass(sh, m.encoder, m.decoder, x)[-1]


def _ms_att_encoder_decoder(sh: ShardedOps, m: MS.MSAttEncoderDecoder,
                            x: Band) -> tuple:
    return _hourglass(sh, m.encoder, m.decoder, x)


def _backbone(sh: ShardedOps, m: MR.Backbone, x: Band) -> Band:
    """``litehandnet_msrb.Backbone``: max pools between the encoder's
    levels, the banded pool of level 0 beside the deepest decoder stage,
    nearest resizes up the decoder."""
    n = len(m.encoder)
    out_encoder = []
    for i, stage in enumerate(m.encoder):
        x = sh.run(stage, x)
        out_encoder.append(x)
        if i != n - 1:
            x = sh.max_pool2(x)
    last = out_encoder[-1]
    x = _join(torch.add, sh.run(m.decoder[n - 1], last),
              sh.adaptive_avg_pool(out_encoder[0], _size(last), banded=True))
    for i in range(n - 2, -1, -1):
        counterpart = out_encoder[i]
        up = sh.resize_nearest(x, _size(counterpart))
        x = sh.run(m.decoder[i], _join(torch.add, up, counterpart))
    return x


def _litehandnet(sh: ShardedOps, m: LH.LiteHandNet, x: Band) -> Band:
    x = sh.run(m.hgs, sh.run(m.pre, x))
    return sh.run(m.out_layer, sh.run(m.features, x)).map(L.head_output)


def _litehandnet_msrb(sh: ShardedOps, m: MR.LiteHandNetMSRB, x: Band
                      ) -> Band:
    x = sh.run(m.neck, sh.run(m.backone, sh.run(m.stem, x)))
    return sh.run(m.head, x).map(L.head_output)


def _ms_att_hourglass(sh: ShardedOps, m: MS.MSAttHourglass, x: Band) -> Band:
    x = sh.run(m.hgs, sh.run(m.pre, x))[-1]
    preds = sh.run(m.outs, sh.run(m.features, x)).map(L.head_output)
    if m.with_activation:
        return preds.map(lambda t: L.leaky_relu(t, 0.5))
    return preds


def _hourglass_ablation(sh: ShardedOps, m: HA.HourglassAblation, x: Band
                        ) -> Band:
    x = sh.run(m.features, sh.run(m.hgs, sh.run(m.pre, x)))
    return sh.run(m.outs, x).map(L.head_output)


RULES: Dict[type, Callable] = {
    nn.Conv2d: lambda sh, m, x: sh.conv(x, m),
    nn.Sequential: _sequential,
    **dict.fromkeys((L.TorchBatchNorm, L.Dropout, nn.ReLU, nn.LeakyReLU),
                    _pointwise),
    L.RepConv: _rep,
    L.RepBlock: _rep,
    L.ChannelAttention: _channel_attention,
    L.SEBlock: _se_block,
    # litehandnet (deploy graph)
    LH.DWConv: _dwconv,
    LH.BottleNeck: _bottleneck,
    LH.BasicBlock: _basic_block,
    LH.Residual: _residual,
    LH.MSAB: _msab,
    LH.Stem: _stem,
    LH.EncoderDecoder: _last_of_hourglass,
    LH.LiteHandNet: _litehandnet,
    # litehandnet_msrb (deploy graph)
    MR.MSRB: _msrb,
    MR.RepBasicUnit: _rep_basic_unit,
    MR.Stem: _msrb_stem,
    MR.Backbone: _backbone,
    MR.LiteHandNetMSRB: _litehandnet_msrb,
    # mynet (eval mode)
    MS.PlainDWConv: _dwconv,
    MS.PlainBottleNeck: _plain_bottleneck,
    MS.PlainBasicBlock: _plain_basic_block,
    MS.PlainResidual: _residual,
    MS.BRC: _brc,
    MS.RCAGate: _pooled_gate,
    MS.MEAtt: _me_att,
    MS.PeleeStem: _stem,
    MS.MSAttEncoderDecoder: _ms_att_encoder_decoder,
    MS.MSAttHourglass: _ms_att_hourglass,
    # hourglass_ablation (eval mode), CBAM's gates included
    HA.SEGate: _pooled_gate,
    HA.AblationResidual: _ablation_residual,
    HA.AblationMEAtt: _me_att,
    HA.AblationEncoderDecoder: _last_of_hourglass,
    HA.HourglassAblation: _hourglass_ablation,
    AT.CBAM: _cbam,
    AT.RegionChannelAttention: _region_channel_attention,
    AT.RegionSpatialAttention: _region_spatial_attention,
}
# rules that run their submodules themselves on the replicated pooled map
# (the gates' MLPs, Linear and Flatten included): those submodules need no
# rule of their own, and nowhere else is one let through without a rule
OWNS_CHILDREN = frozenset({L.ChannelAttention, L.SEBlock, MS.RCAGate,
                           HA.SEGate, AT.RegionChannelAttention})


def _unserved(module: nn.Module) -> set:
    """The classes in ``module``'s tree that no rule runs: every module
    needs its class's rule, except an ``nn.ModuleList`` (a rule indexes it)
    and the submodules of a rule in ``OWNS_CHILDREN``."""
    kind = type(module)
    missing = (set() if kind in RULES or kind is nn.ModuleList
               else {kind.__name__})
    if kind not in OWNS_CHILDREN:
        for child in module.children():
            missing |= _unserved(child)
    return missing


def _check_model(model: nn.Module, device: torch.device) -> None:
    missing = sorted(_unserved(model))
    if missing:
        raise NotImplementedError(
            f"no height-sharded rule for {', '.join(missing)}: spatial "
            "serving runs the deploy graphs of litehandnet and "
            "litehandnet_msrb and the eval-mode graphs of mynet and "
            "hourglass_ablation")
    if any(m.training for m in model.modules()):
        raise ValueError("spatial serving runs a model in eval mode")
    devices = {p.device for p in model.parameters()}
    if devices != {device}:
        raise ValueError(f"the model's parameters lie on "
                         f"{sorted(map(str, devices))}, the world's device "
                         f"is {device}")


def _canonical(device) -> torch.device:
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class SpatialServe:
    """``serve(img, centers, scales) -> (preds, maxvals)`` with the forward
    height-sharded over ``world``'s ranks; see :func:`make_spatial_serve`.
    ``exchanges`` counts the last request's all-reduces by kind."""

    def __init__(self, model: nn.Module, world: World,
                 post_process: Optional[str] = "unbiased", kernel: int = 11):
        self.device = _canonical(world.device)
        _check_model(model, self.device)
        self.model, self.world = model, world
        self.post_process, self.kernel = post_process, kernel
        self.exchanges: Dict[str, int] = {}

    @torch.no_grad()
    def heatmaps(self, img) -> torch.Tensor:
        """The model's output ``[B, K, H/4, W/4]`` for ``img`` ``[B, 3, H, W]``
        (the whole image on every rank; each rank takes its band), gathered
        on every rank."""
        img = torch.as_tensor(img, device=self.device)
        if img.dim() != 4 or img.shape[1] != 3:
            raise ValueError(f"expected [B, 3, H, W] images, got "
                             f"{tuple(img.shape)}")
        H = img.shape[2]
        if H % self.world.size:
            raise ValueError(f"height {H} does not divide over "
                             f"{self.world.size} ranks")
        sh = ShardedOps(self.world)
        rows = sh.rows(H)
        out = sh.run(self.model, Band(img[:, :, rows.start:rows.stop], H))
        hm = sh.gather(out)
        self.exchanges = dict(sh.counts)
        return hm

    @torch.no_grad()
    def __call__(self, img, centers, scales) -> Tuple[torch.Tensor,
                                                      torch.Tensor]:
        hm = self.heatmaps(img)
        hm = unpack_outputs(hm, hm.shape[1])[0]
        centers = torch.as_tensor(centers, dtype=torch.float32,
                                  device=self.device)
        scales = torch.as_tensor(scales, dtype=torch.float32,
                                 device=self.device)
        _, preds, maxvals = keypoints_from_heatmaps(
            hm, centers, scales, post_process=self.post_process,
            kernel=self.kernel)
        return preds, maxvals


def make_spatial_serve(model: nn.Module, world: World,
                       post_process: Optional[str] = "unbiased",
                       kernel: int = 11) -> SpatialServe:
    """The height-sharded serve function (JAX ``make_spatial_serve``).

    Args:
        model: a served graph in eval mode on ``world.device``
            (:func:`spatial_model`): the deploy graph of ``litehandnet`` or
            ``litehandnet_msrb``, the eval-mode graph of ``mynet`` or
            ``hourglass_ablation``.
        world: this rank's world (``train.distributed.make_mesh``); its
            ranks split the image's height.
        post_process: decode refinement (None | 'default' | 'unbiased').
        kernel: DARK modulation kernel.

    Returns:
        ``serve(img, centers, scales) -> (preds [B, K, 2], maxvals [B, K,
        1])``: every rank passes the same whole ``img [B, 3, H, W]`` and gets
        the same outputs; ``serve.heatmaps(img)`` gives the gathered map.

    Raises:
        NotImplementedError: a module without a height-sharded rule (another
            family, or the train graph of a deploy-graph family).
        ValueError: the model is in train mode or its parameters do not lie
            on ``world.device``; at a call, a height that does not divide
            over the ranks.
        RuntimeError: ``world.device`` is CUDA and CUDA is unavailable.
    """
    return SpatialServe(model, world, post_process, kernel)


def spatial_model(cfg, variables: Optional[Mapping] = None, seed: int = 0,
                  device="cuda") -> nn.Module:
    """The graph :func:`make_spatial_serve` serves for ``cfg``, in eval mode,
    float32, ``channels_last`` on ``device``: ``serve.deploy_model``'s, but
    for ``litehandnet_msrb``, which ``deploy_model`` serves unfused (as
    JAX's ``tools/test`` does), its deploy graph (JAX serves deploy-mode
    models, :47-84).

    Args:
        cfg: experiment config.
        variables: JAX variables as numpy arrays, as ``deploy_model`` takes
            them: the train graph, or for ``litehandnet`` and
            ``litehandnet_msrb`` the JAX ``fuse_params`` output. ``None``
            draws train-graph weights from ``seed``.
        seed: seed of the random weights when ``variables`` is None.
        device: where the model runs.
    """
    from litehandnet_tpu_torch.models import fuse_params, get_model
    from litehandnet_tpu_torch.serve import deploy_model
    from litehandnet_tpu_torch.utils.weights import (
        load_jax_variables,
        rules_for,
    )

    name = cfg.MODEL.name.lower()
    if name != "litehandnet_msrb":
        return deploy_model(cfg, variables, seed, device)
    model = get_model(cfg, deploy=True, device="cpu")
    if variables is not None and "batch_stats" not in variables:
        load_jax_variables(model, variables, rules_for(name, deploy=True))
    else:
        model.load_state_dict(fuse_params(
            deploy_model(cfg, variables, seed, "cpu")))
    return model.to(device=resolve_device(device),
                    memory_format=torch.channels_last)
