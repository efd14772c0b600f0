"""Height-sharded serving, the batch-1 latency mode (port of
``litehandnet_tpu/eval/spatial_serving.py``).

Data parallelism cannot bring one request below one device's forward time.
The JAX package partitions the image's height over the mesh instead and
lets GSPMD derive the halo exchanges (:1-28, 72-84). PyTorch has no such
partitioner for these models: ``torch.distributed.tensor`` shards a
convolution along its last axis only and refuses dilated and strided padded
ones. So the exchanges are written here, one rule per op kind and per
class, for the served graphs of the hand families (the deploy graphs of
``litehandnet`` and ``litehandnet_msrb``, the eval-mode graphs of ``mynet``
and ``hourglass_ablation`` with every gate, CBAM included) and of the
benchmark zoo (the eval-mode graphs of ``srhandnet``, ``litehrnet`` 18 and
30, ``resnet``, ``mobilenetv2`` and the stacked ``hourglass``):

* a map is a :class:`Band`, this rank's rows of a map ``height`` rows high,
  in GSPMD's layout (:func:`spatial_spec`) at every level of the network;
  a rule of Lite-HRNet takes and returns a list of bands, one a branch,
  each at its own height;
* a convolution, a transposed convolution, the max pools, the nearest
  resize and the align-corners bilinear resize compute their output band
  from the input rows it reads: the rows other ranks hold come in one halo
  fetch, rows outside the map are the op's padding (zeros, and -inf for
  the max pools); the transposed convolution and the bilinear resize put
  those rows into a zero map of the input's size and run the op on it
  whole, so that each row keeps the whole map's bits (cuDNN's transposed
  convolution of a window does not);
* eval-mode BatchNorm, the activations and eval dropout run on the band
  alone, as do channel splits, concatenations, channel shuffles, gates
  multiplied in and per-pixel channel statistics;
* the adaptive average pools and the gates' means sum over each rank's own
  rows and all-reduce the partial sums; CBAM's global maximum takes each
  rank's maximum (-inf for a rank without rows) and all-reduces by max; the
  channel gates then run on the replicated pooled map;
* Lite-HRNet's gates reduce gathered maps instead: its spatial weighting
  takes the mean of its branch's whole map, and its cross-resolution
  weighting gathers every branch in one all-reduce, pools them to the last
  branch's size and concatenates that branch with the module's own ops,
  runs its 1x1 convolutions on the replicated mini map, and each rank
  takes the rows of the gate's nearest resize its bands need, with no
  further exchange: 84 + 28 all-reduces a request at depth 30, as many as
  partial sums would take, and every rank reduces as one device does
  (partial sums left the maps 1e-5 of their max from one device's, which
  ill-posed DARK steps turned into coordinate errors);
* a multi-scale or stacked output keeps its bands: only the last map (the
  finest scale, the last stack) is gathered into the whole map on every
  rank, which the DARK decode (the ``blur_log`` kernel) reads as one
  device would.

Ranks are processes (``train.distributed``: NCCL across GPUs, gloo on the
CPU). Every exchange is an ``all_reduce``: a fetch, a sum or the gather over
a zero buffer in which each rank fills the rows it owns, so a fetch or
gather is exact (x + 0 = x), and the maximum by max. Every rank gets the
same outputs, bit for bit. A world of one runs the modules' own ops.

Deviations from JAX: ranks instead of a mesh; a height that does not divide
over the ranks raises ``ValueError`` where JAX asserts (:70); only the
families above have sharded rules, and any other module raises
``NotImplementedError``. JAX's serve passes the stacked hourglass's 5-D
output to the decode, which refuses it; the port decodes its last stack,
as JAX's ``tools/test`` does (:159-160 there).

The other registry families are refused on both sides: JAX's serve decodes
``hm[-1]`` of the output with ``keypoints_from_heatmaps`` (:76-84), which
needs a 4-D map, and none of them gives one: ``mynet_stacked``'s last
output is its SimDR ``pred_y`` ``[B, K, W * 2]``, ``atthandnet`` returns
coordinates ``[B, K, 2]``, ``yolov6`` rows ``[B, N, 5 + nc]`` and
``classifier`` logits ``[B, nc]``. JAX raises ``ValueError`` in the decode
after the forward; the port raises ``NotImplementedError`` before it,
naming the classes without a rule.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn
from torch.nn.modules.utils import _pair

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.eval.decoder import unpack_outputs
from litehandnet_tpu_torch.models import attention as AT
from litehandnet_tpu_torch.models import hourglass as HG
from litehandnet_tpu_torch.models import hourglass_ablation as HA
from litehandnet_tpu_torch.models import layers as L
from litehandnet_tpu_torch.models import litehandnet as LH
from litehandnet_tpu_torch.models import litehandnet_msrb as MR
from litehandnet_tpu_torch.models import litehrnet as HR
from litehandnet_tpu_torch.models import ms_att_hourglass as MS
from litehandnet_tpu_torch.models import simplebaseline as SB
from litehandnet_tpu_torch.models import srhandnet as SR
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


@functools.lru_cache(maxsize=None)
def _bilinear_rows(in_h: int, out_h: int) -> tuple:
    """The two input rows ``(h0, h1)`` of each output row of an
    align-corners bilinear resize from ``in_h`` to ``out_h`` rows: ``h0 =
    floor(o * (in_h - 1) / (out_h - 1))`` in float32 and the row after it
    (``h0`` itself at the last row), as PyTorch's kernels compute them."""
    scale = (np.float32(in_h - 1) / np.float32(out_h - 1) if out_h > 1
             else np.float32(0))
    src = np.floor(np.arange(out_h, dtype=np.float32) * scale)
    return tuple((int(h), int(h) + int(h < in_h - 1)) for h in src)


def _pool_size(size: int, k: int, s: int, p: int, d: int, ceil: bool) -> int:
    """The output size of a max pool over ``size`` inputs
    (``F.max_pool2d``'s rule: in ceil mode the last window starts inside
    the input or its left padding)."""
    span = size + 2 * p - d * (k - 1) - 1
    out = (span + (s - 1 if ceil else 0)) // s + 1
    if ceil and (out - 1) * s >= size + p:
        out -= 1
    return out


def _nearest_band(t: torch.Tensor, rows: list, width: int) -> torch.Tensor:
    """The rows ``rows`` of ``t``, nearest-resized to ``width`` columns."""
    picked = t.index_select(2, torch.as_tensor(rows, device=t.device))
    return F.interpolate(picked, size=(len(rows), width), mode="nearest-exact")


def _memory_format(t: torch.Tensor) -> torch.memory_format:
    """``channels_last`` for a tensor in that layout, else contiguous."""
    return (torch.channels_last if not t.is_contiguous()
            and t.is_contiguous(memory_format=torch.channels_last)
            else torch.contiguous_format)


def _empty_rows(t: torch.Tensor, channels: int, width: int) -> torch.Tensor:
    """A band of no rows: a rank whose output band is empty."""
    return t.new_empty((t.shape[0], channels, 0, width))


def _pool_regions(size: int, out: int) -> list:
    """Adaptive pooling's input span of each of ``out`` outputs over
    ``size`` inputs: ``[floor(i * size / out), ceil((i + 1) * size / out))``."""
    return [((i * size) // out, -(-((i + 1) * size) // out))
            for i in range(out)]


class ShardedOps:
    """The ops of the served graphs on height bands of ``world``'s ranks.
    ``counts`` tallies the exchanges: ``halo`` fetches, ``reduce``
    (partial sums of a pool or mean), ``max`` (a global maximum) and
    ``gather``, each one ``all_reduce``. Every window of rows an op reads
    takes ``memory_format``, the layout of the model's whole-map forward,
    so the ops after it run the kernels the whole map runs: cuDNN's
    eval-mode BatchNorm gives a band in NCHW memory other bits than the
    rows of a channels_last map."""

    def __init__(self, world: World, memory_format: torch.memory_format):
        self.world = world
        self.memory_format = memory_format
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
        win = parts[0] if len(parts) == 1 else torch.cat(parts, dim=2)
        return win.contiguous(memory_format=self.memory_format)

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
            out_w = (x.t.shape[3] + 2 * pw - dw * (kw - 1) - 1) // sw + 1
            return Band(_empty_rows(x.t, conv.out_channels, out_w), out_h)
        return Band(F.conv2d(win, conv.weight, conv.bias, (s, sw), (0, pw),
                             (d, dw), conv.groups), out_h)

    def _on_zero_map(self, x: Band, windows: tuple, op, out_shape: tuple
                     ) -> Band:
        """This rank's band of ``op`` on the whole map, from the rows the
        band reads (``windows``, one halo fetch): they fill a zero map of
        the input's size, in the band's memory format, which ``op`` takes
        whole; the band keeps its rows. Each row is computed from the same
        inputs by the same kernel as on the whole map, so it has the same
        bits; the price is the whole op on every rank. ``out_shape`` is
        the output's (channels, height, width)."""
        channels, out_height, out_width = out_shape
        win = self._halo(x, windows, 0.0)
        if win is None:
            return Band(_empty_rows(x.t, channels, out_width), out_height)
        a, b = windows[self.rank]
        lo, hi = max(a, 0), min(b, x.height)
        B, C, _, W = win.shape
        full = torch.empty((B, C, x.height, W), dtype=win.dtype,
                           device=win.device, memory_format=_memory_format(
                               x.t if x.t.shape[2] else win)).zero_()
        full[:, :, lo:hi] = win[:, :, lo - a:hi - a]
        out = self.rows(out_height)
        return Band(op(full)[:, :, out.start:out.stop], out_height)

    def conv_transpose(self, x: Band, conv: nn.ConvTranspose2d) -> Band:
        """``conv(x)`` of a transposed convolution: output row ``o = i * s
        - p + j * d`` gathers input row ``i`` through tap ``j``, so an
        output band ``[o0, o1)`` reads input rows ``ceil((o0 + p - d (k -
        1)) / s)`` to ``floor((o1 - 1 + p) / s)``. Computed on the zero map
        (:meth:`_on_zero_map`): cuDNN's transposed convolution of a window
        does not give the whole map's bits, which an ill-posed DARK step
        turns into coordinate errors."""
        if self.n == 1:
            return _whole(conv(x.t))
        (k, kw), (s, sw) = conv.kernel_size, conv.stride
        (p, pw), (d, dw) = conv.padding, conv.dilation
        op, opw = conv.output_padding
        out_h = (x.height - 1) * s - 2 * p + d * (k - 1) + op + 1
        out_w = (x.t.shape[3] - 1) * sw - 2 * pw + dw * (kw - 1) + opw + 1
        windows = tuple(
            (-(-(o.start + p - d * (k - 1)) // s), (o.stop - 1 + p) // s + 1)
            if o else None for o in spatial_spec(out_h, self.n))
        return self._on_zero_map(x, windows, conv,
                                 (conv.out_channels, out_h, out_w))

    def max_pool(self, x: Band, kernel, stride, padding=0, dilation=1,
                 ceil_mode=False) -> Band:
        """``F.max_pool2d(x, kernel, stride, padding, dilation,
        ceil_mode)``: output row ``o`` reads input rows from ``o * s - p``
        on; rows past the map are -inf (the op's own padding)."""
        (k, kw), (s, sw) = _pair(kernel), _pair(stride)
        (p, pw), (d, dw) = _pair(padding), _pair(dilation)
        if self.n == 1:
            return _whole(F.max_pool2d(x.t, (k, kw), (s, sw), (p, pw),
                                       (d, dw), ceil_mode))
        out_h = _pool_size(x.height, k, s, p, d, ceil_mode)
        windows = tuple((o.start * s - p, (o.stop - 1) * s - p + d * (k - 1)
                         + 1) if o else None
                        for o in spatial_spec(out_h, self.n))
        win = self._halo(x, windows, float("-inf"))
        if win is None:
            out_w = _pool_size(x.t.shape[3], kw, sw, pw, dw, ceil_mode)
            return Band(_empty_rows(x.t, x.t.shape[1], out_w), out_h)
        return Band(F.max_pool2d(win, (k, kw), (s, sw), (0, pw), (d, dw),
                                 ceil_mode), out_h)

    def max_pool2(self, x: Band) -> Band:
        """``layers.max_pool2(x)``: 2x2 stride 2, ceil mode."""
        return self.max_pool(x, 2, 2, ceil_mode=True)

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
            return Band(_empty_rows(x.t, x.t.shape[1], w), h)
        return Band(_nearest_band(win, [src[i] - src[out.start] for i in out],
                                  w), h)

    def resize_bilinear(self, x: Band, size) -> Band:
        """``litehrnet.resize_bilinear_align_corners(x, size)``: output row
        ``o`` reads input rows ``floor(o (h - 1) / (H - 1))`` and the one
        after it; computed on the zero map (:meth:`_on_zero_map`), the
        same bits as the whole resize."""
        h, w = size
        if (x.height, x.t.shape[3]) == (h, w):
            return x
        if self.n == 1:
            return _whole(HR.resize_bilinear_align_corners(x.t, size))
        src = _bilinear_rows(x.height, h)
        windows = tuple((src[o.start][0], src[o.stop - 1][1] + 1) if o
                        else None for o in spatial_spec(h, self.n))
        return self._on_zero_map(
            x, windows, lambda t: HR.resize_bilinear_align_corners(t, size),
            (x.t.shape[1], h, w))

    def resize_replicated(self, y: torch.Tensor, size) -> Band:
        """This rank's band of ``layers.resize_nearest(y, size)`` for a map
        ``y`` that every rank holds whole: its rows picked, no exchange."""
        h, w = size
        if self.n == 1:
            return _whole(L.resize_nearest(y, size))
        out = self.rows(h)
        if not out:
            return Band(_empty_rows(y, y.shape[1], w), h)
        src = _nearest_rows(y.shape[2], h)
        return Band(_nearest_band(y, [src[i] for i in out], w), h)

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

    def gather_all(self, xs: List[Band]) -> List[torch.Tensor]:
        """The whole maps of ``xs`` on every rank, in one all-reduce (each
        rank's rows in a zero buffer), each in its band's memory format, so
        that a module's own op reduces them as on one device."""
        if self.n == 1:
            return [x.t for x in xs]
        wholes = []
        for x in xs:
            B, C, _, W = x.t.shape
            own = self.rows(x.height)
            full = x.t.new_zeros((B, C, x.height, W))
            full[:, :, own.start:own.stop] = x.t
            wholes.append(full)
        flat = torch.cat([w.flatten() for w in wholes])
        self._all_reduce(flat, "gather")
        out = []
        for x, w in zip(xs, flat.split([w.numel() for w in wholes])):
            out.append(w.view(x.t.shape[0], -1, x.height, x.t.shape[3])
                       .contiguous(memory_format=_memory_format(x.t)))
        return out

    def gather(self, x: Band) -> torch.Tensor:
        """The whole map on every rank."""
        return self.gather_all([x])[0]

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


def _cat(*xs: Band) -> Band:
    """``torch.cat`` of bands of one map height along the channels."""
    if len({x.height for x in xs}) != 1:
        raise ValueError(f"bands of heights {[x.height for x in xs]}")
    return Band(torch.cat([x.t for x in xs], dim=1), xs[0].height)


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


# -- the benchmark zoo (eval mode) --------------------------------------------

def _sr_stem(sh: ShardedOps, m: SR.SRStem, x: Band) -> Band:
    return _cat(sh.run(m.conv1, x), sh.run(m.conv2, x),
                sh.run(m.conv3, x)).map(F.relu)


def _sr_basic_block(sh: ShardedOps, m: SR.SRBasicBlock, x: Band) -> Band:
    skip = x if m.conv1x1 is None else sh.run(m.conv1x1, x)
    return _join(torch.add, sh.run(m.conv3x3, x), skip).map(F.relu)


def _doubled(sh: ShardedOps, x: Band) -> Band:
    """``resize_nearest(x, (2 h, 2 w))``."""
    return sh.resize_nearest(x, (2 * x.height, 2 * x.t.shape[3]))


def _srhandnet(sh: ShardedOps, m: SR.SRHandNet, x: Band) -> tuple:
    """The four scales, each a band: the serve gathers the last."""
    b1 = sh.run(m.block1, sh.run(m.stem, x))
    b2 = sh.run(m.block2, b1)
    b3 = sh.run(m.block3, b2)
    out1 = sh.run(m.block4, b3)
    out2 = sh.run(m.block5, _cat(b3, out1))
    out3 = sh.run(m.block6, _cat(b2, _doubled(sh, out2)))
    out4 = sh.run(m.block7, _cat(b1, _doubled(sh, out3)))
    return tuple(o.map(L.head_output) for o in (out1, out2, out3, out4))


def _sb_res_block(sh: ShardedOps, m, x: Band) -> Band:
    """``simplebaseline.ResBasicBlock`` and ``ResBottleneck``."""
    skip = x if m.downsample is None else sh.run(m.downsample, x)
    return _join(torch.add, skip, sh.run(m.conv, x)).map(F.relu)


def _deconv_head(sh: ShardedOps, m: SB.DeconvHead, x: Band) -> Band:
    return sh.run(m.final_layer, sh.run(m.deconv_layers, x))


def _pose_resnet(sh: ShardedOps, m: SB.PoseResNet, x: Band) -> Band:
    x = sh.run(m.maxpool, sh.run(m.stem, x))
    for stage in m.res_layers:
        x = sh.run(stage, x)
    return sh.run(m.out_head, x).map(L.head_output)


def _inverted_residual(sh: ShardedOps, m: SB.InvertedResidual, x: Band
                       ) -> Band:
    out = sh.run(m.conv, x)
    return _join(torch.add, x, out) if m.use_res else out


def _pose_mobilenetv2(sh: ShardedOps, m: SB.PoseMobileNetV2, x: Band
                      ) -> Band:
    x = sh.run(m.conv1, x)
    for i in range(len(m.ARCH)):
        x = sh.run(getattr(m, f"layer{i + 1}"), x)
    return sh.run(m.out_head, sh.run(m.conv2, x)).map(L.head_output)


def _hg_conv(sh: ShardedOps, m: HG.HgConv, x: Band) -> Band:
    x = sh.run(m.conv, x)
    if m.bn is not None:
        x = sh.run(m.bn, x)
    return x.map(F.relu) if m.relu else x


def _hg_residual(sh: ShardedOps, m: HG.HgResidual, x: Band) -> Band:
    residual = x if m.skip_layer is None else sh.run(m.skip_layer, x)
    out = sh.run(m.conv1, sh.run(m.bn1, x).map(F.relu))
    out = sh.run(m.conv2, sh.run(m.bn2, out).map(F.relu))
    out = sh.run(m.conv3, sh.run(m.bn3, out).map(F.relu))
    return _join(torch.add, out, residual)


def _hg_module(sh: ShardedOps, m: HG.HourglassModule, x: Band) -> Band:
    up1 = sh.run(m.up1, x)
    low = sh.run(m.low3, sh.run(m.low2, sh.run(m.low1, sh.max_pool2(x))))
    return _join(torch.add, up1, sh.resize_nearest(low, _size(up1)))


def _hourglass_net(sh: ShardedOps, m: HG.HourglassNet, imgs: Band) -> tuple:
    """Each stack's preds, a band each: the serve gathers the last; the
    earlier stacks' feed ``merge_preds`` on their own bands."""
    x = sh.run(m.pre, imgs)
    outs = []
    for i in range(m.num_stack):
        feat = sh.run(m.features[i], sh.run(m.hgs[i], x))
        preds = sh.run(m.outs[i], feat)
        outs.append(preds.map(L.head_output))
        if i < m.num_stack - 1:
            x = _join(torch.add, _join(torch.add, x,
                                       sh.run(m.merge_preds[i], preds)),
                      sh.run(m.merge_features[i], feat))
    return tuple(outs)


def _spatial_weighting(sh: ShardedOps, m: HR.SpatialWeighting, x: Band
                       ) -> Band:
    """The mean of the gathered map (the module's own op); the gate's
    convolutions run on the replicated ``[B, C, 1, 1]`` map."""
    s = sh.gather_all([x])[0].mean(dim=(2, 3), keepdim=True)
    s = torch.sigmoid(F.relu(m.conv1(s)))
    s = torch.sigmoid(F.relu(m.conv2(s)))
    return x.map(lambda t: t * s)


def _cross_resolution_weighting(sh: ShardedOps,
                                m: HR.CrossResolutionWeighting,
                                xs: List[Band]) -> List[Band]:
    """One gather gives every rank the branches' whole maps, pooled to the
    smallest by the module's own op; the 1x1 convolutions run on the
    replicated mini map, and each branch's band takes its rows of the
    gate's nearest resize."""
    whole = sh.gather_all(xs)
    mini = whole[-1].shape[2:]
    out = torch.cat([L.adaptive_avg_pool(s, mini) for s in whole[:-1]]
                    + [whole[-1]], dim=1)
    out = torch.sigmoid(F.relu(m.conv1(out)))
    out = torch.sigmoid(F.relu(m.conv2(out)))
    return [_join(torch.mul, s, sh.resize_replicated(a, _size(s)))
            for s, a in zip(xs, torch.split(out, m.channels, dim=1))]


def _shuffled(x: Band) -> Band:
    return x.map(lambda t: L.channel_shuffle(t, 2))


def _conditional_channel_weighting(sh: ShardedOps,
                                   m: HR.ConditionalChannelWeighting,
                                   xs: List[Band]) -> List[Band]:
    halves = [_split(s, s.t.shape[1] // 2) for s in xs]
    x2 = sh.run(m.cross_resolution_weighting, [b for _, b in halves])
    x2 = [sh.run(sw, sh.run(dw, s)) for s, dw, sw in
          zip(x2, m.depthwise_convs, m.spatial_weighting)]
    return [_shuffled(_cat(a, b)) for (a, _), b in zip(halves, x2)]


def _stage_module(sh: ShardedOps, m: HR.StageModule, xs: List[Band]
                  ) -> List[Band]:
    """The blocks, then the eval-mode fuse: strided depthwise-separable
    convolutions down, 1x1 convolutions and nearest upsamples up."""
    xs = sh.run(m.layers, xs)
    n = len(xs)

    def fuse(j, i, s):
        out = sh.run(m.fuse_layers[i][j], s)
        if j > i:
            f = 2 ** (j - i)
            out = sh.resize_nearest(out, (out.height * f, out.t.shape[3] * f))
        return out

    s0 = xs[0].map(lambda t: 2.0 * t)
    for j in range(1, n):
        s0 = _join(torch.add, s0, fuse(j, 0, xs[j]))
    out = [s0.map(F.relu)]
    for i in range(1, n):
        y = fuse(0, i, s0).map(lambda t: 2.0 * t)
        for j in range(1, n):
            y = _join(torch.add, y, xs[j] if i == j else fuse(j, i, xs[j]))
        out.append(y.map(F.relu))
    return out


def _hr_stem(sh: ShardedOps, m: HR.StemModule, x: Band) -> Band:
    left, right = _split(sh.run(m.conv1, x), m.branch)
    x2 = sh.run(m.linear_conv, sh.run(m.depthwise_conv,
                                       sh.run(m.expand_conv, right)))
    return _shuffled(_cat(sh.run(m.branch1, left), x2))


def _iterative_head(sh: ShardedOps, m: HR.IterativeHead, xs: List[Band]
                    ) -> List[Band]:
    y, last = [], None
    for s, proj in zip(xs[::-1], m.projects):
        if last is not None:
            s = _join(torch.add, s, sh.resize_bilinear(last, _size(s)))
        last = sh.run(proj, s)
        y.append(last)
    return y[::-1]


def _litehrnet(sh: ShardedOps, m: HR.LiteHRNet, x: Band) -> Band:
    ys = [sh.run(m.stem, x)]
    for i in range(len(m.NUM_CHANNELS)):
        trans = getattr(m, f"transition{i}")
        xs = [sh.run(t, ys[min(j, len(ys) - 1)]) for j, t in enumerate(trans)]
        for module in getattr(m, f"stage{i}"):
            xs = sh.run(module, xs)
        ys = xs
    return sh.run(m.out_conv, sh.run(m.head_layer, ys)[0]).map(L.head_output)


RULES: Dict[type, Callable] = {
    nn.Conv2d: lambda sh, m, x: sh.conv(x, m),
    nn.ConvTranspose2d: lambda sh, m, x: sh.conv_transpose(x, m),
    nn.MaxPool2d: lambda sh, m, x: sh.max_pool(
        x, m.kernel_size, m.stride, m.padding, m.dilation, m.ceil_mode),
    nn.Sequential: _sequential,
    nn.Identity: lambda sh, m, x: x,
    **dict.fromkeys((L.TorchBatchNorm, L.Dropout, nn.ReLU, nn.ReLU6,
                     nn.LeakyReLU), _pointwise),
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
    # srhandnet
    SR.SRStem: _sr_stem,
    SR.SRBasicBlock: _sr_basic_block,
    SR.SRHandNet: _srhandnet,
    # resnet and mobilenetv2 (SimpleBaseline)
    SB.CBL: lambda sh, m, x: sh.run(m.conv, x),
    SB.ResBasicBlock: _sb_res_block,
    SB.ResBottleneck: _sb_res_block,
    SB.DeconvHead: _deconv_head,
    SB.PoseResNet: _pose_resnet,
    SB.InvertedResidual: _inverted_residual,
    SB.PoseMobileNetV2: _pose_mobilenetv2,
    # hourglass
    HG.HgConv: _hg_conv,
    HG.HgResidual: _hg_residual,
    HG.HourglassModule: _hg_module,
    HG.HourglassNet: _hourglass_net,
    HG._Merge: lambda sh, m, x: sh.run(m.conv, x),
    # litehrnet: lists of bands, one a branch
    HR.HRDWConv: _dwconv,
    HR.SpatialWeighting: _spatial_weighting,
    HR.CrossResolutionWeighting: _cross_resolution_weighting,
    HR.ConditionalChannelWeighting: _conditional_channel_weighting,
    HR.StageModule: _stage_module,
    HR.StemModule: _hr_stem,
    HR.IterativeHead: _iterative_head,
    HR.LiteHRNet: _litehrnet,
}
# rules that run their submodules themselves on the replicated pooled map
# (the gates' MLPs, Linear and Flatten included): those submodules need no
# rule of their own, and nowhere else is one let through without a rule
OWNS_CHILDREN = frozenset({L.ChannelAttention, L.SEBlock, MS.RCAGate,
                           HA.SEGate, AT.RegionChannelAttention,
                           HR.SpatialWeighting,
                           HR.CrossResolutionWeighting})


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
            "litehandnet_msrb and the eval-mode graphs of mynet, "
            "hourglass_ablation, srhandnet, litehrnet, resnet, mobilenetv2 "
            "and hourglass; mynet_stacked (SimDR vectors), atthandnet "
            "(coordinates), yolov6 (detection rows) and classifier "
            "(logits) give no heatmap to decode, and JAX's serve refuses "
            "them too")
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
        # the layout of the model's whole-map forward: channels_last where
        # its convolution weights are
        self.memory_format = (
            torch.channels_last if any(
                p.dim() == 4 and _memory_format(p) == torch.channels_last
                for p in model.parameters()) else torch.contiguous_format)
        self.exchanges: Dict[str, int] = {}

    @torch.no_grad()
    def heatmaps(self, img) -> torch.Tensor:
        """The map the serve decodes, ``[B, K, H/4, W/4]`` for ``img`` ``[B,
        3, H, W]`` (the whole image on every rank; each rank takes its
        band), gathered on every rank: ``decoder.served_map`` of the model's
        output (JAX's ``hm[-1]``), the other scales and stacks never
        gathered."""
        img = torch.as_tensor(img, device=self.device)
        if img.dim() != 4 or img.shape[1] != 3:
            raise ValueError(f"expected [B, 3, H, W] images, got "
                             f"{tuple(img.shape)}")
        H = img.shape[2]
        if H % self.world.size:
            raise ValueError(f"height {H} does not divide over "
                             f"{self.world.size} ranks")
        sh = ShardedOps(self.world, self.memory_format)
        rows = sh.rows(H)
        out = sh.run(self.model, Band(img[:, :, rows.start:rows.stop], H))
        if isinstance(out, (tuple, list)):
            out = out[-1]
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
            ``litehandnet_msrb``, the eval-mode graph of ``mynet``,
            ``hourglass_ablation``, ``srhandnet``, ``litehrnet`` (18 and
            30), ``resnet``, ``mobilenetv2`` or ``hourglass``.
        world: this rank's world (``train.distributed.make_mesh``); its
            ranks split the image's height.
        post_process: decode refinement (None | 'default' | 'unbiased').
        kernel: DARK modulation kernel.

    Returns:
        ``serve(img, centers, scales) -> (preds [B, K, 2], maxvals [B, K,
        1])``: every rank passes the same whole ``img [B, 3, H, W]`` and gets
        the same outputs; ``serve.heatmaps(img)`` gives the gathered map.
        ``K`` counts every channel of the decoded map, as JAX's serve: 24
        for SRHandNet's region-map configs (21 joints, the center, w/h).
        A multi-scale model decodes its last scale (SRHandNet's finest), the
        stacked hourglass its last stack.

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
