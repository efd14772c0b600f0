"""Height-sharded serving, the batch-1 latency mode (port of
``litehandnet_tpu/eval/spatial_serving.py``).

Data parallelism cannot bring one request below one device's forward time.
The JAX package partitions the image's height over the mesh instead and
lets GSPMD derive the halo exchanges (:1-28, 72-84). PyTorch has no such
partitioner for this model: ``torch.distributed.tensor`` shards a
convolution along its last axis only and refuses dilated and strided padded
ones. So the exchanges are written here, one rule per op kind, for the
deploy graph of the ``litehandnet`` family:

* a map is a :class:`Band`, this rank's rows of a map ``height`` rows high,
  in GSPMD's layout (:func:`spatial_spec`) at every level of the network;
* a convolution, the ceil-mode max pool and the nearest resize compute their
  output band from the input rows it reads: the rows other ranks hold come
  in one halo fetch, rows outside the map are the op's padding (zeros, and
  -inf for the max pool);
* the adaptive average pools and the SE mean sum over each rank's own rows
  and all-reduce the partial sums; the channel gates then run on the
  replicated pooled map;
* the head's bands are gathered into the whole map on every rank, which the
  DARK decode (the ``blur_log`` kernel) reads as one device would.

Ranks are processes (``train.distributed``: NCCL across GPUs, gloo on the
CPU). Every exchange is an ``all_reduce`` over a zero buffer in which each
rank fills the rows it owns, so a fetch or gather is exact (x + 0 = x) and
all-reduce is the one collective used. Every rank gets the same outputs,
bit for bit. A world of one runs the modules' own ops.

Deviations from JAX: ranks instead of a mesh; a height that does not divide
over the ranks raises ``ValueError`` where JAX asserts (:70); only the
``litehandnet`` family has sharded rules, and any other module raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from collections import Counter
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.eval.decoder import unpack_outputs
from litehandnet_tpu_torch.models import layers as L
from litehandnet_tpu_torch.models import litehandnet as LH
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
    """The ops of the deploy graph on height bands of ``world``'s ranks.
    ``counts`` tallies the exchanges: ``halo`` fetches, ``reduce``
    (partial sums of a pool or mean) and ``gather``, each one
    ``all_reduce``."""

    def __init__(self, world: World):
        self.world = world
        self.n, self.rank = world.size, world.rank
        self.counts: Counter = Counter()

    def _all_reduce(self, t: torch.Tensor, kind: str) -> None:
        dist.all_reduce(t, group=self.world.group)
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


def _rep(sh: ShardedOps, m, x: Band) -> Band:
    """``RepConv`` and ``RepBlock`` of the deploy graph (layers.py
    ``forward``: ``self.rep(x)``, then the activation)."""
    return _act(sh.conv(x, m.rep), m.act)


def _dwconv(sh: ShardedOps, m: LH.DWConv, x: Band) -> Band:
    return sh.run(m.pointwise_conv, sh.run(m.depthwise_conv, x))


def _bottleneck(sh: ShardedOps, m: LH.BottleNeck, x: Band) -> Band:
    return _act(_join(torch.add, x, sh.run(m.conv, x)), m.act)


def _basic_block(sh: ShardedOps, m: LH.BasicBlock, x: Band) -> Band:
    skip = x if m.skip_layer is None else sh.run(m.skip_layer, x)
    return _act(_join(torch.add, skip, sh.run(m.conv, x)), m.act)


def _residual(sh: ShardedOps, m: LH.Residual, x: Band) -> Band:
    return sh.run(m.blocks, sh.run(m.conv1, x))


def _cat(a: Band, b: Band) -> Band:
    return _join(lambda u, v: torch.cat([u, v], dim=1), a, b)


def _msab(sh: ShardedOps, m: LH.MSAB, x: Band) -> Band:
    y = sh.run(m.conv1, x)
    for p1, p2 in zip(m.mid1_conv, m.mid2_conv):
        y = _cat(sh.run(p1, y), sh.run(p2, y))
    out = sh.run(m.conv2, _join(torch.add, y, x))
    return out if m.ca is None else sh.run(m.ca, out)


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


def _stem(sh: ShardedOps, m: LH.Stem, x: Band) -> Band:
    x = sh.run(m.conv1, x)
    out = _cat(sh.run(m.branch1, x), sh.max_pool2(x))
    return sh.run(m.conv1x1, out)


def _encoder_decoder(sh: ShardedOps, m: LH.EncoderDecoder, x: Band) -> Band:
    out_encoder = []
    for layer in m.encoder:
        x = sh.run(layer, x)
        out_encoder.append(x)
    last = out_encoder[-1]
    shortcut = sh.adaptive_avg_pool(
        out_encoder[0], (last.height, last.t.shape[3]), banded=True)
    for i, layer in enumerate(m.decoder):
        counterpart = out_encoder[m.num_levels - 1 - i]
        if i == 0:
            x = _join(torch.add, sh.run(layer, counterpart), shortcut)
        else:
            up = sh.resize_nearest(
                sh.run(layer, x),
                (counterpart.height, counterpart.t.shape[3]))
            x = _join(torch.add, up, counterpart)
    return x


def _litehandnet(sh: ShardedOps, m: LH.LiteHandNet, x: Band) -> Band:
    x = sh.run(m.hgs, sh.run(m.pre, x))
    return sh.run(m.out_layer, sh.run(m.features, x)).map(L.head_output)


RULES: Dict[type, Callable] = {
    nn.Conv2d: lambda sh, m, x: sh.conv(x, m),
    nn.Sequential: _sequential,
    L.RepConv: _rep,
    L.RepBlock: _rep,
    LH.DWConv: _dwconv,
    LH.BottleNeck: _bottleneck,
    LH.BasicBlock: _basic_block,
    LH.Residual: _residual,
    LH.MSAB: _msab,
    L.ChannelAttention: _channel_attention,
    L.SEBlock: _se_block,
    LH.Stem: _stem,
    LH.EncoderDecoder: _encoder_decoder,
    LH.LiteHandNet: _litehandnet,
}
# modules that a rule above runs on replicated tensors or walks itself
_INSIDE_RULES = (nn.ModuleList, L.ChannelDropout, nn.LeakyReLU)


def _check_model(model: nn.Module, device: torch.device) -> None:
    missing = sorted({type(m).__name__ for m in model.modules()
                      if type(m) not in RULES
                      and not isinstance(m, _INSIDE_RULES)})
    if missing:
        raise NotImplementedError(
            f"no height-sharded rule for {', '.join(missing)}: spatial "
            "serving runs the deploy graph of the litehandnet family")
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
        model: a deploy-graph ``litehandnet`` model in eval mode
            (``serve.deploy_model``, ``get_model(cfg, deploy=True)``) on
            ``world.device``.
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
            family, or the train graph).
        ValueError: the model is in train mode or its parameters do not lie
            on ``world.device``; at a call, a height that does not divide
            over the ranks.
        RuntimeError: ``world.device`` is CUDA and CUDA is unavailable.
    """
    return SpatialServe(model, world, post_process, kernel)
