"""Shared building blocks: re-parameterizable convolutions and channel
attention (port of ``litehandnet_tpu/models/layers.py``).

Layout is NCHW (run in ``channels_last`` memory by the caller); conv weights
are OIHW. Submodule names follow the reference torch code
(``repblocks.py``, ``common.py``) so checkpoints and the JAX package's
``utils/torch_import.py`` rules apply unchanged:

* ``RepConv``: train graph ``conv.conv`` + ``conv.bn``; deploy ``rep``.
* ``RepBlock``: ``rbr_dense``, ``rbr_1x1``, ``rbr_identity``; deploy ``rep``.
* ``ChannelAttention``: ``conv3x3`` (deploy ``att_rep``) and the gate MLP
  ``conv1x1.{1,3}``.
* ``SEBlock``: ``down``, ``up``.

A deploy ``RepConv`` or ``RepBlock`` whose ``rep`` is a "same" stride-1
depthwise conv runs, on the card and without gradients, through the
``dw_conv_bias_act`` kernel, bias and activation in its epilogue
(``dw_kernel_route``); everything else keeps ``rep`` and the activation,
its weight and bias cast to autocast's dtype once, not on every call
(``deploy_conv``).

BatchNorm is ``TorchBatchNorm``, an ``nn.BatchNorm2d(eps=1e-5,
momentum=0.1)`` whose train mode follows the JAX package's semantics: batch
statistics through ``ops.fused_bn.moments`` at C % 128 == 0 sites (and
C < 128 with ``LHN_FUSED_BN_SMALLC=1``), stats
handed in by a fused producer (``precomputed``), statistics over every rank
of a process group (SyncBN, ``set_sync_bn``), and a running variance that
tracks the unbiased batch variance.
"""

from __future__ import annotations

import contextlib
import os
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.kernels.dw_conv_bias_act import (
    KERNEL_SIZES,
    MAX_DILATION,
    dw_conv_bias_act,
    launch_plan,
)
from litehandnet_tpu_torch.ops.fused_bn import (
    dw_conv3x3_stats,
    dw_conv3x3_stats_supported,
    moments,
)

Activation = Optional[Callable[[torch.Tensor], torch.Tensor]]

leaky_relu = F.leaky_relu  # slope 0.01
relu = F.relu


def get_activation(name: str | None) -> Activation:
    if name is None:
        return None
    return {
        "leakyrelu": leaky_relu,
        "leaky_relu": leaky_relu,
        "relu": relu,
        "silu": F.silu,
        "mish": F.mish,
        "sigmoid": torch.sigmoid,
        "none": None,
        "identity": None,
    }[name.lower()]


def repconv_act(act: Activation, inplace: bool) -> Activation:
    """Effective activation of a reference RepConv.

    The reference builds ``activation(inplace)`` positionally, so for
    LeakyReLU the bool lands in ``negative_slope``: ``inplace=True`` gives
    slope 1 (identity), ``inplace=False`` slope 0 (exact ReLU). Other
    activations take ``inplace`` as their first argument and are unchanged.
    RepBlock passes it by keyword and is unaffected.
    """
    if act is leaky_relu:
        return None if inplace else relu
    return act


def Conv(in_channels: int, features: int, kernel: int = 1, stride: int = 1,
         padding: int = 0, dilation: int = 1, groups: int = 1,
         bias: bool = True) -> nn.Conv2d:
    """Conv with torch-style integer padding."""
    return nn.Conv2d(in_channels, features, kernel, stride, padding,
                     dilation, groups, bias=bias)


def use_fused_bn_stats() -> bool:
    """One-read BN statistics through the ``moments`` kernel at C % 128 == 0
    sites (``LHN_FUSED_BN=0`` opts out), the JAX package's gate of the same
    name."""
    return os.environ.get("LHN_FUSED_BN", "1") != "0"


def moments_site(C: int, n: int) -> bool:
    """Whether a train-mode BatchNorm over ``n`` values of each of ``C``
    channels takes its statistics from the ``moments`` kernel: at C % 128
    == 0, and at C < 128 with 128 % C == 0 and n * C % 128 == 0 when
    ``LHN_FUSED_BN_SMALLC=1`` (opt-in, as in JAX ``fused_bn.py:152-172``);
    never with ``LHN_FUSED_BN=0``."""
    if not use_fused_bn_stats():
        return False
    if C % 128 == 0:
        return True
    return (128 % C == 0 and (n * C) % 128 == 0
            and os.environ.get("LHN_FUSED_BN_SMALLC", "0") == "1")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks of ``group`` whose backward is the same sum of the
    gradients: every rank's loss reads every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_mean(x: torch.Tensor, group=None) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``group`` (JAX ``lax.pmean``),
    differentiable."""
    return _AllReduceSum.apply(x, group) / dist.get_world_size(group)


class TorchBatchNorm(nn.BatchNorm2d):
    """BatchNorm with the JAX package's train-mode semantics
    (``layers.py:125-214``), under ``nn.BatchNorm2d``'s names so state-dict
    keys, ``randomize_`` and ``fuse_params`` are unchanged.

    Train mode: two-pass batch mean and biased variance (through
    ``ops.fused_bn.moments`` where ``moments_site(C, n)``, or ``precomputed=(mean, var)`` from a fused producer); running mean and
    running variance of ``var * n / max(n - 1, 1)`` move by ``momentum``;
    the output is ``(x - mean) * (rsqrt(var + eps) * weight) + bias``. A
    single value per channel (the channel attention's 1x1 map at B = 1) is
    allowed, as in JAX. Eval mode is ``nn.BatchNorm2d``'s. With
    ``moves_running_stats`` False (inside :func:`rematerializing`) the train
    mode leaves the running statistics and ``num_batches_tracked`` alone.

    With a ``sync_group`` (SyncBN, ``set_sync_bn``; JAX ``axis_name``,
    :176-205) the statistics are the plain two-pass over every rank's
    values: the mean of the ranks' means, then the mean of the ranks'
    ``mean((x - mean)^2)``, with ``n`` times the world size; such a site
    never takes the ``moments`` kernel.

    Rank-2 ``[B, C]`` input (``BatchNorm1d``, BAM's channel gate) is taken
    as ``[B, C, 1, 1]``, so the statistics run through the same code and
    ``moments`` kernel.
    """

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-5, momentum=0.1)
        self.sync_group = None
        self.moves_running_stats = True

    def forward(self, x, precomputed=None):
        if x.dim() == 2:
            return self.forward(x[:, :, None, None], precomputed)[:, :, 0, 0]
        if not self.training:
            return super().forward(x)
        C = x.shape[1]
        n = x.numel() // C
        sync = self.sync_group
        if precomputed is not None:
            mean, var = precomputed
        elif sync is None and moments_site(C, n):
            mean, var = moments(x)
        else:
            # synced: per-rank shifts do not compose across the mean, so the
            # plain two-pass runs over every rank's values
            xf = x.to(torch.promote_types(x.dtype, torch.float32))
            mean = xf.mean(dim=(0, 2, 3))
            if sync is not None:
                mean = all_reduce_mean(mean, sync)
            var = (xf - mean.view(1, -1, 1, 1)).square().mean(dim=(0, 2, 3))
            if sync is not None:
                var = all_reduce_mean(var, sync)
                n *= dist.get_world_size(sync)
        if self.moves_running_stats:
            with torch.no_grad():
                m = self.momentum
                unbiased = var * (n / max(n - 1, 1))
                self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
                self.running_var.mul_(1.0 - m).add_(unbiased, alpha=m)
                self.num_batches_tracked.add_(1)
        view = (1, -1, 1, 1)
        mul = torch.rsqrt(var + self.eps) * self.weight
        return (x - mean.view(view)) * mul.view(view) + self.bias.view(view)


def BatchNorm(channels: int) -> TorchBatchNorm:
    return TorchBatchNorm(channels)


def set_sync_bn(model: nn.Module, group) -> None:
    """Point every ``TorchBatchNorm`` of ``model`` at the process group
    ``group`` (SyncBN, JAX ``get_model(cfg, axis_name=...)``), or back to
    per-rank statistics with None."""
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm):
            mod.sync_group = group


class ConvBN(nn.Module):
    """Bias-free conv followed by BatchNorm (reference ``conv_bn``)."""

    def __init__(self, in_channels, features, kernel, stride=1, padding=0,
                 dilation=1, groups=1):
        super().__init__()
        self.conv = Conv(in_channels, features, kernel, stride, padding,
                         dilation, groups, bias=False)
        self.bn = BatchNorm(features)

    def forward(self, x):
        return self.bn(self.conv(x))


def autopad(k, p=None):
    """'same'-output padding for odd kernels when ``p`` is unset (the
    YOLOv5 convention of the reference's ``Conv``, rep_pose_hg_ms_att.py:10)."""
    if p is None:
        p = k // 2 if isinstance(k, int) else tuple(x // 2 for x in k)
    return p


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


class ConvBnAct(nn.Module):
    """Bias-free conv, BatchNorm and activation under the reference's names
    ``conv`` and ``bn``: YOLOv6's ``SimConv``/``Conv`` (common.py:19-64)
    and the block library's ``Conv`` (rep_pose_hg_ms_att.py:6-18).

    ``act=True`` is SiLU, ``False``/``None`` identity, a callable is used as
    it is. With ``deploy=True`` it is the reference's ``forward_fuse``: one
    biased ``conv`` (the BatchNorm folded by ``reparam.fuse_params`` or
    ``rep_blocks.fuse_conv_bn``), then the activation.
    """

    def __init__(self, in_channels, features, kernel=1, stride=1,
                 padding=None, groups=1, act=True, deploy=False):
        super().__init__()
        self.act = act
        self.deploy = deploy
        self.conv = nn.Conv2d(in_channels, features, _pair(kernel),
                              _pair(stride), _pair(autopad(kernel, padding)),
                              groups=groups, bias=deploy)
        self.bn = None if deploy else BatchNorm(features)

    def forward(self, x):
        y = self.conv(x)
        if self.bn is not None:
            y = self.bn(y)
        if self.act is True:
            return F.silu(y)
        return self.act(y) if callable(self.act) else y


_DW_ACTS = {None: ("none", 0.01), relu: ("relu", 0.01),
            leaky_relu: ("leaky_relu", 0.01)}


def dw_kernel_spec(module: nn.Module) -> Optional[tuple]:
    """``(kernel size, dilation, act, slope)`` of a deploy ``RepConv`` or
    ``RepBlock`` whose ``rep`` is a "same" stride-1 depthwise conv with a
    bias that ``dw_conv_bias_act`` takes (k in 3, 5, 7; dilation 1 to 4;
    padding dilation * (k // 2)) and whose ``act`` is None, ReLU or leaky
    ReLU (slope 0.01); None for every other module. Read once a module."""
    spec = module.__dict__.get("_dw_spec", False)
    if spec is not False:
        return spec
    spec = None
    conv = getattr(module, "rep", None) if getattr(module, "deploy",
                                                   False) else None
    if isinstance(conv, nn.Conv2d) and module.act in _DW_ACTS:
        C, k, d = conv.in_channels, conv.kernel_size[0], conv.dilation[0]
        if (conv.groups == C == conv.out_channels and conv.bias is not None
                and conv.kernel_size == (k, k) and k in KERNEL_SIZES
                and conv.dilation == (d, d) and 1 <= d <= MAX_DILATION
                and conv.stride == (1, 1)
                and conv.padding == (d * (k // 2),) * 2
                and conv.padding_mode == "zeros"):
            spec = (k, d) + _DW_ACTS[module.act]
    module._dw_spec = spec
    return spec


_AUTOCAST_ELIGIBLE = (torch.float32, torch.float16, torch.bfloat16)


def conv_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype ``F.conv2d`` computes ``x`` in under the current autocast
    state of x's device."""
    kind = x.device.type
    if x.dtype in _AUTOCAST_ELIGIBLE and torch.is_autocast_enabled(kind):
        return torch.get_autocast_dtype(kind)
    return x.dtype


def dw_kernel_route(module: nn.Module, x: torch.Tensor
                    ) -> Optional[torch.dtype]:
    """The route: the dtype in which a deploy ``RepConv`` or ``RepBlock``
    runs ``x`` through ``dw_conv_bias_act``, or None where it keeps ``rep``
    and the activation. Routed only with ``dw_kernel_spec``, x on CUDA, no
    gradient needed, bfloat16 or float32 after autocast (a cast x dense
    channels_last), and a shape the kernel's ``plan`` tiles."""
    spec = dw_kernel_spec(module)
    if spec is None or not x.is_cuda:
        return None
    conv = module.rep
    if torch.is_grad_enabled() and (x.requires_grad or conv.weight.requires_grad
                                    or conv.bias.requires_grad):
        return None
    dtype = conv_dtype(x)
    if dtype not in (torch.bfloat16, torch.float32) or (
            dtype != x.dtype
            and not x.is_contiguous(memory_format=torch.channels_last)):
        return None
    # a cast of a dense channels_last x keeps its strides
    if launch_plan(x, spec[0], spec[1], dtype=dtype) is None:
        return None
    return dtype


def deploy_params(module: nn.Module, dtype: torch.dtype) -> tuple:
    """``module.rep``'s weight and bias in ``dtype``: the parameters
    themselves where they are in it, else a copy made once per module,
    dtype, device and weight version (an in-place update makes a new
    one)."""
    w, b = module.rep.weight, module.rep.bias
    if w.dtype == dtype and b.dtype == dtype:
        return w, b
    key = (w.device, w.data_ptr(), w._version, b._version)
    casts = module.__dict__.setdefault("_deploy_casts", {})
    cached = casts.get(dtype)
    if cached is None or cached[0] != key:
        cached = casts[dtype] = (key, w.detach().to(dtype),
                                 b.detach().to(dtype))
    return cached[1], cached[2]


def deploy_conv(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """``module.rep(x)``. On the card under autocast and without gradients
    the conv takes its weight and bias already cast to the autocast dtype
    (``deploy_params``), so autocast finds nothing to cast: the same bits
    as its own casts, without their two dispatches and kernels a conv on
    every call."""
    conv = module.rep
    kind = x.device.type
    if (kind == "cuda" and not torch.is_grad_enabled()
            and torch.is_autocast_enabled(kind)
            and x.dtype in _AUTOCAST_ELIGIBLE
            and conv.weight.dtype in _AUTOCAST_ELIGIBLE):
        w, b = deploy_params(module, torch.get_autocast_dtype(kind))
        return conv._conv_forward(x, w, b)
    return conv(x)


def deploy_forward(module: nn.Module, x: torch.Tensor) -> torch.Tensor:
    """A deploy ``RepConv``'s or ``RepBlock``'s output: through
    ``dw_conv_bias_act`` where ``dw_kernel_route`` says so (x cast as
    autocast casts it, the conv's float32 taps and bias), else
    ``deploy_conv`` and the activation."""
    dtype = dw_kernel_route(module, x)
    if dtype is not None:
        _, d, act, slope = module._dw_spec
        w, b = deploy_params(module, torch.float32)
        return dw_conv_bias_act(x.to(dtype), w, b, d, act, slope)
    out = deploy_conv(module, x)
    return out if module.act is None else module.act(out)


class RepConv(nn.Module):
    """Conv+BN that fuses to one biased conv at deploy time
    (reference ``repblocks.py:23-73``).

    In train mode a depthwise 3x3 stride-1 conv with ``padding ==
    dilation`` runs through ``ops.fused_bn.dw_conv3x3_stats`` when
    ``LHN_FUSED_DW=1`` (``layers.py:278-292, 306-322``): the conv's epilogue
    gives the BN its statistics.
    """

    def __init__(self, in_channels, features, kernel=1, stride=1, padding=0,
                 dilation=1, groups=1, act: Activation = leaky_relu,
                 deploy=False):
        super().__init__()
        self.act = act
        self.deploy = deploy
        if deploy:
            self.rep = Conv(in_channels, features, kernel, stride, padding,
                            dilation, groups, bias=True)
        else:
            self.conv = ConvBN(in_channels, features, kernel, stride, padding,
                               dilation, groups)

    def forward(self, x):
        if self.deploy:
            return deploy_forward(self, x)
        if self.training and self._dw_fusable(x):
            conv = self.conv.conv
            y, mean, var = dw_conv3x3_stats(x, conv.weight, conv.dilation[0])
            out = self.conv.bn(y, precomputed=(mean, var))
        else:
            out = self.conv(x)
        return out if self.act is None else self.act(out)

    def _dw_fusable(self, x) -> bool:
        if os.environ.get("LHN_FUSED_DW", "0") != "1":
            return False
        conv = self.conv.conv
        C = x.shape[1]
        d = conv.dilation[0]
        return (
            use_fused_bn_stats()
            and self.conv.bn.sync_group is None
            and conv.groups == C and conv.out_channels == C
            and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
            and conv.dilation == (d, d) and conv.padding == (d, d)
            and dw_conv3x3_stats_supported(tuple(x.shape), x.dtype, d)
        )


class RepBlock(nn.Module):
    """RepVGG block: kxk + 1x1 + identity-BN branches, fused at deploy
    (reference ``repblocks.py:76-236``)."""

    def __init__(self, in_channels, features, kernel=3, stride=1, padding=1,
                 dilation=1, groups=1, act: Activation = leaky_relu,
                 deploy=False):
        super().__init__()
        self.act = act
        self.deploy = deploy
        if deploy:
            self.rep = Conv(in_channels, features, kernel, stride, padding,
                            dilation, groups, bias=True)
            return
        self.rbr_dense = ConvBN(in_channels, features, kernel, stride,
                                padding, dilation, groups)
        self.rbr_1x1 = ConvBN(in_channels, features, 1, stride, 0, 1, groups)
        if in_channels == features and stride == 1:
            self.rbr_identity = BatchNorm(in_channels)
        else:
            self.rbr_identity = None

    def forward(self, x):
        if self.deploy:
            return deploy_forward(self, x)
        out = self.rbr_dense(x) + self.rbr_1x1(x)
        if self.rbr_identity is not None:
            out = out + self.rbr_identity(x)
        return out if self.act is None else self.act(out)


def adaptive_avg_pool(x: torch.Tensor, output_size) -> torch.Tensor:
    """Adaptive average pooling; region i spans
    ``[floor(i*S/O), ceil((i+1)*S/O))``, the JAX package's rule."""
    return F.adaptive_avg_pool2d(x, output_size)


class SEBlock(nn.Module):
    """Squeeze-and-excitation gate (reference ``common.py:23-37``)."""

    def __init__(self, channels, internal):
        super().__init__()
        self.down = Conv(channels, internal, 1)
        self.up = Conv(internal, channels, 1)

    def forward(self, x):
        s = x.mean(dim=(2, 3), keepdim=True)
        s = self.up(F.relu(self.down(s)))
        return x * torch.sigmoid(s)


class Dropout(nn.Module):
    """Element-wise dropout, flax ``Dropout`` without broadcast dims: each
    element is kept with probability 1 - p and scaled by 1 / (1 - p). Draws
    from ``generator`` (set by the train step through
    :func:`set_dropout_generator`), else from PyTorch's default generator.
    Identity in eval mode and at p = 0."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def mask_shape(self, x: torch.Tensor):
        return x.shape

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep_prob = 1.0 - self.p
        u = torch.rand(self.mask_shape(x), generator=self.generator,
                       device=x.device)
        return torch.where(u < keep_prob, x / keep_prob, torch.zeros_like(x))


class ChannelDropout(Dropout):
    """Dropout of whole channels, flax ``Dropout(broadcast_dims=(1, 2))`` on
    the NHWC side: each (b, c) is kept with probability 1 - p and scaled by
    1 / (1 - p)."""

    def mask_shape(self, x: torch.Tensor):
        return (x.shape[0], x.shape[1], 1, 1)


def set_dropout_generator(model: nn.Module,
                          generator: Optional[torch.Generator]) -> None:
    """Point every ``Dropout`` (``ChannelDropout`` included) of ``model`` at
    ``generator``."""
    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.generator = generator


@contextlib.contextmanager
def rematerializing(model: nn.Module,
                    generator: Optional[torch.Generator] = None):
    """The context of a second forward of ``model`` that rebuilds the first
    one's activations (a checkpoint's recompute in the backward): no
    ``TorchBatchNorm`` moves its running statistics, which the first forward
    moved, and every ``Dropout`` draws from ``generator``, a generator in
    the state the first forward's started from, so it draws the same masks.
    Both are put back on exit."""
    norms = [m for m in model.modules() if isinstance(m, TorchBatchNorm)]
    drops = [m for m in model.modules() if isinstance(m, Dropout)]
    before = [m.generator for m in drops]
    for m in norms:
        m.moves_running_stats = False
    for m in drops:
        m.generator = generator
    try:
        yield
    finally:
        for m in norms:
            m.moves_running_stats = True
        for m, g in zip(drops, before):
            m.generator = g


class ChannelAttention(nn.Module):
    """3x3-pooled depthwise gate (reference ``common.py:40-90``). Deploy
    fuses ``conv3x3`` (conv+BN) into ``att_rep``. In train mode the gate
    MLP starts with channel dropout at p = 0.3."""

    def __init__(self, channels, deploy=False):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.att_rep = Conv(channels, channels, 3, 1, 0, groups=channels)
        else:
            self.conv3x3 = ConvBN(channels, channels, 3, 1, 0, groups=channels)
        self.conv1x1 = nn.Sequential(
            ChannelDropout(0.3),
            Conv(channels, channels // 2, 1),
            nn.LeakyReLU(),
            Conv(channels // 2, channels, 1),
        )

    def forward(self, x):
        y = adaptive_avg_pool(x, (3, 3))
        att = self.att_rep(y) if self.deploy else self.conv3x3(y)
        return x * torch.sigmoid(self.conv1x1(att))


def resize_nearest(x: torch.Tensor, size) -> torch.Tensor:
    """Nearest resize to ``(h, w)``: pixel repeat for integer factors, the
    half-pixel rule otherwise (both as ``jax.image.resize``)."""
    if tuple(x.shape[2:]) == tuple(size):
        return x
    return F.interpolate(x, size=tuple(size), mode="nearest-exact")


def resize_dtype(x: torch.Tensor) -> torch.dtype:
    """The dtype ``resize_nearest`` hands ``x`` on in when it resizes it:
    CUDA autocast runs every upsample in float32 (its float32 list), so a
    bfloat16 or float16 x comes back float32 there; elsewhere x's own."""
    if (x.is_cuda and x.dtype in (torch.float16, torch.bfloat16)
            and torch.is_autocast_enabled("cuda")):
        return torch.float32
    return x.dtype


def max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 stride-2 max pool in ceil mode."""
    return F.max_pool2d(x, 2, 2, ceil_mode=True)


def channel_shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    """ShuffleNet channel shuffle of NCHW (reference ``common.py:6-20``):
    channel ``g * (C / groups) + i`` moves to ``i * groups + g``."""
    B, C, H, W = x.shape
    return x.reshape(B, groups, C // groups, H, W).transpose(1, 2).reshape(
        B, C, H, W)


def head_output(x: torch.Tensor) -> torch.Tensor:
    """Heatmaps in float32 from a bfloat16 or float32 model, as JAX's
    heads cast them; a float64 model's stay float64."""
    return x.to(torch.promote_types(x.dtype, torch.float32))
