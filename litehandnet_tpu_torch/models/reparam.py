"""RepVGG re-parameterization (port of ``litehandnet_tpu/models/reparam.py``).

``fuse_params(train_model)`` maps the train graph's weights and BatchNorm
running statistics to the ``state_dict`` of the same model built with
``deploy=True``, where every RepConv, RepBlock, ConvBnAct and
ChannelAttention is one biased conv and BatchNorm is gone. Per output
channel o (OIHW kernels), :func:`fold_bn`:

    t_o = gamma_o / sqrt(var_o + eps),  K' = K * t,  b' = beta - (mean - b) * t

RepBlock adds its 1x1 branch zero-padded to kxk and its identity-BN branch as
a delta kernel (reference ``repblocks.py:169-212``).

``fold_input_normalization`` folds ``(x - mean) / std`` into a deploy
graph's first conv, so that it reads raw pixels.
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    ChannelAttention,
    ConvBnAct,
    RepBlock,
    RepConv,
)

BN_EPS = 1e-5


def fold_bn(weight, gamma, beta, mean, var, bias=None):
    """A conv (OIHW ``weight``, optional ``bias``) followed by an eval-mode
    BatchNorm as one biased conv: ``(weight * t, beta - (mean - bias) * t)``
    with ``t = gamma / sqrt(var + eps)`` per output channel."""
    t = gamma / torch.sqrt(var + BN_EPS)
    shift = mean if bias is None else mean - bias
    return weight * t[:, None, None, None], beta - shift * t


def _bn_leaves(bn: nn.BatchNorm2d):
    return bn.weight, bn.bias, bn.running_mean, bn.running_var


def _fuse_conv_bn(cb):
    """A module's ``conv`` and ``bn`` children (``ConvBN``, ``ConvBnAct``)
    as one biased conv."""
    return fold_bn(cb.conv.weight, *_bn_leaves(cb.bn))


def _fuse_bn_identity(bn: nn.BatchNorm2d, kernel_size: int, in_per_group: int):
    """Identity-BN branch as an equivalent kxk delta-kernel conv."""
    features = bn.num_features
    mid = kernel_size // 2
    kernel = torch.zeros(features, in_per_group, kernel_size, kernel_size,
                         dtype=bn.weight.dtype, device=bn.weight.device)
    o = torch.arange(features)
    kernel[o, o % in_per_group, mid, mid] = 1.0
    return fold_bn(kernel, *_bn_leaves(bn))


def _pad_1x1_to_kxk(kernel: torch.Tensor, k: int) -> torch.Tensor:
    pad = k // 2
    return F.pad(kernel, (pad, pad, pad, pad))


def _fuse_module(mod: nn.Module):
    """(deploy child, fused weight, fused bias, train branches it replaces)
    of one Rep module, or None for any other module."""
    if isinstance(mod, RepConv):
        return ("rep",) + _fuse_conv_bn(mod.conv) + (("conv",),)
    if isinstance(mod, RepBlock):
        _, in_per_group, kh, _ = mod.rbr_dense.conv.weight.shape
        kernel, bias = _fuse_conv_bn(mod.rbr_dense)
        k1, b1 = _fuse_conv_bn(mod.rbr_1x1)
        kernel = kernel + _pad_1x1_to_kxk(k1, kh)
        bias = bias + b1
        if mod.rbr_identity is not None:
            kid, bid = _fuse_bn_identity(mod.rbr_identity, kh, in_per_group)
            kernel = kernel + kid
            bias = bias + bid
        return "rep", kernel, bias, ("rbr_dense", "rbr_1x1", "rbr_identity")
    if isinstance(mod, ConvBnAct):
        return ("conv",) + _fuse_conv_bn(mod) + (("conv", "bn"),)
    if isinstance(mod, ChannelAttention):
        return ("att_rep",) + _fuse_conv_bn(mod.conv3x3) + (("conv3x3",),)
    return None


@torch.no_grad()
def fuse_params(model: nn.Module) -> Dict[str, torch.Tensor]:
    """Deploy-graph ``state_dict`` of a train-graph model.

    Load the result into the same model built with ``deploy=True``
    (``load_state_dict`` is strict, so a missed branch fails loudly).
    """
    sd = model.state_dict()
    out: Dict[str, torch.Tensor] = {}
    fused_prefixes: List[str] = []
    for name, mod in model.named_modules():
        if getattr(mod, "deploy", False):
            raise ValueError(f"{name or 'model'} is already a deploy graph")
        fused = _fuse_module(mod)
        if fused is None:
            continue
        child, weight, bias, branches = fused
        prefix = f"{name}." if name else ""
        out[f"{prefix}{child}.weight"] = weight
        out[f"{prefix}{child}.bias"] = bias
        fused_prefixes.extend(f"{prefix}{b}." for b in branches)
    for key, value in sd.items():
        if not any(key.startswith(p) for p in fused_prefixes):
            out[key] = value
    return out


@torch.no_grad()
def fold_input_normalization(state_dict: Dict[str, torch.Tensor], mean, std,
                             conv: str = "pre.conv1.0.rep"
                             ) -> Dict[str, torch.Tensor]:
    """Fold ``(x - mean) / std`` input normalization into the first conv
    (JAX ``reparam.py:118-176``): for an OIHW kernel K and bias b,

        conv((x - mean) / std; K, b) == conv(x; K / std, b - sum K / std @ mean)

    wherever the conv window reads only real pixels, in particular for a
    VALID-padded first conv. Where zero padding is read, a padded zero now
    means raw 0 (normalized ``-mean / std``), so the first map's border ring
    shifts; in nets with global pooling on the trunk (LiteHandNet's encoder
    shortcut and channel gates) that reaches every output, so validate such
    models with their trained weights first.

    Args:
        state_dict: a deploy graph's ``state_dict`` (from ``fuse_params``).
        mean, std: per input channel, in the raw input's units (for 0..255
            pixels, the ImageNet statistics times 255).
        conv: the first conv's module name; LiteHandNet's fused stem conv
            by default.

    Returns:
        A new dict: the folded ``<conv>.weight`` and ``<conv>.bias``, every
        other entry the same tensor as in ``state_dict``.
    """
    weight = state_dict[f"{conv}.weight"]
    bias = state_dict[f"{conv}.bias"]
    mean = torch.as_tensor(mean, dtype=torch.float32, device=weight.device)
    std = torch.as_tensor(std, dtype=torch.float32, device=weight.device)
    folded = weight.float() / std[None, :, None, None]
    shift = torch.einsum("oihw,i->o", folded, mean)
    out = dict(state_dict)
    out[f"{conv}.weight"] = folded.to(weight.dtype)
    out[f"{conv}.bias"] = (bias.float() - shift).to(bias.dtype)
    return out
