"""RepVGG re-parameterization (port of ``litehandnet_tpu/models/reparam.py``).

``fuse_params(train_model)`` maps the train graph's weights and BatchNorm
running statistics to the ``state_dict`` of the same model built with
``deploy=True``, where every RepConv, RepBlock and ChannelAttention is one
biased conv and BatchNorm is gone. Per output channel o (OIHW kernels):

    t_o = gamma_o / sqrt(var_o + eps),  K' = K * t,  b' = beta - mean * t

RepBlock adds its 1x1 branch zero-padded to kxk and its identity-BN branch as
a delta kernel (reference ``repblocks.py:169-212``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import (
    ChannelAttention,
    ConvBN,
    RepBlock,
    RepConv,
)

BN_EPS = 1e-5


def _bn_scale(bn: nn.BatchNorm2d) -> torch.Tensor:
    return bn.weight / torch.sqrt(bn.running_var + BN_EPS)


def _fuse_conv_bn(cb: ConvBN):
    t = _bn_scale(cb.bn)
    return cb.conv.weight * t[:, None, None, None], cb.bn.bias - cb.bn.running_mean * t


def _fuse_bn_identity(bn: nn.BatchNorm2d, kernel_size: int, in_per_group: int):
    """Identity-BN branch as an equivalent kxk delta-kernel conv."""
    features = bn.num_features
    mid = kernel_size // 2
    kernel = torch.zeros(features, in_per_group, kernel_size, kernel_size,
                         dtype=bn.weight.dtype, device=bn.weight.device)
    o = torch.arange(features)
    kernel[o, o % in_per_group, mid, mid] = 1.0
    t = _bn_scale(bn)
    return kernel * t[:, None, None, None], bn.bias - bn.running_mean * t


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
