"""AttHandNet ("Attention! A Lightweight 2D Hand Pose Estimation Approach";
port of ``litehandnet_tpu/models/atthandnet.py``; reference
``AttentionHandNet/{__init__,attention_augmentation2D,blur,mish}.py``).

DenseNet-style ARB blocks with attention-augmented convolutions, BlurPool
anti-aliased downsampling, Mish, and a direct ``[B, 21, 2]`` coordinate
head, ``min(relu(x), 1)``. The attention runs over all H * W positions with
width- and height-relative logits in plain PyTorch; its learned relative
embeddings have the size of the map they attend over, so the model is built
for one input size (``cfg.DATASET.image_size``; seven BlurPool halvings,
224 -> 2). Submodule names are the reference torch names of
``utils/torch_import.py``'s ``_atthandnet_rules`` (:675-705):
``dense{i}.arb.{j}.{conv1,attention_aug,conv2}``,
``transition{i}.{conv,activation,batch_normalization}``, ``dense8``,
``aug_block`` and ``conv``.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from litehandnet_tpu_torch.models.layers import BatchNorm, Conv, head_output


def mish(x: torch.Tensor) -> torch.Tensor:
    """Mish activation (reference mish.py:7-12)."""
    return F.mish(x)


_BINOMIAL = {
    1: [1.0],
    2: [1.0, 1.0],
    3: [1.0, 2.0, 1.0],
    4: [1.0, 3.0, 3.0, 1.0],
    5: [1.0, 4.0, 6.0, 4.0, 1.0],
}


def binomial_filter(channels: int, filt_size: int = 3) -> torch.Tensor:
    """The normalized binomial blur as a depthwise ``[C, 1, k, k]`` kernel
    (reference blur.py:13-53)."""
    a = torch.tensor(_BINOMIAL[filt_size], dtype=torch.float32)
    filt = a[:, None] * a[None, :]
    filt = filt / filt.sum()
    return filt[None, None].repeat(channels, 1, 1, 1)


def blur_pool(x: torch.Tensor, filt: torch.Tensor, stride: int = 2
              ) -> torch.Tensor:
    """Anti-aliased downsampling (reference blur.py:13-53): reflect pad,
    then the depthwise ``filt`` ``[C, 1, k, k]`` at ``stride``."""
    k = filt.shape[-1]
    lo, hi = (k - 1) // 2, -(-(k - 1) // 2)
    x = F.pad(x, (lo, hi, lo, hi), mode="reflect")
    return F.conv2d(x, filt.to(x.dtype), stride=stride, groups=x.shape[1])


def blurred_size(size: int, filt_size: int = 3, stride: int = 2) -> int:
    """A side after :func:`blur_pool`."""
    return (size + filt_size - 1 - filt_size) // stride + 1


class BlurPool(nn.Module):
    """:func:`blur_pool` with its filter as the buffer ``filt``, as the
    reference's module keeps it (so a reference state dict loads)."""

    def __init__(self, channels: int, filt_size: int = 3, stride: int = 2):
        super().__init__()
        self.stride = stride
        self.register_buffer("filt", binomial_filter(channels, filt_size))

    def forward(self, x):
        return blur_pool(x, self.filt, self.stride)


def rel_to_abs(x: torch.Tensor) -> torch.Tensor:
    """``[B, Nh, L, 2L-1]`` relative logits -> ``[B, Nh, L, L]`` absolute
    (reference attention_augmentation2D.py:128-140)."""
    B, Nh, L, _ = x.shape
    x = torch.cat([x, x.new_zeros(B, Nh, L, 1)], dim=3)
    flat = x.reshape(B, Nh, L * 2 * L)
    flat = torch.cat([flat, x.new_zeros(B, Nh, L - 1)], dim=2)
    return flat.reshape(B, Nh, L + 1, 2 * L - 1)[:, :, :L, L - 1:]


class AugmentedConv(nn.Module):
    """Attention-augmented convolution (reference
    attention_augmentation2D.py:10-140): ``conv_out`` gives out - dv
    channels, multi-head self-attention over the H * W positions with
    relative logits (``key_rel_w`` ``[2W-1, dk/Nh]``, ``key_rel_h``
    ``[2H-1, dk/Nh]``) gives dv more through ``attn_out``. ``shape`` is the
    (H, W) of the map it attends over.

    The reference's quirk is kept (attention_augmentation2D.py:70): the
    ``[B, Nh, H*W, dv/Nh]`` attention result is reshaped straight to
    ``[B, dv, H, W]``, a reinterpretation of its memory, not a transpose.
    """

    def __init__(self, in_channels, out_channels, kernel, shape: Tuple[int, int],
                 dk_ratio=0.1, dv_ratio=0.1, num_heads=4):
        super().__init__()
        dk = int(dk_ratio * out_channels)
        dv = int(dv_ratio * out_channels)
        if dk % num_heads or dv % num_heads:
            raise ValueError(f"dk {dk} and dv {dv} must divide by the "
                             f"{num_heads} heads")
        self.dk, self.dv, self.num_heads, self.kernel = dk, dv, num_heads, kernel
        H, W = shape
        self.conv_out = Conv(in_channels, out_channels - dv, kernel, 1,
                             (kernel - 1) // 2)
        self.qkv_conv = Conv(in_channels, 2 * dk + dv, 1)
        self.attn_out = Conv(dv, dv, 1)
        self.key_rel_w = nn.Parameter(torch.randn(2 * W - 1, dk // num_heads))
        self.key_rel_h = nn.Parameter(torch.randn(2 * H - 1, dk // num_heads))

    def forward(self, x):
        dk, dv, Nh = self.dk, self.dv, self.num_heads
        xc = F.pad(x, (0, 1, 0, 1)) if self.kernel % 2 == 0 else x
        conv_out = self.conv_out(xc)
        B, _, H, W = conv_out.shape
        q, k, v = torch.split(self.qkv_conv(x), [dk, dk, dv], dim=1)
        dkh = dk // Nh

        def heads(t, d):  # [B, d, H, W] -> [B, Nh, H, W, d / Nh]
            return t.reshape(B, Nh, d // Nh, H, W).permute(0, 1, 3, 4, 2)

        q = heads(q, dk) * dkh ** -0.5
        k = heads(k, dk)
        v = heads(v, dv)
        logits = torch.einsum("bnxyd,bnuvd->bnxyuv", q, k).reshape(
            B, Nh, H * W, H * W)
        # width-relative
        rel_w = torch.einsum("bnxyd,md->bnxym", q, self.key_rel_w)
        rel_w = rel_to_abs(rel_w.reshape(B, Nh * H, W, 2 * W - 1))
        rel_w = rel_w.reshape(B, Nh, H, 1, W, W).expand(B, Nh, H, H, W, W)
        logits = logits + rel_w.permute(0, 1, 2, 4, 3, 5).reshape(
            B, Nh, H * W, H * W)
        # height-relative: x and y swapped
        qt = q.transpose(2, 3)  # [B, Nh, W, H, dkh]
        rel_h = torch.einsum("bnxyd,md->bnxym", qt, self.key_rel_h)
        rel_h = rel_to_abs(rel_h.reshape(B, Nh * W, H, 2 * H - 1))
        rel_h = rel_h.reshape(B, Nh, W, 1, H, H).expand(B, Nh, W, W, H, H)
        logits = logits + rel_h.permute(0, 1, 4, 2, 5, 3).reshape(
            B, Nh, H * W, H * W)

        weights = torch.softmax(logits, dim=-1)
        # v flattened channels-first over (H, W): [B, Nh, dv/Nh, H*W]
        flat_v = v.permute(0, 1, 4, 2, 3).reshape(B, Nh, dv // Nh, H * W)
        attn = torch.einsum("bnqk,bndk->bnqd", weights, flat_v)
        attn = attn.contiguous().reshape(B, dv, H, W)   # the raw reshape
        return torch.cat([conv_out, self.attn_out(attn)], dim=1)


def _aug_block(in_channels, out_channels, kernel, shape, num_heads):
    """AugmentedConv, BatchNorm, Mish (reference __init__.py:36-43)."""
    return nn.Sequential(
        AugmentedConv(in_channels, out_channels, kernel, shape,
                      num_heads=num_heads),
        BatchNorm(out_channels), nn.Mish())


class ARBAdd(nn.Module):
    """Attention-augmented residual block with an additive merge
    (reference __init__.py:46-76): ``conv1`` (1x1, BN, Mish, depthwise kxk,
    BN, Mish), ``attention_aug`` added to it, ``conv2`` (1x1, BN, Mish). An
    even kernel pads the input by one row and column at the bottom and
    right, which its unpadded depthwise conv consumes."""

    def __init__(self, in_channels, out_channels, kernel, shape, aug=True,
                 num_heads=4):
        super().__init__()
        mid = out_channels * 4
        self.kernel = kernel
        self.conv1 = nn.Sequential(
            Conv(in_channels, mid, 1), BatchNorm(mid), nn.Mish(),
            Conv(mid, mid, kernel, 1, (kernel - 1) // 2, groups=mid),
            BatchNorm(mid), nn.Mish())
        self.attention_aug = (_aug_block(mid, mid, kernel, shape, num_heads)
                              if aug else None)
        self.conv2 = nn.Sequential(Conv(mid, out_channels, 1),
                                   BatchNorm(out_channels), nn.Mish())

    def forward(self, x):
        if self.kernel % 2 == 0:
            x = F.pad(x, (0, 1, 0, 1))
        h = self.conv1(x)
        if self.attention_aug is not None:
            h = self.attention_aug(h) + h
        return self.conv2(h)


class DenseBlock(nn.Module):
    """Dense connectivity over ARB blocks ``arb.{i}`` (reference
    __init__.py:141-160): each block reads the concatenation of the input
    and every earlier block's output."""

    def __init__(self, in_channels, growth_rate, kernel, iteration, shape,
                 num_heads=4, aug=True):
        super().__init__()
        self.arb = nn.ModuleList(
            ARBAdd(in_channels + i * growth_rate, growth_rate, kernel, shape,
                   aug, num_heads)
            for i in range(iteration))
        self.out_channels = in_channels + iteration * growth_rate

    def forward(self, x):
        outs = [x]
        cur = x
        for block in self.arb:
            outs.append(block(cur))
            cur = torch.cat(outs, dim=1)
        return cur


class Transition(nn.Module):
    """1x1 ``conv``, BlurPool ``activation`` and BN ``batch_normalization``
    (reference __init__.py:163-174)."""

    def __init__(self, in_channels, out_channels):
        super().__init__()
        self.conv = Conv(in_channels, out_channels, 1)
        self.activation = BlurPool(out_channels)
        self.batch_normalization = BatchNorm(out_channels)

    def forward(self, x):
        return self.batch_normalization(self.activation(self.conv(x)))


class AttHandNet(nn.Module):
    """light_Model (reference __init__.py:177-237). Output ``[B, K, 2]``
    float32 normalized coordinates, ``min(relu(x), 1)``."""

    # (growth, kernel, iterations, heads, aug, transition out) per stage
    STAGES = (
        (10, 5, 8, 4, False, 64),
        (10, 5, 8, 4, False, 64),
        (10, 3, 6, 1, True, 64),
        (10, 3, 8, 4, True, 64),
        (10, 3, 10, 4, True, 64),
        (10, 3, 12, 4, True, 128),
        (10, 3, 14, 4, True, 128),
    )
    # the last dense block (growth, kernel, iterations, heads, aug)
    FINAL = (10, 2, 32, 4, True)

    def __init__(self, num_joints=21, image_size=(224, 224)):
        super().__init__()
        self.num_joints = num_joints
        W, H = image_size
        c = 3
        for i, (g, k, it, nh, aug, t_out) in enumerate(self.STAGES):
            dense = DenseBlock(c, g, k, it, (H, W), nh, aug)
            self.add_module(f"dense{i + 1}", dense)
            self.add_module(f"transition{i + 1}",
                            Transition(dense.out_channels, t_out))
            c = t_out
            H, W = blurred_size(H), blurred_size(W)
        g, k, it, nh, aug = self.FINAL
        self.dense8 = DenseBlock(c, g, k, it, (H, W), nh, aug)
        self.aug_block = _aug_block(self.dense8.out_channels, 100, 2, (H, W),
                                    10)
        self.conv = Conv(100, num_joints * 2, 1)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "AttHandNet":
        del deploy  # no Rep modules in this family
        return cls(num_joints=cfg.MODEL.get("output_channel", 42) // 2,
                   image_size=tuple(cfg.DATASET.image_size))

    def forward(self, x):
        for i in range(len(self.STAGES)):
            x = getattr(self, f"dense{i + 1}")(x)
            x = getattr(self, f"transition{i + 1}")(x)
        x = self.aug_block(self.dense8(x))
        x = torch.clamp(F.relu(self.conv(F.avg_pool2d(x, 2, 2))), max=1.0)
        return head_output(x.reshape(x.shape[0], self.num_joints, 2))
