"""Legacy photometric and geometric augmentation ops of the Gen-1 lineage
(port of ``litehandnet_tpu/ops/photometric.py``; reference
utils/data_augmentation.py:14-175 and datasets/data_pipeline/mosaic.py).

Gamma, sigmoid contrast, horizontal flip, central scale, homography warp and
a 4-image mosaic, on the tensor's own device. Each takes JAX's per-image
shapes (``img [H, W, C]``, ``joints [K, 2]``) or the same with leading batch
axes, as ``jax.vmap`` of the JAX function would.

``mosaic4`` resizes its canvas with ``F.interpolate(mode="bilinear",
antialias=True)``: that is ``jax.image.resize(..., "bilinear")`` in both
directions, a triangle filter widened by the scale when it shrinks (JAX
antialiases by default) and plain half-pixel bilinear with clamped edges
when it grows. Its jittered center is drawn from a ``torch.Generator``
where JAX splits a PRNG key.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.data.device_pipeline import _bilinear_sample
from litehandnet_tpu_torch.ops.affine import get_affine_transform


def adjust_gamma(img: torch.Tensor, gamma: float = 1.0) -> torch.Tensor:
    """Gamma correction of [0, 255] images (reference :14-30)."""
    img = img.clamp(0.0, 255.0) / 255.0
    return torch.pow(img, gamma) * 255.0


def adjust_sigmoid(img: torch.Tensor, cutoff: float = 0.5,
                   gain: float = 10.0) -> torch.Tensor:
    """Sigmoid contrast adjustment (reference :33-47)."""
    img = img.clamp(0.0, 255.0) / 255.0
    return 255.0 / (1.0 + torch.exp(gain * (cutoff - img)))


def horizontal_flip(img: torch.Tensor, joints: torch.Tensor,
                    flip_index: Sequence[int]) -> tuple:
    """Mirror the image ``[..., H, W, C]`` and its joints ``[..., K, 2]``,
    swapping left and right joints by ``flip_index`` (reference :96-118)."""
    W = img.shape[-2]
    flipped = torch.flip(img, dims=(-2,))
    j = torch.cat([W - 1.0 - joints[..., :1], joints[..., 1:]], dim=-1)
    index = torch.as_tensor(flip_index, dtype=torch.long, device=j.device)
    return flipped, j.index_select(-2, index)


def _pixel_grid(H: int, W: int, device) -> torch.Tensor:
    """``[H, W, 3]`` homogeneous pixel coordinates (x, y, 1)."""
    ys, xs = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=device),
        torch.arange(W, dtype=torch.float32, device=device), indexing="ij")
    return torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)


def _sample(img: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of ``img [..., H0, W0, C]`` at ``src [..., H, W, 2]``
    (x, y), zero outside; float32."""
    lead = img.shape[:-3]
    H0, W0, C = img.shape[-3:]
    H, W = src.shape[-3:-1]
    src = src.expand(*lead, H, W, 2).reshape(-1, H, W, 2)
    out = _bilinear_sample(img.reshape(-1, H0, W0, C).float(),
                           src[..., 0], src[..., 1])
    return out.reshape(*lead, H, W, C)


def _homogeneous(joints: torch.Tensor) -> torch.Tensor:
    return torch.cat([joints[..., :2], torch.ones_like(joints[..., :1])], -1)


def central_scale(img: torch.Tensor, joints: torch.Tensor,
                  scale: float) -> tuple:
    """Zoom about the image center by ``scale`` (reference :150-175), through
    the affine crop machinery."""
    H, W = img.shape[-3:-1]
    dev = img.device
    center = torch.tensor([W / 2, H / 2], dtype=torch.float32, device=dev)
    s = torch.tensor([W / 200.0 / scale, H / 200.0 / scale],
                     dtype=torch.float32, device=dev)
    inv = get_affine_transform(center, s, 0.0, (W, H), inv=True)
    fwd = get_affine_transform(center, s, 0.0, (W, H))
    src = torch.einsum("ij,hwj->hwi", inv, _pixel_grid(H, W, dev))
    return (_sample(img, src),
            torch.einsum("ij,...kj->...ki", fwd, _homogeneous(joints)))


def _dehomogenize(p: torch.Tensor) -> torch.Tensor:
    """x / w with the sign of w kept and |w| floored at 1e-6, as JAX does."""
    w = p[..., 2:]
    return p[..., :2] / torch.clamp(w.abs(), min=1e-6) * torch.sign(w)


def homography_warp(img: torch.Tensor, joints: torch.Tensor,
                    matrix: torch.Tensor) -> tuple:
    """Warp the image ``[..., H, W, C]`` and its joints ``[..., K, 2]`` by a
    3x3 homography ``[..., 3, 3]`` (reference :50-93): every output pixel
    samples the source at the inverse map."""
    H, W = img.shape[-3:-1]
    matrix = torch.as_tensor(matrix, dtype=torch.float32, device=img.device)
    # as jnp.linalg.inv: no singularity check (that would wait for the card)
    inv = torch.linalg.inv_ex(matrix)[0]
    src_h = torch.einsum("...ij,hwj->...hwi", inv,
                         _pixel_grid(H, W, img.device))
    jw = torch.einsum("...ij,...kj->...ki", matrix, _homogeneous(joints))
    return _sample(img, _dehomogenize(src_h)), _dehomogenize(jw)


def draw_mosaic_centers(size: int, batch_shape=(),
                        generator: Optional[torch.Generator] = None
                        ) -> torch.Tensor:
    """Mosaic centers ``[*batch_shape, 2]`` (cx, cy), each uniform over the
    integers of [S/2, 3S/2] as JAX draws them, from ``generator`` (its
    device; the CPU when None)."""
    lo = size // 2
    return torch.randint(lo, size + lo + 1, (*batch_shape, 2),
                         generator=generator,
                         device=generator.device if generator is not None
                         else "cpu")


def mosaic4(images: torch.Tensor, joints: torch.Tensor, vis: torch.Tensor,
            generator: Optional[torch.Generator], out_size: int,
            center: Optional[torch.Tensor] = None) -> tuple:
    """YOLOX-style 4-image mosaic (reference mosaic.py:9-275), fixed shape:
    four ``[S, S]`` images tile a ``[2S, 2S]`` canvas around a jittered
    center, clipped at the canvas border, and the canvas is resized to
    ``out_size``.

    As in JAX, the images are placed on a 3S canvas padded by S // 2 and
    the central 2S window is read; a later image overwrites an earlier one.
    For odd S and a center at S // 2 an image's start is -1 on that canvas,
    which ``lax.dynamic_update_slice`` reads as 3S - 1 and clamps to 2S: the
    image lands at the far edge. The port places it there too. The joints
    move by the unclamped offsets.

    Args:
        images: ``[..., 4, S, S, C]``; joints: ``[..., 4, K, 2]``;
            vis: ``[..., 4, K]``.
        generator: draws the centers when ``center`` is None.
        center: ``[..., 2]`` integer (cx, cy) in canvas pixels, in place of
            the draw.

    Returns:
        (mosaic ``[..., out, out, C]`` float32, joints ``[..., 4K, 2]``,
        vis ``[..., 4K]``).
    """
    lead = images.shape[:-4]
    S, C = images.shape[-3], images.shape[-1]
    dev = images.device
    if center is None:
        center = draw_mosaic_centers(S, lead, generator)
    center = torch.as_tensor(center, device=dev).long().expand(*lead, 2)
    c = center[..., None, :]                                  # [..., 1, 2]
    quadrant = torch.tensor([[-S, -S], [0, -S], [-S, 0], [0, 0]],
                            dtype=torch.long, device=dev)
    offsets = c + quadrant                                    # [..., 4, 2]
    pad = S // 2
    # start on the 3S canvas, read as lax.dynamic_update_slice reads it: a
    # negative index counts from the end, then the start is clamped so the
    # image fits
    starts = offsets + pad
    starts = torch.where(starts < 0, starts + 3 * S, starts).clamp(0, 2 * S)

    imgs = images.reshape(-1, 4, S, S, C)
    st = starts.reshape(-1, 4, 2)
    N = imgs.shape[0]
    # canvas pixel (u, v) is (u + pad, v + pad) on the 3S canvas
    uv = torch.arange(2 * S, device=dev) + pad
    canvas = torch.zeros(N, 2 * S, 2 * S, C, dtype=images.dtype, device=dev)
    batch = torch.arange(N, device=dev)[:, None, None]
    for i in range(4):
        sx = uv[None, :] - st[:, i, 0:1]                      # [N, 2S]
        sy = uv[None, :] - st[:, i, 1:2]
        inside = (((sy >= 0) & (sy < S))[:, :, None]
                  & ((sx >= 0) & (sx < S))[:, None, :])        # [N, 2S, 2S]
        pix = imgs[:, i][batch, sy.clamp(0, S - 1)[:, :, None],
                         sx.clamp(0, S - 1)[:, None, :]]
        canvas = torch.where(inside[..., None], pix, canvas)
    canvas = canvas.reshape(*lead, 2 * S, 2 * S, C)

    K = joints.shape[-2]
    moved = joints + offsets[..., None, :].to(joints.dtype)   # [..., 4, K, 2]
    all_joints = moved.reshape(*lead, 4 * K, 2)
    all_vis = vis.reshape(*lead, 4 * K)
    # joints clipped off the canvas become invisible (the reference filters
    # labels to the mosaic bounds)
    inside = ((all_joints >= 0) & (all_joints < 2 * S)).all(dim=-1)
    all_vis = all_vis * inside.to(all_vis.dtype)
    scale = out_size / (2.0 * S)
    flat = canvas.reshape(-1, 2 * S, 2 * S, C).permute(0, 3, 1, 2).float()
    out = F.interpolate(flat, size=(out_size, out_size), mode="bilinear",
                        align_corners=False, antialias=True)
    out = out.permute(0, 2, 3, 1).reshape(*lead, out_size, out_size, C)
    return out, all_joints * scale, all_vis
