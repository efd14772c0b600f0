"""Batched heatmap / SimDR decoding (port of ``litehandnet_tpu/ops/decode.py``).

Argmax, the ±0.25 gradient-sign shift (and its Gen-1 variant), DARK Taylor
refinement (classic and UDP) and SimDR vector decode, each as one batched
expression using gathers over ``[B, H, W, K]`` maps (reference
top_down_eval.py:199-500). The classic DARK modulation (blur,
max-preserving rescale, log) runs through the ``blur_log`` kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from litehandnet_tpu_torch.kernels.blur_log import blur_log
from litehandnet_tpu_torch.ops.affine import transform_preds
from litehandnet_tpu_torch.ops.blur import gaussian_blur


def argmax_coords(heatmaps: torch.Tensor):
    """Argmax decode (reference top_down_eval.py:199-231); ties go to the
    first flat index.

    Returns:
        (preds [B, K, 2] float32 (x, y; -1 where max <= 0),
         maxvals [B, K, 1])
    """
    B, H, W, K = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, K)
    idx = flat.argmax(dim=1)  # documented to return the first maximum
    maxvals = flat.amax(dim=1)[..., None]
    preds = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    preds = torch.where(maxvals > 0.0, preds, torch.full_like(preds, -1.0))
    return preds, maxvals


def _gather_hm(flat: torch.Tensor, ix: torch.Tensor, iy: torch.Tensor, W: int):
    """Values of ``flat`` ([B, H*W, K]) at integer coords ``ix``, ``iy``
    ([B, K]; the caller clips them). A negative flat index wraps around, as
    JAX and numpy indexing do: the UDP decode of an empty map (preds -1)
    reads before the first pixel."""
    idx = torch.remainder(iy * W + ix, flat.shape[1])[:, None, :]
    return torch.gather(flat, 1, idx)[:, 0, :]


def refine_default(heatmaps: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """±0.25 shift toward the gradient sign, for strictly interior maxima
    (reference top_down_eval.py:440-452)."""
    B, H, W, K = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, K)
    px = preds[..., 0].long()  # truncates toward zero, as jnp.trunc
    py = preds[..., 1].long()
    interior = (px > 1) & (px < W - 1) & (py > 1) & (py < H - 1)
    pxc = px.clamp(1, W - 2)
    pyc = py.clamp(1, H - 2)
    dx = _gather_hm(flat, pxc + 1, pyc, W) - _gather_hm(flat, pxc - 1, pyc, W)
    dy = _gather_hm(flat, pxc, pyc + 1, W) - _gather_hm(flat, pxc, pyc - 1, W)
    shift = torch.stack([torch.sign(dx), torch.sign(dy)], dim=-1) * 0.25
    return preds + shift * interior.float()[..., None]


def refine_offset_gen1(heatmaps: torch.Tensor, preds: torch.Tensor,
                       half_shift: bool = True) -> torch.Tensor:
    """Gen-1 ±0.25 refinement (reference heatmap_post_processing.py:6-33,
    adjust_keypoints_by_offset): neighbour reads clamp at the border, so the
    shift applies everywhere, and both coordinates gain +0.5 (the pixel
    centre). ``half_shift=False`` is HeatmapParser.adjust_keypoints
    (HeatmapParser.py:197-223): the same clamped ±0.25 without the +0.5."""
    B, H, W, K = heatmaps.shape
    flat = heatmaps.reshape(B, H * W, K)
    px = preds[..., 0].long().clamp(0, W - 1)
    py = preds[..., 1].long().clamp(0, H - 1)
    right = _gather_hm(flat, (px + 1).clamp(max=W - 1), py, W)
    left = _gather_hm(flat, (px - 1).clamp(min=0), py, W)
    down = _gather_hm(flat, px, (py + 1).clamp(max=H - 1), W)
    up = _gather_hm(flat, px, (py - 1).clamp(min=0), W)
    half = 0.5 if half_shift else 0.0
    quarter = torch.full_like(right, 0.25)
    sx = torch.where(right > left, quarter, -quarter) + half
    sy = torch.where(down > up, quarter, -quarter) + half
    return preds + torch.stack([sx, sy], dim=-1)


def refine_dark(heatmaps: torch.Tensor, preds: torch.Tensor,
                kernel: int = 11) -> torch.Tensor:
    """Classic DARK: blur + log (the ``blur_log`` kernel) and one Newton step
    on a Taylor expansion (reference top_down_eval.py:233-272, 338-372).

    Applied only where 1 < p < size-2 and the Hessian is non-singular.
    """
    return dark_step(blur_log(heatmaps, kernel), preds)


def dark_step(log_maps: torch.Tensor, preds: torch.Tensor) -> torch.Tensor:
    """``refine_dark``'s Newton step on maps ``[B, H, W, K]`` already
    blurred and logged (``blur_log``), at ``preds`` ``[B, K, 2]``; ``K`` may
    be a stride-0 view of one map read at several points."""
    B, H, W, K = log_maps.shape
    flat = log_maps.reshape(B, H * W, K)

    px = preds[..., 0].long()
    py = preds[..., 1].long()
    interior = (px > 1) & (px < W - 2) & (py > 1) & (py < H - 2)
    px = px.clamp(2, W - 3)
    py = py.clamp(2, H - 3)

    def v(dx_, dy_):
        return _gather_hm(flat, px + dx_, py + dy_, W)

    dx = 0.5 * (v(1, 0) - v(-1, 0))
    dy = 0.5 * (v(0, 1) - v(0, -1))
    dxx = 0.25 * (v(2, 0) - 2.0 * v(0, 0) + v(-2, 0))
    dyy = 0.25 * (v(0, 2) - 2.0 * v(0, 0) + v(0, -2))
    dxy = 0.25 * (v(1, 1) - v(1, -1) - v(-1, 1) + v(-1, -1))

    det = dxx * dyy - dxy * dxy
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    # offset = -H^{-1} @ [dx, dy]
    off_x = -(dyy * dx - dxy * dy) / safe_det
    off_y = -(-dxy * dx + dxx * dy) / safe_det
    valid = (interior & (det != 0.0)).float()[..., None]
    return preds + torch.stack([off_x, off_y], dim=-1) * valid


# A Newton step of ``refine_dark`` is well conditioned where the Hessian of
# the log map has |det H| >= DARK_COND_DET and the step is at most
# DARK_COND_STEP heatmap px. Elsewhere (the flat maxima of random weights)
# float32 rounding of the log map can move the refined coordinate by tens
# of px, so two correct decoders agree only on well-conditioned joints.
DARK_COND_DET, DARK_COND_STEP = 1e-2, 1.0


def dark_conditioning(heatmaps: torch.Tensor, log_maps=None, kernel: int = 11):
    """How well ``refine_dark``'s Newton step is posed at each map's argmax,
    in float64 from the same central differences.

    Args:
        heatmaps: ``[B, H, W, K]`` maps.
        log_maps: their ``blur_log`` (computed here when None).

    Returns:
        (well [B, K] bool: the argmax is interior with a positive maximum,
         |det H| >= DARK_COND_DET and step <= DARK_COND_STEP;
         |det H| [B, K]; step length [B, K] in heatmap px)
    """
    B, H, W, K = heatmaps.shape
    if log_maps is None:
        log_maps = blur_log(heatmaps, kernel)
    flat = log_maps.double().reshape(B, H * W, K)
    preds, _ = argmax_coords(heatmaps)
    px, py = preds[..., 0].long(), preds[..., 1].long()
    interior = (px > 1) & (px < W - 2) & (py > 1) & (py < H - 2)
    px, py = px.clamp(2, W - 3), py.clamp(2, H - 3)

    def v(dx_, dy_):
        return _gather_hm(flat, px + dx_, py + dy_, W)

    gx, gy = 0.5 * (v(1, 0) - v(-1, 0)), 0.5 * (v(0, 1) - v(0, -1))
    dxx = 0.25 * (v(2, 0) - 2.0 * v(0, 0) + v(-2, 0))
    dyy = 0.25 * (v(0, 2) - 2.0 * v(0, 0) + v(0, -2))
    dxy = 0.25 * (v(1, 1) - v(1, -1) - v(-1, 1) + v(-1, -1))
    det = dxx * dyy - dxy * dxy
    safe = torch.where(det == 0.0, torch.ones_like(det), det)
    step = torch.hypot((dyy * gx - dxy * gy) / safe, (dxx * gy - dxy * gx) / safe)
    well = (interior & (det.abs() >= DARK_COND_DET)
            & (step <= DARK_COND_STEP))
    return well, det.abs(), step


def refine_dark_udp(heatmaps: torch.Tensor, preds: torch.Tensor,
                    kernel: int = 3) -> torch.Tensor:
    """UDP-style DARK (reference post_dark_udp, top_down_eval.py:274-335):
    reflect-101 blur, clip+log, edge pad, 3x3 finite differences,
    eps-regularized 2x2 Hessian solve."""
    B, H, W, K = heatmaps.shape
    hm = gaussian_blur(heatmaps, kernel, border="reflect")
    hm = torch.log(torch.clamp(hm, 0.001, 50.0))
    hm = F.pad(hm.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate")
    Wp = W + 2
    flat = hm.permute(0, 2, 3, 1).reshape(B, (H + 2) * Wp, K)

    px = preds[..., 0].long() + 1
    py = preds[..., 1].long() + 1

    def v(dx_, dy_):
        return _gather_hm(flat, px + dx_, py + dy_, Wp)

    i0 = v(0, 0)
    dx = 0.5 * (v(1, 0) - v(-1, 0))
    dy = 0.5 * (v(0, 1) - v(0, -1))
    dxx = v(1, 0) - 2.0 * i0 + v(-1, 0)
    dyy = v(0, 1) - 2.0 * i0 + v(0, -1)
    dxy = 0.5 * (v(1, 1) - v(1, 0) - v(0, 1) + 2.0 * i0 - v(-1, 0)
                 - v(0, -1) + v(-1, -1))

    eps = torch.finfo(torch.float32).eps
    a = dxx + eps
    b = dxy
    c = dyy + eps
    det = a * c - b * b
    safe_det = torch.where(det == 0.0, torch.ones_like(det), det)
    off_x = (c * dx - b * dy) / safe_det
    off_y = (-b * dx + a * dy) / safe_det
    return preds - torch.stack([off_x, off_y], dim=-1)


def keypoints_from_heatmaps(
    heatmaps: torch.Tensor,
    center,
    scale,
    post_process: str | None = "default",
    kernel: int = 11,
    use_udp: bool = False,
):
    """Argmax + sub-pixel refinement + unwarp to image coords
    (reference top_down_eval.py:375-463).

    Args:
        heatmaps: [B, H, W, K] float32.
        center: [B, 2] bbox centers.
        scale: [B, 2] bbox scales (/200).
        post_process: None | 'default' | 'unbiased' (DARK).
        kernel: DARK modulation kernel.
        use_udp: UDP decode path (post_dark_udp + UDP unwarp).

    Returns:
        (hm_preds [B, K, 2] heatmap-space coords,
         preds [B, K, 2] image-space coords,
         maxvals [B, K, 1])
    """
    _, H, W, _ = heatmaps.shape
    hm_preds, maxvals = argmax_coords(heatmaps)
    if use_udp:
        hm_preds = refine_dark_udp(heatmaps, hm_preds, kernel=kernel)
    elif post_process == "unbiased":
        hm_preds = refine_dark(heatmaps, hm_preds, kernel=kernel)
    elif post_process is not None:
        hm_preds = refine_default(heatmaps, hm_preds)
    preds = transform_preds(hm_preds, center, scale, (W, H), use_udp=use_udp)
    return hm_preds, preds, maxvals


def keypoints_from_simdr(x_vectors: torch.Tensor, y_vectors: torch.Tensor,
                         center, scale, split_ratio: int = 2) -> torch.Tensor:
    """Decode SimDR 1-D vectors (reference top_down_eval.py:466-500).

    Args:
        x_vectors: [B, K, W*k]; y_vectors: [B, K, H*k].
        center, scale: [B, 2] unwarp parameters.
        split_ratio: SimDR split ratio k.

    Returns:
        [B, K, 3] (x, y, score) in image coords.
    """
    k = int(split_ratio)
    Wk = x_vectors.shape[-1]
    Hk = y_vectors.shape[-1]
    x_max = x_vectors.amax(dim=-1)
    y_max = y_vectors.amax(dim=-1)
    preds = torch.stack([x_vectors.argmax(dim=-1).float(),
                         y_vectors.argmax(dim=-1).float()], dim=-1) / float(k)
    scores = ((x_max + y_max) / 2.0)[..., None]
    preds = transform_preds(preds, center, scale, (Wk // k, Hk // k))
    return torch.cat([preds, scores], dim=-1)
