"""Affine-transform math for top-down crops (port of
``litehandnet_tpu/ops/affine.py``).

* ``get_affine_transform``: the classic center/scale/rot crop matrix from
  three point pairs (reference post_transforms.py:101-156 via
  cv2.getAffineTransform), solved as a batched 3x3 system.
* ``get_warp_matrix``: the UDP unbiased warp matrix (reference
  post_transforms.py:52-80), closed form.
* ``transform_preds``: heatmap coords -> original image coords (reference
  post_transforms.py:6-48).

Everything is batched over leading dimensions and elementwise where the JAX
package uses an ``einsum``, so no matrix product can run in TF32 on the
card. The bbox "scale" is normalized by ``PIXEL_STD`` = 200 as in the
reference (base_dataset.py:133-162).
"""

from __future__ import annotations

import math

import torch

PIXEL_STD = 200.0


def _f32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _rotate_point(pt: torch.Tensor, angle_rad: torch.Tensor) -> torch.Tensor:
    """Rotate 2-vector(s) ``pt`` by ``angle_rad`` (counter-clockwise,
    y-down)."""
    sn, cs = torch.sin(angle_rad), torch.cos(angle_rad)
    x, y = pt[..., 0], pt[..., 1]
    return torch.stack([x * cs - y * sn, x * sn + y * cs], dim=-1)


def _get_3rd_point(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Third triangle point: rotate (a-b) by 90 degrees CCW around b."""
    direction = a - b
    return b + torch.stack([-direction[..., 1], direction[..., 0]], dim=-1)


def get_affine_transform(center, scale, rot, output_size, shift=(0.0, 0.0),
                         inv: bool = False) -> torch.Tensor:
    """Affine matrix mapping the (center, scale, rot) box to the output crop.

    Args:
        center: [..., 2] bbox center (x, y) in source-image pixels.
        scale: [..., 2] bbox scale (w, h) / PIXEL_STD.
        rot: [...] rotation in degrees.
        output_size: (w, h) of the destination crop.
        shift: fractional shift of the source box.
        inv: return the dst->src matrix instead.

    Returns:
        [..., 2, 3] float32 affine matrix.
    """
    center = _f32(center)
    dev = center.device
    scale = _f32(scale, dev)
    rot = _f32(rot, dev)
    shift_x, shift_y = (float(v) for v in shift)

    scale_tmp = scale * PIXEL_STD
    src_w = scale_tmp[..., 0]
    dst_w = float(output_size[0])
    dst_h = float(output_size[1])

    # constants enter as python floats: a tensor made from host values
    # would be a copy that waits for the card
    rot_rad = math.pi * rot / 180.0
    zeros = torch.zeros_like(src_w)
    src_dir = _rotate_point(torch.stack([zeros, src_w * -0.5], dim=-1),
                            rot_rad)
    dst_dir = torch.stack([zeros, zeros + dst_w * -0.5], dim=-1)
    shift_px = torch.stack([scale_tmp[..., 0] * shift_x,
                            scale_tmp[..., 1] * shift_y], dim=-1)

    src0 = center + shift_px
    src1 = center + src_dir + shift_px
    src2 = _get_3rd_point(src0, src1)
    src = torch.stack([src0, src1, src2], dim=-2)  # [..., 3, 2]

    dst0 = torch.stack([zeros + dst_w * 0.5, zeros + dst_h * 0.5], dim=-1)
    dst1 = dst0 + dst_dir
    dst2 = _get_3rd_point(dst0, dst1)
    dst = torch.stack([dst0, dst1, dst2], dim=-2)  # [..., 3, 2]

    if inv:
        src, dst = dst, src

    # solve A @ M.T = dst for the 2x3 matrix M, with A = [src | 1]; the
    # `_ex` form skips the singularity check, which would wait for the card
    A = torch.cat([src, torch.ones(src.shape[:-1] + (1,), device=dev)], dim=-1)
    m_t = torch.linalg.solve_ex(A, dst)[0]  # [..., 3, 2]
    return m_t.transpose(-1, -2)           # [..., 2, 3]


def get_warp_matrix(theta, size_input, size_dst, size_target) -> torch.Tensor:
    """UDP unbiased warp matrix (reference post_transforms.py:52-80).

    Args:
        theta: rotation in degrees (scalar or [...]).
        size_input: [..., 2] source image size (w, h).
        size_dst: (w, h) destination size.
        size_target: [..., 2] ROI size in the source plane (w, h).

    Returns:
        [..., 2, 3] float32 warp matrix.
    """
    size_input = _f32(size_input)
    dev = size_input.device
    theta = torch.deg2rad(_f32(theta, dev))
    size_target = _f32(size_target, dev)
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    scale_x = float(size_dst[0]) / size_target[..., 0]
    scale_y = float(size_dst[1]) / size_target[..., 1]
    in_w, in_h = size_input[..., 0], size_input[..., 1]
    tw, th = size_target[..., 0], size_target[..., 1]

    m00 = cos_t * scale_x
    m01 = -sin_t * scale_x
    m02 = scale_x * (-0.5 * in_w * cos_t + 0.5 * in_h * sin_t + 0.5 * tw)
    m10 = sin_t * scale_y
    m11 = cos_t * scale_y
    m12 = scale_y * (-0.5 * in_w * sin_t - 0.5 * in_h * cos_t + 0.5 * th)
    m00, m01, m02, m10, m11, m12 = torch.broadcast_tensors(
        m00, m01, m02, m10, m11, m12)
    row0 = torch.stack([m00, m01, m02], dim=-1)
    row1 = torch.stack([m10, m11, m12], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def affine_transform_points(points, mat: torch.Tensor) -> torch.Tensor:
    """Apply 2x3 affine matrices to points.

    Args:
        points: [..., N, 2].
        mat: [..., 2, 3] (batch dims broadcast with the points').

    Returns:
        [..., N, 2] transformed points.
    """
    mat = _f32(mat)
    points = _f32(points, mat.device)
    x, y = points[..., 0], points[..., 1]
    m = mat[..., None, :, :]  # [..., 1, 2, 3] against [..., N]
    return torch.stack([
        m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2],
        m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2],
    ], dim=-1)


def invert_affine(mat: torch.Tensor) -> torch.Tensor:
    """Invert 2x3 affine matrices ([..., 2, 3] -> [..., 2, 3])."""
    mat = _f32(mat)
    a, b, tx = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    c, d, ty = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    det = a * d - b * c
    ia, ib, ic, id_ = d / det, -b / det, -c / det, a / det
    row0 = torch.stack([ia, ib, -(ia * tx + ib * ty)], dim=-1)
    row1 = torch.stack([ic, id_, -(ic * tx + id_ * ty)], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def transform_preds(
    coords: torch.Tensor,
    center: torch.Tensor,
    scale: torch.Tensor,
    output_size,
    use_udp: bool = False,
) -> torch.Tensor:
    """Map heatmap-space coords back to source-image pixels
    (reference post_transforms.py:6-48).

    Args:
        coords: [..., K, 2] predicted coords in heatmap space.
        center: [..., 2] bbox centers.
        scale: [..., 2] bbox scales (w, h) / PIXEL_STD.
        output_size: (w, h) heatmap size.
        use_udp: unbiased data processing (stride = (s-1)/(o-1)).

    Returns:
        [..., K, 2] float32 coords in source-image pixels.
    """
    coords = coords.float()
    center = torch.as_tensor(center, dtype=torch.float32, device=coords.device)
    scale = torch.as_tensor(scale, dtype=torch.float32,
                            device=coords.device) * PIXEL_STD
    # python-float divisors keep the call free of host-to-device copies
    w, h = (float(s) - 1.0 if use_udp else float(s) for s in output_size)
    scale_xy = torch.stack([scale[..., 0] / w, scale[..., 1] / h], dim=-1)
    return (coords * scale_xy[..., None, :] + center[..., None, :]
            - scale[..., None, :] * 0.5)
