"""Fused on-device preprocessing: augmentation and target encoding as one
batched program over B (port of ``litehandnet_tpu/data/device_pipeline.py``).

The host only decodes JPEGs into a fixed-size uint8 canvas; crop, flip,
HSV, scale/rotation, normalize and target encoding run here on ``[B, ...]``
tensors with no loop over samples. Semantics per reference transform:

* TopDownGetRandomScaleRotation (topdown_affine.py:11-45): scale ~
  clip(N(1, sf), 1-sf, 1+sf); rot ~ clip(N(0, rf), -2rf, 2rf), kept with
  probability rot_prob.
* TopDownAffine (topdown_affine.py:47-115): the classic center/scale/rot
  crop (or the UDP warp), bilinear with a zero border, as an inverse-matrix
  gather.
* HSVRandomAug (random_hsv.py:5-44): YOLOX-style HSV gains (+-5, +-30,
  +-30 on an OpenCV-scaled HSV space), each gated with p=1/2 and truncated.
* TopDownRandomFlip (RandomFlip.py:11-131): horizontal mirror and
  flip_index reorder, in crop space as in the JAX package (its documented
  deviation: the augmentation distribution is the same; pixels differ only
  when the crop is off-center).
* ToTensor/NormalizeTensor: /255, then ImageNet mean/std.
* TopDownGenerateTarget / GenerateSimDR: ``ops.encode``.

The random draws (``sample_params``) are apart from the deterministic
program (``apply``), so the same draws give the same batch on any device.
Source coordinates are elementwise multiply-adds, never a matrix product, so
TF32 cannot move them on the card.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.ops.affine import (
    affine_transform_points,
    get_affine_transform,
    get_warp_matrix,
    invert_affine,
)
from litehandnet_tpu_torch.ops.encode import (
    msra_heatmaps,
    region_map,
    simdr_targets,
    udp_heatmaps,
)

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
HSV_GAIN = (5.0, 30.0, 30.0)


def _bilinear_sample(images: torch.Tensor, x: torch.Tensor,
                     y: torch.Tensor) -> torch.Tensor:
    """Sample ``images`` ``[B, H0, W0, C]`` at float coords ``x``, ``y``
    ``[B, H, W]``; zero outside. Returns ``[B, H, W, C]`` float32."""
    B, H0, W0, C = images.shape
    flat = images.reshape(B * H0 * W0, C)
    base = (torch.arange(B, device=images.device) * (H0 * W0)).view(B, 1, 1)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    dx = (x - x0)[..., None]
    dy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < W0) & (yi >= 0) & (yi < H0)
        idx = base + yi.clamp(0, H0 - 1) * W0 + xi.clamp(0, W0 - 1)
        return flat[idx].float() * valid[..., None]

    v00 = tap(x0i, y0i)
    v01 = tap(x0i + 1, y0i)
    v10 = tap(x0i, y0i + 1)
    v11 = tap(x0i + 1, y0i + 1)
    top = v00 * (1 - dx) + v01 * dx
    bot = v10 * (1 - dx) + v11 * dx
    return top * (1 - dy) + bot * dy


def _rgb_to_hsv_cv(img: torch.Tensor):
    """RGB [0, 255] -> OpenCV-scaled HSV (H in [0, 180), S and V in
    [0, 255])."""
    r, g, b = img[..., 0], img[..., 1], img[..., 2]
    maxc = torch.maximum(torch.maximum(r, g), b)
    minc = torch.minimum(torch.minimum(r, g), b)
    v = maxc
    delta = maxc - minc
    zero = torch.zeros_like(maxc)
    s = torch.where(maxc > 0, delta / torch.clamp(maxc, min=1e-6) * 255.0,
                    zero)
    safe = torch.clamp(delta, min=1e-6)
    h = torch.where(
        maxc == r, (g - b) / safe,
        torch.where(maxc == g, 2.0 + (b - r) / safe, 4.0 + (r - g) / safe),
    )
    # floor-mod, like jnp's `%`: negative hues wrap to [0, 180)
    h = torch.remainder(h * 30.0, 180.0)
    return h, s, v


def _select(i: torch.Tensor, choices) -> torch.Tensor:
    """``choices[i]`` elementwise for ``i`` in 0..len(choices)-1."""
    out = choices[-1]
    for k in range(len(choices) - 2, -1, -1):
        out = torch.where(i == k, choices[k], out)
    return out


def _hsv_to_rgb_cv(h, s, v) -> torch.Tensor:
    h = torch.remainder(h, 180.0) / 30.0
    s = s / 255.0
    i = torch.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6)
    r = _select(i, (v, q, p, p, t, v))
    g = _select(i, (t, v, v, q, p, p))
    b = _select(i, (p, p, t, v, v, q))
    return torch.stack([r, g, b], dim=-1)


def hsv_augment(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """YOLOX HSV augmentation of RGB [0, 255] images ``[B, H, W, 3]``
    (reference random_hsv.py:20-44) with per-sample integer gains
    ``[B, 3]`` (hue, saturation, value), as ``sample_params`` draws them."""
    g = gains.to(img.dtype)[:, None, None, :]
    h, s, v = _rgb_to_hsv_cv(img)
    h = torch.remainder(h + g[..., 0], 180.0)
    s = torch.clamp(s + g[..., 1], 0.0, 255.0)
    v = torch.clamp(v + g[..., 2], 0.0, 255.0)
    return _hsv_to_rgb_cv(h, s, v)


class DevicePipeline:
    """The batched preprocessing program.

    Args:
        cfg: experiment config (PIPELINE, DATASET and MODEL sections).
        flip_index: ``[K]`` permutation applied to joints on a flip.
        is_train: enables the flip, HSV and scale/rotation augmentation.
        with_region: append the 3 region-map channels (default: the model
            predicts bboxes or region maps).
        device: where the program runs.

    Raises:
        RuntimeError: ``device`` is CUDA and no CUDA device is available.
        ValueError: SimDR targets with multi-scale heatmaps.
    """

    def __init__(self, cfg, flip_index: Sequence[int], is_train: bool = True,
                 with_region: Optional[bool] = None, device="cuda"):
        self.device = resolve_device(device)
        p = cfg.PIPELINE
        d = cfg.DATASET
        m = cfg.get("MODEL", {})
        if with_region is None:
            with_region = bool(
                m.get("pred_bbox", False) or m.get("with_region_map", False))
        self.with_region = with_region
        # the Gen-1 center+SimDR workflow (with_region_map) paints
        # +-3*sigma, the Gen-2 SRHandNet workflow (pred_bbox) 5x5
        self.region_patch = (
            "gen1"
            if m.get("with_region_map", False) and not m.get("pred_bbox", False)
            else "srhandnet")
        self.image_size = tuple(int(v) for v in d.image_size)
        hm = d.heatmap_size
        # multi-scale targets (SRHandNet, generateTarget.py:369-426):
        # heatmap_size is a list of pairs and sigma a list
        self.multiscale = bool(hm and isinstance(hm[0], (list, tuple)))
        if self.multiscale:
            self.heatmap_sizes = [tuple(int(v) for v in h) for h in hm]
            self.heatmap_size = self.heatmap_sizes[-1]
        else:
            self.heatmap_sizes = None
            self.heatmap_size = tuple(int(v) for v in hm)
        self.flip_index = torch.as_tensor([int(i) for i in flip_index],
                                          dtype=torch.int64, device=self.device)
        self.is_train = is_train
        self.flip_prob = float(p.get("flip_prob", 0.5)) if is_train else 0.0
        self.rot_prob = float(p.get("rot_prob", 0.0)) if is_train else 0.0
        self.rot_factor = float(p.get("rot_factor", 0.0))
        self.scale_factor = (float(p.get("scale_factor", 0.0)) if is_train
                             else 0.0)
        self.use_udp = bool(p.get("use_udp", False))
        self.sigma = p.get("sigma", 2)
        self.unbiased = bool(p.get("unbiased_encoding", False))
        self.encoding = p.get("encoding", "MSRA")
        self.simdr_split_ratio = int(p.get("simdr_split_ratio", 0) or 0)
        if self.multiscale and self.simdr_split_ratio > 0:
            raise ValueError(
                "simdr_split_ratio > 0 is not supported with multi-scale "
                "heatmap_size (nested lists)")
        self.hsv = bool(is_train)
        self._mean = torch.tensor(IMAGENET_MEAN, device=self.device)
        self._std = torch.tensor(IMAGENET_STD, device=self.device)
        self._hsv_gain = torch.tensor(HSV_GAIN, device=self.device)

    # -- draws ------------------------------------------------------------
    def sample_params(self, B: int,
                      generator: Optional[torch.Generator] = None) -> dict:
        """The augmentation draws for ``B`` samples, on the device:
        ``s_mult`` ``[B]``, ``rot`` ``[B]`` degrees (None in eval mode: the
        caller's rotations are kept), ``do_flip`` ``[B]`` bool and
        ``hsv_gains`` ``[B, 3]`` (None in eval mode). Eval mode draws
        nothing."""
        dev = self.device
        if not self.is_train:
            return dict(s_mult=torch.ones(B, device=dev), rot=None,
                        do_flip=torch.zeros(B, dtype=torch.bool, device=dev),
                        hsv_gains=None)
        sf, rf = self.scale_factor, self.rot_factor

        def uniform(*shape):
            return torch.rand(shape, generator=generator, device=dev)

        def normal(*shape):
            return torch.randn(shape, generator=generator, device=dev)

        # two independent normal draws, as in topdown_affine.py:36-40
        s_mult = torch.clamp(normal(B) * sf + 1.0, 1.0 - sf, 1.0 + sf)
        rot = torch.clamp(normal(B) * rf, -2.0 * rf, 2.0 * rf)
        rot = torch.where(uniform(B) <= self.rot_prob, rot,
                          torch.zeros_like(rot))
        do_flip = uniform(B) <= self.flip_prob
        gains = (uniform(B, 3) * 2.0 - 1.0) * self._hsv_gain
        gate = torch.randint(0, 2, (B, 3), generator=generator,
                             device=dev).float()
        return dict(s_mult=s_mult, rot=rot, do_flip=do_flip,
                    hsv_gains=torch.trunc(gains * gate))

    # -- program ----------------------------------------------------------
    def _encode(self, joints, vis, hm_size, sigma):
        if self.encoding.upper() == "UDP":
            return udp_heatmaps(joints, vis, self.image_size, hm_size,
                                float(sigma))
        return msra_heatmaps(joints, vis, self.image_size, hm_size,
                             float(sigma), unbiased=self.unbiased)

    def apply(self, images, joints, vis, centers, scales, rotations, bboxes,
              params: dict) -> dict:
        """The deterministic program for given draws.

        Args:
            images: ``[B, H0, W0, 3]`` uint8 canvases.
            joints: ``[B, K, 2]`` canvas coords; ``vis`` ``[B, K]``.
            centers, scales: ``[B, 2]``; rotations ``[B]`` (used in eval
                mode); bboxes ``[B, 4]`` (x, y, w, h) or None.
            params: ``sample_params`` output.

        Returns:
            dict of ``img`` ``[B, H, W, 3]`` float32, ``target``
            ``[B, K, h, w]`` (stacked sigma ``[B, S, K, h, w]``, a list
            per scale when multi-scale), ``target_weight`` ``[B, K]``,
            ``joints`` (crop space), ``center``, ``scale`` (jittered), and
            ``bbox`` (crop space, region configs; K+3 target channels) and
            ``simdr_x`` / ``simdr_y`` (SimDR configs).
        """
        dev = self.device
        W, H = self.image_size

        def f32(a):
            return torch.as_tensor(a, dtype=torch.float32, device=dev)

        images = torch.as_tensor(images, device=dev)
        joints, vis = f32(joints)[..., :2], f32(vis)
        center, scale = f32(centers), f32(scales)
        B, K = joints.shape[:2]
        bbox = (torch.zeros(B, 4, device=dev) if bboxes is None
                else f32(bboxes))
        rot = f32(rotations) if params["rot"] is None else params["rot"]
        do_flip = params["do_flip"]
        scale = scale * params["s_mult"][:, None]

        if self.use_udp:
            # one matrix for joints and pixels, as the reference
            # (topdown_affine.py:76); cv2.warpAffine inverts it to sample
            fwd = get_warp_matrix(rot, center * 2.0, (W - 1.0, H - 1.0),
                                  scale * 200.0)
            inv = invert_affine(fwd)
        else:
            fwd = get_affine_transform(center, scale, rot, (W, H))
            inv = get_affine_transform(center, scale, rot, (W, H), inv=True)

        xs = torch.arange(W, dtype=torch.float32, device=dev).view(1, 1, W)
        ys = torch.arange(H, dtype=torch.float32, device=dev).view(1, H, 1)
        m = inv[:, :, :, None, None]  # [B, 2, 3, 1, 1]
        src_x = m[:, 0, 0] * xs + m[:, 0, 1] * ys + m[:, 0, 2]
        src_y = m[:, 1, 0] * xs + m[:, 1, 1] * ys + m[:, 1, 2]
        img = _bilinear_sample(images, src_x, src_y)
        joints_c = affine_transform_points(joints, fwd)

        # flip in crop space
        img = torch.where(do_flip[:, None, None, None], img.flip(2), img)
        flipped = torch.stack([(W - 1.0) - joints_c[..., 0], joints_c[..., 1]],
                              dim=-1)[:, self.flip_index]
        joints_c = torch.where(do_flip[:, None, None], flipped, joints_c)
        vis = torch.where(do_flip[:, None], vis[:, self.flip_index], vis)

        if self.hsv:
            img = hsv_augment(img, params["hsv_gains"])
        img = (img / 255.0 - self._mean) / self._std

        sigmas = (list(self.sigma) if isinstance(self.sigma, (list, tuple))
                  else [self.sigma])
        if self.multiscale:
            if len(sigmas) == 1:
                sigmas = sigmas * len(self.heatmap_sizes)
            pairs = [self._encode(joints_c, vis, hm, s)
                     for hm, s in zip(self.heatmap_sizes, sigmas)]
            target = [t for t, _ in pairs]
            weight = [w for _, w in pairs]
        elif len(sigmas) > 1:
            # stacked sigma (hourglass intermediate supervision,
            # generateTarget.py:252-292): [B, S, K, h, w], one weight [B, K]
            pairs = [self._encode(joints_c, vis, self.heatmap_size, s)
                     for s in sigmas]
            target = torch.stack([t for t, _ in pairs], dim=1)
            weight = pairs[0][1]
        else:
            target, weight = self._encode(joints_c, vis, self.heatmap_size,
                                          sigmas[0])
        out = dict(img=img, target=target, target_weight=weight,
                   joints=joints_c, center=center, scale=scale)

        if self.with_region:
            # all four bbox corners through the affine, then the axis-aligned
            # bound: exact under rotation too
            x0, y0 = bbox[:, 0], bbox[:, 1]
            x1, y1 = x0 + bbox[:, 2], y0 + bbox[:, 3]
            corners = torch.stack([torch.stack([x0, y0], -1),
                                   torch.stack([x1, y0], -1),
                                   torch.stack([x0, y1], -1),
                                   torch.stack([x1, y1], -1)], dim=1)
            warped = affine_transform_points(corners, fwd)  # [B, 4, 2]
            x_lo, x_hi = warped[..., 0].amin(1), warped[..., 0].amax(1)
            y_lo, y_hi = warped[..., 1].amin(1), warped[..., 1].amax(1)
            x_lo = torch.where(do_flip, (W - 1.0) - x_hi, x_lo)
            bbox_c = torch.stack([x_lo, y_lo, x_hi - x_lo, y_hi - y_lo], -1)
            sig0 = float(sigmas[0])
            ones = torch.ones(B, 3, device=dev)
            if self.multiscale:
                target = [torch.cat([t, region_map(
                    bbox_c, self.image_size, hm, sig0, encoding=self.encoding,
                    patch=self.region_patch)], dim=1)
                    for t, hm in zip(target, self.heatmap_sizes)]
                weight = [torch.cat([w, ones], dim=1) for w in weight]
            else:
                rmap = region_map(bbox_c, self.image_size, self.heatmap_size,
                                  sig0, encoding=self.encoding,
                                  patch=self.region_patch)
                if target.dim() == 5:  # stacked sigma
                    rmap = rmap[:, None].expand(-1, target.shape[1], -1, -1, -1)
                target = torch.cat([target, rmap], dim=-3)
                weight = torch.cat([weight, ones], dim=1)
            out.update(target=target, target_weight=weight, bbox=bbox_c)
        if self.simdr_split_ratio > 0:
            out["simdr_x"], out["simdr_y"] = simdr_targets(
                joints_c, weight[:, :K], self.image_size,
                self.simdr_split_ratio, float(self.sigma))
        return out

    def __call__(self, images, joints, vis, centers, scales, rotations,
                 generator: Optional[torch.Generator] = None,
                 bboxes=None) -> dict:
        """Draw the augmentation from ``generator`` (a generator on the
        pipeline's device; unused in eval mode) and run ``apply``."""
        params = self.sample_params(int(images.shape[0]), generator)
        return self.apply(images, joints, vis, centers, scales, rotations,
                          bboxes, params)
