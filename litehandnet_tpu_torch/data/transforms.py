"""Host-side per-sample transform pipeline (port of
``litehandnet_tpu/data/transforms.py``).

The production path is the batched ``DevicePipeline``; this module mirrors
the reference's dict-in/dict-out transform classes (datasets/data_pipeline/)
for single-sample use and debugging. Each transform runs the port's own
``ops.affine``, ``ops.encode`` and the device pipeline's sampling and HSV
helpers on CPU tensors, so the host and device paths share their math.
Images stay ``[H, W, 3]`` numpy arrays; targets are in the port's layout,
``[K, h, w]`` (``[S, K, h, w]`` for several sigmas).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np
import torch

from litehandnet_tpu_torch.data.device_pipeline import (
    HSV_GAIN,
    _bilinear_sample,
    hsv_augment,
)
from litehandnet_tpu_torch.ops.affine import (
    affine_transform_points,
    get_affine_transform,
    get_warp_matrix,
    invert_affine,
)
from litehandnet_tpu_torch.ops.encode import (
    msra_heatmaps,
    simdr_targets,
    udp_heatmaps,
)


class Compose:
    """Sequential dict pipeline; raises on None
    (reference: shared_transform.py:47-79)."""

    def __init__(self, transforms: Sequence[Callable]):
        self.transforms = list(transforms)

    def __call__(self, results: dict) -> dict:
        for t in self.transforms:
            results = t(results)
            if results is None:
                raise RuntimeError(f"{t} returned None")
        return results

    def __repr__(self):
        names = ", ".join(type(t).__name__ for t in self.transforms)
        return f"Compose([{names}])"


class LoadImageFromFile:
    """PIL decode, RGB (reference: loading.py:6-89 used mmcv/BGR->RGB)."""

    def __call__(self, results):
        from PIL import Image

        with Image.open(results["image_file"]) as im:
            results["img"] = np.asarray(im.convert("RGB"), np.uint8)
        return results


def hsv_gains(seed: int) -> torch.Tensor:
    """``[3]`` integer HSV gains drawn from ``seed``: uniform in +-(5, 30,
    30), each kept with p=1/2, truncated (reference random_hsv.py:20-44),
    the distribution ``DevicePipeline.sample_params`` draws from."""
    gen = torch.Generator().manual_seed(int(seed))
    gains = (torch.rand(3, generator=gen) * 2.0 - 1.0) * torch.tensor(HSV_GAIN)
    gate = torch.randint(0, 2, (3,), generator=gen).float()
    return torch.trunc(gains * gate)


class HSVRandomAug:
    """YOLOX HSV jitter (reference: random_hsv.py:5-44). One integer from
    ``rng`` seeds the gains, as the JAX transform seeds its PRNG key, so the
    draws of the transforms after it follow the same ``RandomState``."""

    def __init__(self, hgain=5, sgain=30, vgain=30, rng=None):
        self.gains = (hgain, sgain, vgain)
        self.rng = rng or np.random.RandomState()

    def __call__(self, results):
        gains = hsv_gains(self.rng.randint(2**31))
        img = torch.from_numpy(results["img"].astype(np.float32))
        out = hsv_augment(img[None], gains[None])[0]
        results["img"] = out.numpy().clip(0, 255).astype(np.uint8)
        return results


class TopDownRandomFlip:
    """Horizontal flip of the source image + joints
    (reference: RandomFlip.py:11-131)."""

    def __init__(self, flip_prob=0.5, rng=None):
        self.flip_prob = flip_prob
        self.rng = rng or np.random.RandomState()

    def __call__(self, results):
        if self.rng.rand() > self.flip_prob:
            return results
        img = results["img"]
        W = img.shape[1]
        results["img"] = img[:, ::-1].copy()
        joints = results["joints_3d"].copy()
        joints[:, 0] = W - 1 - joints[:, 0]
        flip_index = results["ann_info"]["flip_index"]
        results["joints_3d"] = joints[flip_index]
        results["joints_3d_visible"] = results["joints_3d_visible"][flip_index]
        center = results["center"].copy()
        center[0] = W - 1 - center[0]
        results["center"] = center
        return results


class TopDownGetRandomScaleRotation:
    """Scale/rotation sampling (reference: topdown_affine.py:11-45)."""

    def __init__(self, rot_factor=40, scale_factor=0.3, rot_prob=0.6,
                 rng=None):
        self.rot_factor = rot_factor
        self.scale_factor = scale_factor
        self.rot_prob = rot_prob
        self.rng = rng or np.random.RandomState()

    def __call__(self, results):
        sf, rf = self.scale_factor, self.rot_factor
        results["scale"] = results["scale"] * np.clip(
            self.rng.randn() * sf + 1, 1 - sf, 1 + sf
        )
        rot = np.clip(self.rng.randn() * rf, -2 * rf, 2 * rf)
        results["rotation"] = rot if self.rng.rand() <= self.rot_prob else 0
        return results


class TopDownAffine:
    """Crop to image_size (reference: topdown_affine.py:47-115); classic or
    UDP matrix, bilinear, zero border."""

    def __init__(self, use_udp=False):
        self.use_udp = use_udp

    def __call__(self, results):
        W, H = (int(v) for v in results["ann_info"]["image_size"])
        center = torch.as_tensor(np.asarray(results["center"], np.float32))
        scale = torch.as_tensor(np.asarray(results["scale"], np.float32))
        rot = float(results.get("rotation", 0))
        if self.use_udp:
            # one matrix for joints and pixels (reference
            # topdown_affine.py:76; cv2.warpAffine inverts internally)
            fwd = get_warp_matrix(rot, center * 2.0, (W - 1.0, H - 1.0),
                                  scale * 200.0)
            inv = invert_affine(fwd)
        else:
            fwd = get_affine_transform(center, scale, rot, (W, H))
            inv = get_affine_transform(center, scale, rot, (W, H), inv=True)
        xs = torch.arange(W, dtype=torch.float32).view(1, W)
        ys = torch.arange(H, dtype=torch.float32).view(H, 1)
        src_x = inv[0, 0] * xs + inv[0, 1] * ys + inv[0, 2]
        src_y = inv[1, 0] * xs + inv[1, 1] * ys + inv[1, 2]
        img = torch.from_numpy(np.ascontiguousarray(results["img"]))
        results["img"] = _bilinear_sample(img[None], src_x[None],
                                          src_y[None])[0].numpy()
        joints = results["joints_3d"].copy()
        joints[:, :2] = affine_transform_points(
            torch.from_numpy(joints[:, :2].astype(np.float32)), fwd).numpy()
        results["joints_3d"] = joints
        return results


class ToTensor:
    """HWC uint8 -> float [0, 1] (torchvision F.to_tensor semantics, kept
    channels-last)."""

    def __call__(self, results):
        results["img"] = np.asarray(results["img"], np.float32) / 255.0
        return results


class NormalizeTensor:
    def __init__(self, mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225)):
        self.mean = np.asarray(mean, np.float32)
        self.std = np.asarray(std, np.float32)

    def __call__(self, results):
        results["img"] = (results["img"] - self.mean) / self.std
        return results


class TopDownGenerateTarget:
    """Gaussian heatmap targets (reference: generateTarget.py:34-300):
    ``target`` ``[K, h, w]`` (``[S, K, h, w]`` for a list of sigmas) and
    ``target_weight`` ``[K]`` (``[S, K]``)."""

    def __init__(self, sigma=2, encoding="MSRA", unbiased_encoding=False):
        self.sigma = sigma
        self.encoding = encoding
        self.unbiased = unbiased_encoding

    def __call__(self, results):
        ann = results["ann_info"]
        joints = torch.from_numpy(
            np.asarray(results["joints_3d"], np.float32)[None, :, :2])
        vis = torch.from_numpy(
            np.asarray(results["joints_3d_visible"], np.float32)[None, :, 0])
        sigmas = (
            self.sigma if isinstance(self.sigma, (list, tuple))
            else [self.sigma]
        )
        targets, weights = [], []
        for s in sigmas:
            if self.encoding.upper() == "UDP":
                t, w = udp_heatmaps(joints, vis, ann["image_size"],
                                    ann["heatmap_size"], float(s))
            else:
                t, w = msra_heatmaps(joints, vis, ann["image_size"],
                                     ann["heatmap_size"], float(s),
                                     unbiased=self.unbiased)
            targets.append(t[0].numpy())
            weights.append(w[0].numpy())
        if len(targets) == 1:
            results["target"] = targets[0]
            results["target_weight"] = weights[0]
        else:
            results["target"] = np.stack(targets)
            results["target_weight"] = np.stack(weights)
        return results


class GenerateSimDR:
    """1-D SimDR vectors (reference: generate_simder.py:3-42)."""

    def __init__(self, sigma=2, k=2):
        self.sigma = sigma
        self.k = int(k)

    def __call__(self, results):
        if self.k <= 0:
            return results
        ann = results["ann_info"]
        tx, ty = simdr_targets(
            torch.from_numpy(
                np.asarray(results["joints_3d"], np.float32)[None, :, :2]),
            torch.from_numpy(
                np.asarray(results["joints_3d_visible"], np.float32)[None, :, 0]),
            ann["image_size"], self.k, float(self.sigma),
        )
        results["simdr_x"] = tx[0].numpy()
        results["simdr_y"] = ty[0].numpy()
        return results


def build_train_pipeline(cfg, rng=None):
    """The reference's default train pipeline order
    (build_dataset.py:110-131)."""
    p = cfg.PIPELINE
    rng = rng or np.random.RandomState()
    transforms = [
        LoadImageFromFile(),
        HSVRandomAug(rng=rng),
        TopDownRandomFlip(p.get("flip_prob", 0.5), rng=rng),
        TopDownGetRandomScaleRotation(
            p.get("rot_factor", 40), p.get("scale_factor", 0.3),
            p.get("rot_prob", 0.6), rng=rng,
        ),
        TopDownAffine(p.get("use_udp", False)),
        ToTensor(),
        NormalizeTensor(),
        TopDownGenerateTarget(
            p.get("sigma", 2), p.get("encoding", "MSRA"),
            p.get("unbiased_encoding", False),
        ),
    ]
    if p.get("simdr_split_ratio", 0):
        transforms.append(
            GenerateSimDR(p.get("sigma", 2), p.simdr_split_ratio)
        )
    return Compose(transforms)
