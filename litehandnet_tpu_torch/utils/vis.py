"""Visualization: prediction/GT grids and heatmap dumps (a copy of
``litehandnet_tpu/utils/vis.py``, host-side numpy and PIL, so a grid has
the JAX package's pixels).

Reference surface: utils/post_processing/vis_results.py:8-150 (
SaveResultImages) and utils/visualization_tools.py:9-160 (draw helpers).
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def denormalize(img: np.ndarray) -> np.ndarray:
    """Normalized float image -> uint8 RGB."""
    img = np.asarray(img, np.float32)
    img = (img * IMAGENET_STD + IMAGENET_MEAN) * 255.0
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_keypoints(img: np.ndarray, joints, skeleton=None,
                   kpt_colors=None, link_colors=None, radius=2,
                   visible=None):
    """Draw joints + skeleton on a uint8 RGB image (returns a copy).

    `visible` ([K] mask, optional) skips invisible joints and any skeleton
    link touching one — the reference masks by visibility, and unlabeled
    joints sit at (0, 0) where they would draw a misleading origin
    cluster."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img))
    drawer = ImageDraw.Draw(im)
    joints = np.asarray(joints)
    vis = (
        np.ones(len(joints), bool) if visible is None
        else np.asarray(visible).astype(bool).reshape(-1)
    )
    if skeleton is not None:
        for li, (a, b) in enumerate(skeleton):
            if not (vis[a] and vis[b]):
                continue
            xa, ya = joints[a][:2]
            xb, yb = joints[b][:2]
            color = tuple(
                int(c) for c in (
                    link_colors[li] if link_colors is not None else (255, 128, 0)
                )
            )
            drawer.line([xa, ya, xb, yb], fill=color, width=1)
    for ki, (x, y) in enumerate(joints[:, :2]):
        if not vis[ki]:
            continue
        color = tuple(
            int(c) for c in (
                kpt_colors[ki] if kpt_colors is not None else (0, 255, 0)
            )
        )
        drawer.ellipse([x - radius, y - radius, x + radius, y + radius],
                       fill=color)
    return np.asarray(im)


def draw_bbox(img: np.ndarray, boxes, color=(255, 0, 0)):
    """Draw (cx, cy, w, h[, conf]) boxes."""
    from PIL import Image, ImageDraw

    im = Image.fromarray(np.ascontiguousarray(img))
    drawer = ImageDraw.Draw(im)
    for box in np.asarray(boxes):
        if len(box) > 4 and box[4] <= 0:
            continue
        cx, cy, w, h = box[:4]
        drawer.rectangle(
            [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
            outline=tuple(color), width=2,
        )
    return np.asarray(im)


def heatmap_to_rgb(hm: np.ndarray) -> np.ndarray:
    """[H, W] heatmap -> uint8 RGB (red-hot colormap)."""
    hm = np.asarray(hm, np.float32)
    hm = (hm - hm.min()) / max(hm.max() - hm.min(), 1e-6)
    r = np.clip(hm * 3.0, 0, 1)
    g = np.clip(hm * 3.0 - 1.0, 0, 1)
    b = np.clip(hm * 3.0 - 2.0, 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def make_grid(images: Sequence[np.ndarray], ncols: Optional[int] = None):
    """Stack same-size uint8 images into a grid."""
    n = len(images)
    ncols = ncols or int(math.ceil(math.sqrt(n)))
    nrows = int(math.ceil(n / ncols))
    h, w = images[0].shape[:2]
    grid = np.zeros((nrows * h, ncols * w, 3), np.uint8)
    for i, im in enumerate(images):
        r, c = divmod(i, ncols)
        grid[r * h:(r + 1) * h, c * w:(c + 1) * w] = im
    return grid


class SaveResultImages:
    """Grid dumps of predictions vs GT (reference: vis_results.py:8-150)."""

    def __init__(self, dataset, out_dir: str):
        self.dataset = dataset
        self.out_dir = out_dir
        os.makedirs(out_dir, exist_ok=True)

    def _save(self, grid, name):
        from PIL import Image

        Image.fromarray(grid).save(os.path.join(self.out_dir, name))

    def save_images_with_joints(self, images, joints, joints_visible,
                                name="joints.png", max_images=16):
        tiles = []
        for i in range(min(len(images), max_images)):
            img = denormalize(np.asarray(images[i]))
            tiles.append(
                draw_keypoints(
                    img, np.asarray(joints[i]),
                    skeleton=self.dataset.pose_skeleton,
                    kpt_colors=self.dataset.pose_kpt_color,
                    link_colors=self.dataset.pose_link_color,
                    visible=(
                        None if joints_visible is None
                        else np.asarray(joints_visible[i])[..., 0]
                        if np.asarray(joints_visible[i]).ndim > 1
                        else np.asarray(joints_visible[i])
                    ),
                )
            )
        self._save(make_grid(tiles), name)

    def save_images_with_heatmap(self, images, heatmaps, name="heatmaps.png",
                                 max_images=8):
        tiles = []
        for i in range(min(len(images), max_images)):
            img = denormalize(np.asarray(images[i]))
            hm = np.asarray(heatmaps[i]).max(axis=-1)  # [h, w]
            hm_rgb = heatmap_to_rgb(hm)
            # upsample heatmap tile to image size (nearest)
            H, W = img.shape[:2]
            yi = (np.arange(H) * hm.shape[0] // H).clip(0, hm.shape[0] - 1)
            xi = (np.arange(W) * hm.shape[1] // W).clip(0, hm.shape[1] - 1)
            overlay = (0.5 * img + 0.5 * hm_rgb[yi][:, xi]).astype(np.uint8)
            tiles.append(overlay)
        self._save(make_grid(tiles), name)
