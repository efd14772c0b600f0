"""Image and video demo on one device (port of
``litehandnet_tpu/tools/demo.py``; the reference's test/video_demo.py).

Usage:
    python -m litehandnet_tpu_torch.tools.demo --cfg <config> \
        --inputs img1.jpg img2.jpg [--out-dir demo_out] [--load-best] \
        [--pyramid] [--max-hands N] [--device cuda|cpu]

For each image (or each frame of a video, with cv2): a model with region
maps (``MODEL.with_region_map`` or ``pred_bbox``) goes through
``ResultParser``: boxes from the center map, keypoints per box, drawn with
their skeletons (``--max-hands`` boxes at most); any other model is decoded
top-down over the whole image by ``TopDownDecoder``; ``--pyramid`` runs
SRHandNet's two-stage inference on the full frame. The weights are the
run's checkpoint (``--load-best``: the best slot), else the port's init
drawn from seed 0, as ``tools/test --allow-init``; ``litehandnet`` runs
deploy-fused.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from litehandnet_tpu_torch import resolve_device
from litehandnet_tpu_torch.config import get_config
from litehandnet_tpu_torch.data.dataset_info import DATASET_INFOS, DatasetInfo
from litehandnet_tpu_torch.eval.decoder import TopDownDecoder, unpack_outputs
from litehandnet_tpu_torch.eval.result_parser import ResultParser
from litehandnet_tpu_torch.models import get_model
from litehandnet_tpu_torch.tools.test import eval_model
from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
from litehandnet_tpu_torch.utils.vis import draw_bbox, draw_keypoints

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)
VIDEO_SUFFIXES = (".mp4", ".avi", ".mov", ".mkv")


def load_model(cfg, load_best: bool, device) -> torch.nn.Module:
    """The run's checkpoint restored raw (the model's state only), else the
    port's init from seed 0; deploy-fused for ``litehandnet``; in eval mode
    on ``device``."""
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = get_model(cfg, device="cpu")
    saved, _ = CheckpointManager(run_dir(cfg), cfg, read_only=True).restore_raw(
        best=load_best)
    if saved is None:
        print("no checkpoint found; running random init", flush=True)
    else:
        model.load_state_dict(saved["model"])
    return eval_model(cfg, model, device)


def iter_frames(paths):
    """(tag, RGB frame) of each image file, or of each frame of a video
    (with cv2, as test/video_demo.py)."""
    from PIL import Image

    for path in paths:
        if path.lower().endswith(VIDEO_SUFFIXES):
            import cv2

            cap = cv2.VideoCapture(path)
            n = 0
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield f"{os.path.basename(path)}_{n:05d}.jpg", frame[..., ::-1]
                n += 1
            cap.release()
        else:
            yield os.path.basename(path), np.asarray(
                Image.open(path).convert("RGB"))


@torch.no_grad()
def main(argv=None):
    parser = argparse.ArgumentParser(description="litehandnet_tpu_torch demo")
    parser.add_argument("--cfg", required=True)
    parser.add_argument("--inputs", nargs="+", required=True,
                        help="image files or a single video file")
    parser.add_argument("--out-dir", default="demo_out")
    parser.add_argument("--load-best", action="store_true")
    parser.add_argument(
        "--pyramid", action="store_true",
        help="SRHandNet two-stage multi-hand inference on full frames "
             "(reference official_code.py:28-213)")
    parser.add_argument("--max-hands", type=int, default=4)
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    args = parser.parse_args(argv)
    from PIL import Image

    device = resolve_device(args.device)
    cfg = get_config(args.cfg)
    os.makedirs(args.out_dir, exist_ok=True)
    W, H = (int(v) for v in cfg.DATASET.image_size)
    info = DatasetInfo(DATASET_INFOS[cfg.DATASET.name.lower()])
    K = info.keypoint_num
    model = load_model(cfg, args.load_best, device)
    with_region = (cfg.MODEL.get("pred_bbox", False)
                   or cfg.MODEL.get("with_region_map", False))
    decoder = TopDownDecoder(cfg, device=device)
    # pcfg.max_num_bbox is the reference's single-hand default (1); the demo
    # drives multi-hand scenes, so --max-hands raises the cap
    parser_ = (ResultParser(cfg, max_num_bbox=args.max_hands, device=device)
               if with_region else None)
    pyramid = None
    if args.pyramid:
        from litehandnet_tpu_torch.eval.srhandnet_pyramid import SRHandNetPyramid

        if cfg.MODEL.name.lower() != "srhandnet":
            raise ValueError("--pyramid is the SRHandNet official demo path")
        pyramid = SRHandNetPyramid(model, input_hw=(H, W),
                                   max_hands=args.max_hands, num_joints=K,
                                   device=device)

    written = []
    for tag, frame in iter_frames(args.inputs):
        if pyramid is not None:
            coords, found, rects, hand_valid = pyramid(frame)
            vis = frame
            valid_rects = rects[hand_valid]
            if len(valid_rects):
                # (x, y, w, h) -> (cx, cy, w, h) for draw_bbox
                cboxes = valid_rects.copy()
                cboxes[:, :2] += cboxes[:, 2:] / 2
                vis = draw_bbox(vis, np.concatenate(
                    [cboxes, np.ones((len(cboxes), 1))], axis=1))
            for hi in np.where(hand_valid)[0]:
                hand = np.concatenate(
                    [coords[hi], found[hi][:, None].astype(np.float32)], axis=1)
                vis = draw_keypoints(vis, hand, info.skeleton,
                                     info.pose_kpt_color, info.pose_link_color)
        else:
            img = np.asarray(Image.fromarray(frame).resize((W, H)))
            inp = ((img / 255.0 - IMAGENET_MEAN) / IMAGENET_STD).astype(
                np.float32)[None]
            x = torch.from_numpy(inp).to(device).permute(0, 3, 1, 2)
            out = model(x)
            maps = out
            if isinstance(out, (tuple, list)):
                # the last stack of (stacks, pred_x, pred_y), else the last
                # (finest) output
                maps = (out[0][-1] if isinstance(out[0], (tuple, list))
                        else out[-1])
            if with_region and maps.shape[1] >= K + 3:
                hm = maps.float().permute(0, 2, 3, 1)   # [1, h, w, C]
                boxes = parser_.get_pred_bbox(hm[..., -3:])
                kpts = parser_.get_group_keypoints(inp, hm[..., :-3], boxes)
                vis = draw_bbox(img, boxes[0])
                for hand in kpts[0]:
                    if hand[:, 2].max() > 0:
                        vis = draw_keypoints(vis, hand, info.skeleton,
                                             info.pose_kpt_color,
                                             info.pose_link_color)
            else:
                center = np.array([[W / 2, H / 2]], np.float32)
                scale = np.array([[W / 200.0, H / 200.0]], np.float32)
                res = decoder.decode({"center": center, "scale": scale},
                                     unpack_outputs(out, K)[0])
                vis = draw_keypoints(img, res["preds"][0], info.skeleton,
                                     info.pose_kpt_color, info.pose_link_color)
        out_path = os.path.join(args.out_dir, tag)
        Image.fromarray(np.asarray(vis, np.uint8)).save(out_path)
        written.append(out_path)
        print(f"wrote {out_path}", flush=True)
    return written


if __name__ == "__main__":
    main()
