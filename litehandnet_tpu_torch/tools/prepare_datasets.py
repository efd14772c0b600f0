"""Convert OFFICIAL dataset archives into the COCO-json layout the configs
expect (`data/handset/<ds>/annotations/<ds>_{train,val,test}.json`); port of
``litehandnet_tpu/tools/prepare_datasets.py``, host only, no device.

The reference never ships this step: its `generate_dataset.ipynb` consumes
ALREADY-converted COCO jsons, so a user arriving with the official
downloads has no path into either framework. This CLI closes that gap for
the four BASELINE §A hand datasets; afterwards `tools/reproduce_auc.py
--data-root <root>` runs the full grid.

Official layouts handled (from each dataset's public release):

  freihand   FreiHAND_pub_v2: training/rgb/%08d.jpg (G annotated images,
             optionally x4 augmented versions where image i reuses
             annotation i % G), training_K.json (G 3x3 intrinsics),
             training_xyz.json (G 21x3 3D joints); evaluation/rgb +
             evaluation_K.json + evaluation_xyz.json for the test split.
             2D keypoints are the pinhole projection uv = (K @ xyz)_xy/z.
  rhd        RHD_published_v2: {training,evaluation}/color/%05d.png
             (320x320) + anno_{training,evaluation}.pickle — dict
             idx -> {'uv_vis': (42,3) [u, v, visible] for left(0:21) and
             right(21:42) hands, 'xyz': (42,3), 'K': (3,3)}. One COCO
             annotation per hand with >=1 visible keypoint, bbox = visible
             keypoint extents.
  panoptic   CMU "hand_labels": manual_{train,test}/*.json, each with
             hand_pts (21x[x, y, conf]), is_left, head_size (MPII-derived
             frames), and the image as the same basename .jpg.
  onehand10k OneHand10K: {Train,Test}/source/*.jpg + an annotation txt
             whose lines are `name[,W,H],x1,y1,...,x21,y21` (comma or
             whitespace separated; missing joints encoded as -1,-1).
             NOTE: validate the column convention against your download —
             the txt variant in the wild differs by the optional W,H pair;
             both are auto-detected by field count.

Images are symlinked (not copied) into the destination; annotations are
rewritten as COCO dicts with per-hand bbox and keypoint triples
(v=2 visible / 0 unlabeled). Keypoint ORDER is passed through unchanged
from each official source, matching the reference's dataset_info
conventions (datasets/dataset_info/dataset_configs/*.py).

Usage:
    python -m litehandnet_tpu_torch.tools.prepare_datasets freihand \
        --src /downloads/FreiHAND_pub_v2 --dst data/handset/freihand
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import pickle


def _coco(images, annotations):
    return dict(images=images, annotations=annotations,
                categories=[dict(id=1, name="hand")])


def _link(src: str, dst: str) -> None:
    """Symlink src -> dst (absolute target); replace a stale link."""
    src = osp.abspath(src)
    if osp.islink(dst):
        os.remove(dst)
    os.makedirs(osp.dirname(dst), exist_ok=True)
    os.symlink(src, dst)


def _kpt_bbox(kpts, margin: float = 1.0):
    """[x, y, w, h] over the visible keypoints (v > 0), 1-px margin so
    degenerate single-point hands keep a positive area."""
    import numpy as np

    k = np.asarray(kpts, np.float32).reshape(-1, 3)
    vis = k[:, 2] > 0
    xs, ys = k[vis, 0], k[vis, 1]
    x1, y1 = float(xs.min() - margin), float(ys.min() - margin)
    return [x1, y1, float(xs.max() + margin) - x1,
            float(ys.max() + margin) - y1]


def prepare_freihand(src: str, dst: str, val_frac: float = 0.03) -> dict:
    import numpy as np

    ann_dir = osp.join(dst, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    _link(osp.join(src, "training", "rgb"), osp.join(dst, "images_train"))

    with open(osp.join(src, "training_K.json")) as f:
        Ks = np.asarray(json.load(f), np.float64)
    with open(osp.join(src, "training_xyz.json")) as f:
        xyzs = np.asarray(json.load(f), np.float64)
    G = len(Ks)
    assert len(xyzs) == G, (len(xyzs), G)
    names = sorted(os.listdir(osp.join(src, "training", "rgb")))

    def project(xyz, K):
        uvw = xyz @ K.T
        return uvw[:, :2] / uvw[:, 2:3]

    def record(i, name, prefix, K, xyz, base_id):
        uv = project(xyz, K)
        kpts = []
        for x, y in uv:
            kpts += [float(x), float(y), 2]
        img = dict(id=base_id + i, file_name=f"{prefix}/{name}",
                   width=224, height=224)
        ann = dict(id=base_id + i, image_id=base_id + i, category_id=1,
                   iscrowd=0, keypoints=kpts, bbox=_kpt_bbox(kpts),
                   area=224.0 * 224.0)
        return img, ann

    # image i (any of the up-to-4 augmented versions) reuses annotation
    # i % G (official FreiHAND convention)
    train_imgs, train_anns, val_imgs, val_anns = [], [], [], []
    n_val_base = max(1, int(G * val_frac))
    for i, name in enumerate(names):
        img, ann = record(i, name, "images_train",
                          Ks[i % G], xyzs[i % G], 0)
        # the val split holds the LAST n_val_base base indices of every
        # version block, so no base annotation leaks between splits
        if i % G >= G - n_val_base:
            val_imgs.append(img), val_anns.append(ann)
        else:
            train_imgs.append(img), train_anns.append(ann)

    with open(osp.join(ann_dir, "freihand_train.json"), "w") as f:
        json.dump(_coco(train_imgs, train_anns), f)
    with open(osp.join(ann_dir, "freihand_val.json"), "w") as f:
        json.dump(_coco(val_imgs, val_anns), f)

    counts = dict(train=len(train_anns), val=len(val_anns), test=0)
    eval_xyz = osp.join(src, "evaluation_xyz.json")
    if osp.isfile(eval_xyz):
        _link(osp.join(src, "evaluation", "rgb"),
              osp.join(dst, "images_eval"))
        with open(osp.join(src, "evaluation_K.json")) as f:
            eKs = np.asarray(json.load(f), np.float64)
        with open(eval_xyz) as f:
            exyzs = np.asarray(json.load(f), np.float64)
        enames = sorted(os.listdir(osp.join(src, "evaluation", "rgb")))
        imgs, anns = [], []
        for i, name in enumerate(enames):
            img, ann = record(i, name, "images_eval", eKs[i], exyzs[i],
                              10_000_000)
            imgs.append(img), anns.append(ann)
        with open(osp.join(ann_dir, "freihand_test.json"), "w") as f:
            json.dump(_coco(imgs, anns), f)
        counts["test"] = len(anns)
    else:
        # the official evaluation annotations were released separately; if
        # absent, point the test split at val so the grid still runs
        with open(osp.join(ann_dir, "freihand_test.json"), "w") as f:
            json.dump(_coco(val_imgs, val_anns), f)
        counts["test"] = f"val reused ({len(val_anns)}) — evaluation_xyz.json absent"
    return counts


def prepare_rhd(src: str, dst: str) -> dict:
    ann_dir = osp.join(dst, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    counts = {}
    for split, out_name in (("training", "rhd_train.json"),
                            ("evaluation", "rhd_test.json")):
        color = osp.join(src, split, "color")
        pkl = osp.join(src, f"anno_{split}.pickle")
        if not osp.isfile(pkl):
            counts[split] = f"skipped — {pkl} absent"
            continue
        _link(color, osp.join(dst, f"images_{split}"))
        with open(pkl, "rb") as f:
            # the official pickles are python2-era: latin1 decodes them
            anno = pickle.load(f, encoding="latin1")
        imgs, anns = [], []
        ann_id = 0
        for idx in sorted(anno):
            uv_vis = anno[idx]["uv_vis"]
            name = f"{idx:05d}.png"
            img_id = len(imgs)
            hands = []
            for lo in (0, 21):  # left then right hand
                hand = uv_vis[lo:lo + 21]
                if float(hand[:, 2].sum()) < 1:
                    continue
                kpts = []
                for u, v, vis in hand:
                    kpts += [float(u), float(v), 2 if vis > 0 else 0]
                hands.append(dict(
                    id=ann_id, image_id=img_id, category_id=1, iscrowd=0,
                    keypoints=kpts, bbox=_kpt_bbox(kpts),
                    area=float(_kpt_bbox(kpts)[2] * _kpt_bbox(kpts)[3]),
                ))
                ann_id += 1
            if not hands:
                continue
            imgs.append(dict(id=img_id, file_name=f"images_{split}/{name}",
                             width=320, height=320))
            anns.extend(hands)
        with open(osp.join(ann_dir, out_name), "w") as f:
            json.dump(_coco(imgs, anns), f)
        counts[split] = len(anns)
    return counts


def prepare_panoptic(src: str, dst: str) -> dict:
    from PIL import Image

    ann_dir = osp.join(dst, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    counts = {}
    for split, out_name in (("manual_train", "panoptic_train.json"),
                            ("manual_test", "panoptic_test.json")):
        sdir = osp.join(src, split)
        if not osp.isdir(sdir):
            counts[split] = f"skipped — {sdir} absent"
            continue
        _link(sdir, osp.join(dst, split))
        imgs, anns = [], []
        for jname in sorted(os.listdir(sdir)):
            if not jname.endswith(".json"):
                continue
            with open(osp.join(sdir, jname)) as f:
                rec = json.load(f)
            base = jname[:-len(".json")]
            img_path = osp.join(sdir, base + ".jpg")
            if not osp.isfile(img_path):
                continue
            with Image.open(img_path) as im:
                W, H = im.size
            kpts = []
            for x, y, conf in rec["hand_pts"]:
                kpts += [float(x), float(y), 2 if conf > 0 else 0]
            img_id = len(imgs)
            imgs.append(dict(id=img_id, file_name=f"{split}/{base}.jpg",
                             width=W, height=H))
            bbox = _kpt_bbox(kpts)
            anns.append(dict(
                id=img_id, image_id=img_id, category_id=1, iscrowd=0,
                keypoints=kpts, bbox=bbox, area=float(bbox[2] * bbox[3]),
                # PCKh normalizer (reference panoptic_hand2d_dataset.py:103);
                # 0.7*head_size scaling happens at eval time
                head_size=float(rec.get("head_size", 1.0)),
            ))
        with open(osp.join(ann_dir, out_name), "w") as f:
            json.dump(_coco(imgs, anns), f)
        counts[split] = len(anns)
    return counts


def prepare_onehand10k(src: str, dst: str) -> dict:
    from PIL import Image

    ann_dir = osp.join(dst, "annotations")
    os.makedirs(ann_dir, exist_ok=True)
    counts = {}
    for split, out_name in (("Train", "onehand10k_train.json"),
                            ("Test", "onehand10k_test.json")):
        sdir = osp.join(src, split)
        if not osp.isdir(sdir):
            counts[split] = f"skipped — {sdir} absent"
            continue
        txts = [n for n in sorted(os.listdir(sdir)) if n.endswith(".txt")]
        if not txts:
            counts[split] = f"skipped — no annotation txt in {sdir}"
            continue
        _link(osp.join(sdir, "source"), osp.join(dst, f"images_{split}"))
        imgs, anns = [], []
        with open(osp.join(sdir, txts[0])) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                fields = line.replace(",", " ").split()
                name = fields[0]
                nums = [float(v) for v in fields[1:]]
                if len(nums) == 44:          # W, H, then 21 x (x, y)
                    W, H = int(nums[0]), int(nums[1])
                    coords = nums[2:]
                elif len(nums) == 42:        # 21 x (x, y); probe the image
                    with Image.open(
                            osp.join(sdir, "source", name)) as im:
                        W, H = im.size
                    coords = nums
                else:
                    raise ValueError(
                        f"unrecognized OneHand10K annotation line "
                        f"({len(nums)} numeric fields): {line[:80]}")
                kpts = []
                visible = 0
                for j in range(21):
                    x, y = coords[2 * j], coords[2 * j + 1]
                    v = 2 if x >= 0 and y >= 0 else 0
                    visible += v > 0
                    kpts += [x, y, v]
                if not visible:
                    continue
                img_id = len(imgs)
                imgs.append(dict(id=img_id,
                                 file_name=f"images_{split}/{name}",
                                 width=W, height=H))
                bbox = _kpt_bbox(kpts)
                anns.append(dict(
                    id=img_id, image_id=img_id, category_id=1, iscrowd=0,
                    keypoints=kpts, bbox=bbox,
                    area=float(bbox[2] * bbox[3]),
                ))
        with open(osp.join(ann_dir, out_name), "w") as f:
            json.dump(_coco(imgs, anns), f)
        counts[split] = len(anns)
    return counts


PREPARERS = {
    "freihand": prepare_freihand,
    "rhd": prepare_rhd,
    "panoptic": prepare_panoptic,
    "onehand10k": prepare_onehand10k,
}


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="official archive -> data/handset COCO layout")
    parser.add_argument("dataset", choices=sorted(PREPARERS))
    parser.add_argument("--src", required=True,
                        help="official archive root (e.g. FreiHAND_pub_v2)")
    parser.add_argument("--dst", required=True,
                        help="destination (e.g. data/handset/freihand)")
    parser.add_argument("--val-frac", type=float, default=0.03,
                        help="freihand only: fraction of base annotations "
                             "held out as the val split")
    args = parser.parse_args(argv)

    kw = {"val_frac": args.val_frac} if args.dataset == "freihand" else {}
    counts = PREPARERS[args.dataset](args.src, args.dst, **kw)
    print(json.dumps({"dataset": args.dataset, "dst": args.dst,
                      "annotations": counts}))
    return counts


if __name__ == "__main__":
    main()
