"""Build size-stratified eval splits from a COCO-format annotation file
(port of ``litehandnet_tpu/tools/split_testset.py``; host only, no device).

Reference workflow: utils/k_means.py clusters relative bbox areas
(bbox_area / input_area, 4 clusters initialized at 0.2/0.4/0.6/0.8,
midpoint thresholds) and the resulting per-bin annotation files are
shipped as split_testset/freihand_20/{small,middle,large}.json. This CLI
automates that: it reads one annotation json, bins every annotation by
relative bbox area, and writes one COCO json per bin (images without a
surviving annotation are dropped from that bin).

Usage:
    python -m litehandnet_tpu_torch.tools.split_testset \
        --ann data/handset/freihand/annotations/freihand_test.json \
        --image-size 224 224 --out-dir split_testset/freihand
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np

from litehandnet_tpu_torch.utils.kmeans import kmeans_ref, size_thresholds

_DEFAULT_NAMES = {
    2: ["small", "large"],
    3: ["small", "middle", "large"],
    4: ["small", "middle", "large", "xlarge"],
}


def build_splits(ann: dict, image_area: float, centers_init):
    """Returns (bin_annotation_lists, thresholds, centers).

    Clusters that end up empty (the reference's phantom-sample quirk decays
    them toward 0, leaving the center list unsorted) are dropped before
    thresholding, and the surviving centers are sorted — so the midpoint
    thresholds are monotonic and the bin walk below is well-defined. The
    returned bins/centers may therefore be fewer than ``centers_init``."""
    annotations = ann.get("annotations", [])
    sizes = [
        a["bbox"][2] * a["bbox"][3] / image_area for a in annotations
    ]
    centers, counts = kmeans_ref(sizes, centers_init)
    kept = np.sort(centers[np.asarray(counts) > 1.0])
    if kept.size == 0:  # no annotations at all
        kept = np.sort(np.asarray(centers_init, np.float64))[:1]
    thresholds, _ = size_thresholds(sizes, kept)
    bins = [[] for _ in range(len(kept))]
    for a, s in zip(annotations, sizes):
        b = 0
        while b < len(thresholds) and s >= thresholds[b]:
            b += 1
        bins[b].append(a)
    return bins, thresholds, kept


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ann", required=True, help="COCO annotation json")
    p.add_argument("--image-size", type=float, nargs=2, default=[224, 224],
                   help="model input size the relative area normalizes by "
                        "(reference uses cfg image_size)")
    p.add_argument("--out-dir", required=True)
    p.add_argument("--clusters", type=float, nargs="+",
                   default=[0.2, 0.4, 0.6, 0.8],
                   help="initial cluster centers (reference: 4 at .2-.8)")
    p.add_argument("--names", nargs="+", default=None,
                   help="bin names, smallest first (default: "
                        "small/middle/large[/xlarge])")
    args = p.parse_args(argv)

    names = args.names or _DEFAULT_NAMES.get(
        len(args.clusters),
        [f"bin{i}" for i in range(len(args.clusters))],
    )
    if len(names) != len(args.clusters):
        raise SystemExit(
            f"{len(args.clusters)} clusters need {len(args.clusters)} "
            f"names, got {names}"
        )

    with open(args.ann) as f:
        ann = json.load(f)
    area = args.image_size[0] * args.image_size[1]
    bins, thresholds, centers = build_splits(ann, area, args.clusters)
    if len(bins) < len(args.clusters):
        print(
            f"warning: {len(args.clusters) - len(bins)} cluster(s) ended "
            f"up empty and were dropped; writing {len(bins)} bin(s)"
        )
        names = names[: len(bins)]
    print(f"centers={np.round(centers, 4).tolist()}")
    print(f"thresholds={[round(t, 4) for t in thresholds]}")

    os.makedirs(args.out_dir, exist_ok=True)
    base = {k: v for k, v in ann.items()
            if k not in ("images", "annotations")}
    images_by_id = {im["id"]: im for im in ann.get("images", [])}
    outs = []
    for name, rows in zip(names, bins):
        img_ids = {a["image_id"] for a in rows}
        out = dict(
            base,
            images=[images_by_id[i] for i in sorted(img_ids)
                    if i in images_by_id],
            annotations=rows,
        )
        path = os.path.join(args.out_dir, f"{name}.json")
        with open(path, "w") as f:
            json.dump(out, f)
        print(f"{name}: {len(rows)} annotations, "
              f"{len(out['images'])} images -> {path}")
        outs.append(path)
    return outs


if __name__ == "__main__":
    main()
