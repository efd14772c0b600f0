"""COCO-WholeBody mAP evaluation CLI (port of
``litehandnet_tpu/tools/eval_wholebody.py``; host only, no device).

Mirror of the reference's standalone driver
(utils/post_processing/coco_wholebody_evaluation/evaluation_wholebody.py):
evaluates a result file against a GT file for every body part.

Usage:
    python -m litehandnet_tpu_torch.tools.eval_wholebody \
        --gt_file gt.json --res_file preds.json [--parts body face ...]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="COCO-WholeBody mAP evaluation"
    )
    parser.add_argument("--res_file", required=True,
                        help="path to the result file")
    parser.add_argument("--gt_file", required=True,
                        help="path to the GT annotation file")
    parser.add_argument("--parts", nargs="*", default=None,
                        help="subset of parts (default: all)")
    args = parser.parse_args(argv)

    from litehandnet_tpu_torch.data.coco import COCO
    from litehandnet_tpu_torch.eval.wholebody import evaluate_wholebody

    gt = COCO(args.gt_file)
    with open(args.res_file) as f:
        detections = json.load(f)
    results = evaluate_wholebody(gt, detections, parts=args.parts)
    for name, value in results.items():
        print(f"{name}: {value:.4f}")
    return results


if __name__ == "__main__":
    main()
