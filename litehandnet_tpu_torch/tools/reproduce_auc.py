"""Reproduce the reference's headline accuracy table (BASELINE.md §A); port
of ``litehandnet_tpu/tools/reproduce_auc.py``.

The reference publishes one results artifact: `model_performance.png` — an
AUC table of 6 models x 4 hand datasets at 256x256 input
(/root/reference/README.md:4). This driver reproduces it end to end with
the port: for every (model, dataset) cell it trains via the port's
`tools/train.py` (loader -> DevicePipeline -> Trainer, on `--device`) and
evaluates the saved best checkpoint via its `tools/test.py` (deploy-fused
forward + batched DARK decode + PCK/AUC/EPE), then prints the
measured-vs-reference table and writes `auc_table.json`. `--num-devices N`
trains each cell on N ranks of this host (`tools/train.py --num-devices`).

The only input it cannot synthesize is the datasets themselves: COCO-format
annotation files + images under the reference's own layout
(`data/handset/{freihand,rhd,onehand10k,panoptic}/...`, templates.py keeps
the reference paths verbatim). Cells whose annotation file is absent are
reported as SKIPPED(no data) so a partial checkout still yields a partial
table.

Usage:
    python -m litehandnet_tpu_torch.tools.reproduce_auc \
        --data-root /path/to/datasets [--models litehandnet resnet18] \
        [--datasets freihand rhd] [--eval-only] [--bf16] [--num-devices N] \
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os

# (display name, reference AUC per dataset) from BASELINE.md §A /
# /root/reference/model_performance.png
REFERENCE_AUC = {
    "srhandnet":   {"onehand10k": 32.5, "panoptic": 43.0,
                    "freihand": 83.0, "rhd": 84.1},
    "litehrnet18": {"onehand10k": 46.5, "panoptic": 63.0,
                    "freihand": 80.9, "rhd": 80.7},
    "resnet18":    {"onehand10k": 50.2, "panoptic": 61.3,
                    "freihand": 80.2, "rhd": 80.8},
    "mobilenetv2": {"onehand10k": 47.0, "panoptic": 61.6,
                    "freihand": 81.9, "rhd": 84.1},
    "litehrnet30": {"onehand10k": 48.1, "panoptic": 64.3,
                    "freihand": 82.1, "rhd": 85.4},
    "litehandnet": {"onehand10k": 51.4, "panoptic": 65.2,
                    "freihand": 82.5, "rhd": 85.2},
}

# experiment-config name per (model, dataset) cell, all 256x256
CONFIGS = {
    "srhandnet":   {d: f"srhandnet/{d}_256"
                    for d in ("onehand10k", "panoptic", "freihand", "rhd")},
    "litehrnet18": {d: f"litehrnet/{d}_256_d18"
                    for d in ("onehand10k", "panoptic", "freihand", "rhd")},
    "litehrnet30": {d: f"litehrnet/{d}_256_d30"
                    for d in ("onehand10k", "panoptic", "freihand", "rhd")},
    "resnet18":    {d: f"resnet/{d}_256_r18"
                    for d in ("onehand10k", "panoptic", "freihand", "rhd")},
    "mobilenetv2": {d: f"mobilenetv2/{d}_256"
                    for d in ("onehand10k", "panoptic", "freihand", "rhd")},
    "litehandnet": {
        "onehand10k": "litehandnet/onehand10k_256_dark_h4_ca_r4",
        "panoptic": "litehandnet/panoptic_256_dark_h4_ca_r4",
        "freihand": "litehandnet/freihand_256_dark_h4_ca_r4",
        "rhd": "litehandnet/rhd_256_dark_h4_ca_r4",
    },
}


def _ann_file(cfg_name: str) -> str:
    from litehandnet_tpu_torch.config import get_config

    return get_config(cfg_name).DATASET.train.ann_file


def main(argv=None):
    parser = argparse.ArgumentParser(
        description="reproduce BASELINE.md §A (AUC, 6 models x 4 datasets)"
    )
    parser.add_argument("--data-root", default=".",
                        help="directory containing the reference's "
                             "data/handset/... dataset layout")
    parser.add_argument("--models", nargs="+",
                        default=list(CONFIGS), choices=list(CONFIGS))
    parser.add_argument("--datasets", nargs="+",
                        default=["onehand10k", "panoptic", "freihand", "rhd"])
    parser.add_argument("--eval-only", action="store_true",
                        help="skip training; evaluate existing best "
                             "checkpoints only")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--decode-procs", type=int, default=0,
                        help="decode worker processes per loader "
                             "(set ~cores-2 on a real host)")
    parser.add_argument("--epochs", type=int, default=None,
                        help="override every cell's cfg.TRAIN.total_epoches "
                             "(smoke runs / budget-capped reproductions)")
    parser.add_argument("--num-devices", type=int, default=None,
                        help="ranks each cell trains on (tools/train.py "
                             "--num-devices), TRAIN.batch_per_gpu rows each")
    parser.add_argument("--device", default="cuda",
                        help="cuda (default) or cpu")
    parser.add_argument("--out", default="auc_table.json")
    args = parser.parse_args(argv)
    from litehandnet_tpu_torch.train.distributed import check_device_count

    # no CUDA, or fewer devices than asked: raise here, not in every cell
    check_device_count(args.num_devices, args.device)

    # resolve --out before entering --data-root (template dataset paths are
    # reference-relative, so the cells run chdir'd into the data root);
    # restore the caller's cwd afterwards — in-process callers must not be
    # left stranded in the data root
    out_path = os.path.abspath(args.out)
    prev_cwd = os.getcwd()
    os.chdir(args.data_root)

    from litehandnet_tpu_torch.tools.test import main as eval_main
    from litehandnet_tpu_torch.tools.train import main as train_main

    results: dict[str, dict[str, dict]] = {}
    try:
        for model in args.models:
            results[model] = {}
            for ds in args.datasets:
                cfg_name = CONFIGS[model][ds]
                ann = _ann_file(cfg_name)
                if not os.path.isfile(ann):
                    results[model][ds] = {"status": "SKIPPED(no data)",
                                          "missing": ann}
                    print(f"[{model}/{ds}] SKIPPED — {ann} not found")
                    continue
                procs = ["--decode-procs", str(args.decode_procs),
                         "--device", args.device]
                try:
                    if not args.eval_only:
                        extra = ([] if args.epochs is None
                                 else ["--epochs", str(args.epochs)])
                        if args.num_devices is not None:
                            extra += ["--num-devices", str(args.num_devices)]
                        train_main(["--cfg", cfg_name] + procs + extra)
                    eval_args = ["--cfg", cfg_name, "--load-best"] + procs
                    if args.bf16:
                        eval_args.append("--bf16")
                    metrics = eval_main(eval_args)
                    cell = {"status": "ok",
                            **{k: float(v) for k, v in metrics.items()},
                            "reference_auc": REFERENCE_AUC[model][ds]}
                except Exception as exc:  # keep filling the rest
                    cell = {"status": f"FAILED({type(exc).__name__})",
                            "error": str(exc)}
                results[model][ds] = cell
                print(f"[{model}/{ds}] {cell}")
    finally:
        os.chdir(prev_cwd)

    with open(out_path, "w") as f:
        json.dump(results, f, indent=2)

    # measured-vs-reference table (AUC x100 like the png)
    hdr = "| model | " + " | ".join(args.datasets) + " |"
    print("\n" + hdr + "\n|" + "---|" * (len(args.datasets) + 1))
    for model in args.models:
        cells = []
        for ds in args.datasets:
            c = results[model][ds]
            if c.get("status") == "ok" and "AUC" in c:
                cells.append(
                    f"{100 * c['AUC']:.1f} (ref {c['reference_auc']})"
                )
            else:
                cells.append(c["status"])
        print(f"| {model} | " + " | ".join(cells) + " |")
    return results


if __name__ == "__main__":
    main()
