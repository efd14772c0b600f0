"""Experiment-config templates (port of ``litehandnet_tpu/config/templates.py``).

Builds configs with the reference schema
``{ID, MODEL, DATASET, PIPELINE, CHECKPOINT, EVAL, TRAIN, OPTIMIZER, LOSS}``
from (model family, dataset, overrides). A user's own experiment file is a
``.py`` whose ``_get_cfg()`` returns ``make_cfg(...)`` from this module.
"""

from __future__ import annotations

import copy

_DATASETS = {
    "freihand": dict(
        name="freihand", num_joints=21,
        ann_root="data/handset/freihand/annotations",
        img_prefix="data/handset/freihand/",
        files=("freihand_train.json", "freihand_val.json", "freihand_test.json"),
    ),
    "rhd": dict(
        name="rhd", num_joints=21,  # registry aliases rhd == rhd2d
        ann_root="data/handset/rhd/annotations",
        img_prefix="data/handset/rhd/",
        files=("rhd_train.json", "rhd_test.json", "rhd_test.json"),
    ),
    "onehand10k": dict(
        name="onehand10k", num_joints=21,
        ann_root="data/handset/onehand10k/annotations",
        img_prefix="data/handset/onehand10k/",
        files=("onehand10k_train.json", "onehand10k_test.json",
               "onehand10k_test.json"),
    ),
    "panoptic": dict(
        name="panoptic", num_joints=21,
        ann_root="data/handset/panoptic/annotations",
        img_prefix="data/handset/panoptic/",
        files=("panoptic_train.json", "panoptic_test.json",
               "panoptic_test.json"),
    ),
    "coco_wholebody_hand": dict(
        name="coco_wholebody_hand", num_joints=21,
        ann_root="data/coco/annotations",
        img_prefix="data/coco/",
        files=("coco_wholebody_train_v1.0.json",
               "coco_wholebody_val_v1.0.json",
               "coco_wholebody_val_v1.0.json"),
    ),
    "mpii": dict(
        name="mpii", num_joints=16,
        ann_root="data/mpii/annotations",
        img_prefix="data/mpii/images/",
        files=("mpii_train.json", "mpii_val.json", "mpii_val.json"),
    ),
    "coco": dict(
        name="coco", num_joints=17,
        ann_root="data/coco/annotations",
        img_prefix="data/coco/",
        files=("person_keypoints_train2017.json",
               "person_keypoints_val2017.json",
               "person_keypoints_val2017.json"),
    ),
    "mpii_action": dict(
        name="mpii_action", num_joints=16,
        ann_root="data/mpii/annotations",
        img_prefix="data/mpii/images/",
        files=("mpii_action_train.json", "mpii_action_val.json",
               "mpii_action_val.json"),
    ),
    "zhhand": dict(
        name="zhhand", num_joints=21,
        ann_root="data/handset/zhhand/annotations",
        img_prefix="data/handset/zhhand/",
        files=("zhhand_train.json", "zhhand_test.json", "zhhand_test.json"),
    ),
}

_MODELS = {
    "litehandnet": dict(
        name="litehandnet", num_stage=4, num_block=[2, 2, 2],
        input_channel=128, ca_type="ca", reduction=4,
        activation="leakyrelu", pred_bbox=False,
    ),
    "mynet": dict(
        name="mynet", num_stage=4, num_block=[2, 2, 2], input_channel=128,
    ),
    "mynet_stacked": dict(
        name="mynet_stacked", hm_loss_factor=[1.0, 1.0], main_channels=128,
        hg_depth=4, increase=0, with_region_map=True, simdr_split_ratio=2,
    ),
    "hourglass": dict(name="hourglass", num_stack=2, num_level=4,
                      input_channel=256),
    "hourglass_ablation": dict(
        name="hourglass_ablation", num_stage=4, num_block=[2, 2, 2],
        input_channel=128, msrb=True, rca=False, ca_type="ca",
    ),
    "litehrnet": dict(name="litehrnet", depth=30),
    "resnet": dict(name="resnet", depth=50),
    "mobilenetv2": dict(name="mobilenetv2", widen_factor=1.0),
    "srhandnet": dict(name="srhandnet", output_channel=24, pred_bbox=True),
    "atthandnet": dict(name="atthandnet", output_channel=42),
}


def make_cfg(model: str, dataset: str, exp_id: int = 1, image_size=256,
             **overrides) -> dict:
    """A plain config dict. ``overrides`` are ``'SECTION.field'`` keys (one
    field) or ``'SECTION'`` keys (a whole section, which must exist).

    Raises:
        KeyError: an unknown model, dataset or bare section name.
    """
    ds = _DATASETS[dataset]
    model_cfg = copy.deepcopy(_MODELS[model])
    num_joints = ds["num_joints"]
    model_cfg.setdefault("output_channel", num_joints)
    size = (
        list(image_size) if isinstance(image_size, (list, tuple))
        else [image_size, image_size]
    )
    if model == "srhandnet":
        heatmap_size = [
            [s // 16, s // 16] for s in (size[0], size[0], size[0] * 2,
                                         size[0] * 4)
        ]
        sigma = [2, 2, 2, 2]
        loss = dict(type="SRHandNetLoss",
                    loss_weight=[0.1, 0.2, 0.3, 0.4], auto_weight=False)
    elif model == "mynet_stacked":
        # Gen-1 center+SimDR workflow: per-stack region loss + SimDR heads
        heatmap_size = [size[0] // 4, size[1] // 4]
        sigma = 2
        loss = dict(type="CenterSimdrLoss", loss_weight=[1.0],
                    auto_weight=False, simdr_weight=1.0)
    else:
        heatmap_size = [size[0] // 4, size[1] // 4]
        sigma = 2
        loss = dict(type="TopdownHeatmapLoss", loss_weight=[1.0, 0.1],
                    auto_weight=False)

    files = ds["files"]
    pred_bbox = model_cfg.get("pred_bbox", False)
    cfg = dict(
        ID=exp_id,
        MODEL=model_cfg,
        DATASET=dict(
            name=ds["name"],
            num_joints=num_joints,
            image_size=size,
            heatmap_size=heatmap_size,
            train=dict(ann_file=f"{ds['ann_root']}/{files[0]}",
                       img_prefix=ds["img_prefix"]),
            val=dict(ann_file=f"{ds['ann_root']}/{files[1]}",
                     img_prefix=ds["img_prefix"]),
            test=dict(ann_file=f"{ds['ann_root']}/{files[2]}",
                      img_prefix=ds["img_prefix"]),
        ),
        PIPELINE=dict(
            flip_prob=0.5,
            rot_prob=0 if pred_bbox else 0.6,
            rot_factor=0 if pred_bbox else 40,
            scale_factor=0.3,
            use_udp=False,
            sigma=sigma,
            kernel=(11, 11),
            encoding="MSRA",
            unbiased_encoding=True,
            target_type="GaussianHeatmap",
            simdr_split_ratio=model_cfg.get("simdr_split_ratio", 0),
        ),
        CHECKPOINT=dict(interval=10, resume=True, load_best=False,
                        save_root="checkpoints/"),
        EVAL=dict(
            interval=1,
            metric=(
                ["PCKh", "AUC", "EPE"] if ds["name"] == "panoptic"
                else ["PCKh"] if ds["name"].startswith("mpii")
                else ["mAP"] if ds["name"] == "coco"
                else ["PCK", "AUC", "EPE"]
            ),
            save_best="PCK",
            pck_threshold=0.2,
        ),
        TRAIN=dict(
            distributed=True, pin_memory=False, workers=4, syncBN=True,
            total_epoches=210, batch_per_gpu=32,
        ),
        OPTIMIZER=dict(type="Adam", lr=5e-4, warmup_steps=400,
                       step_epoch=[170, 200], resume=False),
        LOSS=loss,
    )
    for key, value in overrides.items():
        section, _, field = key.partition(".")
        if field:
            cfg[section][field] = value
        elif section in cfg:
            cfg[section] = value
        else:
            # a bare unknown key would become a top-level entry that every
            # consumer ignores: model and pipeline fields need dotted keys
            raise KeyError(
                f"unknown config section {section!r}; field overrides "
                f"need dotted keys (e.g. 'MODEL.{section}')"
            )
    return cfg
