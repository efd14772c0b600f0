"""Weights across frameworks: JAX variables into the port, and seeded random
weights.

``load_jax_variables(model, variables, rules_for(cfg.MODEL.name))`` loads a
JAX ``{'params', 'batch_stats'}`` tree, given as numpy arrays, into the port.
Each port parameter is found through a table of (regex over the torch key
prefix, kind, JAX path template): copies of the rules of
``litehandnet_tpu/utils/torch_import.py`` (``_repconv``, ``_repblock``,
``_litehandnet_rules``, ``_mynet_rules``, ``_mynet_stacked_rules``,
``_hourglass_ablation_rules``, the
``resnet`` and ``mobilenetv2`` tables with ``_DECONV_HEAD``,
``_srhandnet_rules``, ``_litehrnet_rules``, ``_hourglass_rules``,
``_litehandnet_msrb_rules``, ``_yolov6_rules``, ``_atthandnet_rules``),
which encode the reference torch names the port uses, plus the deploy-graph
names (``rep``, ``att_rep``) and the port's own table for ``classifier``,
which JAX's importer lacks. A template is a string with
``\\1``-style backrefs or a callable of the match. Conv kernels go HWIO ->
OIHW, transposed-conv kernels ``[kh, kw, in, out]`` -> ``[in, out, kh, kw]``
flipped in both spatial axes, and Dense kernels ``[in, out]`` ->
``[out, in]``; BatchNorm ``scale``/``bias``/
``mean``/``var`` become ``weight``/``bias``/``running_mean``/
``running_var``, LayerNorm ``scale``/``bias`` ``weight``/``bias``;
AugmentedConv's ``key_rel_w``/``key_rel_h`` are copied (kind ``rel``), and a
``skip`` rule leaves a buffer that JAX computes on the fly (AttHandNet's
BlurPool filter) as the port built it.
"""

from __future__ import annotations

import math
import re
from typing import Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

Rule = Tuple[str, str, str]  # (prefix regex, kind, JAX path template)

# kind -> {torch leaf: (JAX collection, JAX leaf, transform)}
_KINDS = {
    "conv": {
        "weight": ("params", "kernel", lambda a: np.transpose(a, (3, 2, 0, 1))),
        "bias": ("params", "bias", lambda a: a),
    },
    # flax ConvTranspose (padding "SAME", no kernel transpose) is a
    # fractionally strided conv; torch's ConvTranspose2d is the gradient of
    # a conv, i.e. the same with the kernel flipped in both spatial axes
    "deconv": {
        "weight": ("params", "kernel",
                   lambda a: np.transpose(a[::-1, ::-1], (2, 3, 0, 1))),
        "bias": ("params", "bias", lambda a: a),
    },
    "linear": {
        "weight": ("params", "kernel", lambda a: np.transpose(a)),
        "bias": ("params", "bias", lambda a: a),
    },
    "bn": {
        "weight": ("params", "scale", lambda a: a),
        "bias": ("params", "bias", lambda a: a),
        "running_mean": ("batch_stats", "mean", lambda a: a),
        "running_var": ("batch_stats", "var", lambda a: a),
    },
    "ln": {
        "weight": ("params", "scale", lambda a: a),
        "bias": ("params", "bias", lambda a: a),
    },
    # AugmentedConv's learned relative position embeddings, same layout
    "rel": {
        "key_rel_w": ("params", "key_rel_w", lambda a: a),
        "key_rel_h": ("params", "key_rel_h", lambda a: a),
    },
}


def repconv_rules(tp: str, fp: str) -> List[Rule]:
    """RepConv: train ``conv.conv``/``conv.bn`` -> ``main``/``main_bn``;
    deploy ``rep``."""
    return [
        (tp + r"\.conv\.conv", "conv", fp + r"/main/conv"),
        (tp + r"\.conv\.bn", "bn", fp + r"/main_bn/bn"),
        (tp + r"\.rep", "conv", fp + r"/rep/conv"),
    ]


def repblock_rules(tp: str, fp: str) -> List[Rule]:
    """RepBlock: ``rbr_dense`` + ``rbr_1x1`` + ``rbr_identity``; deploy
    ``rep``."""
    return [
        (tp + r"\.rbr_dense\.conv", "conv", fp + r"/dense/conv"),
        (tp + r"\.rbr_dense\.bn", "bn", fp + r"/dense_bn/bn"),
        (tp + r"\.rbr_1x1\.conv", "conv", fp + r"/one/conv"),
        (tp + r"\.rbr_1x1\.bn", "bn", fp + r"/one_bn/bn"),
        (tp + r"\.rbr_identity", "bn", fp + r"/id_bn/bn"),
        (tp + r"\.rep", "conv", fp + r"/rep/conv"),
    ]


def attention_rules(tp: str, fp: str) -> List[Rule]:
    """ChannelAttention (``conv3x3``, deploy ``att_rep``, gate
    ``conv1x1.{1,3}``) and SEBlock (``down``, ``up``)."""
    return [
        (tp + r"\.conv3x3\.conv", "conv", fp + r"/att/conv"),
        (tp + r"\.conv3x3\.bn", "bn", fp + r"/att_bn/bn"),
        (tp + r"\.att_rep", "conv", fp + r"/att_rep/conv"),
        (tp + r"\.conv1x1\.1", "conv", fp + r"/fc_down/conv"),
        (tp + r"\.conv1x1\.3", "conv", fp + r"/fc_up/conv"),
        (tp + r"\.down", "conv", fp + r"/down/conv"),
        (tp + r"\.up", "conv", fp + r"/up/conv"),
    ]


def _litehandnet_rules() -> List[Rule]:
    """LiteHandNet (reference liteHandNet.py:196-244): Stem ``pre``,
    hourglass ``hgs`` (MSAB at encoder.0 / decoder.last, Residual
    elsewhere), ``features``, ``out_layer``."""
    rules: List[Rule] = []
    rules += repblock_rules(r"pre\.conv1\.0", r"pre/c1")
    rules += repblock_rules(r"pre\.conv1\.1", r"pre/c2")
    rules += repconv_rules(r"pre\.branch1\.0", r"pre/b1a")
    rules += repconv_rules(r"pre\.branch1\.1", r"pre/b1b")
    rules.append((r"pre\.conv1x1", "conv", r"pre/proj/conv"))
    for t, f in (("encoder", "enc"), ("decoder", "dec")):
        P = rf"hgs\.{t}\.(\d+)"
        F = rf"hgs/{f}\1"
        # MSAB
        rules += repconv_rules(P + r"\.conv1", F + r"/conv1")
        rules += repconv_rules(P + r"\.conv2", F + r"/conv2")
        for mid, pn in (("mid1_conv", "p1"), ("mid2_conv", "p2")):
            for j, ab in (("0", "a"), ("1", "b")):
                rules += repconv_rules(
                    P + rf"\.{mid}\.(\d+)\.{j}\.depthwise_conv",
                    F + rf"/{pn}_\2_{ab}/dw",
                )
                rules += repconv_rules(
                    P + rf"\.{mid}\.(\d+)\.{j}\.pointwise_conv",
                    F + rf"/{pn}_\2_{ab}/pw",
                )
        rules += attention_rules(P + r"\.ca", F + r"/ca")
        # Residual = BasicBlock conv1 + BottleNeck blocks
        rules += repconv_rules(P + r"\.conv1\.conv\.0", F + r"/c1/c1")
        rules += repconv_rules(P + r"\.conv1\.conv\.1", F + r"/c1/c2")
        rules += repconv_rules(P + r"\.conv1\.skip_layer", F + r"/c1/skip")
        for k in ("0", "1", "2"):
            rules += repconv_rules(
                P + rf"\.blocks\.(\d+)\.conv\.{k}", F + rf"/b\2/c{int(k) + 1}"
            )
    for k in ("0", "1", "2"):
        rules += repconv_rules(rf"features\.0\.conv\.{k}", rf"feat_b/c{int(k) + 1}")
    rules += repconv_rules(r"features\.1", r"feat_c")
    rules.append((r"out_layer", "conv", r"head/conv"))
    return rules


LITEHANDNET_RULES = _litehandnet_rules()

# Sequential indices of the reference's plain conv / BN triples: BottleNeck
# ``conv.{0,1,3,4,6,7}`` and the JAX names they map to
_BOTTLENECK = (("0", "c1"), ("1", "bn1"), ("3", "c2"), ("4", "bn2"),
               ("6", "c3"), ("7", "bn3"))


def _plain(tp: str, fp: str, pairs) -> List[Rule]:
    """Rules for Sequential children ``tp.<index>`` -> ``fp/<name>``: a
    BatchNorm where the JAX name holds ``bn``, else a conv."""
    return [(tp + rf"\.{k}", "bn" if "bn" in f else "conv",
             fp + (f"/{f}/bn" if "bn" in f else f"/{f}/conv"))
            for k, f in pairs]


def _pelee_stem_rules() -> List[Rule]:
    """``pre`` of mynet and the ablation (pose_hg_ms_att.py:190-221)."""
    return (_plain(r"pre\.conv1", r"pre", (("0", "c1"), ("1", "bn1"),
                                           ("3", "c2"), ("4", "bn2")))
            + _plain(r"pre\.branch1", r"pre", (("0", "b1a"), ("1", "b1a_bn"),
                                               ("3", "b1b"), ("4", "b1b_bn")))
            + [(r"pre\.conv1x1", "conv", r"pre/proj/conv")])


def _me_att_trunk_rules(P: str, F: str) -> List[Rule]:
    """ME_att's BRC ``conv1``/``conv2`` and DWConv ladders, and the plain
    residual tower (BasicBlock ``conv1`` + BottleNeck ``blocks``)."""
    R: List[Rule] = [
        (P + r"\.conv(\d)\.conv", "conv", F + r"/conv\2/conv/conv"),
        (P + r"\.conv(\d)\.bn", "bn", F + r"/conv\2/norm/bn"),
    ]
    for mid, pn in (("mid1_conv", "p1"), ("mid2_conv", "p2")):
        for j, ab in (("0", "a"), ("1", "b")):
            for dw, fl in (("depthwise_conv", "dw"), ("pointwise_conv", "pw")):
                R += [
                    (P + rf"\.{mid}\.(\d+)\.{j}\.{dw}\.0", "conv",
                     F + rf"/{pn}_\2_{ab}/{fl}/conv"),
                    (P + rf"\.{mid}\.(\d+)\.{j}\.{dw}\.1", "bn",
                     F + rf"/{pn}_\2_{ab}/{fl}_bn/bn"),
                ]
    R += _plain(P + r"\.conv1\.conv", F + r"/c1",
                (("0", "c1"), ("1", "bn1"), ("3", "c2"), ("4", "bn2")))
    R += _plain(P + r"\.conv1\.skip_layer", F + r"/c1",
                (("0", "skip"), ("1", "skip_bn")))
    R += _plain(P + r"\.blocks\.(\d+)\.conv", F + r"/b\2", _BOTTLENECK)
    return R


def _features_rules() -> List[Rule]:
    """``features`` (BottleNeck, 1x1 conv, BN) and the ``outs`` head."""
    return _plain(r"features\.0\.conv", r"feat_b", _BOTTLENECK) + [
        (r"features\.1", "conv", r"feat_c/conv"),
        (r"features\.2", "bn", r"feat_bn/bn"),
        (r"outs", "conv", r"outs/conv"),
    ]


def _mynet_rules() -> List[Rule]:
    """mynet (reference pose_hg_ms_att.py; ``torch_import.py:523-588``):
    pelee stem, ``hgs.encoder``/``hgs.decoder`` with ME_att gates
    ``att.1/3/6``, features tail."""
    R = _pelee_stem_rules()
    for t, f in (("encoder", "enc"), ("decoder", "dec")):
        P, F = rf"hgs\.{t}\.(\d+)", rf"hgs/{f}\1"
        R += [
            (P + r"\.att\.1", "bn", F + r"/att_bn/bn"),
            (P + r"\.att\.3", "conv", F + r"/att_conv/conv"),
            (P + r"\.att\.6", "linear", F + r"/att_fc"),
        ]
        R += _me_att_trunk_rules(P, F)
    return R + _features_rules()


def _hourglass_ablation_rules() -> List[Rule]:
    """hourglass_ablation (reference hourglass_ablation.py;
    ``torch_import.py:708-785``): mynet's layout with the JAX blocks at the
    top level (``enc0``, no ``hgs``) and every gate under ``att``: ca / rca
    ``att.1/3/6``, se ``att.2/4``, 1x1 ``att``, CBAM ``att.pre``,
    ``att.residual_conv``, ``att.ca.sharedMLP``, ``att.sa.conv``."""
    R = _pelee_stem_rules()
    for t, f in (("encoder", "enc"), ("decoder", "dec")):
        P, F = rf"hgs\.{t}\.(\d+)", rf"{f}\1"
        R += [
            (P + r"\.att\.1", "bn", F + r"/att/bn/bn"),
            (P + r"\.att\.3", "conv", F + r"/att/conv/conv"),
            (P + r"\.att\.6", "linear", F + r"/att/fc"),
            (P + r"\.att\.pre\.0", "conv", F + r"/att/c1/conv"),
            (P + r"\.att\.pre\.1", "bn", F + r"/att/bn1/bn"),
            (P + r"\.att\.pre\.3", "conv", F + r"/att/c2/conv"),
            (P + r"\.att\.pre\.4", "bn", F + r"/att/bn2/bn"),
            (P + r"\.att\.residual_conv", "conv", F + r"/att/res/conv"),
            (P + r"\.att\.ca\.sharedMLP\.0", "conv", F + r"/att/ca/mlp1/conv"),
            (P + r"\.att\.ca\.sharedMLP\.2", "conv", F + r"/att/ca/mlp2/conv"),
            (P + r"\.att\.sa\.conv", "conv", F + r"/att/sa/conv/conv"),
            (P + r"\.att\.2", "linear", F + r"/att_fc1"),
            (P + r"\.att\.4", "linear", F + r"/att_fc2"),
            (P + r"\.att", "conv", F + r"/att/conv"),
        ]
        R += _me_att_trunk_rules(P, F)
    return R + _features_rules()


# SimpleBaseline deconv head, shared by resnet and mobilenetv2
# (``torch_import.py:258-268``; reference deconv_head.py:19-129)
_DECONV_HEAD: List[Rule] = [
    (r"out_head\.deconv_layers\.0", "deconv", r"head/deconv0"),
    (r"out_head\.deconv_layers\.1", "bn", r"head/bn0/bn"),
    (r"out_head\.deconv_layers\.3", "deconv", r"head/deconv1"),
    (r"out_head\.deconv_layers\.4", "bn", r"head/bn1/bn"),
    (r"out_head\.deconv_layers\.6", "deconv", r"head/deconv2"),
    (r"out_head\.deconv_layers\.7", "bn", r"head/bn2/bn"),
    (r"out_head\.final_layer", "conv", r"head/final/conv"),
]


def _resnet_rules() -> List[Rule]:
    """PoseResNet (``torch_import.py:242-270``): ``stem.conv.{0,1}``,
    ``res_layers.{s}.{b}.conv.{0,1,3,4[,6,7]}`` (basic: c1, bn1, c2, bn2;
    bottleneck adds c3, bn3), ``downsample.{0,1}``, the deconv head. The
    deep stem ``stem.{0,1,2}.conv.{0,1}`` is the port's own: JAX's table
    has no rule for it (no experiment sets ``deep_stem``)."""
    return [
        (r"stem\.conv\.0", "conv", r"stem/conv/conv"),
        (r"stem\.conv\.1", "bn", r"stem/norm/bn"),
        (r"stem\.(\d)\.conv\.0", "conv", r"stem\1/conv/conv"),
        (r"stem\.(\d)\.conv\.1", "bn", r"stem\1/norm/bn"),
        (r"res_layers\.(\d+)\.(\d+)\.conv\.0", "conv", r"layer\1_\2/c1/conv"),
        (r"res_layers\.(\d+)\.(\d+)\.conv\.1", "bn", r"layer\1_\2/bn1/bn"),
        (r"res_layers\.(\d+)\.(\d+)\.conv\.3", "conv", r"layer\1_\2/c2/conv"),
        (r"res_layers\.(\d+)\.(\d+)\.conv\.4", "bn", r"layer\1_\2/bn2/bn"),
        (r"res_layers\.(\d+)\.(\d+)\.conv\.6", "conv", r"layer\1_\2/c3/conv"),
        (r"res_layers\.(\d+)\.(\d+)\.conv\.7", "bn", r"layer\1_\2/bn3/bn"),
        (r"res_layers\.(\d+)\.(\d+)\.downsample\.0", "conv",
         r"layer\1_\2/down/conv"),
        (r"res_layers\.(\d+)\.(\d+)\.downsample\.1", "bn",
         r"layer\1_\2/down_bn/bn"),
    ] + _DECONV_HEAD


def _mobilenetv2_backbone_rules() -> List[Rule]:
    """The MobileNetV2 backbone (``torch_import.py:275-294``): ``conv1``,
    ``layer{i}.{b}.conv.{k}`` InvertedResiduals (layer1 has no expand conv:
    ``conv.0`` is the depthwise, ``conv.1`` the projection), ``conv2``.
    JAX's ``conv_fold`` kind folds a torch conv bias into the next
    BatchNorm; the port's convs, like JAX's, have none, so here it is a
    plain conv."""
    def cbl(tp, fp):
        return [(tp + r"\.conv\.0", "conv", fp + r"/conv/conv"),
                (tp + r"\.conv\.1", "bn", fp + r"/norm/bn")]

    R = cbl(r"conv1", r"conv1")
    R += cbl(r"layer1\.(\d+)\.conv\.0", r"layer1_\1/dw")
    R += cbl(r"layer1\.(\d+)\.conv\.1", r"layer1_\1/project")
    for k, f in (("0", "expand"), ("1", "dw"), ("2", "project")):
        R += cbl(rf"layer(\d+)\.(\d+)\.conv\.{k}", rf"layer\1_\2/{f}")
    return R + cbl(r"conv2", r"conv2")


def _mobilenetv2_rules() -> List[Rule]:
    """PoseMobileNetV2: the backbone and the deconv head."""
    return _mobilenetv2_backbone_rules() + _DECONV_HEAD


def _classifier_rules() -> List[Rule]:
    """ImageClassifier (JAX ``models/classifier.py``): the MobileNetV2
    backbone and the Linear ``head``. The port's own table: JAX's importer
    has none for this family."""
    return _mobilenetv2_backbone_rules() + [(r"head", "linear", r"head")]


def _srhandnet_rules() -> List[Rule]:
    """SRHandNet (``torch_import.py:373-397``): 3-conv stem, blocks 1-7 of
    two residual blocks (``conv3x3.{0,1,3,4}`` and the 1x1 projection
    ``conv1x1``), 1x1 output heads ``block{4..7}.2``."""
    def res(tp, fp):
        return [
            (tp + r"\.conv3x3\.0", "conv", fp + r"/c1/conv"),
            (tp + r"\.conv3x3\.1", "bn", fp + r"/bn1/bn"),
            (tp + r"\.conv3x3\.3", "conv", fp + r"/c2/conv"),
            (tp + r"\.conv3x3\.4", "bn", fp + r"/bn2/bn"),
            (tp + r"\.conv1x1", "conv", fp + r"/skip/conv"),
        ]

    rules: List[Rule] = [(r"stem\.conv(\d)", "conv", r"stem/c\1/conv")]
    for n in "1234567":
        f = f"b{n}" if n in "123" else f"h{n}"
        rules += res(rf"block{n}\.0", f + "a")
        rules += res(rf"block{n}\.1", f + "b")
        if n in "4567":
            rules.append((rf"block{n}\.2", "conv", rf"h{n}out/conv"))
    return rules


def _litehrnet_rules() -> List[Rule]:
    """Lite-HRNet 18/30 (``torch_import.py:400-465``): shuffle stem,
    depthwise-separable transitions (flat ``transition{i}.{j}`` and nested
    ``transition{i}.{j}.{k}``), conditional channel weighting stages,
    fuse layers, iterative head."""
    R: List[Rule] = [
        (r"stem\.conv1\.0", "conv", r"stem/c1/conv"),
        (r"stem\.conv1\.1", "bn", r"stem/bn1/bn"),
        (r"stem\.branch1\.depthwise_conv\.0", "conv", r"stem/branch1/dw/conv"),
        (r"stem\.branch1\.depthwise_conv\.1", "bn", r"stem/branch1/dw_bn/bn"),
        (r"stem\.branch1\.pointwise_conv\.0", "conv", r"stem/branch1/pw/conv"),
        (r"stem\.branch1\.pointwise_conv\.1", "bn", r"stem/branch1/pw_bn/bn"),
        (r"stem\.expand_conv\.0", "conv", r"stem/expand/conv"),
        (r"stem\.expand_conv\.1", "bn", r"stem/expand_bn/bn"),
        (r"stem\.depthwise_conv\.0", "conv", r"stem/dw/conv"),
        (r"stem\.depthwise_conv\.1", "bn", r"stem/dw_bn/bn"),
        (r"stem\.linear_conv\.0", "conv", r"stem/linear/conv"),
        (r"stem\.linear_conv\.1", "bn", r"stem/linear_bn/bn"),
    ]
    for dw, fl in (("depthwise_conv", "dw"), ("pointwise_conv", "pw")):
        R += [
            (rf"transition(\d+)\.(\d+)\.{dw}\.0", "conv",
             rf"trans\1_\2/{fl}/conv"),
            (rf"transition(\d+)\.(\d+)\.{dw}\.1", "bn",
             rf"trans\1_\2/{fl}_bn/bn"),
            (rf"transition(\d+)\.(\d+)\.(\d+)\.{dw}\.0", "conv",
             rf"trans\1_\2_\3/{fl}/conv"),
            (rf"transition(\d+)\.(\d+)\.(\d+)\.{dw}\.1", "bn",
             rf"trans\1_\2_\3/{fl}_bn/bn"),
            (rf"head_layer\.projects\.(\d+)\.{dw}\.0", "conv",
             rf"head/proj\1/{fl}/conv"),
            (rf"head_layer\.projects\.(\d+)\.{dw}\.1", "bn",
             rf"head/proj\1/{fl}_bn/bn"),
            (rf"stage(\d+)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.(\d+)\.{dw}\.0",
             "conv", rf"stage\1_\2/fuse\3_\4_\5/{fl}/conv"),
            (rf"stage(\d+)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.(\d+)\.{dw}\.1",
             "bn", rf"stage\1_\2/fuse\3_\4_\5/{fl}_bn/bn"),
        ]
    ST = r"stage(\d+)\.(\d+)\.layers\.(\d+)"
    FS = r"stage\1_\2/ccw\3"
    R += [
        (ST + r"\.cross_resolution_weighting\.conv1\.0", "conv",
         FS + r"/crw/c1/conv"),
        (ST + r"\.cross_resolution_weighting\.conv1\.1", "bn",
         FS + r"/crw/bn1/bn"),
        (ST + r"\.cross_resolution_weighting\.conv2\.0", "conv",
         FS + r"/crw/c2/conv"),
        (ST + r"\.cross_resolution_weighting\.conv2\.1", "bn",
         FS + r"/crw/bn2/bn"),
        (ST + r"\.depthwise_convs\.(\d+)\.0", "conv", FS + r"/dw\4/conv"),
        (ST + r"\.depthwise_convs\.(\d+)\.1", "bn", FS + r"/dw\4_bn/bn"),
        (ST + r"\.spatial_weighting\.(\d+)\.conv1\.0", "conv",
         FS + r"/sw\4/c1/conv"),
        (ST + r"\.spatial_weighting\.(\d+)\.conv2\.0", "conv",
         FS + r"/sw\4/c2/conv"),
        # the upsampling fuse path: 1x1 conv, BatchNorm
        (r"stage(\d+)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.0", "conv",
         r"stage\1_\2/fuse\3_\4/conv"),
        (r"stage(\d+)\.(\d+)\.fuse_layers\.(\d+)\.(\d+)\.1", "bn",
         r"stage\1_\2/fuse\3_\4_bn/bn"),
        (r"out_conv", "conv", r"out_conv/conv"),
    ]
    return R


def _hourglass_rules() -> List[Rule]:
    """Stacked hourglass (``torch_import.py:468-520``): ``pre.{0,1,3,4}``
    (``pre.2`` is the parameterless max pool), ``hgs.{n}.0`` the recursive
    ``up1``/``low1``/``low2``/``low3`` residual tree, ``features.{n}.{0,1}``,
    ``outs``, ``merge_features``, ``merge_preds``. The tree's templates are
    callables of the match."""
    TREE = r"((?:low\d|up\d)(?:\.(?:low\d|up\d))*)"

    def tree(m, tail):
        return (f"hg{m.group(1)}/" + m.group(2).replace(".", "/") + "/"
                + tail.format(*m.groups()[2:]))

    def residual(tp, fp):
        return [
            (tp + r"\.conv(\d)\.conv", "conv",
             lambda m: m.expand(fp) + f"/c{m.groups()[-1]}/conv/conv"),
            (tp + r"\.bn(\d)", "bn",
             lambda m: m.expand(fp) + f"/bn{m.groups()[-1]}/bn"),
            (tp + r"\.skip_layer\.conv", "conv",
             lambda m: m.expand(fp) + "/skip/conv/conv"),
        ]

    R: List[Rule] = [
        (r"pre\.0\.conv", "conv", r"pre0/conv/conv"),
        (r"pre\.0\.bn", "bn", r"pre0/norm/bn"),
    ]
    for ti, fi in (("1", "1"), ("3", "2"), ("4", "3")):
        R += residual(rf"pre\.{ti}", rf"pre{fi}")
    R += [
        (rf"hgs\.(\d+)\.0\.{TREE}\.conv(\d)\.conv", "conv",
         lambda m: tree(m, "c{0}/conv/conv")),
        (rf"hgs\.(\d+)\.0\.{TREE}\.bn(\d)", "bn",
         lambda m: tree(m, "bn{0}/bn")),
        (rf"hgs\.(\d+)\.0\.{TREE}\.skip_layer\.conv", "conv",
         lambda m: tree(m, "skip/conv/conv")),
    ]
    R += residual(r"features\.(\d+)\.0", r"feat\1_res")
    R += [
        (r"features\.(\d+)\.1\.conv", "conv", r"feat\1_conv/conv/conv"),
        (r"features\.(\d+)\.1\.bn", "bn", r"feat\1_conv/norm/bn"),
        (r"outs\.(\d+)\.conv", "conv", r"out\1/conv/conv"),
        (r"merge_features\.(\d+)\.conv\.conv", "conv",
         r"merge_feat\1/conv/conv"),
        (r"merge_preds\.(\d+)\.conv\.conv", "conv", r"merge_pred\1/conv/conv"),
    ]
    return R


def _mynet_stacked_rules() -> List[Rule]:
    """Stacked MultiScaleAttentionHourglass (``torch_import.py:591-660``):
    pelee stem with a BN on the projection, ``hgs.N`` recursive hourglass
    trees (attention blocks at the top level, pre-activation residuals
    ``conv.{0,2,3,5,6,8}`` inside), ``features``, ``outs``, the merges and
    the SimDR heads. The tree's templates are callables of the match."""
    TREE = r"((?:low\d|up\d)(?:\.(?:low\d|up\d))*)"
    RES = (("0", "bn1", "bn"), ("2", "c1", "conv"), ("3", "bn2", "bn"),
           ("5", "c2", "conv"), ("6", "bn3", "bn"), ("8", "c3", "conv"))

    def tree(m, tail):
        return f"hg{m.group(1)}/" + m.group(2).replace(".", "/") + "/" + tail

    R: List[Rule] = [
        (rf"pre\.{seq}\.{k}", kind, f"pre_{name}/{kind}")
        for seq, pairs in (("conv1", (("0", "c1"), ("1", "bn1"), ("3", "c2"),
                                      ("4", "bn2"))),
                           ("branch1", (("0", "b1a"), ("1", "b1a_bn"),
                                        ("3", "b1b"), ("4", "b1b_bn"))),
                           ("conv1x1", (("0", "proj"), ("1", "proj_bn"))))
        for k, name in pairs
        for kind in ("bn" if "bn" in name else "conv",)]
    P = rf"hgs\.(\d+)\.{TREE}"
    R += [
        (P + r"\.conv(\d)\.conv", "conv",
         lambda m: tree(m, f"conv{m.group(3)}_conv/conv")),
        (P + r"\.conv(\d)\.bn", "bn",
         lambda m: tree(m, f"conv{m.group(3)}_bn/bn")),
        (P + r"\.att\.1", "bn", lambda m: tree(m, "att_bn/bn")),
        (P + r"\.att\.3", "conv", lambda m: tree(m, "att_conv/conv")),
        (P + r"\.att\.6", "linear", lambda m: tree(m, "att_fc")),
    ]
    for mid, pn in (("mid1_conv", "p1"), ("mid2_conv", "p2")):
        for j, ab in (("0", "a"), ("1", "b")):
            for dw, fl in (("depthwise_conv", "dw"), ("pointwise_conv", "pw")):
                R += [
                    (P + rf"\.{mid}\.(\d+)\.{j}\.{dw}\.0", "conv",
                     lambda m, pn=pn, ab=ab, fl=fl:
                     tree(m, f"{pn}_{m.group(3)}_{ab}/{fl}/conv")),
                    (P + rf"\.{mid}\.(\d+)\.{j}\.{dw}\.1", "bn",
                     lambda m, pn=pn, ab=ab, fl=fl:
                     tree(m, f"{pn}_{m.group(3)}_{ab}/{fl}_bn/bn")),
                ]
    for k, fk, kind in RES:
        R.append((P + rf"\.conv\.{k}", kind,
                  lambda m, fk=fk, kind=kind: tree(m, f"{fk}/{kind}")))
        R.append((rf"features\.(\d+)\.0\.conv\.{k}", kind,
                  rf"feat\1_res/{fk}/{kind}"))
    R += [
        (P + r"\.skip_layer", "conv", lambda m: tree(m, "skip/conv")),
        (r"features\.(\d+)\.0\.skip_layer", "conv", r"feat\1_res/skip/conv"),
        (r"features\.(\d+)\.1", "bn", r"feat\1_bn/bn"),
        (r"features\.(\d+)\.3", "conv", r"feat\1_conv/conv"),
        (r"outs\.(\d+)", "conv", r"out\1/conv"),
        (r"merge_features\.(\d+)", "conv", r"merge_feat\1/conv"),
        (r"merge_preds\.(\d+)", "conv", r"merge_pred\1/conv"),
        (r"pred_x", "linear", r"pred_x"),
        (r"pred_y", "linear", r"pred_y"),
    ]
    return R


def _litehandnet_msrb_rules() -> List[Rule]:
    """LiteHandNet MSRB (``torch_import.py:800-838``): shuffle ``stem``,
    MSRB and RepBasicUnit stages ``backone.{encoder,decoder}``, RBU
    ``neck``, ``head``."""
    def rbu(tp, fp):
        return (repconv_rules(tp + r"\.conv\.0", fp + r"/c1")
                + repconv_rules(tp + r"\.conv\.1", fp + r"/c2")
                + attention_rules(tp + r"\.ca", fp + r"/ca"))

    def msrb(tp, fp):
        R = []
        for j in ("0", "1"):
            R += repconv_rules(tp + rf"\.branch1\.{j}", fp + rf"/b1_{j}")
            R += repconv_rules(tp + rf"\.branch2\.{j}", fp + rf"/b2_{j}")
            R += attention_rules(tp + rf"\.ca\.{j}", fp + rf"/ca_{j}")
        return R + repconv_rules(tp + r"\.conv", fp + r"/proj")

    R: List[Rule] = []
    R += repconv_rules(r"stem\.conv1\.0", r"stem_c1")
    R += repconv_rules(r"stem\.conv1\.1", r"stem_c2")
    R += repconv_rules(r"stem\.branch1\.0", r"stem_b1a")
    R += repconv_rules(r"stem\.branch1\.1", r"stem_b1b")
    R += repconv_rules(r"stem\.branch1\.2", r"stem_b1c")
    R += repconv_rules(r"stem\.conv2\.0", r"stem_proj")
    R += rbu(r"stem\.conv2\.1", r"stem_u1")
    R += rbu(r"stem\.conv2\.2", r"stem_u2")
    for t, f in (("encoder", "enc"), ("decoder", "dec")):
        R += msrb(rf"backone\.{t}\.0\.0", rf"{f}0_msrb")
        R += rbu(rf"backone\.{t}\.0\.1", rf"{f}0_rbu")
        R += rbu(rf"backone\.{t}\.(\d+)\.0", rf"{f}\1_a")
        R += rbu(rf"backone\.{t}\.(\d+)\.1", rf"{f}\1_b")
    R += rbu(r"neck\.0", r"neck1")
    R += rbu(r"neck\.1", r"neck2")
    R.append((r"head", "conv", r"head/conv"))
    return R


def _yolov6_rules(deploy: bool = False) -> List[Rule]:
    """YOLOv6 (``torch_import.py:841-885``): EfficientRep ``backbone``,
    Rep-PAN ``neck`` (SimConv ``conv``/``bn``, the ConvTranspose upsamplers
    of kind ``deconv``), decoupled ``detect`` head. A fused SimConv keeps
    the name ``conv`` (the reference's ``forward_fuse``) where JAX's deploy
    graph has ``rep``: the ``deploy`` rules map it there."""
    def simconv(tp, fp):
        if deploy:
            return [(tp + r"\.conv", "conv", fp + r"/rep/conv")]
        return [
            (tp + r"\.conv", "conv", fp + r"/main/conv"),
            (tp + r"\.bn", "bn", fp + r"/main_bn/bn"),
        ]

    def stage(tp, fp):
        return (repblock_rules(tp + r"\.conv1", fp + r"/conv1")
                + repblock_rules(tp + r"\.block\.(\d+)", fp + r"/blk\1"))

    R: List[Rule] = []
    R += repblock_rules(r"backbone\.stem", r"backbone/stem")
    for i in (2, 3, 4, 5):
        R += repblock_rules(rf"backbone\.ERBlock_{i}\.0", rf"backbone/er{i}_down")
        R += stage(rf"backbone\.ERBlock_{i}\.1", rf"backbone/er{i}_stage")
    R += simconv(r"backbone\.ERBlock_5\.2\.cv1", r"backbone/sppf/cv1")
    R += simconv(r"backbone\.ERBlock_5\.2\.cv2", r"backbone/sppf/cv2")
    R += simconv(r"neck\.reduce_layer0", r"neck/reduce0")
    R.append((r"neck\.upsample0\.upsample_transpose", "deconv", r"neck/up0"))
    R += simconv(r"neck\.reduce_layer1", r"neck/reduce1")
    R.append((r"neck\.upsample1\.upsample_transpose", "deconv", r"neck/up1"))
    R += stage(r"neck\.Rep_p4", r"neck/p4")
    R += stage(r"neck\.Rep_p3", r"neck/p3")
    R += stage(r"neck\.Rep_n3", r"neck/n3")
    R += stage(r"neck\.Rep_n4", r"neck/n4")
    R += simconv(r"neck\.downsample2", r"neck/down2")
    R += simconv(r"neck\.downsample1", r"neck/down1")
    R += simconv(r"detect\.stems\.(\d+)", r"head/stem\1")
    R += simconv(r"detect\.cls_convs\.(\d+)", r"head/cls_conv\1")
    R += simconv(r"detect\.reg_convs\.(\d+)", r"head/reg_conv\1")
    R.append((r"detect\.cls_preds\.(\d+)", "conv", r"head/cls_pred\1"))
    R.append((r"detect\.reg_preds\.(\d+)", "conv", r"head/reg_pred\1"))
    R.append((r"detect\.obj_preds\.(\d+)", "conv", r"head/obj_pred\1"))
    return R


def augmented_conv_rules(tp: str, fp: str) -> List[Rule]:
    """AugmentedConv: ``qkv_conv``, ``attn_out``, ``conv_out`` and the
    relative embeddings ``key_rel_w``/``key_rel_h`` (kind ``rel``)."""
    return [
        (tp + r"\.qkv_conv", "conv", fp + r"/qkv/conv"),
        (tp + r"\.attn_out", "conv", fp + r"/attn_out/conv"),
        (tp + r"\.conv_out", "conv", fp + r"/conv_out/conv"),
        (tp, "rel", fp),
    ]


def arb_rules(tp: str, fp: str) -> List[Rule]:
    """AttHandNet's ARBAdd: ``conv1`` (pw, dw), ``conv2`` (projection) and
    ``attention_aug`` (AugmentedConv, BatchNorm)."""
    return [
        (tp + r"\.conv1\.0", "conv", fp + r"/pw/conv"),
        (tp + r"\.conv1\.1", "bn", fp + r"/pw_bn/bn"),
        (tp + r"\.conv1\.3", "conv", fp + r"/dw/conv"),
        (tp + r"\.conv1\.4", "bn", fp + r"/dw_bn/bn"),
        (tp + r"\.conv2\.0", "conv", fp + r"/proj/conv"),
        (tp + r"\.conv2\.1", "bn", fp + r"/proj_bn/bn"),
        (tp + r"\.attention_aug\.1", "bn", fp + r"/att/norm/bn"),
    ] + augmented_conv_rules(tp + r"\.attention_aug\.0", fp + r"/att/aug")


def _atthandnet_rules() -> List[Rule]:
    """AttHandNet (``torch_import.py:675-705``): dense ARB blocks,
    BlurPool transitions (the fixed filter buffer ``activation.filt`` is
    skipped: JAX computes it), the final ``aug_block`` and the ``conv``
    head."""
    R = arb_rules(r"dense(\d)\.arb\.(\d+)", r"dense\1/arb\2")
    R += augmented_conv_rules(r"aug_block\.0", r"aug_final/aug")
    R += [
        (r"aug_block\.1", "bn", r"aug_final/norm/bn"),
        (r"transition(\d)\.conv", "conv", r"transition\1/conv/conv"),
        (r"transition(\d)\.batch_normalization", "bn",
         r"transition\1/norm/bn"),
        (r"transition(\d)\.activation", "skip", r""),
        (r"conv", "conv", r"head/conv"),
    ]
    return R


RULES: Dict[str, List[Rule]] = {
    "litehandnet": LITEHANDNET_RULES,
    "mynet": _mynet_rules(),
    "mynet_stacked": _mynet_stacked_rules(),
    "hourglass_ablation": _hourglass_ablation_rules(),
    "srhandnet": _srhandnet_rules(),
    "litehrnet": _litehrnet_rules(),
    "resnet": _resnet_rules(),
    "mobilenetv2": _mobilenetv2_rules(),
    "hourglass": _hourglass_rules(),
    "litehandnet_msrb": _litehandnet_msrb_rules(),
    "yolov6": _yolov6_rules(),
    "atthandnet": _atthandnet_rules(),
    "classifier": _classifier_rules(),
}


# the families whose deploy graph needs rules of its own
DEPLOY_RULES: Dict[str, List[Rule]] = {"yolov6": _yolov6_rules(deploy=True)}


def rules_for(family: str, deploy: bool = False) -> List[Rule]:
    """The weight rules of a ported family (``cfg.MODEL.name``), for its
    train graph or (``deploy``) its deploy graph.

    Raises:
        KeyError: the family is not ported.
    """
    name = family.lower()
    if name not in RULES:
        raise KeyError(f"no weight rules for {family!r}; ported: "
                       f"{sorted(RULES)}")
    return DEPLOY_RULES.get(name, RULES[name]) if deploy else RULES[name]


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (str(key),)))
        else:
            out[prefix + (str(key),)] = np.asarray(value)
    return out


def _compile(rules: Sequence[Rule]):
    return [(re.compile(p), kind, tmpl) for p, kind, tmpl in rules]


def _jax_key(key: str, compiled):
    """(JAX key tuple ``(collection, *path, leaf)``, transform) of the port
    key ``key``; None for a ``skip`` rule.

    Raises:
        KeyError: no rule maps it.
    """
    prefix, _, leaf = key.rpartition(".")
    hit = next(((m, kind, tmpl) for pat, kind, tmpl in compiled
                if (m := pat.fullmatch(prefix)) is not None), None)
    if hit is None:
        raise KeyError(f"{key}: no rule maps it to a JAX path")
    m, kind, tmpl = hit
    if kind == "skip":
        return None
    collection, jax_leaf, transform = _KINDS[kind][leaf]
    path = tmpl(m) if callable(tmpl) else m.expand(tmpl)
    return (collection, *path.split("/"), jax_leaf), transform


def load_jax_variables(model: nn.Module, variables: Mapping,
                       rules: Sequence[Rule] = LITEHANDNET_RULES) -> None:
    """Load JAX variables (numpy leaves) into ``model`` in place.

    ``variables`` is ``{'params': ..., 'batch_stats': ...}`` for the train
    graph or ``{'params': ...}`` for the deploy graph (the JAX
    ``fuse_params`` output); ``model`` must be the matching graph. ``rules``
    map port key prefixes to JAX paths (LiteHandNet's by default); a port
    tensor under a ``skip`` rule keeps its value.

    Raises:
        KeyError: a port parameter matches no rule or has no JAX leaf, or a
            JAX leaf was left unused.
        ValueError: a shape differs.
    """
    compiled = _compile(rules)
    flat = _flatten(variables)
    used = set()
    new = {}
    for key, current in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        hit = _jax_key(key, compiled)
        if hit is None:
            continue
        jkey, transform = hit
        if jkey not in flat:
            raise KeyError(f"{key}: JAX variables lack {'/'.join(jkey)}")
        value = np.ascontiguousarray(transform(flat[jkey]))
        if tuple(value.shape) != tuple(current.shape):
            raise ValueError(
                f"{key}: JAX {'/'.join(jkey)} gives shape {value.shape}, "
                f"port has {tuple(current.shape)}"
            )
        used.add(jkey)
        new[key] = torch.tensor(value, dtype=current.dtype)
    unused = sorted("/".join(k) for k in set(flat) - used)
    if unused:
        raise KeyError(f"{len(unused)} JAX leaves unused, e.g. {unused[:8]}")
    model.load_state_dict(new, strict=False)


def load_jax_criterion(criterion: nn.Module, crit_params: Mapping) -> None:
    """Load a JAX criterion's params (the ``crit_params`` of a JAX
    ``TrainState``, e.g. ``{'mtl_p': [2]}`` or the SimDR decoders
    ``{'simdr': {'x_decoder': {'kernel', 'bias'}, ...}}``) into the port's
    criterion in place. Leaves map by their path joined with dots; a Dense
    ``kernel`` ``[in, out]`` becomes the ``nn.Linear`` ``weight``
    ``[out, in]``, every other leaf is unchanged.

    Raises:
        KeyError: a port parameter has no JAX leaf, or a JAX leaf was left
            unused.
        ValueError: a shape differs.
    """
    flat = {}
    for path, value in _flatten(crit_params).items():
        if path[-1] == "kernel":
            path, value = (*path[:-1], "weight"), np.asarray(value).T
        flat[".".join(path)] = value
    current = criterion.state_dict()
    if set(flat) != set(current):
        raise KeyError(f"criterion keys differ: JAX {sorted(flat)}, port "
                       f"{sorted(current)}")
    new = {}
    for key, value in flat.items():
        if tuple(value.shape) != tuple(current[key].shape):
            raise ValueError(f"{key}: JAX shape {value.shape}, port "
                             f"{tuple(current[key].shape)}")
        new[key] = torch.tensor(value, dtype=current[key].dtype)
    criterion.load_state_dict(new)


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight and BatchNorm statistic from ``generator``.

    Conv, transposed conv and Linear weights are N(0, 1/fan_in), biases
    N(0, 0.1^2);
    BatchNorm (rank 2 and 4 alike) affine parameters and running statistics
    and LayerNorm affine parameters move away from their identity init so
    that fusion and normalization are non-trivial. Draws happen on the CPU,
    so a seed gives the same weights on every machine.
    """
    def normal(t, std):
        return torch.randn(t.shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, (nn.Conv2d, nn.Linear, nn.ConvTranspose2d)):
            # a transposed conv's weight is [in, out, kh, kw], and each
            # output sums in * kh * kw / (stride_h * stride_w) products
            fan_in = (mod.weight[:, 0].numel() // math.prod(mod.stride)
                      if isinstance(mod, nn.ConvTranspose2d)
                      else mod.weight[0].numel())
            mod.weight.copy_(normal(mod.weight, fan_in ** -0.5))
            if mod.bias is not None:
                mod.bias.copy_(normal(mod.bias, 0.1))
        elif isinstance(mod, nn.BatchNorm2d):
            c = mod.num_features
            mod.weight.copy_(0.5 + torch.rand(c, generator=generator))
            mod.bias.copy_(normal(mod.bias, 0.1))
            mod.running_mean.copy_(normal(mod.running_mean, 0.1))
            mod.running_var.copy_(0.5 + torch.rand(c, generator=generator))
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.copy_(0.5 + torch.rand(mod.weight.shape,
                                              generator=generator))
            mod.bias.copy_(normal(mod.bias, 0.1))
    return model
