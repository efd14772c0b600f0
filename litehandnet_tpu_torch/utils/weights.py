"""Weights across frameworks: JAX variables into the port, and seeded random
weights.

``load_jax_variables(model, variables)`` loads a JAX ``{'params',
'batch_stats'}`` tree, given as numpy arrays, into the port. Each port
parameter is found through a table of (regex over the torch key prefix,
kind, JAX path template): the rules of ``litehandnet_tpu/utils/
torch_import.py`` (``_repconv``, ``_repblock``, ``_litehandnet_rules``),
which encode the reference torch names the port uses, plus the deploy-graph
names (``rep``, ``att_rep``). Conv kernels go HWIO -> OIHW; BatchNorm
``scale``/``bias``/``mean``/``var`` become ``weight``/``bias``/
``running_mean``/``running_var``.
"""

from __future__ import annotations

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
    "bn": {
        "weight": ("params", "scale", lambda a: a),
        "bias": ("params", "bias", lambda a: a),
        "running_mean": ("batch_stats", "mean", lambda a: a),
        "running_var": ("batch_stats", "var", lambda a: a),
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


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[tuple, np.ndarray]:
    out = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            out.update(_flatten(value, prefix + (str(key),)))
        else:
            out[prefix + (str(key),)] = np.asarray(value)
    return out


def load_jax_variables(model: nn.Module, variables: Mapping,
                       rules: Sequence[Rule] = LITEHANDNET_RULES) -> None:
    """Load JAX variables (numpy leaves) into ``model`` in place.

    ``variables`` is ``{'params': ..., 'batch_stats': ...}`` for the train
    graph or ``{'params': ...}`` for the deploy graph (the JAX
    ``fuse_params`` output); ``model`` must be the matching graph. ``rules``
    map port key prefixes to JAX paths (LiteHandNet's by default).

    Raises:
        KeyError: a port parameter matches no rule or has no JAX leaf, or a
            JAX leaf was left unused.
        ValueError: a shape differs.
    """
    rules = [(re.compile(p), kind, tmpl) for p, kind, tmpl in rules]
    flat = _flatten(variables)
    used = set()
    new = {}
    for key, current in model.state_dict().items():
        if key.endswith("num_batches_tracked"):
            continue
        prefix, _, leaf = key.rpartition(".")
        hit = next(((m, kind, tmpl) for pat, kind, tmpl in rules
                    if (m := pat.fullmatch(prefix)) is not None), None)
        if hit is None:
            raise KeyError(f"{key}: no rule maps it to a JAX path")
        m, kind, tmpl = hit
        collection, jax_leaf, transform = _KINDS[kind][leaf]
        jkey = (collection, *m.expand(tmpl).split("/"), jax_leaf)
        if jkey not in flat:
            raise KeyError(f"{key}: JAX variables lack {'/'.join(jkey)}")
        value = transform(flat[jkey])
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


@torch.no_grad()
def randomize_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Draw every weight and BatchNorm statistic from ``generator``.

    Conv weights are N(0, 1/fan_in), biases N(0, 0.1^2); BatchNorm affine
    parameters and running statistics move away from their identity init
    so that fusion is non-trivial. Draws happen on the CPU, so a seed gives
    the same weights on every machine.
    """
    def normal(t, std):
        return torch.randn(t.shape, generator=generator) * std

    for mod in model.modules():
        if isinstance(mod, nn.Conv2d):
            fan_in = mod.weight[0].numel()
            mod.weight.copy_(normal(mod.weight, fan_in ** -0.5))
            if mod.bias is not None:
                mod.bias.copy_(normal(mod.bias, 0.1))
        elif isinstance(mod, nn.BatchNorm2d):
            c = mod.num_features
            mod.weight.copy_(0.5 + torch.rand(c, generator=generator))
            mod.bias.copy_(normal(mod.bias, 0.1))
            mod.running_mean.copy_(normal(mod.running_mean, 0.1))
            mod.running_var.copy_(0.5 + torch.rand(c, generator=generator))
    return model
