"""Hourglass ablation: mynet with switchable attention (port of
``litehandnet_tpu/models/hourglass_ablation.py``; reference
``hourglass_ablation.py:110-311``).

Switches (``cfg.MODEL``): ``msrb`` (ME_att blocks at the hourglass's entry
and exit, else residual towers), ``rca`` (the 3x3-pooled gate after every
residual tower) and ``ca_type`` in {ca, se, 1x1, identity, cbam}, the gate
of the ME_att blocks. No Rep modules: the served graph is the train graph in
eval mode. Submodule names are the reference torch names that
``utils/torch_import.py::_hourglass_ablation_rules`` (:708-785) encodes; the
gate of every kind is ``att``.
"""

from __future__ import annotations

from typing import Sequence

from torch import nn

from litehandnet_tpu_torch.models.attention import CBAM
from litehandnet_tpu_torch.models.layers import Conv, head_output
from litehandnet_tpu_torch.models.ms_att_hourglass import (
    MEAttBody,
    PeleeStem,
    PlainBasicBlock,
    PlainBottleNeck,
    RCAGate,
    features_head,
    hourglass_forward,
)

CA_TYPES = ("ca", "se", "1x1", "identity", "cbam")


class SEGate(nn.Sequential):
    """Mean -> Linear to features / reduction -> ReLU -> Linear -> sigmoid,
    times the input (the ``se`` gate; Sequential indices 2 and 4 are the
    reference's ``att.2/4``)."""

    def __init__(self, features, reduction=16):
        super().__init__(
            nn.AdaptiveAvgPool2d(1),
            nn.Flatten(),
            nn.Linear(features, features // reduction, bias=False),
            nn.ReLU(),
            nn.Linear(features // reduction, features, bias=False),
            nn.Sigmoid(),
        )

    def forward(self, x):
        return x * super().forward(x)[:, :, None, None]


class AblationResidual(nn.Module):
    """BasicBlock + BottleNecks, then the pooled gate when ``rca``
    (hourglass_ablation.py:56-75)."""

    def __init__(self, in_channels, features, stride=1, num_block=2,
                 rca=False):
        super().__init__()
        self.conv1 = PlainBasicBlock(in_channels, features, stride)
        self.blocks = nn.Sequential(*[PlainBottleNeck(features)
                                      for _ in range(num_block)])
        self.att = RCAGate(features) if rca else None

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        return x if self.att is None else self.att(x)


class AblationMEAtt(MEAttBody):
    """ME_att with a switchable gate (hourglass_ablation.py:78-126)."""

    def __init__(self, in_channels, features, ca_type="ca", reduction=16):
        super().__init__(in_channels, features)
        ca = ca_type.lower()
        if ca == "ca":
            self.att = RCAGate(features)
        elif ca == "se":
            self.att = SEGate(features, reduction)
        elif ca == "1x1":
            self.att = Conv(features, features, 1)
        elif ca == "identity":
            self.att = None
        elif ca == "cbam":
            self.att = CBAM(features, features)
        else:
            raise ValueError(f"ca_type {ca_type!r} is not one of {CA_TYPES}")

    def forward(self, x):
        out = self.trunk(x)
        return out if self.att is None else self.att(out)


class AblationEncoderDecoder(nn.Module):
    """The ablation's hourglass: ME_att (``msrb``) or residual entry and
    exit around stride-2 residual towers (hourglass_ablation.py:163-213)."""

    def __init__(self, num_stage=4, features=128,
                 num_blocks: Sequence[int] = (2, 2, 2), msrb=True, rca=False,
                 ca_type="ca"):
        super().__init__()
        f = features
        want = num_stage - 1 if msrb else num_stage
        if len(num_blocks) != want:
            raise ValueError(f"num_block needs {want} entries with msrb="
                             f"{msrb}, got {num_blocks}")
        if msrb:
            encoder = [AblationMEAtt(f, f, ca_type)]
            strided = num_blocks
            exit_ = AblationMEAtt(f, f, ca_type)
        else:
            encoder = [AblationResidual(f, f, 1, num_blocks[0], rca)]
            strided = num_blocks[1:]
            exit_ = AblationResidual(f, f, 1, 2, rca)
        encoder += [AblationResidual(f, f, 2, nb, rca) for nb in strided]
        self.encoder = nn.ModuleList(encoder)
        self.decoder = nn.ModuleList(
            [AblationResidual(f, f, 1, 2, rca) for _ in range(num_stage - 1)]
            + [exit_])

    def forward(self, x):
        return hourglass_forward(self.encoder, self.decoder, x)[-1]


class HourglassAblation(nn.Module):
    """Reference hourglass_ablation.py:272-303.

    Config keys (``cfg.MODEL``): num_stage, input_channel, output_channel,
    num_block, msrb, rca, ca_type.
    """

    def __init__(self, num_joints=21, num_stage=4, features=128,
                 num_blocks: Sequence[int] = (2, 2, 2), msrb=True, rca=False,
                 ca_type="ca"):
        super().__init__()
        self.pre = PeleeStem(3, features)
        self.hgs = AblationEncoderDecoder(num_stage, features,
                                          tuple(num_blocks), msrb, rca,
                                          ca_type)
        self.features = features_head(features)
        self.outs = Conv(features, num_joints, 1)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "HourglassAblation":
        del deploy  # no Rep modules: one graph
        m = cfg.MODEL
        return cls(
            num_joints=m.get("output_channel", cfg.DATASET.num_joints),
            num_stage=m.get("num_stage", 4),
            features=m.get("input_channel", 128),
            num_blocks=tuple(m.get("num_block", [2, 2, 2])),
            msrb=m.get("msrb", True),
            rca=m.get("rca", False),
            ca_type=m.get("ca_type", "ca"),
        )

    def forward(self, imgs):
        return head_output(self.outs(self.features(self.hgs(self.pre(imgs)))))
