"""Image classifier (port of ``litehandnet_tpu/models/classifier.py``; the
reference's classification stub, ``models/classification/classifier.py:5``).

The MobileNetV2 backbone of SimpleBaseline (``conv1``, ``layer{i}``,
``conv2``), global average pooling and a Linear ``head``; for gesture
classification in the demo pipeline. Output ``[B, num_classes]`` float32.
"""

from __future__ import annotations

from torch import nn

from litehandnet_tpu_torch.models.layers import head_output
from litehandnet_tpu_torch.models.simplebaseline import (
    CBL,
    InvertedResidual,
    make_divisible,
)


class ImageClassifier(nn.Module):
    """MobileNetV2-style classifier: backbone -> GAP -> Linear."""

    # (expand ratio, channels, blocks, stride) of layer1..layer7
    ARCH = (
        (1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
        (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1),
    )

    def __init__(self, num_classes=1000, widen_factor=1.0):
        super().__init__()
        in_ch = make_divisible(32 * widen_factor, 8)
        self.conv1 = CBL(3, in_ch, 3, 2, 1)
        for i, (expand, channels, blocks, stride) in enumerate(self.ARCH):
            out_ch = make_divisible(channels * widen_factor, 8)
            layer = []
            for b in range(blocks):
                layer.append(InvertedResidual(in_ch, out_ch,
                                              stride if b == 0 else 1, expand))
                in_ch = out_ch
            self.add_module(f"layer{i + 1}", nn.Sequential(*layer))
        out_ch = int(1280 * max(widen_factor, 1.0))
        self.conv2 = CBL(in_ch, out_ch)
        self.head = nn.Linear(out_ch, num_classes)

    @classmethod
    def from_config(cls, cfg, deploy: bool = False) -> "ImageClassifier":
        del deploy  # no Rep modules in this family
        return cls(num_classes=cfg.MODEL.get("num_classes", 1000),
                   widen_factor=cfg.MODEL.get("widen_factor", 1.0))

    def forward(self, x):
        x = self.conv1(x)
        for i in range(len(self.ARCH)):
            x = getattr(self, f"layer{i + 1}")(x)
        x = self.conv2(x).mean(dim=(2, 3))
        return head_output(self.head(x))
