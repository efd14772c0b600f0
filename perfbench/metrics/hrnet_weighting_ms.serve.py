"""Mean device ms per request that kernels and copies ran inside the
program's spans ``lhn.litehrnet.weighting``, summed over the forward's
conditional channel weighting blocks (28 in Lite-HRNet-30: the split, the
cross-resolution gate, the depthwise 3x3 and spatial gates, the join and
shuffle), in the counted profiled stretch. None for a program without the
span."""

from perfbench.core.spans import busy_ms


def read(run):
    return busy_ms(run, "lhn.litehrnet.weighting")
