"""Mean device ms per request that kernels and copies ran inside the
program's span ``lhn.decode`` (argmax, refinement, ``transform_preds``): no
bbox copy, no answer's copy, and no time the device waited for the host,
in the counted profiled stretch."""

from perfbench.core.spans import busy_ms


def read(run):
    return busy_ms(run, "lhn.decode")
