"""Mean device ms per request that kernels and copies ran inside the
program's span ``lhn.decode.refine``: the DARK refinement (``blur_log`` and
``dark_step``) of the serve decode, in the counted profiled stretch."""

from perfbench.core.spans import busy_ms


def read(run):
    return busy_ms(run, "lhn.decode.refine")
