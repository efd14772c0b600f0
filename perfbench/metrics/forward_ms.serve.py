"""Mean device ms per request that kernels and copies ran inside the
program's span ``lhn.serve.forward``: the served graph under autocast and
``unpack_outputs``, in the counted profiled stretch."""

from perfbench.core.spans import busy_ms


def read(run):
    return busy_ms(run, "lhn.serve.forward")
