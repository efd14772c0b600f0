"""Mean device ms per request that kernels and copies ran inside the
program's span ``lhn.serve.input``: the uint8 batch's copy to the device and
the normalize, in the counted profiled stretch."""

from perfbench.core.spans import busy_ms


def read(run):
    return busy_ms(run, "lhn.serve.input")
