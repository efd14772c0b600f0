"""The reference forward's operations per image times the window's images
a second, over the configuration's serve peak (bf16 dense, 989 TFLOP/s)."""

from perfbench.core.readers import mfu_pct


def read(run):
    return mfu_pct(run, "serve")
