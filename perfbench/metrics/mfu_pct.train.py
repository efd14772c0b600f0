"""The reference train step's operations per image (forward, weight and
input gradients) times the window's images a second, over the
configuration's train peak (TF32 dense, 495 TFLOP/s)."""

from perfbench.core.readers import mfu_pct


def read(run):
    return mfu_pct(run, "train")
