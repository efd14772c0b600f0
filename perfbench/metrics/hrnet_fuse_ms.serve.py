"""Mean device ms per request that kernels and copies ran inside the
program's spans ``lhn.litehrnet.fuse``, summed over the forward's
cross-resolution fuses (14 in Lite-HRNet-30: strided depthwise-separable
downsamples, 1x1 convs with nearest upsamples, the sums and ReLUs), in the
counted profiled stretch. None for a program without the span."""

from perfbench.core.spans import busy_ms


def read(run):
    return busy_ms(run, "lhn.litehrnet.fuse")
