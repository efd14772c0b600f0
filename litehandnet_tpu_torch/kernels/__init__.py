"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every kernel wrapper launches through a ``_device.Kernel``, counts its
launches in ``<wrapper>.launches`` and declares its counters with
``utils/profiling.register_counters``; ``KERNELS`` lists the wrappers of the
ported kernels. ``_build`` counts, always, the ``nvcc`` runs by source
(``_build.compiles``) and the host seconds spent building and loading the
libraries (``_build.seconds``): the benchmark's ``kernel_build_s.serve``
reads the seconds and notes the runs beside them, so that a build tells from
a warm cache.
"""

from litehandnet_tpu_torch.kernels.blur_log import blur_log
from litehandnet_tpu_torch.kernels.dw_conv3x3_stats import dw_conv3x3_stats
from litehandnet_tpu_torch.kernels.dw_conv_bias_act import dw_conv_bias_act
from litehandnet_tpu_torch.kernels.fuse_sum_relu import fuse_sum_relu
from litehandnet_tpu_torch.kernels.moments import moments
from litehandnet_tpu_torch.kernels.softpool_2x2 import softpool_2x2

KERNELS = {
    "blur_log": blur_log,
    "moments": moments,
    "dw_conv3x3_stats": dw_conv3x3_stats,
    "softpool_2x2": softpool_2x2,
    "dw_conv_bias_act": dw_conv_bias_act,
    "fuse_sum_relu": fuse_sum_relu,
}
