"""Hand-written Hopper kernels, each beside its plain PyTorch version.

Every kernel wrapper counts its launches in ``<wrapper>.launches``;
``KERNELS`` lists the wrappers of the ported kernels.
"""

from litehandnet_tpu_torch.kernels.blur_log import blur_log

KERNELS = {"blur_log": blur_log}
