"""Launches of ``dw_conv_bias_act`` per served batch: the kernel's launch
counter over the batches the process sent through the predictor
(``serve.Predictor.batches``: warm-up, window, traced and span requests),
both counted since the process started. The deploy graph's depthwise
convolutions take the kernel; a graph without them reads 0. None for a
program without the kernel or the counter."""


def read(run):
    try:
        from litehandnet_tpu_torch.kernels.dw_conv_bias_act import (
            dw_conv_bias_act,
        )
        from litehandnet_tpu_torch.serve import Predictor
    except ImportError:
        return None
    launches = getattr(dw_conv_bias_act, "launches", None)
    batches = getattr(Predictor, "batches", 0)
    if launches is None or not batches:
        return None
    return launches / batches
