"""``dw_conv_bias_act``'s share of its roofline over a served request: the
least time the H100 could take for the launches one request makes (their
shapes from the kernel's ``shapes`` counter, divided by the batches the
process served, ``serve.Predictor.batches``; bytes and operations from
``costs/dw_conv_bias_act.py``, 3.35 TB/s and 67 TFLOP/s FP32), over the
profiled device time of the kernels whose names hold ``dw_conv_bias_act``.
None for a program without the kernel or the counter, where the route
launched nothing, or where the launches are not the same every request.

The 32 x 32 maps' inputs (8 to 17 MB) may stay in the 50 MB L2, so the
share may read a little above the HBM-only share; the 64 x 64 and 128 x 128
ones (67 to 134 MB) carry most of the bytes."""

from perfbench.core.readers import roofline_pct


def read(run):
    try:
        from litehandnet_tpu_torch.kernels.dw_conv_bias_act import (
            dw_conv_bias_act,
        )
        from litehandnet_tpu_torch.serve import Predictor
    except ImportError:
        return None
    counted = getattr(dw_conv_bias_act, "shapes", None)
    batches = getattr(Predictor, "batches", 0)
    if not counted or not batches:
        return None
    shapes, sizes = [], set()
    for (N, C, H, W, k, d, itemsize), n in counted.items():
        if n % batches:
            return None
        shapes += [(N, C, H, W, k, d)] * (n // batches)
        sizes.add(itemsize)
    if len(sizes) != 1:
        return None
    return roofline_pct(run, "dw_conv_bias_act", "dw_conv_bias_act", shapes,
                        sizes.pop())
