"""``fuse_sum_relu``'s share of its roofline over a served request: the
least time the H100 could take for the launches one request makes (their
shapes from the kernel's ``shapes`` counter, divided by the batches the
process served, ``serve.Predictor.batches``; bytes from
``costs/fuse_sum_relu.py``, each term read once at its own resolution and
dtype, each output written once, at 3.35 TB/s), over the profiled device
time of the kernels whose names hold ``fuse_sum_relu``. None for a program
without the kernel or the counter, where the route launched nothing, or
where the launches are not the same every request.

Each term of a four-branch module's last row is 21 MB at a batch of 512 and
may still be in the 50 MB L2 from the convolution that wrote it, so the
share may read a little above the HBM-only share; the rows before it (260
to 1,060 MB a launch) carry most of the bytes."""

from perfbench.core.readers import roofline_pct


def read(run):
    try:
        from litehandnet_tpu_torch.kernels.fuse_sum_relu import fuse_sum_relu
        from litehandnet_tpu_torch.serve import Predictor
    except ImportError:
        return None
    counted = getattr(fuse_sum_relu, "shapes", None)
    batches = getattr(Predictor, "batches", 0)
    if not counted or not batches:
        return None
    shapes = []
    for shape, n in counted.items():
        if n % batches:
            return None
        shapes += [shape] * (n // batches)
    return roofline_pct(run, "fuse_sum_relu", "fuse_sum_relu", shapes, None)
