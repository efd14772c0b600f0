"""Rows of Lite-HRNet's fuse summed by ``fuse_sum_relu`` per served batch:
the wrapper's ``rows`` counter over the batches the process sent through the
predictor (``serve.Predictor.batches``: warm-up, window, traced and span
requests), both counted since the process started. Lite-HRNet-30's forward
sums 42 rows (3 x 2 + 8 x 3 + 3 x 4); a model without its stage modules
reads 0. None for a program without the kernel or the counters."""


def read(run):
    try:
        from litehandnet_tpu_torch.kernels.fuse_sum_relu import fuse_sum_relu
        from litehandnet_tpu_torch.serve import Predictor
    except ImportError:
        return None
    rows = getattr(fuse_sum_relu, "rows", None)
    batches = getattr(Predictor, "batches", 0)
    if rows is None or not batches:
        return None
    return rows / batches
