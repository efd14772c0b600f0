"""Served batches whose forward was a replay of captured CUDA graphs, per
served batch: the program's counter ``serve.Predictor.graph_replays`` over
``serve.Predictor.batches`` (warm-up, window, traced and span requests),
both counted since the process started. A key's first call runs eagerly, so
a run reads a little under 1. None for a program without the counters."""


def read(run):
    try:
        from litehandnet_tpu_torch.serve import Predictor
    except ImportError:
        return None
    replays = getattr(Predictor, "graph_replays", None)
    batches = getattr(Predictor, "batches", 0)
    if replays is None or not batches:
        return None
    return replays / batches
