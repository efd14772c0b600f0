"""Cross-resolution gates run per served batch: the program's counter
``models.litehrnet.CrossResolutionWeighting.calls`` over the batches the
process sent through the predictor (``serve.Predictor.batches``: warm-up,
window, traced and span requests), both counted since the process started.
Lite-HRNet-30's forward runs 28. None for a program without the counter."""


def read(run):
    try:
        from litehandnet_tpu_torch.models.litehrnet import (
            CrossResolutionWeighting,
        )
        from litehandnet_tpu_torch.serve import Predictor
    except ImportError:
        return None
    calls = getattr(CrossResolutionWeighting, "calls", None)
    batches = getattr(Predictor, "batches", 0)
    if calls is None or not batches:
        return None
    return calls / batches
