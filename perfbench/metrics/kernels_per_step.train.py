"""Device kernels per ``Trainer.train_step`` (``torch.profiler``; copies
and sets left out)."""

from perfbench.core.readers import kernels_per_call


def read(run):
    return kernels_per_call(run)
