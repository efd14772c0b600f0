"""Host seconds the run spent building (``nvcc``) and loading the port's
CUDA libraries (``kernels._build.seconds``); None for a program that does
not count them. A run whose checkout already holds the libraries builds
nothing, so the reading compares only between runs of the same cache state:
the run's notes give ``nvcc_runs`` (``kernels._build.compiles``), 0 on a
warm cache."""


def read(run):
    from litehandnet_tpu_torch.kernels import _build

    compiles = getattr(_build, "compiles", None)
    if compiles is not None:
        run.notes["nvcc_runs"] = sum(compiles.values())
    return getattr(_build, "seconds", None)
