"""Mean ms of ``serve.Predictor.heatmaps`` (the H2D copy, normalize, the
served graph's forward and ``unpack_outputs``) per batch, the benchmark's
span closed by a synchronize."""

from perfbench.core.readers import span_ms


def read(run):
    return span_ms(run, "heatmaps")
