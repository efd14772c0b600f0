"""Mean ms of ``ops.decode.keypoints_from_heatmaps`` (argmax, DARK with the
``blur_log`` kernel, ``transform_preds``) per request, with the bbox copy to
the device and the answer's copy to the host, as ``Predictor.__call__``
runs it: the benchmark's span closed by the copy to the host."""

from perfbench.core.readers import span_ms


def read(run):
    return span_ms(run, "decode")
