"""Faults planted in the program's serve path, each of which the check that
decides ``correct`` has to catch. The benchmark's own runs never plant
them: the tests under ``perfbench/tests/`` and ``perfbench/calibrate.py``
(which reads them on the chip) do.

- ``half_batch``: the served graph runs on the first half of each batch;
  the other half is answered from the first crop's maps.
- ``stale``: every other request is answered from the previous request's
  maps (half of the answers wrong where a batch holds one crop).
- ``altered_maxval``: each joint's maxval is the next joint's, where the
  decode produces it.
- ``altered_preds``: every keypoint 32 px off, where the decode produces it.
"""

from __future__ import annotations

import contextlib

import torch

SERVE = ("half_batch", "stale", "altered_maxval", "altered_preds")


@contextlib.contextmanager
def planted(kind: str):
    """Inside, ``serve.Predictor`` carries the fault ``kind``."""
    from litehandnet_tpu_torch import serve

    Predictor = serve.Predictor
    heatmaps, decode = Predictor.heatmaps, serve.keypoints_from_heatmaps
    seen = {"calls": 0, "last": None}

    def half_batch(self, images):
        n = max(1, images.shape[0] // 2)
        hm = heatmaps(self, images[:n])
        return torch.cat([hm, hm[:1].expand(images.shape[0] - n,
                                            *hm.shape[1:])])

    def stale(self, images):
        hm = heatmaps(self, images)
        seen["calls"] += 1
        if seen["calls"] % 2 == 0 and seen["last"] is not None:
            hm = seen["last"]
        seen["last"] = hm
        return hm

    def altered(*args, **kw):
        hm, preds, maxvals = decode(*args, **kw)
        if kind == "altered_maxval":
            return hm, preds, maxvals.roll(-1, dims=1)
        return hm, preds + 32.0, maxvals

    if kind not in SERVE:
        raise KeyError(f"no serve fault named {kind!r}; known: {SERVE}")
    try:
        if kind in ("half_batch", "stale"):
            Predictor.heatmaps = half_batch if kind == "half_batch" else stale
        else:
            serve.keypoints_from_heatmaps = altered
        yield
    finally:
        Predictor.heatmaps = heatmaps
        serve.keypoints_from_heatmaps = decode
