"""The serve runner: a closed loop of one client with one request in flight
through ``serve.Predictor.__call__``, on crops made from the seed.

Inputs are ``distinct`` uint8 batches ``[B, H, W, 3]`` in pinned host
memory, each with its bbox centers and scales, made before the window; the
i-th request sends batch ``i % distinct``. A request ends when its ``preds``
and ``maxvals`` are on the host. Every answer of the run is held, once the
window has closed, against the plain reference's answer for the same batch
(``judge``).
"""

from __future__ import annotations

import contextlib
import itertools
import math
import statistics
import time
from typing import Callable, Dict, List, Tuple

import numpy as np
import torch

from perfbench.core import spec, trace
from perfbench.core.program import load, predictor, seeded_weights
from perfbench.core.run_context import Run, quarters
from perfbench.reference.common import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    dark_decode,
    exact_fp32,
    fp8_products,
)

Answer = Tuple[int, torch.Tensor, torch.Tensor]   # (batch index, preds, maxvals)


def make_inputs(run: Run, size) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """``(images [D, B, H, W, 3] uint8, centers [D, B, 2], scales [D, B,
    2])`` on the host, images pinned: noise crops with bbox centers within
    ``center_jitter_px`` of the crop's middle and scales (units of 200 px)
    of the crop's size times U(``scale``)."""
    mix, dev = run.cell.mix, run.device
    D, B = int(mix["distinct"]), int(mix["batch"])
    H, W = size
    gen = torch.Generator(dev).manual_seed(spec.sub_seed(run.seed, "inputs"))
    made = torch.randint(0, 256, (D, B, H, W, 3), generator=gen, device=dev,
                         dtype=torch.uint8)
    images = torch.empty(made.shape, dtype=torch.uint8,
                         pin_memory=dev.type == "cuda")
    images.copy_(made)
    del made
    jitter = float(mix["center_jitter_px"])
    lo, hi = (float(v) for v in mix["scale"])
    u = torch.rand((D, B, 3), generator=gen, device=dev, dtype=torch.float64)
    centers = torch.stack([W / 2 + (2 * u[..., 0] - 1) * jitter,
                           H / 2 + (2 * u[..., 1] - 1) * jitter], dim=-1)
    s = lo + (hi - lo) * u[..., 2]
    scales = torch.stack([s * W / 200.0, s * H / 200.0], dim=-1)
    return images, centers.float().cpu(), scales.float().cpu()


def closed_loop(call: Callable[[int], Tuple[torch.Tensor, torch.Tensor]],
                distinct: int, seconds: float, answers: List[Answer]):
    """Requests one after another until ``seconds`` have passed; each
    request's answer is copied to the host before the next is sent.

    Returns (latencies in seconds, start, end of the last request)."""
    latency = []
    start = done = time.perf_counter()
    deadline = start + seconds
    i = 0
    while True:
        t = time.perf_counter()
        if t >= deadline:
            break
        j = i % distinct
        preds, maxvals = call(j)
        answers.append((j, preds.cpu(), maxvals.cpu()))
        done = time.perf_counter()
        latency.append(done - t)
        i += 1
    return latency, start, done


def reference_answers(run: Run, images, centers, scales, kernel: int,
                      control: bool = False) -> List[tuple]:
    """The plain reference's ``preds``, ``maxvals`` and ``well`` for each
    distinct batch (``reference.common.dark_decode``), float32 without TF32
    from the run's weights. ``control`` computes the forward one precision
    below the served bfloat16: bfloat16 autocast with every convolution's
    operands rounded to float8 e4m3."""
    dev = run.device
    with torch.device(dev):
        model = spec.reference(run.cell.config["reference"]).build(
            run.cell.model_spec(run.overrides))
    load(model, seeded_weights(run))
    model.eval()
    mean = torch.tensor(IMAGENET_MEAN, device=dev).view(1, 3, 1, 1) * 255.0
    std = torch.tensor(IMAGENET_STD, device=dev).view(1, 3, 1, 1) * 255.0
    out = []
    with torch.no_grad(), exact_fp32():
        for j in range(images.shape[0]):
            x = (images[j].to(dev).permute(0, 3, 1, 2).float() - mean) / std
            with contextlib.ExitStack() as stack:
                if control:
                    stack.enter_context(torch.autocast(dev.type,
                                                       dtype=torch.bfloat16))
                    stack.enter_context(fp8_products())
                maps = model(x)
            maps = maps.float().permute(0, 2, 3, 1).contiguous()
            preds, maxvals, well = dark_decode(maps, centers[j].to(dev),
                                               scales[j].to(dev), kernel)
            out.append({"preds": preds, "maxvals": maxvals, "well": well})
    return out


def judge(answers: List[Answer], refs: List[dict], limits: dict,
          device) -> Tuple[Dict[str, float], int, int]:
    """Every answer against the reference's for its batch, pooled over the
    run; ``limits`` names the numbers compared.

    Every joint of every answer counts toward both: ``maxval_mean_gap``,
    the mean of |maxval - reference maxval| as a share of the batch's
    largest |reference maxval|, and ``pred_p75_px``, the 75th percentile of
    the distance in image px between the served and the reference
    keypoint, which a fault in a quarter of the joints or more moves. (On
    most joints of random-weight maps the DARK step divides by a
    near-singular Hessian, where rounding alone moves a keypoint by tens of
    px, and bfloat16 moves some argmaxes to another peak: a wider quantile
    or the widest gap would fail sound runs.) Non-finite values count as
    infinite. Returns (the numbers, answers judged, answers that failed:
    all of them where a number breaks its limit, else those with a
    non-finite value)."""
    gaps, dists, broken = [], [], 0
    by_batch: Dict[int, list] = {}
    for j, preds, maxvals in answers:
        by_batch.setdefault(j, []).append((preds, maxvals))
    for j, got in by_batch.items():
        ref = refs[j]
        P = torch.stack([p for p, _ in got]).to(device).double()
        M = torch.stack([m for _, m in got]).to(device).double()
        finite = torch.isfinite(P).flatten(1).all(1) & torch.isfinite(
            M).flatten(1).all(1)
        broken += int((~finite).sum())
        scale = ref["maxvals"].abs().max().clamp(min=1e-30)
        gap = ((M - ref["maxvals"]) / scale).abs()
        dist = (P - ref["preds"]).norm(dim=-1)
        gaps.append(torch.nan_to_num(gap, nan=float("inf")).flatten())
        dists.append(torch.nan_to_num(dist, nan=float("inf")).flatten())
    gap, dist = torch.cat(gaps), torch.cat(dists)
    numbers = {"maxval_mean_gap": float(gap.mean()),
               "pred_p75_px": float(dist.kthvalue(
                   max(1, math.ceil(0.75 * dist.numel()))).values)}
    numbers = {n: v for n, v in numbers.items() if n in limits}
    if any(v > limits[n]["limit"] for n, v in numbers.items()):
        broken = len(answers)
    return numbers, len(answers), broken


def run(r: Run) -> dict:
    """Set-up, the window, the traced calls with ``--trace 1``, then the
    check. Returns the numbers the result line needs."""
    cfg = r.cell.port_config(r.overrides)
    mix = r.cell.mix
    D = int(mix["distinct"])
    images, centers, scales = make_inputs(r, cfg.DATASET.image_size)
    r.log("set-up: inputs made")
    served = predictor(r)
    r.log("set-up: predictor built")

    def call(j):
        return served(images[j], centers[j], scales[j])

    for i in range(int(mix["warmup"])):
        call(i % D)
    r.sync()
    r.log("set-up: warmed up")
    answers: List[Answer] = []
    r.setup_s = time.perf_counter() - r.t0
    latency, start, end = closed_loop(call, D, r.seconds, answers)
    B = int(mix["batch"])
    r.rate = len(latency) * B / (end - start)
    r.call_s = (end - start) / len(latency)
    done = list(itertools.accumulate(latency, initial=start))[1:]
    r.log(f"window: {len(latency)} requests of {B} in {end - start:.3f} s, "
          f"median {statistics.median(latency) * 1e3:.3f} ms, set-up "
          f"{r.setup_s:.3f} s; requests in each quarter "
          f"{quarters(done, start, r.seconds)}")
    if r.trace:
        from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps

        def traced(i):
            preds, maxvals = call(i % D)
            answers.append((i % D, preds.cpu(), maxvals.cpu()))

        r.traced = trace.profile(traced, int(mix["trace_requests"]),
                                 "serve.request", r.device)
        heat, dec = r.spans.setdefault("heatmaps", []), r.spans.setdefault(
            "decode", [])
        for i in range(int(mix["span_requests"])):
            j = i % D
            r.sync()
            t0 = time.perf_counter()
            hm = served.heatmaps(images[j])
            r.sync()
            t1 = time.perf_counter()
            c = torch.as_tensor(centers[j], dtype=torch.float32, device=r.device)
            s = torch.as_tensor(scales[j], dtype=torch.float32, device=r.device)
            _, preds, maxvals = keypoints_from_heatmaps(hm, c, s, **served.decode)
            answers.append((j, preds.cpu(), maxvals.cpu()))
            t2 = time.perf_counter()
            heat.append(t1 - t0)
            dec.append(t2 - t1)
    r.sync()
    if r.device.type == "cuda":
        r.memory_peak_bytes = torch.cuda.max_memory_allocated(r.device)
    kernel = served.decode["kernel"]
    del served, call
    if r.device.type == "cuda":
        torch.cuda.empty_cache()
    refs = reference_answers(r, images, centers, scales, kernel)
    numbers, attempted, failed = judge(answers, refs, r.cell.limits, r.device)
    r.notes["well_posed_joints"] = int(sum(int(ref["well"].sum())
                                           for ref in refs))
    e2e = {"setup_s": r.setup_s, "serve_img_s": r.rate,
           "serve_p95_ms": float(np.percentile(latency, 95)) * 1e3}
    return dict(numbers=numbers, attempted=attempted, failed=failed, e2e=e2e)
