"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every hand-written kernel of the port from
   ``litehandnet_tpu_torch/csrc`` with ``nvcc`` (one process per source,
   all started together);
2. kernels of the serve and attention paths: ``blur_log`` and
   ``softpool_2x2`` held against their plain PyTorch versions on the card,
   on each of their two paths (fast and general, as the wrappers' ``plan``
   picks them) at their paths' shapes and at one shape per path boundary
   (softpool: float32 and bfloat16, channels_last and NCHW memory, k=3 s=2
   on odd sizes, ragged C, an unaligned start, the overflow window); a
   second call and the other memory layout give the same bits; then
   kernel, plain version and library yardstick timed (``blur_log`` also at
   phase 16's batch-1 requests ``[1,64,64,21]`` and ``[1,56,56,21]``),
   beside the earlier
   kernels of commit ``EARLIER_COMMIT`` in turns (device and host time)
   where their sources were copied into ``build/parent_csrc``; and
   ``dw_conv_bias_act`` at each depthwise site of the served LiteHandNet
   deploy graph (B=128, float32 and bfloat16 against its plain version),
   its bfloat16 device and host time beside its bound, the plain version
   and cuDNN's grouped conv with its bias pass and activation;
3. serve: full-width LiteHandNet (``freihand_256_dark_h4_ca_r4``, random
   weights from a seed): train graph equals deploy graph in float32 on the
   card, and the card's deploy forward equals the CPU's; card decode
   (kernel) equals CPU decode (plain); then a few bfloat16 requests
   through ``Predictor`` with every kernel launch counter set to 0 just
   before and read just after (every ``blur_log`` launch on its fast path,
   ``dw_conv_bias_act`` once per routed depthwise conv and batch),
   the serve rate, and the device time of one request by kernel
   (``torch.profiler``);
4. serve of ``mynet/freihand_256`` and
   ``hourglass_ablation/freihand_256_cbam`` at full width, unfused: card
   forward (float32, TF32 off) equals the CPU's, card decode of its
   heatmaps equals the CPU's, then the same counted bfloat16 requests,
   rate and profile;
5. attention entry: ``SoftPooling`` forward and backward on the card equal
   the CPU's, with one ``softpool_2x2`` launch per forward (on its fast
   path) and none in the backward;
6. kernels of the train path: ``moments`` and ``dw_conv3x3_stats`` held
   against their plain versions at every site shape of the train steps at
   B=32 of the flagship, ``hourglass_ablation``-cbam and the zoo families
   of phases 11 and 13 (``moments`` up to 2048 channels, 16 channel
   groups; ``dw_conv3x3_stats`` of the flagship and ``litehandnet_msrb``)
   and at ragged shapes; the C = 32/64 sites that ``LHN_FUSED_BN_SMALLC=1``
   adds in the flagship and ``litehandnet_msrb`` beside their plain
   two-pass; the sites of phase 17's seven twin runs (B=16, 128²);
   float32 and bfloat16 (NCHW memory and a second call give the same bits),
   then timed per site shape beside the bound and the library yardstick,
   with the sums per train step;
7. train (flagship, weights from ``randomize_``): one B=2 step on the card
   equals the same step on the CPU in float64 and float32 (TF32 off,
   dropout at identity); the fused depthwise path (``LHN_FUSED_DW=1``)
   gives the same loss; ``Trainer.fit`` for one epoch of B=32 batches with
   the counters set to 0 just before and read just after (each kernel
   launched once per site per step), checkpoints written and restored;
   ms/step and img/s, ms/step with ``LHN_FUSED_BN_SMALLC`` off and on,
   peak memory and a profiled step;
8. train ``hourglass_ablation/freihand_256_cbam`` the same way (step card
   = CPU, counted ``Trainer.fit`` with ``moments`` once per 128-channel
   BatchNorm per step, ms/step, peak memory, profile);
9. train from disk: a seeded FreiHAND-style COCO dataset of 224x224 JPEGs
   (256 train and 64 val records) for the flagship at full width; one train
   batch through ``DevicePipeline.apply`` on the card equals the CPU's with
   the same draws (TF32 off); the pipeline's device and host ms and kernels
   per batch, the loader's host ms per batch; ``tools/train.main`` for one
   epoch (8 steps of B=32) and a val pass with the counters set to 0 just
   before (``moments`` once per 128-channel BatchNorm per step); loader-fed
   epochs against the same batches held on the card, and the busy share of
   one loader-fed step; the val targets decoded on the card through
   ``TopDownDecoder`` (``blur_log`` on its fast path) evaluate to PCK 1.0;
10. evaluate from disk: ``tools/test.main --load-best`` on phase 9's run
   (``blur_log`` once per batch, fast path) equals the same call on the CPU
   within one joint crossing a threshold, and a ``--bf16`` run; the SimDR
   fine-tune configuration (224², B=24, SGD) trained one epoch from phase
   9's fixture by ``tools/train.main`` (``moments`` once per 128-channel
   BatchNorm per step), its checkpoint's SimDR decoders, and
   ``tools/test.main`` on it; ``tools/test.main --allow-init`` on
   ``mynet/_1_mpii_action_256x256_dark`` at full width over a seeded
   MPII-action fixture (PCKh), and again with ``MODEL.output_channel``
   K + 3, whose region channels ``tools/test`` cuts before a fast-path
   decode; the targets of that fixture and of a seeded
   COCO fixture (ground-truth boxes, and a detection ``bbox_file``)
   decoded on the card and on the CPU to the same PCKh 100 and AP 1.0;
   the loader's host ms per batch for ``decode_procs`` 0, 4 and
   ``default_procs()`` in turns, and loader-fed epochs with the fastest
   process setting against 0 (a measurement, not a gate);
11. the model zoo at full width (``ZOO_CONFIGS``: SRHandNet, Lite-HRNet-30,
   SimpleBaseline ResNet-50 and MobileNetV2, hourglass with 2 stacks,
   LiteHandNet MSRB; random weights from a seed): card forward (float32, TF32 off) equals the
   CPU's on every output; ``blur_log`` on the evaluated maps equals its
   plain twin and card decode equals CPU decode (on at least
   ``ZOO_MIN_WELL`` joints with a well-conditioned DARK step, decoding
   batches of random images until there are as many); the counted bf16 serve
   path through ``Predictor`` (``blur_log`` once a request, fast path; the
   finest scale or last stack, region channels cut); one float64 step card
   = CPU (SRHandNet on per-scale targets from ``DevicePipeline``); a
   counted ``Trainer.fit`` (``moments`` once per 128-channel BatchNorm per
   step, none in Lite-HRNet; LiteHandNet MSRB under ``LHN_FUSED_DW=1``,
   ``dw_conv3x3_stats`` once per depthwise site at d = 1 and 2, and
   ms/step with ``LHN_FUSED_BN_SMALLC`` off and on), ms/step of its
   synchronized steps and its peak memory; for LiteHandNet MSRB its deploy
   graph = train graph, and ``tools/train.main`` for ``MARKED_EPOCHS``
   epochs on phase 9's fixture with its joints marked in color, then
   ``tools/test.main --load-best`` on the card and the CPU (the decoded
   maps equal, at least ``ZOO_MIN_WELL`` joints with a well-conditioned
   DARK step and those within 1e-3 px, PCK and AUC within one joint, EPE
   within 0.1 px); then
   ``tools/benchmark.main`` over the 8-stack hourglass, the one model no
   other phase times, serving at B=128 bf16 and training at B=32;
12. multi-hand (the Gen-1 path) at the full width of
   ``mynet_stacked/freihand_256_region_simdr`` (exp 16, seed-0 weights):
   the card's float32 forward equals the CPU's on every output and a
   float64 step on the card equals the CPU's; ``tools/train_center_simdr``
   for one epoch of B=32 on phase 9's fixture with the cycle-detection pass
   on every step (8 full- and 8 half-resolution steps; ``moments`` once per
   128-channel BatchNorm per step, ``blur_log`` twice per val batch on its
   general path at 19 taps); ``tools/demo`` on that checkpoint (region
   branch, ``blur_log`` twice a frame, general path), on phase 9's run (the
   top-down branch, once a frame, fast path) and on SRHandNet with
   ``--pyramid`` (no kernel); ``ResultParser`` on the card equals the CPU on
   seeded multi-hand scenes (boxes and keypoints within 1e-3 px, the same
   PCK and AP);
13. the rest of the zoo (random weights from a seed, float32, TF32 off):
   YOLOv6 (``yolov6/cwb_hand_od``, 256², B=32, BatchNorm statistics
   calibrated on the batch) card = CPU rows (every column) and raw maps
   for the train and deploy graphs, deploy = train, a counted
   train-mode forward (``moments`` at its 45 sites); AttHandNet at 224²
   (forward card = CPU at B=8, a float64 step card = CPU at B=2 on
   coordinate targets, a counted float32 step at B=32 with ms/step and
   peak memory); the MobileNetV2 classifier (1000 classes, 224², B=32)
   card = CPU and a counted train-mode forward; ``rep_blocks`` fusion; and
   a seeded LiteHandNet MSRB ``.pth`` through ``tools/import_checkpoint``,
   ``tools/test`` on it equal to the same weights saved directly, and
   ``tools/analyze_weights`` over every parameter;
14. the rest of the package: ``HeatmapParser.parse`` on the card equals
   the CPU on seeded scenes of two hands an image (B = 32, 256², 64²
   maps; boxes and keypoints within 1e-3 px; no kernel launched) and
   ``HeatmapParserSH.parse_single`` too, with the parse's device ms per
   batch; ``centermap.pool_nms`` and ``decode_bbox``; ``homography_warp``,
   ``mosaic4`` (below and above 2S) and the other photometric ops on a
   B = 32 batch of 256² images within 1e-3 of 255; ``utils/profiling.trace``
   around one served LiteHandNet request (counted: ``blur_log`` once, fast
   path; the trace must hold the card's kernels) and ``cost_analysis`` of
   the flagship's forward; the loader's choice between the native ROI
   decoder and cv2 (no ``jpeglib.h`` on the card's machine: cv2).
15. data parallel on the one card: ``tools/test --data-parallel`` over
   the card count on phase 9's run gives phase 10's metrics (``blur_log``
   once per batch, fast path); ``tools/train --num-devices 1`` (one spawned
   rank over NCCL, the DDP step) on phase 9's fixture equals the same run
   in this process (cuDNN deterministic, TF32 off: first-step loss, final
   weights; ``moments`` once per 128-channel BatchNorm per step, counted in
   the rank); two gloo ranks on cuda:0 at full width: a SyncBN step equals
   one process's step on the global batch, and a per-rank-BN step launches
   ``moments`` at every 128-channel site on each rank (counted per rank)
   with running statistics the mean of the ranks'; ms/step of a world of 1
   over NCCL against one process's step, in turns in one new process.
16. spatial serve: the hand families and the benchmark zoo at full width
   (seed-0 weights, float32, TF32 off, deterministic cuDNN algorithms):
   the flagship (exp 2) and ``litehandnet_msrb`` at 256² in their deploy
   graphs, ``mynet`` and ``hourglass_ablation``-CBAM at 224² in eval mode,
   SRHandNet (its finest scale's 24 channels decoded), Lite-HRNet-30,
   ResNet-50, MobileNetV2 and hourglass-s2 (its last stack decoded) at 256²
   in eval mode, served at batch 1 through
   ``eval.make_spatial_serve`` by worlds of 2 and 8 gloo ranks on cuda:0,
   each world started once for all nine (the image's height split over the
   ranks; halo fetches, reductions, CBAM's maxima and the gather as
   all-reduces; 8 ranks hold 1-row bands at the deepest level) against the
   single-device forward and decode: gathered maps within 1e-4 of the map
   max; preds 98% within 1e-3 heatmap px, the flagship's all within 0.1 px
   and the other families' well-conditioned joints within 1e-3 px, and the
   one-device decode of the served maps within 1e-3 px of the served
   preds; maxvals within 1e-4 of the request's
   largest, every rank the same bits and exchanges, ``blur_log`` once per
   request on each rank (fast path, counted in the rank); the median
   batch-1 latency of one device and of each world, the exchanges per
   request and the time of one all-reduce of a halo-sized buffer.
17. twin: the twin-accuracy protocol (``tools/twin_accuracy.py``): for
   each of the seven stored runs of ``TWIN_RUNS`` at 128² (its stored
   protocol, float32, TF32 off) the init checksum equals the stored one and
   the step-0 loss on the card is within 1e-5 of the stored ``loss_first``
   and of the CPU's; the flagship's run cut to 25 steps and 32 eval images
   through ``main`` (``moments`` once per C % 128 BatchNorm per step,
   ``blur_log`` once per decode, fast path), resumed from its step-0
   snapshot to the same json, and ``--side report`` refusing the cut
   run's protocol; ms/step.
18. remat: the rematerialized train step (``make_train_step(remat=True)``,
   ``LHN_REMAT``) of exp 2 at B=32 (float32, TF32 off, cuDNN
   deterministic, dropout live from a seeded generator) equals its plain
   step bit for bit (loss, every buffer, gradient and parameter), with
   ``moments`` (and ``dw_conv3x3_stats`` under ``LHN_FUSED_DW=1``) launched
   twice a site, counted; phase 15's world of 1 (NCCL, DDP) the same; then
   ms/step and peak memory with remat off and on for exp 2, AttHandNet and
   hourglass-s2 at B=32.

19. serve graphs, in a process of its own: the benchmark cells' three
   models (LiteHandNet exp 2 and ResNet-50 at B=128, Lite-HRNet-30 at
   B=512; bfloat16, seeded weights) through ``Predictor``, its forward
   replayed as CUDA graphs (``utils/cuda_graphs``), against an always-eager
   copy on the same model:
   the heatmaps equal bit for bit, the program counters move alike per
   batch (``dw_conv_bias_act`` once per routed depthwise conv), a profiled
   request of each runs the kernels its counters count (by name in the
   device trace: ``dw_conv_bias_act`` once per routed conv inside the
   replay, ``blur_log`` once in the decode) and records the same spans;
   each one's host enqueue of ``heatmaps``, device busy time (profiled),
   capture seconds, graph pool and request time in turns (eager, graphed,
   graphed, eager); LiteHandNet at two smaller batches on the same
   predictor, captured into its one pool (bit for bit, less than 3/4 of the
   first pool added); then the batch-1 request of the parked
   ``litehandnet.serve_b1`` graphed and eager, as a finding.

Kernel times are device times: one CUDA event pair around 50 back-to-back
calls queued behind ``torch.cuda._sleep`` (so the card never waits for the
host), the median of 7 such runs; host microseconds per call are timed
apart, with the card kept busy. ``--kernels-only`` runs phases 1, 2 and 6
alone, ``--serve-graphs-only`` phases 1 and 19.

Prints the card's name and power limit, each kernel function's ``ptxas``
registers, shared memory and spills, each phase's wall seconds, a
``{"kernels": [...]}`` line, and last ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA card
or when any check fails. Imports nothing of JAX.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
BATCH = 128          # serve batch (bench.py's per-chip batch)
BATCH_TRAIN = 32     # train batch (TRAIN.batch_per_gpu of the template)
TRAIN_STEPS = 8      # steps of the counted Trainer.fit epoch
TIMED_STEPS = 10     # timed train steps per setting, after 3 warm-up steps
# Float32 gradients of the full-depth step differ from float64 by ~0.4% (the
# flagship) to ~2% (hourglass_ablation-cbam) over all leaves, on the CPU as
# on the card, and single leaves by far more: summation orders differ and the
# train-mode BatchNorms of the full depth amplify rounding. The exact
# comparison is made in float64; in float32 the card's gradients are held to
# float64 within 1% overall, or within twice the CPU's own float32 error
# where the model's rounding alone exceeds that.
F32_GRAD_TOL = 1e-2
# Adam's first step moves a weight by lr * sign(g): where g is near zero its
# sign may differ, 2 lr apart; the extra 1% covers rounding of w +- lr.
PARAM_TOL = 2.02
REQUESTS = 4         # batches served in the counted main-path run
TIMED_REPS = 5       # serve-rate runs; twice as many calls time a batch
TIMED_LAUNCHES = 50  # back-to-back calls between one event pair
TIMED_RUNS = 7       # such runs; their median is the device time
SLEEP_CYCLES_PER_US = 2000   # above the H100's 1.98 GHz top SM clock
KERNEL_ATOL = 1e-4   # on log values: sum order differs, log turns relative
                     # error of the blurred map into absolute error
SERVE_KERNELS = ("blur_log",)
DARK_KERNEL_GEN1 = 19     # pcfg.dark_kernel: ResultParser's DARK blur
MULTIHAND_MAX_HANDS = 4   # tools/demo --max-hands in phase 12
DECODE_MODEL_TOL = 0.1    # heatmap px, card vs CPU decode of a model's maps
# the families served unfused at full width, and the one trained
SERVED_FAMILIES = ("mynet/freihand_256", "hourglass_ablation/freihand_256_cbam")
TRAINED_FAMILY = "hourglass_ablation/freihand_256_cbam"
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, FP32 outside tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def latency_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median milliseconds of single calls of ``fn`` from an idle card: one
    event pair around each call, so the host's enqueue time is included
    (a request's latency, not a kernel's device time)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_us(fn, n: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Host microseconds per call of ``fn``: a host clock around ``n``
    calls while the card sleeps (``torch.cuda._sleep``), so the host never
    waits for the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(int(n * 200 * SLEEP_CYCLES_PER_US))
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    seconds = time.perf_counter() - t0
    torch.cuda.synchronize()
    return seconds / n * 1e6


def device_ms(fn, n: int = TIMED_LAUNCHES, runs: int = TIMED_RUNS,
              warmup: int = 3) -> float:
    """Device milliseconds per call of ``fn``: one CUDA event pair around
    ``n`` back-to-back calls, queued behind a ``torch.cuda._sleep`` that
    outlasts their enqueue, so the card runs them without waiting for the
    host; the median over ``runs`` such runs, after warm-up."""
    per_call_us = host_us(fn, n, warmup)
    sleep = int((2 * n * per_call_us + 100) * SLEEP_CYCLES_PER_US)
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


def timed(fn) -> dict:
    """``{"ms": device ms per call, "host_us": host us per call}``."""
    return {"ms": device_ms(fn), "host_us": host_us(fn)}


def set_tf32(enabled: bool) -> None:
    torch.backends.cudnn.allow_tf32 = enabled
    torch.backends.cuda.matmul.allow_tf32 = enabled


def heatmap_probe(B, H, W, K, seed):
    """float32 maps [B, H, W, K] with Gaussian peaks (sigma 2) at random
    sub-pixel centres, some inside the kernel-11 halo of the border, plus
    all-zero maps and single-pixel spikes."""
    rng = np.random.RandomState(seed)
    cx = rng.uniform(0, W - 1, size=(B, 1, 1, K)).astype(np.float32)
    cy = rng.uniform(0, H - 1, size=(B, 1, 1, K)).astype(np.float32)
    ys = np.arange(H, dtype=np.float32)[None, :, None, None]
    xs = np.arange(W, dtype=np.float32)[None, None, :, None]
    hm = np.exp(-((xs - cx) ** 2 + (ys - cy) ** 2) / 8.0).astype(np.float32)
    hm += rng.uniform(0, 1e-3, size=hm.shape).astype(np.float32)
    hm[0, :, :, 0] = 0.0                       # all-zero map
    if K > 2:
        hm[0, :, :, 1] = 0.0
        hm[0, 0, 0, 1] = 1.0                   # spike in the corner
        hm[0, :, :, 2] = 0.0
        hm[0, H // 2, W // 2, 2] = 3.0         # spike in the interior
    if B > 1:
        hm[1, :, :, 0] = 0.0
        hm[1, H - 1, W // 3, 0] = 2.0          # spike on the bottom edge
    return torch.from_numpy(hm)


def card_line() -> str:
    from litehandnet_tpu_torch import card_line as line

    return line(torch.device("cuda", 0))


def ptxas_usage(log_text: str) -> dict:
    """``{kernel function: "N registers, ... spill ..."}`` from the
    ``-Xptxas -v`` output of one ``nvcc`` run."""
    usage, func = {}, None
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            func = line.split("'")[1]
        elif func and ("registers" in line or "spill" in line):
            usage[func] = (usage.get(func, "") + " " + line.split(":", 1)[-1]
                           .strip()).strip()
    return usage


def phase_build() -> dict:
    """Builds every kernel of the port, and the earlier versions of the
    redesigned ones where their sources were copied in, all at once; logs
    each kernel function's registers, shared memory and spills."""
    from litehandnet_tpu_torch.kernels import KERNELS, _build

    t0 = time.perf_counter()
    earlier = start_earlier_build()
    _build.build(KERNELS)
    seconds = time.perf_counter() - t0
    log(f"build: {sorted(KERNELS)} with nvcc in {seconds:.1f} s")
    for name in KERNELS:
        text = _build.library_path(name).with_suffix(".log").read_text()
        for func, use in ptxas_usage(text).items():
            log(f"  ptxas {name} {func}: {use}")
    return finish_earlier_build(earlier)


def took_path(wrapper, fn):
    """Calls ``fn`` and returns (its result, the path of the one launch it
    made, from ``wrapper.path_launches``); fails unless it launched once."""
    before = dict(wrapper.path_launches)
    out = fn()
    moved = [p for p, n in wrapper.path_launches.items() if n != before[p]]
    if len(moved) != 1 or wrapper.path_launches[moved[0]] != before[moved[0]] + 1:
        raise AssertionError(f"expected one launch, path counts went from "
                             f"{before} to {wrapper.path_launches}")
    return out, moved[0]


def kernel_ptxas(name: str) -> dict:
    """``{kernel function: ptxas usage}`` of the port's built ``name``."""
    from litehandnet_tpu_torch.kernels import _build

    return ptxas_usage(_build.library_path(name).with_suffix(".log")
                       .read_text())


def path_ptxas(usage: dict, marker: str) -> list:
    return [f"{f}: {u}" for f, u in usage.items() if marker in f]


def phase_kernels(dev, earlier) -> dict:
    """``blur_log`` on both paths: each case against the plain twin, a
    second call giving the same bits, the ``[B, K, H, W]``-memory view
    (general path) giving the same bits as the contiguous tensor; then the
    serve shape timed in turns against the earlier kernel, beside the plain
    twin, two cuDNN passes and a plain copy of the same bytes."""
    import importlib

    # the module (the package binds its name to the wrapper)
    BL = importlib.import_module("litehandnet_tpu_torch.kernels.blur_log")

    blur_log, blur_log_reference = BL.blur_log, BL.blur_log_reference
    set_tf32(False)
    # (shape, kernel, path): the serve shape; H = 56 (7 rows a CTA); the
    # unaligned rows of K = 5; H = 5 (one row a CTA, the halo reaching
    # CTAs two and more away); a cluster of 6 whose last CTA has 2 rows;
    # 64 maps (a CTA of 8 rows would need 262 KB); kernel 7; then the
    # shapes phase 10 decodes: FreiHAND 64² and 56² (SimDR), MPII 64² x 16
    # and COCO 64 x 48 x 17, at tools/test's batch
    cases = [((BATCH, 64, 64, 21), 11, "fast"), ((4, 56, 56, 21), 11, "fast"),
             ((3, 17, 23, 5), 11, "general"), ((2, 5, 8, 4), 11, "fast"),
             ((3, 17, 24, 6), 11, "fast"), ((2, 64, 64, 64), 11, "general"),
             ((2, 64, 64, 21), 7, "general"),
             ((EVAL_BATCH, 64, 64, 21), 11, "fast"),
             ((EVAL_BATCH, 56, 56, 21), 11, "fast"),
             ((EVAL_BATCH, 64, 64, 16), 11, "fast"),
             ((EVAL_BATCH, 64, 48, 17), 11, "fast"),
             # phase 16's batch-1 requests at 256² (one cluster of 8 CTAs)
             # and at 224² (8 CTAs of 7 rows), and SRHandNet's 24 channels
             # (W * K = 1,536, the fast path's limit)
             ((1, 64, 64, 21), 11, "fast"), ((1, 56, 56, 21), 11, "fast"),
             ((1, 64, 64, 24), 11, "fast"),
             # phase 17's decodes of the twin's eval split: the cut run's,
             # and a full run's at 128² and 256²
             ((TWIN_CUT["eval_n"], 32, 32, 21), 11, "fast"),
             ((256, 32, 32, 21), 11, "fast"), ((256, 64, 64, 21), 11, "fast")]
    # the Gen-1 multi-hand decode of phase 12 (ResultParser, DARK at 19
    # taps: the general path): the per-box keypoint maps of a val batch
    # (B x M = 32 x 1), of a demo frame (M = 4) and of phase 12's
    # ResultParser check (B x M = 32 x 4), and the center map that
    # candidate_bboxes blurs once per batch
    cases += [((EVAL_BATCH, 64, 64, 21), DARK_KERNEL_GEN1, "general"),
              ((MULTIHAND_MAX_HANDS, 64, 64, 21), DARK_KERNEL_GEN1, "general"),
              ((MULTIHAND_SCENES * MULTIHAND_MAX_HANDS, 64, 64, 21),
               DARK_KERNEL_GEN1, "general"),
              ((EVAL_BATCH, 64, 64, 1), DARK_KERNEL_GEN1, "general")]
    worst = 0.0
    for seed, (shape, k, path) in enumerate(cases):
        x = heatmap_probe(*shape, seed=seed).to(dev)
        got, took = took_path(blur_log, lambda: blur_log(x, k))
        want = blur_log_reference(x, k)
        again = blur_log(x, k)
        # a strided [B, H, W, K] view of NCHW memory: the general path
        strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        other, other_path = took_path(blur_log, lambda: blur_log(strided, k))
        same = [torch.equal(got, again), torch.equal(got, other)]
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"kernels: blur_log {list(shape)} kernel {k} path {took} "
            f"max_abs_err {err:.3g} (atol {KERNEL_ATOL}); a second call, the "
            f"[B,K,H,W]-memory view ({other_path}) give the same bits: {same}")
        if took != path or other_path != "general":
            raise AssertionError(f"blur_log {shape} took {took} / "
                                 f"{other_path}, expected {path} / general")
        if not (err <= KERNEL_ATOL and all(same)):
            raise AssertionError(f"blur_log disagrees at {shape} kernel {k}")

    x = heatmap_probe(BATCH, 64, 64, 21, seed=1).to(dev)
    lib = earlier.get("blur_log")
    if lib:
        err = float((earlier_blur_log(lib, x) - blur_log(x)).abs().max())
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"earlier blur_log disagrees: {err}")
    old_fn = (lambda: earlier_blur_log(lib, x)) if lib else None
    ms, earlier_ms = in_turns(lambda: blur_log(x), old_fn)
    host, earlier_host = in_turns(lambda: blur_log(x), old_fn, timer=host_us)
    # the bytes alone: a plain copy of the maps
    copy = torch.empty_like(x)
    copy_ms = device_ms(lambda: copy.copy_(x))
    # the same maps in [B, K, H, W] memory: the general path, each block
    # reading and writing its own map contiguously
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    nchw_ms = device_ms(lambda: blur_log(nchw))
    nchw_host = host_us(lambda: blur_log(nchw))
    base = blur_log_baselines(dev, BL, x, 11)
    plain_ms, library_ms = base["plain_ms"], base["library_ms"]
    bound_ms, bound_by = base["bound_ms"], base["bound_by"]
    general19 = time_blur_log_gen1(dev, BL)
    batch1 = [time_blur_log_fast(dev, BL, 1, hm, K)
              for hm, K in ((64, 21), (56, 21), (64, 24))]
    twin = time_blur_log_fast(dev, BL, 256, 32, 21)
    p = BL.plan(x.shape, x.stride(), 11, x.data_ptr() % 16 == 0)
    usage = kernel_ptxas("blur_log")
    earlier_txt = ("not measured" if earlier_ms is None else
                   f"{earlier_ms:.4f} ms, host {earlier_host:.1f} us")
    log(f"kernels: blur_log fast path [128,64,64,21]: device {ms:.4f} ms per "
        f"call, host {host:.1f} us per call; "
        f"earlier kernel of {EARLIER_COMMIT} {earlier_txt}; plan rows "
        f"{p['rows']}, cluster {p['cluster']}, {p['threads']} threads, "
        f"{p['smem']} B shared a CTA; "
        f"ptxas {path_ptxas(usage, 'fast')}")
    log(f"kernels: blur_log general path [128,64,64,21] on [B,K,H,W] memory: "
        f"device {nchw_ms:.4f} ms, host {nchw_host:.1f} us; ptxas "
        f"{path_ptxas(usage, 'general')}")
    log(f"kernels: blur_log [128,64,64,21]: plain {plain_ms:.4f} ms, two cuDNN "
        f"depthwise conv passes {library_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.1f} us ({base['nbytes'] / 1e6:.1f} MB moved, "
        f"{base['flops'] / 1e9:.3f} GFLOP, {bound_ms / ms:.0%} of it), a plain "
        f"copy of "
        f"the maps {copy_ms:.4f} ms")
    return dict(
        name="blur_log", route="cuda",
        source="litehandnet_tpu_torch/csrc/blur_log.cu",
        replaces="litehandnet_tpu/ops/pallas_kernels.py:106",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, host_us=host,
        earlier_ms=earlier_ms, earlier_host_us=earlier_host,
        general_ms=nchw_ms, general_host_us=nchw_host, copy_ms=copy_ms,
        general19=general19, batch1=batch1, twin=twin,
    )


def blur_log_baselines(dev, BL, x, k) -> dict:
    """What ``blur_log(x, k)`` on ``[B, H, W, K]`` maps is held against: the
    plain twin's device time, two cuDNN depthwise passes at ``k`` taps (the
    library time) and the bound over the bytes read once and written once
    and the FLOPs of two ``k``-tap FMA passes, the rescale and the log."""
    from litehandnet_tpu_torch.ops.blur import cv2_gaussian_kernel

    _, H, W, _ = x.shape
    plain_ms = device_ms(lambda: BL.blur_log_reference(x, k))
    pad = (k - 1) // 2
    maps = torch.nn.functional.pad(
        x.permute(0, 3, 1, 2).reshape(-1, 1, H, W), (pad,) * 4)
    taps = torch.as_tensor(cv2_gaussian_kernel(k, 0.0), device=dev)
    kv, kh = taps.view(1, 1, k, 1), taps.view(1, 1, 1, k)
    library_ms = device_ms(lambda: torch.nn.functional.conv2d(
        torch.nn.functional.conv2d(maps, kv), kh))
    n = x.numel()
    nbytes, flops = 2 * n * 4, n * (4 * k + 2)
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, nbytes=nbytes, flops=flops)


def time_blur_log_gen1(dev, BL) -> dict:
    """``blur_log`` at 19 taps on the general path, at the per-box keypoint
    maps of a val batch ``[32,64,64,21]``: device and host time beside the
    plain twin, two cuDNN depthwise passes and the bound; and the center
    map ``[32,64,64,1]`` that ``candidate_bboxes`` blurs."""
    k = DARK_KERNEL_GEN1
    x = heatmap_probe(EVAL_BATCH, 64, 64, 21, seed=3).to(dev)
    center = heatmap_probe(EVAL_BATCH, 64, 64, 1, seed=4).to(dev)
    ms = device_ms(lambda: BL.blur_log(x, k))
    host = host_us(lambda: BL.blur_log(x, k))
    center_ms = device_ms(lambda: BL.blur_log(center, k))
    base = blur_log_baselines(dev, BL, x, k)
    plain_ms, library_ms = base["plain_ms"], base["library_ms"]
    bound_ms, bound_by = base["bound_ms"], base["bound_by"]
    p = BL.plan(x.shape, x.stride(), k, x.data_ptr() % 16 == 0)
    log(f"kernels: blur_log general path at {k} taps {list(x.shape)}: device "
        f"{ms:.4f} ms, host {host:.1f} us per call ({p['threads']} threads, "
        f"{p['smem']} B shared a block); plain {plain_ms:.4f} ms, two cuDNN "
        f"depthwise conv passes {library_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.1f} us ({bound_by}, {bound_ms / ms:.0%} of it); the "
        f"center map [{EVAL_BATCH},64,64,1] {center_ms:.4f} ms")
    return dict(shape=list(x.shape), kernel=k, ms=ms, host_us=host,
                plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
                bound_by=bound_by, center_ms=center_ms)


def time_blur_log_fast(dev, BL, B: int, hm: int, K: int) -> dict:
    """``blur_log`` on the fast path at ``[B,hm,hm,K]``: one of phase 16's
    batch-1 requests (one cluster of 8 CTAs on the card) or phase 17's
    eval-split decode: device and host time beside the plain twin, two
    cuDNN depthwise passes and the bound."""
    x = heatmap_probe(B, hm, hm, K, seed=5).to(dev)
    ms = device_ms(lambda: BL.blur_log(x))
    host = host_us(lambda: BL.blur_log(x))
    base = blur_log_baselines(dev, BL, x, 11)
    p = BL.plan(x.shape, x.stride(), 11, x.data_ptr() % 16 == 0)
    log(f"kernels: blur_log fast path {list(x.shape)}: device "
        f"{ms:.4f} ms, host {host:.1f} us per call (cluster {p['cluster']} "
        f"CTAs of {p['rows']} rows, {p['threads']} threads); plain "
        f"{base['plain_ms']:.4f} ms, two cuDNN depthwise conv passes "
        f"{base['library_ms']:.4f} ms, bound {base['bound_ms'] * 1e3:.3f} us "
        f"({base['bound_by']}, {base['nbytes'] / 1e3:.0f} KB moved, "
        f"{base['bound_ms'] / ms:.2%} of it)")
    return dict(shape=list(x.shape), ms=ms, host_us=host,
                plain_ms=base["plain_ms"], library_ms=base["library_ms"],
                bound_ms=base["bound_ms"], bound_by=base["bound_by"])


def phase_serve(dev, kernel_rows: dict) -> None:
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
    from litehandnet_tpu_torch.serve import deploy_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    cfg = get_config()
    size = cfg.DATASET.image_size[0]

    # train graph (eval mode) == deploy graph, float32 without TF32
    set_tf32(False)
    train = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED))
    train = train.to(dev, memory_format=torch.channels_last)
    deploy = deploy_model(cfg, seed=SEED, device=dev)
    x = torch.randn(8, 3, size, size, generator=torch.Generator().manual_seed(1))
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want, got = train(x), deploy(x)
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    log(f"serve: train vs deploy f32 max_abs_err {err:.3g} (output max "
        f"{scale:.3g}, tolerance 1e-4 x max)")
    if not (got.shape == (8, 21, size // 4, size // 4) and err <= 1e-4 * scale):
        raise AssertionError(f"deploy graph disagrees: {err} at scale {scale}")
    # the card's deploy forward == the same weights on the CPU
    with torch.no_grad():
        ref = deploy_model(cfg, seed=SEED, device="cpu")(x[:2].cpu())
    cpu_err = float((got[:2].cpu() - ref).abs().max())
    log(f"serve: deploy f32 card vs CPU max_abs_err {cpu_err:.3g} "
        f"(tolerance 1e-4 x max)")
    if not cpu_err <= 1e-4 * scale:
        raise AssertionError(f"card forward disagrees with the CPU: {cpu_err}")
    del train, deploy

    # card decode (blur_log kernel) == CPU decode (plain path)
    hm = heatmap_probe(BATCH, size // 4, size // 4, 21, seed=2)
    center = torch.tile(torch.tensor([size / 2, size / 2]), (BATCH, 1))
    scale_ = torch.tile(torch.tensor([size / 200.0, size / 200.0]), (BATCH, 1))
    kw = dict(post_process="unbiased", kernel=11)
    cpu = keypoints_from_heatmaps(hm, center, scale_, **kw)
    card = keypoints_from_heatmaps(hm.to(dev), center.to(dev), scale_.to(dev), **kw)
    hm_err = float((card[0].cpu() - cpu[0]).abs().max())
    val_err = float((card[2].cpu() - cpu[2]).abs().max())
    log(f"serve: decode card vs CPU hm_preds max_abs_err {hm_err:.3g} px "
        f"(tolerance 1e-3), maxvals {val_err:.3g}")
    if not (hm_err <= 1e-3 and val_err == 0.0):
        raise AssertionError(f"card decode disagrees: {hm_err}, {val_err}")

    serve_requests(dev, cfg, kernel_rows)


def serve_requests(dev, cfg, kernel_rows: dict, reps: int = TIMED_REPS) -> None:
    """The serve main path of ``cfg``: ``REQUESTS`` bf16 batches of
    ``BATCH`` through the ``Predictor`` (random weights from ``SEED``) with
    the launch counts set to 0 just before and read just after (``blur_log``
    once per batch, no other kernel); then the time per batch (median of
    ``2 * reps`` calls), the serve rate (median of ``reps`` runs) and one
    profiled request."""
    from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
    from litehandnet_tpu_torch.serve import Predictor

    size = cfg.DATASET.image_size[0]
    name = cfg.MODEL.name
    predictor = Predictor(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.randint(0, 256, (BATCH, size, size, 3), generator=gen,
                             device=dev, dtype=torch.uint8)
               for _ in range(REQUESTS)]
    center = torch.tile(torch.tensor([size / 2, size / 2], device=dev),
                        (BATCH, 1))
    scale_ = torch.tile(torch.tensor([size / 200.0, size / 200.0], device=dev),
                        (BATCH, 1))
    kw = dict(post_process="unbiased", kernel=11)
    predictor(batches[0], center, scale_)          # warm-up, not counted
    zero_counts()
    # the first counted forward is captured as CUDA graphs and the rest
    # replay it, adding the counts the capture saw; phase 19 holds those
    # counts to the kernels a replay runs on the card
    outs = [predictor(b, center, scale_) for b in batches]
    # the train kernels and softpool have no place on a serve path
    from litehandnet_tpu_torch.models.layers import dw_kernel_spec

    # the deploy graph's depthwise convs, each once a batch
    routed = sum(dw_kernel_spec(m) is not None
                 for m in predictor.model.modules())
    expected = {k: REQUESTS for k in SERVE_KERNELS}
    expected["dw_conv_bias_act"] = routed * REQUESTS
    read_counts(kernel_rows, f"serve:{name}", expected, {"blur_log": "fast"})
    for preds, maxvals in outs:
        if preds.shape != (BATCH, 21, 2) or maxvals.shape != (BATCH, 21, 1):
            raise AssertionError(f"bad output shapes {preds.shape}, {maxvals.shape}")
        if not (torch.isfinite(preds).all() and torch.isfinite(maxvals).all()):
            raise AssertionError("non-finite serve output")

    # where the time goes, per batch, and the serve rate
    images = batches[0]
    fwd_ms = latency_ms(lambda: predictor.heatmaps(images), 2 * reps)
    hm = predictor.heatmaps(images)
    dec_ms = latency_ms(lambda: keypoints_from_heatmaps(hm, center, scale_,
                                                        **kw), 2 * reps)
    rates = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            predictor(b, center, scale_)
        torch.cuda.synchronize()
        rates.append(REQUESTS * BATCH / (time.perf_counter() - t0))
    log(f"serve {name}: per batch of {BATCH}: normalize+forward "
        f"{fwd_ms:.3f} ms, decode {dec_ms:.3f} ms")
    log(f"serve {name}: {statistics.median(rates):.1f} img/s median of "
        f"{reps} (min {min(rates):.1f}, max {max(rates):.1f}), bf16, "
        f"B={BATCH}, {size}x{size}")
    profile_request(predictor, images, center, scale_)


def phase_serve_family(dev, name: str, kernel_rows: dict) -> None:
    """A family served unfused (train graph in eval mode) at full width:
    the card's float32 forward equals the CPU's, the card's decode of its
    heatmaps equals the CPU's, then the serve main path."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
    from litehandnet_tpu_torch.serve import deploy_model

    cfg = get_config(name)
    size = cfg.DATASET.image_size[0]
    set_tf32(False)
    x = torch.randn(8, 3, size, size, generator=torch.Generator().manual_seed(1))
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        got = deploy_model(cfg, seed=SEED, device=dev)(x)
        ref = deploy_model(cfg, seed=SEED, device="cpu")(x[:2].cpu())
    scale = max(1.0, float(ref.abs().max()))
    err = float((got[:2].cpu() - ref).abs().max())
    log(f"serve {name}: f32 card vs CPU max_abs_err {err:.3g} (output max "
        f"{scale:.3g}, tolerance 1e-4 x max)")
    if not (got.shape == (8, 21, size // 4, size // 4)
            and torch.isfinite(got).all() and err <= 1e-4 * scale):
        raise AssertionError(f"{name}: card forward disagrees with the CPU")
    hm = got.permute(0, 2, 3, 1)
    center = torch.tile(torch.tensor([size / 2, size / 2]), (8, 1))
    scale_ = torch.tile(torch.tensor([size / 200.0, size / 200.0]), (8, 1))
    kw = dict(post_process="unbiased", kernel=11)
    cpu = keypoints_from_heatmaps(hm.cpu(), center, scale_, **kw)
    card = keypoints_from_heatmaps(hm, center.to(dev), scale_.to(dev), **kw)
    diff = (card[0].cpu() - cpu[0]).abs()
    hm_err = float(diff.max())
    val_err = float((card[2].cpu() - cpu[2]).abs().max())
    # random weights give flat, non-Gaussian maxima where DARK's Newton step
    # divides by a near-singular Hessian and magnifies the 1e-6 rounding of
    # the log map (the 1e-3 px check on Gaussian peaks is the serve
    # phase's): here 98% of the coordinates are held to 1e-3 px and all of
    # them to DECODE_MODEL_TOL
    within = float((diff <= 1e-3).float().mean())
    log(f"serve {name}: decode of its heatmaps, card vs CPU hm_preds "
        f"max_abs_err {hm_err:.3g} px (tolerance {DECODE_MODEL_TOL}), "
        f"{within:.1%} of {diff.numel()} coordinates within 1e-3 px "
        f"(tolerance 98%), maxvals {val_err:.3g}")
    if not (hm_err <= DECODE_MODEL_TOL and within >= 0.98
            and val_err == 0.0):
        raise AssertionError(f"{name}: card decode disagrees: {hm_err}, "
                             f"{val_err}")
    del got
    serve_requests(dev, cfg, kernel_rows)


def profile_request(predictor, images, center, scale) -> None:
    """Device time by kernel over one served batch (``torch.profiler``): the
    device's busy share of the request and the kernels that take most."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        predictor(images, center, scale)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: one request of B={images.shape[0]}: wall {wall_ms:.3f} ms "
        f"under the profiler, device busy {busy_ms:.3f} ms "
        f"({busy_ms / wall_ms:.1%}), {sum(e.count for e in kernels)} kernels")
    for e in kernels[:10]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x "
            f"{e.key[:100]}")

def site_shapes(model, x):
    """Input shapes of the train path's kernel sites in one forward of
    ``model`` on ``x`` (eval mode, no statistics move): BatchNorms with
    C % 128 == 0 (``moments``) and the depthwise 3x3 RepConvs that
    ``LHN_FUSED_DW=1`` fuses (``dw_conv3x3_stats``, with their dilation)."""
    from litehandnet_tpu_torch.models.layers import RepConv, TorchBatchNorm

    bn, dw, hooks = [], [], []
    for mod in model.modules():
        if isinstance(mod, TorchBatchNorm) and mod.num_features % 128 == 0:
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a: bn.append(tuple(a[0].shape))))
        elif isinstance(mod, RepConv) and not mod.deploy:
            conv = mod.conv.conv
            if (conv.groups == conv.in_channels == conv.out_channels
                    and conv.kernel_size == (3, 3) and conv.stride == (1, 1)
                    and conv.padding == conv.dilation):
                hooks.append(mod.register_forward_pre_hook(
                    lambda m, a: dw.append((tuple(a[0].shape),
                                            m.conv.conv.dilation[0]))))
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
        model.train(was_training)
    return bn, dw


def train_sites(dev, name=None, size=None):
    """The kernel sites of ``name``'s train path (an experiment name or a
    config; the flagship by default) at B = BATCH_TRAIN and its input size
    (or ``size``): (BatchNorm shapes, depthwise (shape, dilation))."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model

    cfg = name if hasattr(name, "MODEL") else (
        get_config(name) if name else get_config())
    size = size or cfg.DATASET.image_size[0]
    model = get_model(cfg, device=dev).to(memory_format=torch.channels_last)
    x = torch.randn(BATCH_TRAIN, 3, size, size, device=dev)
    bn, dw = site_shapes(model, x.contiguous(memory_format=torch.channels_last))
    log(f"sites {cfg.MODEL.name}: {len(bn)} BatchNorms with C % 128 == 0 at "
        f"{sorted(set(bn), reverse=True)}; {len(dw)} fusable depthwise 3x3 "
        f"convs at {sorted(set(dw), reverse=True)}")
    return bn, dw


def small_c_sites(dev, name=None):
    """The BatchNorm shapes of ``name``'s train step at B = BATCH_TRAIN
    that ``LHN_FUSED_BN_SMALLC=1`` adds to the ``moments`` kernel: C < 128
    with 128 % C == 0 and N * H * W * C % 128 == 0."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm

    cfg = get_config(name) if name else get_config()
    size = cfg.DATASET.image_size[0]
    model = get_model(cfg, device=dev).to(memory_format=torch.channels_last)
    shapes, hooks = [], []
    for mod in model.modules():
        C = getattr(mod, "num_features", 0)
        if isinstance(mod, TorchBatchNorm) and C < 128 and 128 % C == 0:
            hooks.append(mod.register_forward_pre_hook(
                lambda m, a: shapes.append(tuple(a[0].shape))))
    x = torch.randn(BATCH_TRAIN, 3, size, size, device=dev)
    with torch.no_grad():
        model.eval()(x.contiguous(memory_format=torch.channels_last))
    for h in hooks:
        h.remove()
    shapes = [s for s in shapes if math.prod(s) % 128 == 0]
    log(f"sites {cfg.MODEL.name}: {len(shapes)} BatchNorms with C < 128 that "
        f"LHN_FUSED_BN_SMALLC=1 adds, at {sorted(set(shapes), reverse=True)}")
    return shapes


def bound(nbytes: float, flops: float):
    """(bound ms, what bounds it) on the H100's data-sheet rates."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def channels_last_probe(shape, dtype, seed, dev, scale=3.0, shift=1.0):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed))
    x = x * scale + shift
    return x.to(dev, dtype).contiguous(memory_format=torch.channels_last)


# The redesigned kernels' sources as an earlier commit had them, for a
# comparison in the same run. They are not part of the repository: copy them
# with ``git show`` (see README, "Comparing with the earlier kernels"); where
# the directory is missing, the earlier kernels are not measured.
EARLIER_COMMIT = "abc7c80"
EARLIER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                           "parent_csrc")
EARLIER_KERNELS = ("blur_log", "softpool_2x2")


def start_earlier_build():
    """Starts one ``nvcc`` per earlier source found in ``EARLIER_DIR``;
    returns ``{name: (process, library path)}``."""
    from litehandnet_tpu_torch.kernels import _build

    jobs = {}
    for name in EARLIER_KERNELS:
        src = os.path.join(EARLIER_DIR, f"{name}.cu")
        if os.path.exists(src):
            out = os.path.join(EARLIER_DIR, f"lib{name}_earlier.so")
            jobs[name] = (subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, src],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
                out)
    return jobs


def finish_earlier_build(jobs) -> dict:
    """Waits for ``start_earlier_build``'s jobs; ``{name: ctypes.CDLL}``."""
    import ctypes

    libs = {}
    for name, (proc, out) in jobs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"earlier {name}: nvcc exited "
                               f"{proc.returncode}\n{text}")
        for func, use in ptxas_usage(text).items():
            log(f"  ptxas earlier {name} {func}: {use}")
        libs[name] = ctypes.CDLL(out)
    i, ll, p = ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p
    if "blur_log" in libs:
        fn = libs["blur_log"].lhn_blur_log_f32
        fn.argtypes = [p, p, p, i, i, i, i, i] + [ll] * 8 + [p]
        fn.restype = i
    if "softpool_2x2" in libs:
        fn = libs["softpool_2x2"].lhn_softpool
        fn.argtypes = [p, p] + [i] * 8 + [ll] * 8 + [p]
        fn.restype = i
    log(f"build: earlier kernels of {EARLIER_COMMIT} "
        f"{sorted(libs) or 'not found in ' + EARLIER_DIR}")
    return libs


_EARLIER_TAPS = {}


def earlier_blur_log(lib, x, kernel=11):
    """The earlier ``blur_log`` wrapper: a device context, a Stream object
    and 17 ctypes arguments per call; one block per map."""
    from litehandnet_tpu_torch.ops.blur import cv2_gaussian_kernel

    B, H, W, K = x.shape
    y = torch.empty((B, H, W, K), device=x.device, dtype=torch.float32)
    key = (kernel, x.device)
    if key not in _EARLIER_TAPS:
        _EARLIER_TAPS[key] = torch.as_tensor(cv2_gaussian_kernel(kernel, 0.0),
                                             device=x.device).contiguous()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lhn_blur_log_f32(
            x.data_ptr(), y.data_ptr(), _EARLIER_TAPS[key].data_ptr(), kernel,
            B, H, W, K, *x.stride(), *y.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"earlier blur_log kernel failed: CUDA error {rc}")
    return y


def earlier_softpool(lib, x, kernel=2, stride=2):
    """The earlier ``softpool_2x2`` wrapper: a device context, a Stream
    object and 19 ctypes arguments per call; one thread per output."""
    from litehandnet_tpu_torch.kernels.softpool_2x2 import DTYPES, output_size

    B, C, H, W = x.shape
    Ho, Wo = output_size(H, W, kernel, stride)
    fastest = x.stride(1) <= x.stride(3)
    y = torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype,
                    memory_format=torch.channels_last if fastest
                    else torch.contiguous_format)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.lhn_softpool(
            x.data_ptr(), y.data_ptr(), DTYPES[x.dtype], B, C, H, W, kernel,
            stride, int(fastest), *x.stride(), *y.stride(), stream)
    if rc != 0:
        raise RuntimeError(f"earlier softpool kernel failed: CUDA error {rc}")
    return y


def in_turns(*fns, timer=None):
    """``timer`` (device ms, or host us) of several versions of one
    function, timed in turns (1, 2, ..., n, n, ..., 1) so that a drift of
    the card's clock or the host's load falls on all; each the mean of its
    two readings. A version given as None is not measured (None)."""
    timer = timer or device_ms
    live = [f for f in fns if f is not None]
    first = [timer(f) for f in live]
    second = [timer(f) for f in reversed(live)][::-1]
    means = iter((a + b) / 2 for a, b in zip(first, second))
    return [None if f is None else next(means) for f in fns]


def step_sums(name, site_rows, sites_by_model) -> dict:
    """Per train step of each model: launches and the sums over its sites of
    device ms, bound and library ms and host us."""
    sums = {}
    for model, keys in sites_by_model.items():
        total = {"launches": len(keys)}
        for field in ("ms", "bound_ms", "library_ms", "host_us"):
            total[field] = sum(site_rows[k][field] for k in keys)
        sums[model] = total
        log(f"kernels: {name} per {model} train step: {total['launches']} "
            f"launches, sum of device time {total['ms']:.4f} ms, sum of "
            f"bounds {total['bound_ms']:.4f} ms, "
            f"sum of library time {total['library_ms']:.4f} ms, host "
            f"{total['host_us']:.1f} us")
    return sums


def log_site(name, key, row) -> None:
    log(f"kernels: {name} site {key} float32 channels_last: device "
        f"{row['ms']:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_ms'] / row['ms']:.0%} of it), "
        f"library {row['library_ms']:.4f} ms, host {row['host_us']:.1f} us "
        f"per call, launches per step {row['per_step']}")


def phase_moments(dev, sites_by_model) -> dict:
    from litehandnet_tpu_torch.kernels.moments import moments, moments_reference

    set_tf32(False)
    shapes = sorted({s for v in sites_by_model.values() for s in v},
                    key=lambda s: -s[0] * s[2] * s[3])
    # ragged: M = 1, M not a multiple of a tile, C = 21 and C = 1
    ragged = [(1, 128, 1, 1), (1, 21, 1, 1), (3, 21, 17, 23), (2, 1, 5, 7),
              (5, 128, 9, 7)]
    worst = 0.0
    for i, shape in enumerate(shapes + ragged):
        for dtype in (torch.float32, torch.bfloat16):
            x = channels_last_probe(shape, dtype, seed=100 + i, dev=dev)
            mean, var = moments(x)
            again = moments(x)
            want_mean, want_var = moments_reference(x)
            # the same tensor in NCHW-contiguous memory: same tiles, same bits
            nchw_mean, nchw_var = moments(x.contiguous())
            torch.cuda.synchronize()
            err_mean = float((mean - want_mean).abs().max())
            err_var = float((var - want_var).abs().max())
            worst = max(worst, err_mean, err_var)
            # float32 sums in two orders: mean within 1e-5 relative plus
            # 1e-6 of the input's magnitude, var within 1e-5 relative
            scale = float(x.float().abs().max())
            same = (torch.equal(mean, nchw_mean) and torch.equal(var, nchw_var)
                    and torch.equal(mean, again[0])
                    and torch.equal(var, again[1]))
            ok = (torch.allclose(mean, want_mean, rtol=1e-5, atol=1e-6 * scale)
                  and torch.allclose(var, want_var, rtol=1e-5, atol=1e-12)
                  and same)
            log(f"kernels: moments {list(shape)} {str(dtype)[6:]} max_abs_err "
                f"mean {err_mean:.3g} var {err_var:.3g}, NCHW memory and a "
                f"second call give the same bits: {same}")
            if not ok:
                raise AssertionError(f"moments disagrees at {shape} {dtype}")
    # |mean| / std = 250, against a float64 two-pass (tests/test_fused_bn.py
    # tolerances: mean rtol 1e-6, var rtol 1e-4)
    x64 = torch.randn(64 * 16, 128, generator=torch.Generator().manual_seed(7),
                      dtype=torch.float64) + 250.0
    mean, var = moments(x64.float().to(dev).view(64 * 16, 128, 1, 1))
    want_mean, want_var = x64.mean(0), x64.var(0, unbiased=False)
    rel_mean = float(((mean.cpu().double() - want_mean) / want_mean).abs().max())
    rel_var = float(((var.cpu().double() - want_var) / want_var).abs().max())
    log(f"kernels: moments at mean/std 250 vs float64 two-pass: relative "
        f"error mean {rel_mean:.3g} (rtol 1e-6), var {rel_var:.3g} (rtol 1e-4)")
    if not (rel_mean <= 1e-6 and rel_var <= 1e-4):
        raise AssertionError("moments loses precision at mean/std = 250")

    # device time per site shape, beside the bound and torch.var_mean; the
    # inputs of the <= 16^2 sites (<= 4.2 MB) sit in the 50 MB L2 across the
    # back-to-back calls, as they do in the train step right after the conv
    # that wrote them
    site_rows = {}
    for shape in shapes:
        x = channels_last_probe(shape, torch.float32, seed=1, dev=dev)
        nbytes = x.numel() * 4 + 2 * shape[1] * 4
        bound_ms, bound_by = bound(nbytes, 4 * x.numel())
        row = site_rows[shape] = dict(
            shape=list(shape), ms=device_ms(lambda: moments(x)),
            host_us=host_us(lambda: moments(x)), bound_ms=bound_ms, bound_by=bound_by,
            library_ms=device_ms(lambda: torch.var_mean(
                x, dim=(0, 2, 3), correction=0)),
            per_step={m: v.count(shape) for m, v in sites_by_model.items()})
        log_site("moments", list(shape), row)
        if shape[1] < 128:
            # a LHN_FUSED_BN_SMALLC site: without the flag its statistics
            # are the plain two-pass
            row["plain_ms"] = device_ms(lambda: moments_reference(x))
            log(f"kernels: moments site {list(shape)} (C < 128): plain "
                f"two-pass {row['plain_ms']:.4f} ms, the kernel "
                f"{row['ms']:.4f} ms")
    sums = step_sums("moments", site_rows, sites_by_model)

    # the kernel's row: the flagship's (the first model's) largest site
    first = next(iter(sites_by_model.values()))
    main_shape = next(s for s in shapes if s in first)
    main = site_rows[main_shape]
    x = channels_last_probe(main_shape, torch.float32, seed=1, dev=dev)
    plain_ms = device_ms(lambda: moments_reference(x))
    log(f"kernels: moments {main['shape']} plain version {plain_ms:.4f} ms")
    return dict(
        name="moments", route="cuda",
        source="litehandnet_tpu_torch/csrc/moments.cu",
        replaces="litehandnet_tpu/ops/fused_bn.py:129",
        max_abs_err=worst, ms=main["ms"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], host_us=main["host_us"],
        sites=list(site_rows.values()), per_step=sums,
    )


def phase_dw(dev, sites_by_model) -> dict:
    import torch.nn.functional as F

    from litehandnet_tpu_torch.kernels.dw_conv3x3_stats import (
        dw_conv3x3_stats,
        dw_conv3x3_stats_reference,
    )

    set_tf32(False)
    sites = sorted({s for v in sites_by_model.values() for s in v},
                   key=lambda s: (-s[0][0] * s[0][2], s[0][1], s[1]))
    cases = sites + [((2, c, h, w), d) for c in (32, 64, 128, 24)
                     for h, w in ((64, 64), (17, 23)) for d in (1, 2)]
    worst = 0.0
    for i, (shape, d) in enumerate(cases):
        for dtype in (torch.float32, torch.bfloat16):
            x = channels_last_probe(shape, dtype, seed=200 + i, dev=dev,
                                    scale=1.0, shift=0.0)
            w = torch.randn(shape[1], 1, 3, 3,
                            generator=torch.Generator().manual_seed(i)) * 0.3
            w = w.to(dev)
            y, mean, var = dw_conv3x3_stats(x, w, d)
            again = dw_conv3x3_stats(x, w, d)
            ry, rmean, rvar = dw_conv3x3_stats_reference(x, w, d)
            nchw = dw_conv3x3_stats(x.contiguous(), w, d)
            torch.cuda.synchronize()
            scale = float(ry.float().abs().max())
            # y: 9-term float32 sums in two orders, rtol 1e-5; a bfloat16 y
            # may round one unit (2^-8 relative) apart. Statistics of the
            # float32 accumulators: mean rtol 1e-5, var rtol 1e-4.
            y_rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -8
            errs = [float((y.float() - ry.float()).abs().max()),
                    float((mean - rmean).abs().max()),
                    float((var - rvar).abs().max())]
            worst = max(worst, *errs)
            same = all(torch.equal(a, b) for a, b in zip((y, mean, var), again))
            same_nchw = all(torch.equal(a, b)
                            for a, b in zip((y, mean, var), nchw))
            ok = (y.dtype == x.dtype and y.shape == x.shape
                  and torch.allclose(y.float(), ry.float(), rtol=y_rtol,
                                     atol=1e-6 * scale)
                  and torch.allclose(mean, rmean, rtol=1e-5, atol=1e-6 * scale)
                  and torch.allclose(var, rvar, rtol=1e-4, atol=1e-12)
                  and same and same_nchw)
            log(f"kernels: dw_conv3x3_stats {list(shape)} d={d} "
                f"{str(dtype)[6:]} max_abs_err y {errs[0]:.3g} mean "
                f"{errs[1]:.3g} var {errs[2]:.3g}, a second call and NCHW "
                f"memory give the same bits: {same}, {same_nchw}")
            if not ok:
                raise AssertionError(f"dw_conv3x3_stats disagrees at {shape} "
                                     f"d={d} {dtype}")

    site_rows = {}
    for shape, d in sites:
        C = shape[1]
        x = channels_last_probe(shape, torch.float32, seed=3, dev=dev,
                                scale=1.0, shift=0.0)
        w = torch.randn(C, 1, 3, 3, device=dev) * 0.3
        nbytes = 2 * x.numel() * 4 + w.numel() * 4 + 2 * C * 4
        bound_ms, bound_by = bound(nbytes, 22 * x.numel())
        row = site_rows[(shape, d)] = dict(
            shape=list(shape), dilation=d,
            ms=device_ms(lambda: dw_conv3x3_stats(x, w, d)),
            host_us=host_us(lambda: dw_conv3x3_stats(x, w, d)),
            bound_ms=bound_ms, bound_by=bound_by,
            library_ms=device_ms(lambda: torch.var_mean(
                F.conv2d(x, w, padding=d, dilation=d, groups=C),
                dim=(0, 2, 3), correction=0)),
            conv_ms=device_ms(lambda: F.conv2d(x, w, padding=d, dilation=d,
                                               groups=C)),
            per_step={m: v.count((shape, d))
                      for m, v in sites_by_model.items()})
        log_site("dw_conv3x3_stats", f"{list(shape)} d={d}", row)
        log(f"kernels: dw_conv3x3_stats site {list(shape)} d={d}: cuDNN conv "
            f"alone {row['conv_ms']:.4f} ms")
    sums = step_sums("dw_conv3x3_stats", site_rows, sites_by_model)

    main_key = ((BATCH_TRAIN, 64, 64, 64), 2)
    main = site_rows[main_key]
    x = channels_last_probe(main_key[0], torch.float32, seed=3, dev=dev,
                            scale=1.0, shift=0.0)
    w = torch.randn(64, 1, 3, 3, device=dev) * 0.3
    plain_ms = device_ms(lambda: dw_conv3x3_stats_reference(x, w, 2))
    log(f"kernels: dw_conv3x3_stats {main['shape']} d=2 plain version "
        f"{plain_ms:.4f} ms")
    return dict(
        name="dw_conv3x3_stats", route="cuda",
        source="litehandnet_tpu_torch/csrc/dw_conv3x3_stats.cu",
        replaces="litehandnet_tpu/ops/fused_bn.py:296",
        max_abs_err=worst, ms=main["ms"], plain_ms=plain_ms,
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], host_us=main["host_us"],
        sites=list(site_rows.values()), per_step=sums,
    )


# the served LiteHandNet deploy graph's "same" depthwise convs at 256²:
# (C, H, W, k, dilation, act) and how many a forward runs
DW_BIAS_ACT_SITES = {
    (32, 128, 128, 7, 1, "leaky_relu"): 1,
    (64, 64, 64, 3, 1, "relu"): 4, (64, 64, 64, 3, 2, "relu"): 2,
    (32, 64, 64, 3, 1, "relu"): 2,
    (64, 32, 32, 3, 1, "relu"): 4, (64, 32, 32, 3, 2, "relu"): 2,
    (32, 32, 32, 3, 1, "relu"): 2,
}


def phase_dw_bias_act(dev) -> dict:
    """``dw_conv_bias_act`` at each site of the served deploy graph (B=128):
    bfloat16 and float32 against the plain version, a second call giving
    the same bits; then, in bfloat16 as served, its device and host time
    beside its bound, the plain version and the path it replaces (cuDNN's
    grouped conv under autocast, its bias pass and the activation), and the
    sums over a forward's 17 launches."""
    import torch.nn.functional as F

    from litehandnet_tpu_torch.kernels.dw_conv_bias_act import (
        dw_conv_bias_act,
        dw_conv_bias_act_reference,
    )

    set_tf32(False)
    acts = {"relu": F.relu, "leaky_relu": F.leaky_relu}
    worst = 0.0
    site_rows = []
    for i, (site, count) in enumerate(DW_BIAS_ACT_SITES.items()):
        C, H, W, k, d, act = site
        shape = (BATCH, C, H, W)
        w = (torch.randn(C, 1, k, k, generator=torch.Generator().manual_seed(i))
             * 0.3).to(dev)
        b = torch.randn(C, generator=torch.Generator().manual_seed(i + 50)
                        ).to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            x = channels_last_probe(shape, dtype, seed=300 + i, dev=dev,
                                    scale=1.0, shift=0.0)
            y = dw_conv_bias_act(x, w, b, d, act)
            again = dw_conv_bias_act(x, w, b, d, act)
            ref = dw_conv_bias_act_reference(x, w, b, d, act)
            torch.cuda.synchronize()
            err = float((y.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max())
            worst = max(worst, err / scale)
            rtol = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            ok = (torch.equal(y, again) and y.dtype == dtype
                  and torch.allclose(y.float(), ref.float(), rtol=rtol,
                                     atol=1e-5 * scale))
            log(f"kernels: dw_conv_bias_act {list(shape)} k={k} d={d} {act} "
                f"{str(dtype)[6:]} max_abs_err {err:.3g} of {scale:.3g}, a "
                f"second call gives the same bits: {torch.equal(y, again)}")
            if not ok:
                raise AssertionError(f"dw_conv_bias_act disagrees at {shape} "
                                     f"k={k} d={d} {dtype}")
        x = channels_last_probe(shape, torch.bfloat16, seed=300 + i, dev=dev,
                                scale=1.0, shift=0.0)
        wb, bb = w.to(torch.bfloat16), b.to(torch.bfloat16)
        pad = d * (k // 2)
        n = x.numel()
        bound_ms, bound_by = bound(2 * n * 2 + C * (k * k + 1) * 4,
                                   (2 * k * k + 2) * n)
        row = dict(
            shape=list(shape), k=k, dilation=d, act=act, per_forward=count,
            ms=device_ms(lambda: dw_conv_bias_act(x, w, b, d, act)),
            host_us=host_us(lambda: dw_conv_bias_act(x, w, b, d, act)),
            bound_ms=bound_ms, bound_by=bound_by,
            plain_ms=device_ms(lambda: dw_conv_bias_act_reference(
                x, w, b, d, act)),
            library_ms=device_ms(lambda: acts[act](F.conv2d(
                x, wb, bb, padding=pad, dilation=d, groups=C))),
            library_host_us=host_us(lambda: acts[act](F.conv2d(
                x, wb, bb, padding=pad, dilation=d, groups=C))),
            conv_ms=device_ms(lambda: F.conv2d(x, wb, padding=pad,
                                               dilation=d, groups=C)))
        site_rows.append(row)
        log(f"kernels: dw_conv_bias_act site {list(shape)} k={k} d={d} {act} "
            f"bf16 x{count}: device {row['ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({bound_by}; "
            f"{row['bound_ms'] / row['ms']:.0%} of it), plain "
            f"{row['plain_ms']:.4f} ms, cuDNN conv + bias + act "
            f"{row['library_ms']:.4f} ms (conv alone {row['conv_ms']:.4f}), "
            f"host {row['host_us']:.1f} us against {row['library_host_us']:.1f}")
    sums = {key: sum(r[key] * r["per_forward"] for r in site_rows)
            for key in ("ms", "bound_ms", "plain_ms", "library_ms", "conv_ms",
                        "host_us", "library_host_us")}
    log(f"kernels: dw_conv_bias_act per forward (17 launches, B={BATCH}): "
        f"device {sums['ms']:.4f} ms, bound {sums['bound_ms']:.4f} ms "
        f"({sums['bound_ms'] / sums['ms']:.0%} of it), cuDNN conv + bias + "
        f"act {sums['library_ms']:.4f} ms, host {sums['host_us']:.1f} us "
        f"against {sums['library_host_us']:.1f}")
    main = site_rows[1]
    return dict(
        name="dw_conv_bias_act", route="cuda",
        source="litehandnet_tpu_torch/csrc/dw_conv_bias_act.cu",
        replaces="none (the deploy graph's depthwise convs, XLA's in JAX)",
        max_rel_err=worst, ms=main["ms"], plain_ms=main["plain_ms"],
        bound_ms=main["bound_ms"], bound_by=main["bound_by"],
        library_ms=main["library_ms"], host_us=main["host_us"],
        sites=site_rows, per_forward=sums,
    )


FUSE_BATCH = 512     # litehrnet30.serve_b512's batch


def fuse_rows_of_a_forward(dev, B: int = FUSE_BATCH) -> list:
    """The 42 fuse rows of a Lite-HRNet-30 forward at batch ``B`` under
    bfloat16 autocast, as ``litehrnet.fuse_row`` receives them (the real
    terms of random crops with seeded weights): ``(terms, write_sum)``."""
    from litehandnet_tpu_torch.models import litehrnet
    from litehandnet_tpu_torch.utils.weights import randomize_

    model = litehrnet.LiteHRNet(21, 30)
    randomize_(model, torch.Generator().manual_seed(0))
    model = model.eval().to(device=dev, memory_format=torch.channels_last)
    x = torch.randn(B, 3, 256, 256, generator=torch.Generator().manual_seed(1)
                    ).to(dev).contiguous(memory_format=torch.channels_last)
    rows, fuse_row = [], litehrnet.fuse_row

    def recorded(terms, write_sum):
        rows.append((terms, write_sum))
        return fuse_row(terms, write_sum)

    litehrnet.fuse_row = recorded
    try:
        with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
            model(x)
    finally:
        litehrnet.fuse_row = fuse_row
    torch.cuda.synchronize()
    return rows


def phase_fuse_sum_relu(dev) -> dict:
    """``fuse_sum_relu`` at the 42 rows of a Lite-HRNet-30 forward at batch
    512 (``litehrnet30.serve_b512``), on the forward's own terms under
    bfloat16 autocast: each row and row 0's pre-ReLU sum bit for bit the
    eager ops', in dtype and layout; then each distinct row's device and
    host time beside its bound (bytes at 3.35 TB/s), the eager rows it
    replaces and the plain version, and the sums over a forward."""
    import litehandnet_tpu_torch.kernels  # noqa: F401
    from litehandnet_tpu_torch.models.layers import resize_dtype
    from litehandnet_tpu_torch.models.litehrnet import eager_fuse_row

    fsr = sys.modules["litehandnet_tpu_torch.kernels.fuse_sum_relu"]
    zero_counts()
    rows = fuse_rows_of_a_forward(dev)
    forward_launches = fsr.fuse_sum_relu.launches
    if len(rows) != 42 or forward_launches != 42:
        raise AssertionError(f"a Lite-HRNet-30 forward summed {len(rows)} "
                             f"rows in {forward_launches} launches, not 42")
    keys = collections.Counter()
    first = {}
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        for terms, write_sum in rows:
            size = terms[0].shape[2:]
            dtypes = [t.dtype if t.shape[2:] == size else resize_dtype(t)
                      for t in terms]
            got = fsr.fuse_sum_relu(terms, dtypes, write_sum)
            want = eager_fuse_row(terms)
            for a, b in zip(got, want[:1 + write_sum]):
                if not (a.dtype == b.dtype and a.stride() == b.stride()
                        and torch.equal(a, b)):
                    raise AssertionError(
                        f"fuse_sum_relu differs from the eager row at "
                        f"{[(tuple(t.shape), t.dtype) for t in terms]}")
            key = ((*terms[0].shape, got[0].element_size()),
                   tuple((t.shape[1], t.shape[2], t.shape[3], t.element_size())
                         for t in terms), write_sum)
            keys[key] += 1
            first.setdefault(key, (terms, dtypes, write_sum))
    cost_rows = []
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        for key, count in keys.items():
            terms, dtypes, write_sum = first[key]
            (N, C, H, W, out_size), sizes, _ = key
            nbytes = (sum(N * c * h * w * e for c, h, w, e in sizes)
                      + N * C * H * W * out_size * (1 + write_sum))
            bound_ms, bound_by = bound(nbytes, (len(terms) + 1) * N * C * H * W)

            def kernel():
                fsr.fuse_sum_relu(terms, dtypes, write_sum)

            row = dict(key=repr(key), per_forward=count, bytes=nbytes,
                       ms=device_ms(kernel), host_us=host_us(kernel),
                       bound_ms=bound_ms, bound_by=bound_by,
                       eager_ms=device_ms(lambda: eager_fuse_row(terms)),
                       eager_host_us=host_us(lambda: eager_fuse_row(terms)),
                       plain_ms=device_ms(lambda: fsr.fuse_sum_relu_reference(
                           terms, dtypes, write_sum)))
            cost_rows.append(row)
            log(f"kernels: fuse_sum_relu row {list(key[0][:4])} "
                f"{len(terms)} terms {[s[3] for s in sizes]} -> {out_size} "
                f"B{' + sum' if write_sum else ''} x{count}: device "
                f"{row['ms']:.4f} ms, bound {bound_ms:.4f} ms "
                f"({bound_ms / row['ms']:.0%} of it), eager rows "
                f"{row['eager_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
                f"host {row['host_us']:.1f} us against "
                f"{row['eager_host_us']:.1f}")
    sums = {k: sum(r[k] * r["per_forward"] for r in cost_rows)
            for k in ("ms", "bound_ms", "eager_ms", "plain_ms", "host_us",
                      "eager_host_us", "bytes")}
    log(f"kernels: fuse_sum_relu per forward (42 launches, B={FUSE_BATCH}, "
        f"{sums['bytes'] / 1e9:.3f} GB): device {sums['ms']:.4f} ms, bound "
        f"{sums['bound_ms']:.4f} ms ({sums['bound_ms'] / sums['ms']:.0%} of "
        f"it), eager rows {sums['eager_ms']:.4f} ms, plain "
        f"{sums['plain_ms']:.4f} ms, host {sums['host_us']:.1f} us against "
        f"{sums['eager_host_us']:.1f}")
    return dict(
        name="fuse_sum_relu", route="cuda",
        source="litehandnet_tpu_torch/csrc/fuse_sum_relu.cu",
        replaces="none (Lite-HRNet's fuse, XLA's in JAX)",
        max_rel_err=0.0, ms=sums["ms"], plain_ms=sums["plain_ms"],
        bound_ms=sums["bound_ms"], bound_by="bytes",
        library_ms=sums["eager_ms"], host_us=sums["host_us"],
        sites=cost_rows, per_forward=sums,
        paths={f"Lite-HRNet-30 forward, B={FUSE_BATCH}": forward_launches},
    )


def softpool_probe(shape, seed, dev, dtype=torch.float32, overflow=False,
                   unaligned=False):
    """A channels_last ``[B, C, H, W]`` probe of scale 3 on ``dev``; with
    ``overflow`` one window holds a value whose exp overflows float32 (NaN
    in JAX), one window underflows to 0 / 0, one value is large but finite;
    ``unaligned`` starts it one element past a 16-byte boundary."""
    x = torch.randn(shape, generator=torch.Generator().manual_seed(seed)) * 3.0
    if overflow:
        x[0, 0, 0, 1] = 89.5
        x[0, 1, 2:4, 2:4] = -120.0
        x[0, 2, 4, 4] = 88.0
    x = x.to(dev, dtype).contiguous(memory_format=torch.channels_last)
    if unaligned:
        B, C, H, W = shape
        buf = torch.empty(x.numel() + 1, device=dev, dtype=dtype)[1:]
        moved = buf.view(B, H, W, C).permute(0, 3, 1, 2)
        moved.copy_(x)
        x = moved
    return x


def phase_softpool(dev, earlier) -> dict:
    """``softpool_2x2`` on both paths: each case against the plain twin
    (NaN and inf in the same places), a second call and NCHW memory
    (general path) giving the same bits; then the attention path's shape
    timed in turns against the earlier kernel, the plain twin and two
    ``avg_pool2d``."""
    import torch.nn.functional as F

    from litehandnet_tpu_torch.kernels.softpool_2x2 import (
        softpool_2x2,
        softpool_2x2_reference,
    )

    set_tf32(False)
    # (shape, kernel, stride, unaligned, fast for float32 / bfloat16): the
    # serve batch x the stem's width x 64^2; odd H and W with k=3, s=2;
    # C=21; B=1; odd sizes that floor, C=21 and C=32; overlapping windows;
    # C=20 (whole 16-byte vectors in float32 only); an unaligned start; the
    # overflow windows
    cases = [((BATCH, 128, 64, 64), 2, 2, False, (True, True)),
             ((2, 128, 65, 63), 3, 2, False, (False, False)),
             ((4, 21, 64, 64), 2, 2, False, (False, False)),
             ((1, 128, 64, 64), 2, 2, False, (True, True)),
             ((3, 21, 17, 23), 2, 2, False, (False, False)),
             ((2, 32, 17, 23), 2, 2, False, (True, True)),
             ((2, 24, 16, 16), 2, 1, False, (False, False)),
             ((2, 20, 16, 16), 2, 2, False, (True, False)),
             ((2, 128, 16, 16), 2, 2, True, (False, False)),
             ((2, 8, 8, 8), 2, 2, False, (True, True))]
    worst = 0.0
    for i, (shape, k, s, unaligned, fast) in enumerate(cases):
        overflow = i == len(cases) - 1
        for dtype, want_fast in zip((torch.float32, torch.bfloat16), fast):
            x = softpool_probe(shape, 300 + i, dev, dtype, overflow, unaligned)
            got, took = took_path(softpool_2x2, lambda: softpool_2x2(x, k, s))
            again = softpool_2x2(x, k, s)
            # the plain twin runs in float32 and rounds once to x's dtype
            want = softpool_2x2_reference(x, k, s)
            nchw, nchw_path = took_path(
                softpool_2x2, lambda: softpool_2x2(x.contiguous(), k, s))
            torch.cuda.synchronize()
            # the overflow windows give NaN (inf / inf) and inf (inf / finite)
            nan, inf = torch.isnan(want), torch.isinf(want)
            finite = ~(nan | inf)
            diff = (got.float() - want.float()).abs()[finite]
            err = float(diff.max()) if diff.numel() else 0.0
            worst = max(worst, err)
            # float32 sums of terms e^x x of both signs cancel where the
            # result is near 0: the card's exp and FMA contraction move it by
            # a few ulps of the terms, |x| at most, so the absolute part of
            # the tolerance scales with max |x|; a bfloat16 result may round
            # one bf16 ulp (2^-7 relative at most) apart on top of that
            atol = 1e-6 * float(x.float().abs().max())
            rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
            tol = rel * want.float().abs()[finite] + atol
            ok = (got.dtype == dtype and got.shape == want.shape
                  and got.is_contiguous(memory_format=torch.channels_last)
                  and nchw.is_contiguous()
                  and torch.equal(torch.isnan(got), nan)
                  and torch.equal(got[inf], want[inf])
                  and bool((diff <= tol).all())
                  and torch.allclose(nchw.float(), got.float(), rtol=0,
                                     atol=0, equal_nan=True)
                  and torch.allclose(again.float(), got.float(), rtol=0,
                                     atol=0, equal_nan=True))
            if overflow and not (nan[0, 0, 0, 0] and nan[0, 1, 1, 1]):
                raise AssertionError("softpool overflow probe gave no NaN")
            log(f"kernels: softpool_2x2 {list(shape)} k={k} s={s} "
                f"{str(dtype)[6:]}{' unaligned' if unaligned else ''} path "
                f"{took} max_abs_err {err:.3g} (finite values), NaN "
                f"{int(nan.sum())} and inf {int(inf.sum())} where the plain "
                f"twin has them, a second call and NCHW memory ({nchw_path}) "
                f"give the same bits: {ok}")
            if took != ("fast" if want_fast else "general") or \
                    nchw_path != "general":
                raise AssertionError(f"softpool_2x2 {shape} {dtype} took "
                                     f"{took} / {nchw_path}")
            if not ok:
                raise AssertionError(f"softpool_2x2 disagrees at {shape} k={k} "
                                     f"s={s} {dtype}")

    lib = earlier.get("softpool_2x2")
    x = softpool_probe((BATCH, 128, 64, 64), 1, dev)
    xb = x.to(torch.bfloat16)
    nchw = x.contiguous()
    timed_rows = {}
    for label, inp in (("float32", x), ("bfloat16", xb),
                       ("float32 NCHW", nchw)):
        if lib:
            old = earlier_softpool(lib, inp)
            if not torch.allclose(old.float(), softpool_2x2(inp).float(),
                                  rtol=2.0 ** -7, atol=1e-5, equal_nan=True):
                raise AssertionError(f"earlier softpool disagrees ({label})")
        old_fn = (lambda: earlier_softpool(lib, inp)) if lib else None
        new_ms, old_ms = in_turns(lambda: softpool_2x2(inp), old_fn)
        new_us, old_us = in_turns(lambda: softpool_2x2(inp), old_fn,
                                  timer=host_us)
        timed_rows[label] = dict(ms=new_ms, earlier_ms=old_ms, host_us=new_us,
                                 earlier_host_us=old_us)
    plain_ms = device_ms(lambda: softpool_2x2_reference(x))

    def two_avg_pools():
        e = torch.exp(x)
        return F.avg_pool2d(e * x, 2, 2) / F.avg_pool2d(e, 2, 2)

    library_ms = device_ms(two_avg_pools)
    nbytes = x.numel() * 4 + x.numel() // 4 * 4        # read once, write once
    bound_ms, bound_by = bound(nbytes, 4 * x.numel())   # exp, mul, 2 adds
    nbytes_bf16 = xb.numel() * 2 + xb.numel() // 4 * 2
    timed_rows["bfloat16"]["bound_ms"] = bound(nbytes_bf16, 4 * xb.numel())[0]
    usage = kernel_ptxas("softpool_2x2")
    for label, row in timed_rows.items():
        earlier_txt = ("not measured" if row["earlier_ms"] is None else
                       f"{row['earlier_ms']:.4f} ms, host "
                       f"{row['earlier_host_us']:.1f} us")
        path = "general" if "NCHW" in label else "fast"
        log(f"kernels: softpool_2x2 {path} path {list(x.shape)} k=2 s=2 "
            f"{label}: device {row['ms']:.4f} ms per call, host "
            f"{row['host_us']:.1f} us; earlier kernel of {EARLIER_COMMIT} "
            f"{earlier_txt}")
    log(f"kernels: softpool_2x2 {list(x.shape)} float32: plain {plain_ms:.4f} "
        f"ms, two avg_pool2d {library_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB moved, "
        f"{bound_ms / timed_rows['float32']['ms']:.0%} of it); bfloat16 bound "
        f"{timed_rows['bfloat16']['bound_ms'] * 1e3:.1f} us "
        f"({nbytes_bf16 / 1e6:.1f} MB moved, "
        f"{timed_rows['bfloat16']['bound_ms'] / timed_rows['bfloat16']['ms']:.0%}"
        f" of it); ptxas fast {path_ptxas(usage, 'fast')}, general "
        f"{path_ptxas(usage, 'general')}")
    main = timed_rows["float32"]
    return dict(
        name="softpool_2x2", route="cuda",
        source="litehandnet_tpu_torch/csrc/softpool_2x2.cu",
        replaces="litehandnet_tpu/ops/pallas_kernels.py:62",
        max_abs_err=worst, ms=main["ms"], plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=library_ms, host_us=main["host_us"],
        earlier_ms=main["earlier_ms"], earlier_host_us=main["earlier_host_us"],
        timed=timed_rows,
    )


def zero_counts() -> None:
    """Zeroes every declared program counter (``profiling.counters``)."""
    from litehandnet_tpu_torch.utils import profiling

    if torch.cuda.is_available():
        torch.cuda.synchronize()
    profiling.zero_counters()


# kernels a model's modules route to wherever they run on the card (the
# deploy graph's depthwise convs, Lite-HRNet's fuse): counted on every path,
# held to a count only where ``expected`` names them
ROUTED_KERNELS = ("dw_conv_bias_act", "fuse_sum_relu")


def read_counts(rows: dict, path: str, expected: dict,
                kernel_paths: dict = None) -> dict:
    """The launch counts since ``zero_counts``, recorded under ``path`` in
    ``rows``; fails unless each kernel launched as ``expected`` says (a
    kernel missing there must not launch, but for ``ROUTED_KERNELS``) and
    every launch of a kernel named in ``kernel_paths`` took the kernel path
    it names."""
    from litehandnet_tpu_torch.kernels import KERNELS

    torch.cuda.synchronize()
    counts = {name: k.launches for name, k in KERNELS.items()}
    by_path = {name: dict(k.path_launches) for name, k in KERNELS.items()
               if hasattr(k, "path_launches")}
    log(f"{path}: kernel launches {counts}, by kernel path {by_path}")
    for name, count in counts.items():
        if name in ROUTED_KERNELS and name not in expected:
            pass
        elif count != expected.get(name, 0):
            raise AssertionError(f"{path}: {name} launched {count} times, "
                                 f"expected {expected.get(name, 0)}")
        if count:
            rows[name].setdefault("paths", {})[path] = count
            if name in by_path:
                rows[name].setdefault("kernel_paths", {})[path] = by_path[name]
    for name, kpath in (kernel_paths or {}).items():
        if by_path[name][kpath] != counts[name]:
            raise AssertionError(f"{path}: {name} took {by_path[name]}, "
                                 f"expected every launch on {kpath}")
    return counts


def phase_attention(dev, rows: dict) -> None:
    """The attention library's entry: ``SoftPooling`` forward and backward
    on the card equal the CPU's; one launch per forward, none in the
    backward (autograd of the plain twin)."""
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models.attention import SoftPooling

    pool = SoftPooling()
    x = softpool_probe((8, 128, 64, 64), 400, dev)
    w = torch.randn(8, 128, 32, 32, generator=torch.Generator().manual_seed(401))
    xc = x.detach().cpu().contiguous().requires_grad_(True)
    ((pool(xc) * w).sum()).backward()
    xg = x.detach().clone().requires_grad_(True)
    zero_counts()
    y = pool(xg)
    torch.cuda.synchronize()
    forward = KERNELS["softpool_2x2"].launches
    (y * w.to(dev)).sum().backward()
    read_counts(rows, "attention:SoftPooling", {"softpool_2x2": 1},
                {"softpool_2x2": "fast"})
    if forward != 1:
        raise AssertionError(f"SoftPooling forward launched {forward} times")
    want = pool(xc.detach())
    err = float((y.detach().cpu() - want).abs().max())
    gerr = float((xg.grad.cpu() - xc.grad).abs().max())
    gscale = float(xc.grad.abs().max())
    log(f"attention: SoftPooling card vs CPU max_abs_err forward {err:.3g} "
        f"(tolerance 1e-5 x max), backward {gerr:.3g} (gradient max "
        f"{gscale:.3g}, tolerance 1e-5 x max)")
    if not (err <= 1e-5 * float(want.abs().max()) and gerr <= 1e-5 * gscale):
        raise AssertionError("SoftPooling on the card disagrees with the CPU")


def train_batch(B, size, seed, device):
    """A batch in the trainer's layout, made from a seed on ``device``:
    images of unit-normal noise, each sample scaled and shifted on its own
    (so the channel attention's pooled map differs across the batch and its
    BatchNorm is well conditioned), unbiased Gaussian targets (sigma 2) for
    joints in [24, size - 24] px, about 10% of joints invisible."""
    from litehandnet_tpu_torch.ops.encode import msra_heatmaps

    gen = torch.Generator(device).manual_seed(seed)
    img = torch.randn(B, size, size, 3, generator=gen, device=device)
    img = (img * (0.5 + 1.5 * torch.rand(B, 1, 1, 1, generator=gen,
                                         device=device))
           + 2.0 * torch.rand(B, 1, 1, 3, generator=gen, device=device) - 1.0)
    joints = 24 + torch.rand(B, 21, 2, generator=gen, device=device) * (size - 48)
    vis = (torch.rand(B, 21, generator=gen, device=device) > 0.1).float()
    target, weight = msra_heatmaps(joints, vis, (size, size),
                                   (size // 4, size // 4), 2.0, unbiased=True)
    return {"img": img, "target": target, "target_weight": weight}


def set_dropout(model, p):
    from litehandnet_tpu_torch.models.layers import Dropout

    for mod in model.modules():
        if isinstance(mod, Dropout):
            mod.p = p


def state_on(device, model, cfg, tx):
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.train.state import TrainState

    model = model.to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    return TrainState.create(model, get_loss(cfg).to(device), tx)


def step_card_vs_cpu(dev, cfg, base, tx, lr0, n_bn128) -> None:
    """One step of ``base`` (``cfg.MODEL.name``) from the same weights and
    batch (B=2) on the card and on the CPU, TF32 off, dropout at identity:
    in float64 (LHN_FUSED_BN=0, the moments kernel takes float32 and
    bfloat16 only), which shows the port's step computes the same function
    on the card; in float32, with and without the moments kernel, against
    the float64 gradients. ``moments`` launches once per 128-channel
    BatchNorm (``n_bn128``) in a float32 card step."""
    import copy

    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.train.distributed import make_train_step

    family = cfg.MODEL.name
    size = cfg.DATASET.image_size[0]
    set_tf32(False)
    os.environ["LHN_FUSED_DW"] = "0"
    batch = train_batch(2, size, seed=11, device="cpu")
    runs = {"card64": (dev, torch.float64, "0"),
            "cpu64": (torch.device("cpu"), torch.float64, "0"),
            "card32": (dev, torch.float32, "1"),
            "card32_plain_bn": (dev, torch.float32, "0"),
            "cpu32": (torch.device("cpu"), torch.float32, "1")}
    models, loss = {}, {}
    for name, (device, dtype, fused_bn) in runs.items():
        model = copy.deepcopy(base).to(dtype)
        set_dropout(model, 0.0)
        os.environ["LHN_FUSED_BN"] = fused_bn
        for wrapper in KERNELS.values():
            wrapper.launches = 0
        metrics = make_train_step(device)(
            state_on(device, model, cfg, tx),
            {k: v.to(dtype) if v.is_floating_point() else v
             for k, v in batch.items()})
        loss[name] = float(metrics["loss"])
        models[name] = model
        if device.type == "cuda" and KERNELS["moments"].launches != (
                n_bn128 if fused_bn == "1" else 0):
            raise AssertionError(f"{name}: moments launched "
                                 f"{KERNELS['moments'].launches} times")
    os.environ.pop("LHN_FUSED_BN")

    def grads(name):
        return [p.grad.detach().cpu().double() for p in models[name].parameters()]

    g64 = grads("cpu64")
    # a leaf's scale, floored so that leaves whose gradient is zero in exact
    # arithmetic (float noise only) are judged against the whole gradient
    floor = 1e-8 * max(float(g.abs().max()) for g in g64)
    scales = [max(float(g.abs().max()), floor) for g in g64]

    def worst_leaf(a, b):
        return max(float((x - y).abs().max()) / s
                   for x, y, s in zip(grads(a), grads(b), scales))

    def global_rel(a):
        num = sum(float((x - y).square().sum()) for x, y in zip(grads(a), g64))
        return (num / sum(float(y.square().sum()) for y in g64)) ** 0.5

    def worst_buffer(a, b):
        return max(float((x.cpu().double() - y.cpu().double()).abs().max())
                   / max(float(y.abs().max()), 1e-30)
                   for x, y in zip(models[a].buffers(), models[b].buffers())
                   if x.is_floating_point())

    def worst_param(a, b):
        return max(float((x.detach().cpu().double() - y.detach().cpu().double())
                         .abs().max())
                   for x, y in zip(models[a].parameters(), models[b].parameters()))

    checks = [
        # (what, value, tolerance)
        ("float64 loss, card vs CPU, relative",
         abs(loss["card64"] - loss["cpu64"]) / abs(loss["cpu64"]), 1e-9),
        ("float64 gradients, card vs CPU, worst leaf over its max",
         worst_leaf("card64", "cpu64"), 1e-6),
        ("float64 BN statistics, card vs CPU, worst leaf over its max",
         worst_buffer("card64", "cpu64"), 1e-9),
        ("float32 loss, card vs CPU, relative",
         abs(loss["card32"] - loss["cpu32"]) / abs(loss["cpu32"]), 1e-5),
        ("float32 BN statistics, card vs CPU, worst leaf over its max",
         worst_buffer("card32", "cpu32"), 1e-4),
        ("float32 parameters after the Adam step, card vs CPU, worst",
         worst_param("card32", "cpu32"), PARAM_TOL * lr0),
        ("float32 card gradients vs float64, |g - g64| / |g64| over all leaves",
         global_rel("card32"), max(F32_GRAD_TOL, 2 * global_rel("cpu32"))),
    ]
    log(f"train {family}: one step B=2 from the same weights (TF32 off, dropout "
        f"identity): loss float64 {loss['cpu64']:.9g}, float32 "
        f"{loss['cpu32']:.7g}")
    for what, value, tol in checks:
        log(f"train {family}:   {what}: {value:.3g} (tolerance {tol:.3g})")
    log(f"train {family}:   for scale, float32 gradients vs float64 over all leaves: "
        f"CPU {global_rel('cpu32'):.3g}, card with BN statistics in plain "
        f"PyTorch {global_rel('card32_plain_bn'):.3g}; worst leaf, card vs "
        f"CPU float32 {worst_leaf('card32', 'cpu32'):.3g} of its max")
    failed = [what for what, value, tol in checks if not value <= tol]
    if failed:
        raise AssertionError(f"{family}: card step disagrees with the CPU step: "
                             f"{failed}")


SMALLC_STEPS = 6     # timed steps per LHN_FUSED_BN_SMALLC setting, in turns


def smallc_step_ms(label, step, state, batches, n_bn128, n_small) -> dict:
    """ms/step of ``step`` with ``LHN_FUSED_BN_SMALLC`` off and on, in
    turns after a warm-up step of each, each step synchronized; checks that
    ``moments`` launches ``n_bn128`` times a step without the flag and
    ``n_bn128 + n_small`` with it. The flag is opt-in, as in JAX."""
    from litehandnet_tpu_torch.kernels import KERNELS

    times = {"0": [], "1": []}
    try:
        for i in range(2 * (SMALLC_STEPS + 1)):
            flag = "01"[i % 2]
            os.environ["LHN_FUSED_BN_SMALLC"] = flag
            for wrapper in KERNELS.values():
                wrapper.launches = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step(state, batches[i % len(batches)])
            torch.cuda.synchronize()
            times[flag].append((time.perf_counter() - t0) * 1e3)
            want = n_bn128 + (n_small if flag == "1" else 0)
            if KERNELS["moments"].launches != want:
                raise AssertionError(
                    f"{label}: moments launched {KERNELS['moments'].launches}"
                    f" times with LHN_FUSED_BN_SMALLC={flag}, expected {want}")
    finally:
        os.environ.pop("LHN_FUSED_BN_SMALLC", None)
    med = {flag: statistics.median(v[1:]) for flag, v in times.items()}
    log(f"{label}: LHN_FUSED_BN_SMALLC off {med['0']:.3f} ms/step, on "
        f"{med['1']:.3f} ms/step (medians of {SMALLC_STEPS} in turns; off "
        f"{[round(v, 3) for v in times['0'][1:]]}, on "
        f"{[round(v, 3) for v in times['1'][1:]]}); moments {n_bn128} and "
        f"{n_bn128 + n_small} launches a step ({card_line()})")
    return med


def phase_train(dev, kernel_rows: dict, n_small: int = 0) -> None:
    import copy
    import shutil

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.trainer import Trainer
    from litehandnet_tpu_torch.utils.weights import randomize_

    cfg = get_config()
    size = cfg.DATASET.image_size[0]
    steps = TRAIN_STEPS
    tx, schedule = make_optimizer_from_config(cfg, steps_per_epoch=steps)
    lr0 = schedule(0)
    base = randomize_(get_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    n_bn128 = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                  for m in base.modules())

    # (a) one step from the same weights and batch on the card and on the CPU
    step_card_vs_cpu(dev, cfg, base, tx, lr0, n_bn128)
    batch = train_batch(2, size, seed=11, device="cpu")

    # (b) the same card step with the fused depthwise path off and on
    losses = {}
    for fused in ("0", "1"):
        os.environ["LHN_FUSED_DW"] = fused
        model = copy.deepcopy(base)
        set_dropout(model, 0.0)
        for wrapper in KERNELS.values():
            wrapper.launches = 0
        losses[fused] = float(make_train_step(dev)(
            state_on(dev, model, cfg, tx), batch)["loss"])
        log(f"train: LHN_FUSED_DW={fused} step launches "
            f"{ {k: w.launches for k, w in KERNELS.items()} }")
    rel = abs(losses["1"] - losses["0"]) / abs(losses["0"])
    log(f"train: LHN_FUSED_DW on vs off, loss {losses['1']:.7g} vs "
        f"{losses['0']:.7g}, relative {rel:.3g} (tolerance 1e-5)")
    if rel > 1e-5:
        raise AssertionError(f"fused depthwise path changes the loss by {rel}")

    # (c) + (d) the main path: Trainer.fit, one epoch of TRAIN_STEPS batches
    # of B=32 and one validation batch, LHN_FUSED_DW=1, counters zeroed just
    # before and read just after
    run = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       "chip_smoke_run")
    shutil.rmtree(run, ignore_errors=True)
    cfg.TRAIN.total_epoches = 1
    cfg.CHECKPOINT.save_root = run + "/"
    cfg.CHECKPOINT.resume = False
    trainer = Trainer(cfg, steps_per_epoch=steps, device=dev)
    state = trainer.init_state(seed=SEED)
    randomize_(state.model, torch.Generator().manual_seed(SEED))
    batches = [train_batch(BATCH_TRAIN, size, seed=20 + i, device=dev)
               for i in range(steps)]
    val = [train_batch(BATCH_TRAIN, size, seed=99, device=dev)]
    step_losses = []
    step_fn = trainer.train_step

    def recorded(state, batch, generator=None):
        metrics = step_fn(state, batch, generator)
        step_losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recorded
    os.environ["LHN_FUSED_DW"] = "1"
    n_dw = len(site_shapes(state.model, batches[0]["img"][:1].permute(0, 3, 1, 2))[1])
    if n_bn128 == 0 or n_dw == 0:
        raise AssertionError("the flagship has no moments or dw sites")
    zero_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state, lambda epoch: batches, lambda: val, seed=SEED)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    read_counts(kernel_rows, "train:litehandnet",
                {"moments": n_bn128 * steps, "dw_conv3x3_stats": n_dw * steps})
    log(f"train: Trainer.fit {steps} steps of B={BATCH_TRAIN} + 1 validation "
        f"batch in {fit_s:.2f} s (first steps included); expected moments "
        f"{n_bn128} x {steps}, dw_conv3x3_stats {n_dw} x {steps}")
    losses = [float(v) for v in step_losses]
    log(f"train: step losses {[round(v, 6) for v in losses]}, best val loss "
        f"{trainer.min_val_loss:.6g}")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)
            and math.isfinite(trainer.min_val_loss)):
        raise AssertionError("non-finite or missing train losses")
    for slot in ("checkpoint", "best"):
        for ext in (".pt", ".meta.json"):
            if not os.path.exists(os.path.join(trainer.ckpt.directory, slot + ext)):
                raise AssertionError(f"Trainer.fit wrote no {slot}{ext}")
    trainer.close()
    # a full resume restores the fitted state
    cfg.CHECKPOINT.resume = True
    cfg.OPTIMIZER.resume = True
    resumer = Trainer(cfg, steps_per_epoch=steps, device=dev)
    restored = resumer.maybe_resume(resumer.init_state(seed=SEED + 1))
    same = all(torch.equal(a, b) for a, b in zip(
        restored.model.state_dict().values(), state.model.state_dict().values()))
    log(f"train: restore round trip: step {restored.step}, start epoch "
        f"{resumer.start_epoch}, state equal {same}")
    if not (same and restored.step == steps and resumer.start_epoch == 1):
        raise AssertionError("checkpoint restore does not round-trip")
    resumer.close()
    del restored, resumer

    # (e) ms/step and img/s at B=32, 256x256, float32; the counts of the
    # timed steps, kernel by kernel
    medians = {}
    for tf32 in (False, True):
        set_tf32(tf32)
        for fused in ("0", "1"):
            os.environ["LHN_FUSED_DW"] = fused
            step_ms = []
            for i in range(TIMED_STEPS + 3):
                for wrapper in KERNELS.values():
                    wrapper.launches = 0
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step(state, batches[i % steps])
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t0) * 1e3)
            counts = {k: w.launches for k, w in KERNELS.items()}
            if counts["dw_conv3x3_stats"] != (n_dw if fused == "1" else 0):
                raise AssertionError(f"dw_conv3x3_stats launched "
                                     f"{counts['dw_conv3x3_stats']} times in "
                                     f"a step with LHN_FUSED_DW={fused}")
            med = statistics.median(step_ms[3:])
            medians[(tf32, fused)] = med
            log(f"train: float32, TF32 {'on' if tf32 else 'off'}, "
                f"LHN_FUSED_DW={fused}: {med:.3f} ms/step median of "
                f"{TIMED_STEPS} (min {min(step_ms[3:]):.3f}, max "
                f"{max(step_ms[3:]):.3f}), {BATCH_TRAIN / med * 1e3:.1f} img/s, "
                f"B={BATCH_TRAIN}, {size}x{size}, launches per step {counts}")
    set_tf32(False)
    os.environ["LHN_FUSED_DW"] = "0"
    # (f) the small-channel moments sites, opt-in: off and on in turns
    smallc_step_ms("train litehandnet", trainer.train_step, state, batches,
                   n_bn128, n_small)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    log(f"train: peak device memory of one step "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated, TF32 off, LHN_FUSED_DW=0)")
    # one launch per call, and no second merge kernel
    profile_step(trainer, state, batches[0], "TF32 off, LHN_FUSED_DW=0",
                 {"moments_kernel": n_bn128, "dw_kernel": 0, "chan_merge": 0})
    os.environ["LHN_FUSED_DW"] = "1"
    profile_step(trainer, state, batches[0], "TF32 off, LHN_FUSED_DW=1",
                 {"moments_kernel": n_bn128, "dw_kernel": n_dw,
                  "chan_merge": 0})
    os.environ.pop("LHN_FUSED_DW", None)
    return medians[(False, "0")]


def phase_train_family(dev, name: str, kernel_rows: dict) -> None:
    """Train a family without Rep modules (weights from ``randomize_``): one
    B=2 step on the card equals the CPU's, then the main path
    ``Trainer.fit`` for ``TRAIN_STEPS`` B=32 float32 steps with the launch
    counts set to 0 just before and read just after (``moments`` once per
    128-channel BatchNorm site per step, counted from the model), ms/step,
    peak memory and a profiled step."""
    import shutil

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.trainer import Trainer
    from litehandnet_tpu_torch.utils.weights import randomize_

    cfg = get_config(name)
    family = cfg.MODEL.name
    size = cfg.DATASET.image_size[0]
    steps = TRAIN_STEPS
    tx, schedule = make_optimizer_from_config(cfg, steps_per_epoch=steps)
    base = randomize_(get_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    # the 128-channel BatchNorm sites, counted by hooks over one forward
    x = torch.randn(1, 3, size, size, generator=torch.Generator().manual_seed(5))
    sites = site_shapes(base, x)[0]
    log(f"sites {family}: {len(sites)} BatchNorms with C % 128 == 0 at "
        f"{sorted(set(sites), reverse=True)} (B=1)")
    if not sites:
        raise AssertionError(f"{family} has no 128-channel BatchNorm site")
    step_card_vs_cpu(dev, cfg, base, tx, schedule(0), len(sites))
    del base

    run = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       f"chip_smoke_run_{family}")
    shutil.rmtree(run, ignore_errors=True)
    cfg.TRAIN.total_epoches = 1
    cfg.CHECKPOINT.save_root = run + "/"
    cfg.CHECKPOINT.resume = False
    trainer = Trainer(cfg, steps_per_epoch=steps, device=dev)
    state = trainer.init_state(seed=SEED)
    randomize_(state.model, torch.Generator().manual_seed(SEED))
    batches = [train_batch(BATCH_TRAIN, size, seed=20 + i, device=dev)
               for i in range(steps)]
    step_losses = []
    step_fn = trainer.train_step

    def recorded(state, batch, generator=None):
        metrics = step_fn(state, batch, generator)
        step_losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recorded
    zero_counts()
    t0 = time.perf_counter()
    state = trainer.fit(state, lambda epoch: batches, seed=SEED)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    read_counts(kernel_rows, f"train:{family}", {"moments": len(sites) * steps})
    trainer.train_step = step_fn
    losses = [float(v) for v in step_losses]
    log(f"train {family}: Trainer.fit {steps} steps of B={BATCH_TRAIN} in "
        f"{fit_s:.2f} s (first steps included), moments {len(sites)} x "
        f"{steps}; step losses {[round(v, 6) for v in losses]}")
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{family}: non-finite or missing train losses")
    trainer.close()

    for tf32 in (False, True):
        set_tf32(tf32)
        step_ms = []
        for i in range(TIMED_STEPS + 3):
            zero_counts()
            t0 = time.perf_counter()
            trainer.train_step(state, batches[i % steps])
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
        counts = {k: w.launches for k, w in KERNELS.items()}
        med = statistics.median(step_ms[3:])
        log(f"train {family}: float32, TF32 {'on' if tf32 else 'off'}: "
            f"{med:.3f} ms/step median of {TIMED_STEPS} (min "
            f"{min(step_ms[3:]):.3f}, max {max(step_ms[3:]):.3f}), "
            f"{BATCH_TRAIN / med * 1e3:.1f} img/s, B={BATCH_TRAIN}, "
            f"{size}x{size}, launches per step {counts}")
    set_tf32(False)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer.train_step(state, batches[0])
    torch.cuda.synchronize()
    log(f"train {family}: peak device memory of one step "
        f"{torch.cuda.max_memory_allocated() / 2 ** 30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated, TF32 off)")
    profile_step(trainer, state, batches[0], f"{family}, TF32 off",
                 {"moments_kernel": len(sites), "chan_merge": 0})


def profile_step(trainer, state, batch, setting: str, launches: dict) -> None:
    """Device time by kernel over one train step (``torch.profiler``); fails
    unless each port kernel named in ``launches`` (a part of its symbol)
    ran that many times on the card, which shows one launch per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train_step(state, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = sorted(
        (e for e in prof.key_averages() if e.device_type == DeviceType.CUDA),
        key=lambda e: e.self_device_time_total, reverse=True)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms == 0.0:
        log("profile: the profiler recorded no device time (not measured)")
        return
    log(f"profile: one train step of B={BATCH_TRAIN} ({setting}): wall "
        f"{wall_ms:.3f} ms under the profiler, device "
        f"busy {busy_ms:.3f} ms ({busy_ms / wall_ms:.1%}), "
        f"{sum(e.count for e in kernels)} kernels")
    for e in kernels[:15]:
        log(f"  {e.self_device_time_total / 1e3:8.3f} ms {e.count:4d}x "
            f"{e.key[:100]}")
    seen = {name: sum(e.count for e in kernels if name in e.key)
            for name in launches}
    log(f"profile: device launches of the port's kernels {seen} (expected "
        f"{launches})")
    if seen != launches:
        raise AssertionError(f"profiled step ran {seen}, expected {launches}")


# -- phase 9: train from a COCO-format dataset on disk ----------------------

DISK_EXPERIMENT = "litehandnet/freihand_256_dark_h4_ca_r4"
DISK_EXTRA = {}          # extra make_cfg overrides (none at full size)
DISK_RECORDS = {"train": 256, "val": 64}
DISK_IMAGE = 224         # FreiHAND's image size
DISK_EPOCHS = 2          # loader-fed epochs timed after tools/train.main
PIPE_IMG_TOL = 1e-4      # card vs CPU images, of their max
PIPE_TARGET_TOL = 1e-5
PIPE_JOINT_TOL = 1e-3    # px
PIPE_QUEUED_KERNELS = 512   # kernels queued behind one sleep when timing


def write_disk_dataset(root: str, seed: int) -> str:
    """A seeded FreiHAND-style COCO dataset under ``root``: 224x224 RGB
    JPEGs (a smooth field plus noise, written with PIL), 21 joints each in
    [24, 200] px, about 10% invisible, ``DISK_RECORDS`` records per split;
    and an experiment file for ``DISK_EXPERIMENT`` whose DATASET splits
    point there. Returns the experiment file's path."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    splits = {}
    for split, n in DISK_RECORDS.items():
        images, anns = [], []
        for i in range(n):
            name = f"images/{split}_{i:04d}.jpg"
            low = rng.randint(0, 256, (7, 7, 3)).astype(np.uint8)
            field = np.asarray(Image.fromarray(low).resize(
                (DISK_IMAGE, DISK_IMAGE), Image.BILINEAR), np.float32)
            pixels = np.clip(field + rng.normal(0, 12, field.shape), 0, 255)
            Image.fromarray(pixels.astype(np.uint8)).save(
                os.path.join(root, name), quality=90)
            joints = rng.uniform(24, DISK_IMAGE - 24, (21, 2))
            vis = rng.rand(21) > 0.1
            kpts = [v for (x, y), s in zip(joints, vis)
                    for v in (float(x), float(y), int(s))]
            images.append(dict(id=i, file_name=name, width=DISK_IMAGE,
                               height=DISK_IMAGE))
            anns.append(dict(id=i, image_id=i, category_id=1, iscrowd=0,
                             keypoints=kpts, area=float(DISK_IMAGE ** 2),
                             bbox=[0.0, 0.0, float(DISK_IMAGE),
                                   float(DISK_IMAGE)]))
        ann_file = os.path.join(root, f"{split}.json")
        with open(ann_file, "w") as f:
            json.dump(dict(images=images, annotations=anns,
                           categories=[dict(id=1, name="hand")]), f)
        splits[split] = dict(ann_file=ann_file, img_prefix=root + "/")
    return write_experiment_file(
        os.path.join(root, "freihand_from_disk.py"), DISK_EXPERIMENT,
        dict(DISK_EXTRA, **{
            "DATASET.train": splits["train"], "DATASET.val": splits["val"],
            "DATASET.test": splits["val"],
            "CHECKPOINT.save_root": os.path.join(root, "run") + "/",
            "CHECKPOINT.resume": False}))


def write_experiment_file(path: str, name: str, extra: dict) -> str:
    """An experiment file at ``path``: the experiment ``name`` of the
    port's table with ``extra`` overrides on top. Returns ``path``."""
    from litehandnet_tpu_torch.config.experiments import EXPERIMENTS

    model, dataset, exp_id, image_size, overrides = EXPERIMENTS[name]
    overrides = dict(overrides, **extra)
    with open(path, "w") as f:
        f.write("from litehandnet_tpu_torch.config.templates import make_cfg\n\n\n"
                "def _get_cfg():\n"
                f"    return make_cfg({model!r}, {dataset!r}, exp_id={exp_id!r},\n"
                f"                    image_size={image_size!r},\n"
                f"                    **{overrides!r})\n")
    return path


def pipeline_card_vs_cpu(dev, cfg, loader, card: str) -> None:
    """One train batch through ``DevicePipeline.apply`` on the card and on
    the CPU with the same draws (made on the card), TF32 off; then the
    pipeline's device ms and host ms per batch and its kernels per call."""
    from litehandnet_tpu_torch.data.device_pipeline import DevicePipeline

    set_tf32(False)
    raw_iter = loader._raw_batches(0)
    raw = next(raw_iter)
    raw_iter.close()
    keys = ("img_raw", "joints_canvas", "vis", "center_canvas",
            "scale_canvas", "rotation", "bbox_canvas")
    args = [loader._to_device(raw[k]) for k in keys]
    B = args[0].shape[0]
    params = loader.pipeline.sample_params(
        B, torch.Generator(dev).manual_seed(SEED))
    got = loader.pipeline.apply(*args[:6], args[6], params)
    cpu = DevicePipeline(cfg, loader.dataset.ann_info["flip_index"],
                         is_train=True, device="cpu")
    want = cpu.apply(*[torch.from_numpy(raw[k]) for k in keys[:6]],
                     torch.from_numpy(raw["bbox_canvas"]),
                     {k: None if v is None else v.cpu()
                      for k, v in params.items()})
    errs = {k: float((got[k].cpu() - want[k]).abs().max())
            for k in ("img", "target", "target_weight", "joints")}
    img_max = float(want["img"].abs().max())
    flips = int(params["do_flip"].sum())
    log(f"disk: pipeline card vs CPU, B={B}, the same draws ({flips} "
        f"flipped, {int((params['rot'] != 0).sum())} rotated), TF32 off: "
        f"max_abs_err img {errs['img']:.3g} (max {img_max:.3g}, tolerance "
        f"{PIPE_IMG_TOL} x max), target {errs['target']:.3g} (tolerance "
        f"{PIPE_TARGET_TOL}), target_weight {errs['target_weight']:.3g}, "
        f"joints {errs['joints']:.3g} px (tolerance {PIPE_JOINT_TOL})")
    if not (errs["img"] <= PIPE_IMG_TOL * img_max
            and errs["target"] <= PIPE_TARGET_TOL
            and errs["target_weight"] == 0.0
            and errs["joints"] <= PIPE_JOINT_TOL):
        raise AssertionError("the pipeline on the card disagrees with the CPU")
    (w, h), (hw, hh) = cfg.DATASET.image_size, cfg.DATASET.heatmap_size
    if (tuple(got["img"].shape) != (B, h, w, 3)
            or tuple(got["target"].shape) != (B, 21, hh, hw)):
        raise AssertionError(f"pipeline shapes {tuple(got['img'].shape)}, "
                             f"{tuple(got['target'].shape)}")

    def run():
        return loader.pipeline.apply(*args[:6], args[6], params)

    # the loader-fed step overlaps the host with the card only if the
    # pipeline never waits for it
    generator = torch.Generator(dev).manual_seed(1)
    torch.cuda.set_sync_debug_mode("error")
    try:
        loader.pipeline.sample_params(B, generator)
        run()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    log("disk: sample_params and apply ran with torch.cuda.set_sync_debug_mode"
        "('error'): no synchronizing call")
    kernels, busy_ms, heaviest = profiled_kernels(run)
    # the calls between one event pair must fit the card's launch queue
    # (about a thousand kernels): once it is full the host waits for the
    # sleep to end, and the pair then times the host's enqueue
    calls = max(1, PIPE_QUEUED_KERNELS // max(kernels, 1))
    ms = device_ms(run, n=calls)
    us = host_us(run)
    log(f"disk: DevicePipeline.apply, B={B}, canvas {tuple(args[0].shape[1:3])}"
        f" -> {w}x{h} crops and {hw}x{hh} targets: {ms:.4f} ms device (event "
        f"pair around {calls} call(s) behind a sleep, median of {TIMED_RUNS}),"
        f" {busy_ms:.4f} ms of kernels (profiled), {us / 1e3:.3f} ms host per "
        f"call, {kernels} kernels per call ({card}); heaviest, profiled: "
        + "; ".join(f"{t:.3f} ms {n}x {name}" for t, n, name in heaviest))


def profiled_kernels(fn, top: int = 6):
    """The device kernels one call of ``fn`` launches (``torch.profiler``),
    their summed device ms, and the ``top`` of them by device time as (ms,
    count, name)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = sorted((e for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA),
                key=lambda e: e.self_device_time_total, reverse=True)
    return (sum(e.count for e in ev),
            sum(e.self_device_time_total for e in ev) / 1e3,
            [(e.self_device_time_total / 1e3, e.count, e.key[:80])
             for e in ev[:top]])


def loader_host_ms(loader, card: str) -> float:
    """Host ms per batch of decode and stack (a thread pool of the loader's
    workers decoding into pinned memory), median over an epoch; and, for
    one batch on one thread, the decode alone, the decode into a canvas
    and the stack of the canvases."""
    import concurrent.futures as cf

    from litehandnet_tpu_torch.data.image_io import _decode_image, _load_image

    idxs = loader.local_indices
    records = [loader.dataset.db[i] for i in idxs[:loader.batch_size]]
    t0 = time.perf_counter()
    for r in records:
        _decode_image(r["image_file"])
    t1 = time.perf_counter()
    canvases = [_load_image(r["image_file"], loader.canvas_hw, r["center"],
                            r["scale"], loader.roi_margin)[0] for r in records]
    t2 = time.perf_counter()
    loader._stack_canvases(canvases)
    t3 = time.perf_counter()
    n = len(records)
    log(f"disk: one thread, per image: decode {(t1 - t0) / n * 1e3:.3f} ms, "
        f"decode into a canvas {(t2 - t1) / n * 1e3:.3f} ms; stack of {n} "
        f"canvases into pinned memory {(t3 - t2) * 1e3:.3f} ms ({card})")
    times = []
    with cf.ThreadPoolExecutor(loader.num_workers) as pool:
        for start in range(0, len(idxs) - loader.batch_size + 1,
                           loader.batch_size):
            t0 = time.perf_counter()
            loader._raw_batch(idxs[start:start + loader.batch_size], pool)
            times.append((time.perf_counter() - t0) * 1e3)
    med = statistics.median(times)
    log(f"disk: loader host decode and stack: {med:.3f} ms per batch of "
        f"{loader.batch_size} (median of {len(times)}; min {min(times):.3f}, "
        f"max {max(times):.3f}), {loader.num_workers} decode threads, "
        f"{DISK_IMAGE}x{DISK_IMAGE} JPEGs into a {loader.canvas_hw} canvas "
        f"({card})")
    return med


def phase_train_from_disk(dev, kernel_rows: dict, in_memory_ms: float) -> None:
    """Train LiteHandNet from a COCO-format dataset on disk: the fixture,
    the pipeline card = CPU, ``tools/train.main`` for one epoch and a val
    pass with the counts set to 0 just before (``moments`` once per
    128-channel BatchNorm per step), loader-fed epochs against the same
    batches held on the card, the busy share of one loader-fed step, and the
    val targets decoded on the card through ``TopDownDecoder`` to PCK 1.0."""
    import shutil

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.data.loader import DataLoader
    from litehandnet_tpu_torch.eval.decoder import TopDownDecoder
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm
    from litehandnet_tpu_torch.tools import train as train_cli
    from litehandnet_tpu_torch.train.trainer import Trainer

    card = card_line()
    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_disk")
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    path = write_disk_dataset(root, SEED)
    log(f"disk: wrote {DISK_RECORDS} FreiHAND-style records "
        f"({DISK_IMAGE}x{DISK_IMAGE} JPEGs) in {time.perf_counter() - t0:.2f} s")
    cfg = get_config(path)
    n_bn128 = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                  for m in get_model(cfg, device="cpu").modules())
    B = int(cfg.TRAIN.batch_per_gpu)
    steps = DISK_RECORDS["train"] // B

    loader = DataLoader(cfg, "train", batch_size=B, seed=SEED, device=dev)
    pipeline_card_vs_cpu(dev, cfg, loader, card)
    host_ms = loader_host_ms(loader, card)

    # (a) the main path: tools/train, counters zeroed just before
    set_tf32(False)
    zero_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg", path, "--epochs", "1", "--seed", str(SEED),
                            "--device", str(dev)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    read_counts(kernel_rows, "train_from_disk:litehandnet",
                {"moments": n_bn128 * steps})
    log(f"disk: tools/train.main, 1 epoch of {steps} loader-fed steps of "
        f"B={B} and a val pass: {fit_s:.2f} s with model build, first steps "
        f"and checkpoints; moments {n_bn128} x {steps} ({card})")
    if state.step != steps:
        raise AssertionError(f"tools/train took {state.step} steps, not {steps}")
    run = os.path.join(root, "run", "freihand", "litehandnet", str(cfg.ID))
    for slot in ("checkpoint", "best"):
        if not os.path.exists(os.path.join(run, slot + ".pt")):
            raise AssertionError(f"tools/train wrote no {slot}.pt")

    # (b) loader-fed epochs against the same batches held on the card, in
    # turns; Trainer.train_one_epoch is the body of Trainer.fit
    trainer = Trainer(cfg, steps, log_dir=os.path.join(root, "timing"),
                      device=dev)
    gen = torch.Generator().manual_seed(SEED)

    def loader_batches(epoch):
        for b in loader.batches(epoch):
            yield {k: v for k, v in b.items() if k in train_cli.STEP_KEYS}

    held = list(loader_batches(0))

    def epoch_ms(batches, epoch):
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, metrics = trainer.train_one_epoch(state, batches, epoch, gen)
        torch.cuda.synchronize()
        if not math.isfinite(metrics["loss"]):
            raise AssertionError(f"non-finite loss {metrics}")
        return (time.perf_counter() - t) * 1e3 / steps

    fed, mem = [], []
    epoch_ms(held, 0)  # warm-up
    for e in range(DISK_EPOCHS):
        mem.append(epoch_ms(held, 10 + e))
        fed.append(epoch_ms(loader_batches(1 + e), 1 + e))
    trainer.close()
    log(f"disk: Trainer.fit's epoch, float32, TF32 off, B={B}: loader-fed "
        f"{[round(v, 3) for v in fed]} ms/step ({B / min(fed) * 1e3:.1f} "
        f"img/s at the best), the same batches held on the card "
        f"{[round(v, 3) for v in mem]} ms/step ({B / min(mem) * 1e3:.1f} "
        f"img/s); gap {min(fed) - min(mem):.3f} ms/step; the in-memory step "
        f"of phase 7 in this run {in_memory_ms:.3f} ms (median, synchronized "
        f"per step); loader host decode {host_ms:.3f} ms per batch ({card})")

    # (c) device busy share of one loader-fed step: the next batch's copy
    # and pipeline, then the step
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    it = loader_batches(5)
    trainer.train_step(state, next(it))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        trainer.train_step(state, next(it))
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t) * 1e3
    it.close()
    ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in ev) / 1e3
    if busy == 0.0:
        log("disk: the profiler recorded no device time (busy share not "
            "measured)")
    else:
        log(f"disk: one loader-fed step under the profiler: wall {wall:.3f} "
            f"ms, device busy {busy:.3f} ms ({busy / wall:.1%}), "
            f"{sum(e.count for e in ev)} kernels ({card})")

    # (d) round trip: val targets decoded on the card, evaluated on the host
    val = DataLoader(cfg, "val", batch_size=B, seed=SEED, device=dev)
    decoder = TopDownDecoder(cfg, device=dev)
    batches = list(val.batches())
    zero_counts()
    results = []
    for b in batches:
        meta = {k: b[k] for k in ("image_file", "bbox_id", "bbox_score")}
        meta["center"] = b["center"].cpu().numpy()
        meta["scale"] = b["scale"].cpu().numpy()
        results.append(decoder.decode(
            meta, b["target"].permute(0, 2, 3, 1).contiguous()))
    read_counts(kernel_rows, "train_from_disk:val_decode",
                {"blur_log": len(batches)}, {"blur_log": "fast"})
    metrics = val.dataset.evaluate(results, metric=["PCK", "AUC", "EPE"])
    log(f"disk: val round trip ({len(val.dataset)} records, targets decoded "
        f"on the card): PCK {metrics['PCK']}, AUC {metrics['AUC']:.4f}, "
        f"EPE {metrics['EPE']:.4f} px")
    if metrics["PCK"] != 1.0:
        raise AssertionError(f"val round trip PCK {metrics['PCK']} != 1.0")
    return path



# -- phase 10: evaluate from disk ---------------------------------------------

SIMDR_EXPERIMENT = ("litehandnet/freihand/"
                    "_3_freihand_224x244_dark_h4_ca_r4_leaky_finetune_simdr")
MPII_EXPERIMENT = "mynet/_1_mpii_action_256x256_dark"
COCO_EXPERIMENT = "resnet/coco_256_r50"   # its DATASET and PIPELINE only
EVAL_EXTRA = {}          # extra overrides of the SimDR and MPII-action
                         # experiments (none at full size)
BODY_RECORDS = 64        # MPII-action records; COCO people (2 an image)
MPII_IMAGE = 384         # px, square JPEGs
COCO_IMAGE = (640, 480)  # (w, h), COCO's common size
EVAL_BATCH = 32          # tools/test's default --batch-size
EVAL_EPE_TOL = 0.1       # px, card vs CPU EPE (tests/test_torch_tools_test.py)
DECODE_PROC_SETTINGS = (0, 4)   # and data.mp_decode.default_procs()
MPII_NAMES = [
    "rank", "rkne", "rhip", "lhip", "lkne", "lank", "pelvis", "thorax",
    "upperneck", "head", "rwri", "relb", "rsho", "lsho", "lelb", "lwri",
]


def visible_joints(ann_file: str) -> int:
    with open(ann_file) as f:
        anns = json.load(f)["annotations"]
    return sum(int(v > 0) for a in anns for v in a["keypoints"][2::3])


def assert_metrics_close(got: dict, want: dict, visible: int, what: str):
    """Within one joint crossing a threshold: PCK and AUC to 1 / visible
    joints, EPE to ``EVAL_EPE_TOL`` px (``tests/test_torch_tools_test.py``
    holds the port's CPU CLI to JAX's with these bounds)."""
    if set(got) != set(want):
        raise AssertionError(f"{what}: metric names {set(got)} != {set(want)}")
    bound = {"PCK": 1.0 / visible, "AUC": 1.0 / visible, "EPE": EVAL_EPE_TOL}
    for k, tol in bound.items():
        if abs(got[k] - want[k]) > tol:
            raise AssertionError(f"{what}: {k} {got[k]} against {want[k]}, "
                                 f"tolerance {tol}")


@contextlib.contextmanager
def captured_results(store: dict, key: str):
    """Within the block, the hand datasets' ``evaluate`` also stores the
    decoded results it is given under ``store[key]``."""
    from litehandnet_tpu_torch.data.hand import FreiHandDataset

    original = FreiHandDataset.evaluate

    def evaluate(dataset, results, *args, **kwargs):
        store[key] = results
        return original(dataset, results, *args, **kwargs)

    FreiHandDataset.evaluate = evaluate
    try:
        yield
    finally:
        FreiHandDataset.evaluate = original


def decoded_close(card: list, cpu: list, what: str) -> dict:
    """``tools/test``'s decoded batches on the card against the CPU's: the
    evaluated maps within 1e-4 of their max, maxvals within 1e-4, and
    ``hm_preds`` within 1e-3 heatmap px on the joints whose DARK step is
    well conditioned (``ops.decode.dark_conditioning`` of the CPU maps:
    elsewhere a flat maximum lets the maps' rounding move the Newton step
    far), of which there must be at least ``ZOO_MIN_WELL``. A record that
    pads the last batch counts once. Returns the largest image-space gap
    over all joints, the maps' and the well-conditioned joints' errors and
    their count."""
    from litehandnet_tpu_torch.ops.decode import dark_conditioning

    maps = well_hm = max_px = 0.0
    n_well = n = 0
    seen = set()
    for c, p in zip(card, cpu, strict=True):
        first = np.array([b not in seen and not seen.add(b)
                          for b in map(int, p["bbox_ids"])])
        hm_c, hm_p = (np.asarray(r["output_heatmap"]) for r in (c, p))
        maps = max(maps, float(np.abs(hm_c - hm_p).max())
                   / max(1e-30, float(np.abs(hm_p).max())))
        vals = float(np.abs(c["preds"][..., 2] - p["preds"][..., 2]).max())
        max_px = max(max_px, float(np.abs(c["preds"][..., :2]
                                          - p["preds"][..., :2]).max()))
        well = dark_conditioning(torch.from_numpy(hm_p.astype(np.float32))
                                 )[0].numpy() & first[:, None]
        gap = np.abs(c["hm_preds"] - p["hm_preds"]).max(-1)
        if well.any():
            well_hm = max(well_hm, float(gap[well].max()))
        n_well += int(well.sum())
        n += int(first.sum()) * well.shape[1]
        if not (maps <= 1e-4 and vals <= 1e-4 and well_hm <= 1e-3):
            raise AssertionError(f"{what}: decoded card vs CPU maps {maps}, "
                                 f"maxvals {vals}, well-conditioned joints "
                                 f"{well_hm} px")
    if n_well < ZOO_MIN_WELL:
        raise AssertionError(f"{what}: {n_well} of {n} joints have a "
                             f"well-conditioned DARK step, fewer than "
                             f"{ZOO_MIN_WELL}")
    return dict(maps=maps, well_hm=well_hm, max_px=max_px, n_well=n_well,
                n=n)


def write_mpii_action(root: str, seed: int) -> str:
    """A seeded MPII-action fixture: ``BODY_RECORDS`` 384x384 JPEGs, the
    DHRNet-style json list (1-based joints, about 10% missing) and its
    ``mpii_gt_val.mat``; and an experiment file of ``MPII_EXPERIMENT`` over
    it. ``EVAL.metric`` is cut to PCKh: the MPII evaluator refuses the
    config's AUC and EPE, in JAX as in the port."""
    from PIL import Image
    from scipy.io import savemat

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    n = BODY_RECORDS
    centers = rng.uniform(170, 214, (n, 2))
    pos = centers.T[None] + rng.uniform(-100, 100, (16, 2, n))
    missing = (rng.rand(16, n) < 0.1).astype(np.float64)
    head = pos[MPII_NAMES.index("head")]                       # [2, n]
    savemat(os.path.join(root, "mpii_gt_val.mat"), dict(
        dataset_joints=np.array([MPII_NAMES], dtype=object),
        jnt_missing=missing, pos_gt_src=pos,
        headboxes_src=np.stack([head - 20.0, head + 20.0])))
    anno = []
    for i in range(n):
        name = f"{i:09d}.jpg"
        low = rng.randint(0, 256, (6, 6, 3)).astype(np.uint8)
        field = np.asarray(Image.fromarray(low).resize(
            (MPII_IMAGE, MPII_IMAGE), Image.BILINEAR), np.float32)
        Image.fromarray(np.clip(field + rng.normal(0, 12, field.shape), 0,
                                255).astype(np.uint8)).save(
            os.path.join(root, "images", name), quality=90)
        # the MPII loader adds 15 * scale px to the centre's y and pads the
        # scale by 1.25: a 300 px box around the joints
        anno.append(dict(image=name,
                         center=[float(centers[i, 0]),
                                 float(centers[i, 1] - 18.0)],
                         scale=1.2, joints=pos[:, :, i].tolist(),
                         joints_vis=(1 - missing[:, i]).tolist()))
    ann_file = os.path.join(root, "mpii_action_val.json")
    with open(ann_file, "w") as f:
        json.dump(anno, f)
    split = dict(ann_file=ann_file, img_prefix=os.path.join(root, "images") + "/")
    return write_experiment_file(
        os.path.join(root, "mpii_action_from_disk.py"), MPII_EXPERIMENT, {
            "DATASET.train": split, "DATASET.val": split,
            "DATASET.test": split, "EVAL.metric": ["PCKh"],
            "CHECKPOINT.save_root": os.path.join(root, "run") + "/",
            **EVAL_EXTRA})


def write_coco(root: str, seed: int) -> tuple:
    """A seeded COCO person fixture: ``BODY_RECORDS // 2`` 640x480 JPEGs with
    two people each (17 joints, about 10% unlabeled), and a detection
    ``bbox_file`` with one box per person, moved a few px, scored
    0.5-1. Returns (experiment file of ``COCO_EXPERIMENT`` over it,
    detection experiment file)."""
    from PIL import Image

    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    W, H = COCO_IMAGE
    images, anns, dets = [], [], []
    for i in range(BODY_RECORDS // 2):
        name = f"images/{i:06d}.jpg"
        low = rng.randint(0, 256, (6, 8, 3)).astype(np.uint8)
        field = np.asarray(Image.fromarray(low).resize((W, H), Image.BILINEAR),
                           np.float32)
        Image.fromarray(np.clip(field + rng.normal(0, 12, field.shape), 0,
                                255).astype(np.uint8)).save(
            os.path.join(root, name), quality=90)
        images.append(dict(id=i, file_name=name, width=W, height=H))
        for p in range(2):       # one person in each half: no OKS overlap
            w, h = rng.uniform(90, 150), rng.uniform(180, 300)
            x = rng.uniform(p * W / 2 + 10, (p + 1) * W / 2 - w - 10)
            y = rng.uniform(10, H - h - 10)
            xy = np.stack([rng.uniform(x + 8, x + w - 8, 17),
                           rng.uniform(y + 8, y + h - 8, 17)], 1)
            v = np.where(rng.rand(17) < 0.1, 0, 2)
            anns.append(dict(
                id=len(anns), image_id=i, category_id=1, iscrowd=0,
                keypoints=[float(c) for row in np.concatenate(
                    [xy, v[:, None]], 1) for c in row],
                bbox=[float(x), float(y), float(w), float(h)],
                area=float(w * h), num_keypoints=int((v > 0).sum())))
            dets.append(dict(image_id=i, category_id=1,
                             score=float(rng.uniform(0.5, 1.0)),
                             bbox=[float(x + rng.normal(0, 3)),
                                   float(y + rng.normal(0, 3)),
                                   float(w), float(h)]))
    ann_file = os.path.join(root, "person_keypoints_val.json")
    with open(ann_file, "w") as f:
        json.dump(dict(images=images, annotations=anns,
                       categories=[dict(id=1, name="person")]), f)
    bbox_file = os.path.join(root, "person_detections_val.json")
    with open(bbox_file, "w") as f:
        json.dump(dets, f)
    split = dict(ann_file=ann_file, img_prefix=root + "/")
    extra = {"DATASET.train": split, "DATASET.val": split,
             "DATASET.test": split}
    gt = write_experiment_file(os.path.join(root, "coco_gt.py"),
                               COCO_EXPERIMENT, extra)
    det = write_experiment_file(
        os.path.join(root, "coco_det.py"), COCO_EXPERIMENT,
        dict(extra, **{"DATASET.use_gt_bbox": False,
                       "DATASET.bbox_file": bbox_file}))
    return gt, det


def round_trip(cfg, dev, joints_from=None, rows=None, path=None):
    """The val split's targets through ``DataLoader`` and ``DevicePipeline``
    on ``dev``, cut to the joints (region channels off), decoded by
    ``TopDownDecoder`` and evaluated by the dataset. ``joints_from``: a
    dataset whose records give the joints (a test-mode MPII or detection db
    carries none). With ``rows`` the decode's launches are counted under
    ``path`` (``blur_log`` once per batch, on its fast path)."""
    from litehandnet_tpu_torch.data.loader import DataLoader
    from litehandnet_tpu_torch.eval.decoder import TopDownDecoder
    from litehandnet_tpu_torch.tools.test import META_KEYS

    K = int(cfg.DATASET.num_joints)
    with DataLoader(cfg, "val", batch_size=EVAL_BATCH, seed=SEED,
                    device=dev) as loader:
        if joints_from is not None:
            for rec, src in zip(loader.dataset.db, joints_from.db, strict=True):
                rec["joints_3d"] = src["joints_3d"]
                rec["joints_3d_visible"] = src["joints_3d_visible"]
        batches = list(loader.batches())
        decoder = TopDownDecoder(cfg, device=dev)
        channels = int(batches[0]["target"].shape[1])
        if rows is not None:
            zero_counts()
        results = []
        for b in batches:
            meta = {k: b[k] for k in META_KEYS}
            meta["center"] = b["center"].cpu().numpy()
            meta["scale"] = b["scale"].cpu().numpy()
            results.append(decoder.decode(
                meta, b["target"][:, :K].permute(0, 2, 3, 1).contiguous()))
        if rows is not None:
            read_counts(rows, path, {"blur_log": len(batches)},
                        {"blur_log": "fast"})
        metric = ["mAP"] if cfg.DATASET.name == "coco" else ["PCKh"]
        stats = loader.dataset.evaluate(results, metric=metric)
    return {k: float(v) for k, v in stats.items()}, channels


def phase_evaluate(dev, rows: dict, disk_path: str) -> dict:
    """Evaluate from disk: (a) ``tools/test.main --load-best`` on phase 9's
    run, counted, against the same call on the CPU, and with ``--bf16``;
    (b) the SimDR fine-tune configuration trained for one epoch from phase
    9's fixture with ``tools/train.main`` (counted), its checkpoint's
    decoders, and ``tools/test.main`` on it (counted); (c) MPII-action:
    ``tools/test.main --allow-init`` on ``mynet`` at full width (counted),
    again with K + 3 output channels (counted, ``blur_log`` on its fast
    path after ``unpack_outputs``' cut), and the round trips of an MPII-action and a COCO fixture, card = CPU
    at their ceilings; (d) process decode: the loader's host ms per batch
    for each ``decode_procs`` in turns, and loader-fed epochs with the best
    against 0. Returns (a)'s card metrics."""
    import importlib
    import shutil

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.data import build_dataset
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm
    from litehandnet_tpu_torch.tools import test as test_cli
    from litehandnet_tpu_torch.tools import train as train_cli
    from litehandnet_tpu_torch.train.checkpoint import run_dir

    BL = importlib.import_module("litehandnet_tpu_torch.kernels.blur_log")
    card = card_line()
    set_tf32(False)
    cfg = get_config(disk_path)
    root = os.path.dirname(disk_path)
    n_val = DISK_RECORDS["val"]
    n_batches = -(-n_val // EVAL_BATCH)

    # (a) phase 9's best checkpoint through tools/test
    zero_counts()
    t0 = time.perf_counter()
    card_metrics = test_cli.main(["--cfg", disk_path, "--load-best",
                                  "--device", str(dev)])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    read_counts(rows, "test:litehandnet", {"blur_log": n_batches},
                {"blur_log": "fast"})
    written = os.path.join(run_dir(cfg), "best_pth_metric.json")
    with open(written) as f:
        if json.load(f) != {k: float(v) for k, v in card_metrics.items()}:
            raise AssertionError(f"{written} differs from the returned metrics")
    t0 = time.perf_counter()
    cpu_metrics = test_cli.main(["--cfg", disk_path, "--load-best",
                                 "--device", "cpu"])
    cpu_s = time.perf_counter() - t0
    visible = visible_joints(cfg.DATASET.val.ann_file)
    assert_metrics_close(card_metrics, cpu_metrics, visible, "test:litehandnet")
    bf16_metrics = test_cli.main(["--cfg", disk_path, "--load-best",
                                  "--device", str(dev), "--bf16"])
    if not all(math.isfinite(v) for v in bf16_metrics.values()):
        raise AssertionError(f"--bf16 metrics {bf16_metrics}")
    fmt = lambda m: ", ".join(f"{k} {float(v):.6f}" for k, v in m.items())  # noqa: E731
    log(f"eval: tools/test.main --load-best on phase 9's run ({n_val} val "
        f"records, {n_batches} batches of {EVAL_BATCH}): card float32 {fmt(card_metrics)} "
        f"in {eval_s:.2f} s; CPU {fmt(cpu_metrics)} in {cpu_s:.2f} s (within "
        f"1/{visible} and {EVAL_EPE_TOL} px); card bf16 {fmt(bf16_metrics)} "
        f"({card})")

    # (b) the SimDR fine-tune configuration from phase 9's fixture
    simdr_path = write_experiment_file(
        os.path.join(root, "simdr_from_disk.py"), SIMDR_EXPERIMENT, {
            "DATASET.train": dict(cfg.DATASET.train),
            "DATASET.val": dict(cfg.DATASET.val),
            "DATASET.test": dict(cfg.DATASET.val),
            "CHECKPOINT.save_root": os.path.join(root, "run_simdr") + "/",
            "CHECKPOINT.resume": False, **EVAL_EXTRA})
    scfg = get_config(simdr_path)
    n_bn128 = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                  for m in get_model(scfg, device="cpu").modules())
    B = int(scfg.TRAIN.batch_per_gpu)
    steps = DISK_RECORDS["train"] // B
    zero_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg", simdr_path, "--epochs", "1", "--seed",
                            str(SEED), "--device", str(dev)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    read_counts(rows, "train_from_disk:litehandnet_simdr",
                {"moments": n_bn128 * steps})
    srun = run_dir(scfg)
    with open(os.path.join(srun, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f]
    simdr_loss = [r["train/simdr"] for r in logged if "train/simdr" in r]
    val_simdr = [r["val/simdr"] for r in logged if "val/simdr" in r]
    if not simdr_loss or not all(math.isfinite(v) for v in simdr_loss + val_simdr):
        raise AssertionError(f"SimDR loss {simdr_loss}, val {val_simdr}")
    raw = torch.load(os.path.join(srun, "checkpoint.pt"), map_location="cpu",
                     weights_only=True)
    decoders = {k: tuple(v.shape) for k, v in raw["criterion"].items()}
    (hw, hh), (w, h) = scfg.DATASET.heatmap_size, scfg.DATASET.image_size
    k = int(scfg.PIPELINE.simdr_split_ratio)
    if (decoders.get("simdr.x_decoder.weight") != (k * w, hw * hh)
            or decoders.get("simdr.y_decoder.weight") != (k * h, hw * hh)):
        raise AssertionError(f"the SimDR checkpoint's criterion: {decoders}")
    if state.step != steps:
        raise AssertionError(f"SimDR tools/train took {state.step} steps")
    log(f"eval: SimDR fine-tune ({SIMDR_EXPERIMENT}, {w}x{h}, B={B}, SGD, "
        f"loss_weight {list(scfg.LOSS.loss_weight)}) from disk: 1 epoch of "
        f"{steps} steps and a val pass in {fit_s:.2f} s; moments {n_bn128} "
        f"x {steps}; train SimDR loss {simdr_loss[-1]:.6f}, val "
        f"{val_simdr[-1] if val_simdr else float('nan'):.6f}; checkpoint "
        f"criterion {decoders} ({card})")
    zero_counts()
    simdr_metrics = test_cli.main(["--cfg", simdr_path, "--device", str(dev)])
    torch.cuda.synchronize()
    read_counts(rows, "test:litehandnet_simdr", {"blur_log": n_batches},
                {"blur_log": "fast"})
    log(f"eval: tools/test.main on the SimDR checkpoint ({hw}x{hh} maps): "
        f"{fmt(simdr_metrics)}")

    # (c) body datasets: MPII-action through tools/test, then round trips
    body = os.path.join(root, "body")
    shutil.rmtree(body, ignore_errors=True)
    t0 = time.perf_counter()
    mpii_path = write_mpii_action(os.path.join(body, "mpii"), SEED + 1)
    coco_gt, coco_det = write_coco(os.path.join(body, "coco"), SEED + 2)
    log(f"eval: wrote the MPII-action ({BODY_RECORDS} records, "
        f"{MPII_IMAGE}x{MPII_IMAGE}) and COCO ({BODY_RECORDS // 2} images "
        f"{COCO_IMAGE[0]}x{COCO_IMAGE[1]}, {BODY_RECORDS} people) fixtures in "
        f"{time.perf_counter() - t0:.2f} s")
    mcfg = get_config(mpii_path)
    K = int(mcfg.DATASET.num_joints)
    out_channels = get_model(mcfg, device="cpu")(
        torch.zeros(1, 3, 64, 64)).shape[1]
    zero_counts()
    mpii_metrics = test_cli.main(["--cfg", mpii_path, "--allow-init",
                                  "--device", str(dev)])
    torch.cuda.synchronize()
    read_counts(rows, "test:mynet_mpii_action",
                {"blur_log": -(-BODY_RECORDS // EVAL_BATCH)},
                {"blur_log": "fast"})
    if "PCKh" not in mpii_metrics:
        raise AssertionError(f"MPII-action metrics {mpii_metrics}")
    log(f"eval: tools/test.main --allow-init on {MPII_EXPERIMENT} at full "
        f"width: {fmt(mpii_metrics)}; the model gives {out_channels} "
        f"channels, {K} decoded")
    # the same model with K + 3 output channels (the region maps of a
    # pred_bbox head): tools/test cuts them and copies the joints'
    # channels K-innermost, so blur_log stays on its fast path
    region_path = write_experiment_file(
        os.path.join(body, "mpii", "mpii_region_channels.py"),
        MPII_EXPERIMENT, {
            "DATASET.train": dict(mcfg.DATASET.val),
            "DATASET.val": dict(mcfg.DATASET.val),
            "DATASET.test": dict(mcfg.DATASET.val), "EVAL.metric": ["PCKh"],
            "CHECKPOINT.save_root": os.path.join(body, "mpii", "run_region")
            + "/", "MODEL.output_channel": K + 3, **EVAL_EXTRA})
    region_channels = get_model(get_config(region_path), device="cpu")(
        torch.zeros(1, 3, 64, 64)).shape[1]
    if region_channels != K + 3:
        raise AssertionError(f"the region-channel model gives "
                             f"{region_channels} channels, not {K + 3}")
    probe = heatmap_probe(EVAL_BATCH, 64, 64, K + 3, seed=7).to(dev)
    cut, _, _ = test_cli.unpack_outputs(probe.permute(0, 3, 1, 2), K)
    if not (cut.is_contiguous() and torch.equal(cut, probe[..., :K])
            and BL.plan(cut.shape, cut.stride(), 11,
                        cut.data_ptr() % 16 == 0)["path"] == 1):
        raise AssertionError("unpack_outputs' cut of channels_last "
                             f"[{EVAL_BATCH}, {K + 3}, 64, 64] on the card is "
                             "not the K-innermost copy the fast path reads")
    zero_counts()
    region_metrics = test_cli.main(["--cfg", region_path, "--allow-init",
                                    "--device", str(dev)])
    torch.cuda.synchronize()
    read_counts(rows, "test:mynet_region_channels",
                {"blur_log": -(-BODY_RECORDS // EVAL_BATCH)},
                {"blur_log": "fast"})
    if not all(math.isfinite(v) for v in region_metrics.values()):
        raise AssertionError(f"region-channel metrics {region_metrics}")
    log(f"eval: tools/test.main --allow-init with MODEL.output_channel "
        f"{K + 3}: {fmt(region_metrics)}; {K + 3} channels cut to {K} and "
        f"decoded on the fast path")

    mpii_train = build_dataset(mcfg, "train")   # the records with joints
    coco_db = build_dataset(get_config(coco_gt), "val")
    trips = [("mpii_action", mcfg, mpii_train, "PCKh", 100.0),
             ("coco_gt_boxes", get_config(coco_gt), None, "AP", 1.0),
             ("coco_bbox_file", get_config(coco_det), coco_db, "AP", 1.0)]
    for name, tcfg, joints_from, key, ceiling in trips:
        got, channels = round_trip(tcfg, dev, joints_from, rows,
                                   f"roundtrip:{name}")
        want, _ = round_trip(tcfg, torch.device("cpu"), joints_from)
        if got != want or got[key] != ceiling:
            raise AssertionError(f"round trip {name}: card {got}, CPU {want},"
                                 f" ceiling {key} {ceiling}")
        log(f"eval: round trip {name} ({channels} target channels, "
            f"{tcfg.DATASET.num_joints} decoded on the card): "
            f"{fmt(got)}; the CPU's equal")

    # (d) process decode on phase 9's fixture
    decode_procs_phase(dev, cfg, card)
    return card_metrics


def decode_procs_phase(dev, cfg, card: str) -> None:
    """The loader's host ms per batch (decode, stack into pinned memory,
    and for worker processes the copy out of the shared block) for each
    ``decode_procs`` setting, a batch of each in turns over one epoch; then
    loader-fed epochs with the fastest setting against ``decode_procs=0``,
    in turns, and the device busy share of one loader-fed step with it."""
    import concurrent.futures as cf

    from litehandnet_tpu_torch.data.loader import DataLoader
    from litehandnet_tpu_torch.data.mp_decode import default_procs
    from litehandnet_tpu_torch.tools import train as train_cli
    from litehandnet_tpu_torch.train.trainer import Trainer

    settings = sorted(set(DECODE_PROC_SETTINGS) | {default_procs()})
    B = int(cfg.TRAIN.batch_per_gpu)
    loaders, first_ms = {}, {}
    try:
        with cf.ThreadPoolExecutor(8) as pool:
            for n in settings:
                # the first batch includes the workers' start (spawn)
                t0 = time.perf_counter()
                loaders[n] = DataLoader(cfg, "train", batch_size=B, seed=SEED,
                                        device=dev, decode_procs=n)
                loaders[n]._raw_batch(loaders[n].local_indices[:B], pool)
                first_ms[n] = (time.perf_counter() - t0) * 1e3
            idxs = loaders[0].local_indices
            times = {n: [] for n in settings}
            for i, start in enumerate(range(0, len(idxs) - B + 1, B)):
                order = settings if i % 2 == 0 else settings[::-1]
                for n in order:
                    t0 = time.perf_counter()
                    loaders[n]._raw_batch(idxs[start:start + B], pool)
                    times[n].append((time.perf_counter() - t0) * 1e3)
            # the process settings' batch split: the workers' decode into
            # the shared block (with the pickled geometry), then the copy
            # into pinned memory
            split = {n: ([], []) for n in settings if n > 0}
            for start in range(0, len(idxs) - B + 1, B):
                records = [loaders[0].dataset.db[i] for i in idxs[start:start + B]]
                args = ([r["image_file"] for r in records],
                        np.stack([r["center"] for r in records]),
                        np.stack([r["scale"] for r in records]))
                for n, (dec, cp) in split.items():
                    t0 = time.perf_counter()
                    canvases, _, _ = loaders[n].decode_pool.decode(*args)
                    t1 = time.perf_counter()
                    loaders[n]._stack_canvases(canvases)
                    dec.append((t1 - t0) * 1e3)
                    cp.append((time.perf_counter() - t1) * 1e3)
        med = {n: statistics.median(v) for n, v in times.items()}
        for n in settings:
            parts = ("" if n == 0 else
                     f"; of which the workers' decode "
                     f"{statistics.median(split[n][0]):.3f} and the copy into "
                     f"pinned memory {statistics.median(split[n][1]):.3f} "
                     f"(medians, timed apart)")
            log(f"decode_procs {n}"
                f"{' (8 threads)' if n == 0 else ''}: loader host ms per "
                f"batch of {B}: median {med[n]:.3f} (min {min(times[n]):.3f}, "
                f"max {max(times[n]):.3f}, {len(times[n])} batches in turns)"
                f"{parts}; loader built and first batch {first_ms[n]:.1f} ms "
                f"({card})")
        # the fastest process setting, against decode in this process
        best = min((n for n in settings if n > 0), key=med.get)

        # loader-fed epochs, decode_procs 0 against the best, in turns
        steps = len(loaders[0])
        trainer = Trainer(cfg, steps, log_dir=os.path.join(
            os.path.dirname(cfg.DATASET.train.ann_file), "timing_procs"),
            device=dev)
        state = trainer.init_state(seed=SEED)
        gen = torch.Generator().manual_seed(SEED)

        def fed(n, epoch):
            for b in loaders[n].batches(epoch):
                yield {k: v for k, v in b.items() if k in train_cli.STEP_KEYS}

        def epoch_ms(n, epoch):
            torch.cuda.synchronize()
            t = time.perf_counter()
            _, metrics = trainer.train_one_epoch(state, fed(n, epoch), epoch, gen)
            torch.cuda.synchronize()
            if not math.isfinite(metrics["loss"]):
                raise AssertionError(f"non-finite loss {metrics}")
            return (time.perf_counter() - t) * 1e3 / steps

        epoch_ms(best, 0)  # warm-up
        fed_ms = {0: [], best: []}
        for e, n in enumerate((0, best, best, 0)):
            fed_ms[n].append(epoch_ms(n, 1 + e))

        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        it = fed(best, 9)
        trainer.train_step(state, next(it))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            trainer.train_step(state, next(it))
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t) * 1e3
        it.close()
        trainer.close()
        ev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy = sum(e.self_device_time_total for e in ev) / 1e3
        share = (f"device busy {busy:.3f} of {wall:.3f} ms ({busy / wall:.1%})"
                 if busy else "the profiler recorded no device time (busy "
                 "share not measured)")
        log(f"decode_procs: loader-fed Trainer epochs, float32, TF32 off, "
            f"B={B}, in turns: decode_procs 0 "
            f"{[round(v, 3) for v in fed_ms[0]]} ms/step, decode_procs {best} "
            f"{[round(v, 3) for v in fed_ms[best]]} ms/step; one loader-fed "
            f"step with decode_procs {best}: {share} ({card})")
    finally:
        for loader in loaders.values():
            loader.close()


# -- phase 11: the model zoo -------------------------------------------------

ZOO_CONFIGS = ("srhandnet/freihand_256", "litehrnet/freihand_256_d30",
               "resnet/freihand_256_r50", "mobilenetv2/freihand_256",
               "hourglass/freihand_256_s2", "litehandnet_msrb/freihand_256")
# the zoo configs trained with LHN_FUSED_DW=1 (their stride-1 depthwise
# RepConvs through dw_conv3x3_stats), whose deploy graph is checked, and
# which are trained from disk and evaluated by tools/test
MSRB_CONFIG = "litehandnet_msrb/freihand_256"
# fewer timed reps than the earlier phases, to keep the run short
ZOO_TRAIN_STEPS = 4      # steps of each family's counted Trainer.fit, the
                         # last 3 of them timed
ZOO_TIMED_REPS = 2       # timed serve reps of REQUESTS batches
ZOO_BENCH_REPS = 1       # tools/benchmark --reps (after its 3 warm-up calls)
BENCH_MODELS = ("hourglass",)   # tools/benchmark --models: 8 stacks
ZOO_DECODE_BATCH = 128   # images per batch of the decode check
ZOO_DECODE_MAX = 2048    # images it decodes at most to reach ZOO_MIN_WELL
ZOO_MIN_WELL = 32        # well-conditioned joints the decode check needs
MARKED_EPOCHS = 6        # tools/train epochs of the msrb run on marked joints
MARKED_OPTIMIZER = {"OPTIMIZER.warmup_steps": 50, "OPTIMIZER.lr": 1e-3}
ZOO_BLUR_RTOL = 1e-5     # blur_log kernel vs plain on a family's maps, of
                         # each map's rescaled largest |value| (float32 sums
                         # of 11 products in each of two passes)


def zoo_batch(cfg, B, seed, device):
    """A train batch of ``cfg`` made by the port's ``DevicePipeline`` on
    ``device`` from seeded noise canvases (twice the crop, as the loader
    makes them), joints within 0.4 of the crop around its center, about 10%
    invisible, and their bounding boxes: SRHandNet's four per-scale targets
    with region channels and weights come as lists; a SimDR config's
    targets come too."""
    from litehandnet_tpu_torch.data.device_pipeline import DevicePipeline

    size = cfg.DATASET.image_size[0]
    K = int(cfg.DATASET.num_joints)
    gen = torch.Generator(device).manual_seed(seed)
    canvas = torch.randint(0, 256, (B, 2 * size, 2 * size, 3), generator=gen,
                           device=device, dtype=torch.uint8)
    centers = torch.full((B, 2), float(size), device=device)
    scales = torch.full((B, 2), size / 200.0, device=device)
    joints = centers[:, None] + (torch.rand(B, K, 2, generator=gen,
                                            device=device) - 0.5) * 0.8 * size
    vis = (torch.rand(B, K, generator=gen, device=device) > 0.1).float()
    lo, hi = joints.amin(1), joints.amax(1)
    pipe = DevicePipeline(cfg, list(range(K)), device=device)
    out = pipe(canvas, joints, vis, centers, scales,
               torch.zeros(B, device=device), generator=gen,
               bboxes=torch.cat([lo, hi - lo], -1))
    return {k: out[k] for k in ("img", "target", "target_weight",
                                "simdr_x", "simdr_y") if k in out}


def zoo_forward(dev, cfg) -> None:
    """The card's float32 forward (TF32 off) of a zoo family equals the
    CPU's on every output (1e-4 of its max) at B=2. Then batches of
    ``ZOO_DECODE_BATCH`` random images until ``ZOO_MIN_WELL`` joints have a
    well-conditioned DARK step: on each evaluated map the ``blur_log``
    kernel equals its plain twin, and the card's decode equals the CPU's
    decode of the same maps (1e-3 px on those joints, maxvals exactly)."""
    from litehandnet_tpu_torch.eval.decoder import unpack_outputs
    from litehandnet_tpu_torch.kernels.blur_log import blur_log
    from litehandnet_tpu_torch.ops.blur import gaussian_blur
    from litehandnet_tpu_torch.ops.decode import (dark_conditioning,
                                                  keypoints_from_heatmaps)
    from litehandnet_tpu_torch.serve import deploy_model

    name = cfg.MODEL.name
    size = cfg.DATASET.image_size[0]
    K = int(cfg.DATASET.num_joints)
    set_tf32(False)
    model = deploy_model(cfg, seed=SEED, device=dev)
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        got = model(x.to(dev).contiguous(memory_format=torch.channels_last))
        ref = deploy_model(cfg, seed=SEED, device="cpu")(x)
    gots, refs = ((got, ref) if isinstance(got, tuple) else ((got,), (ref,)))
    errs = []
    for g, r in zip(gots, refs, strict=True):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: non-finite card forward")
        scale = max(1.0, float(r.abs().max()))
        errs.append((float((g.cpu() - r).abs().max()), scale))
    log(f"zoo {name}: f32 card vs CPU max_abs_err per output "
        f"{[f'{e:.3g} (max {m:.3g})' for e, m in errs]}, shapes "
        f"{[tuple(g.shape) for g in gots]} (tolerance 1e-4 x max)")
    if not all(e <= 1e-4 * m for e, m in errs):
        raise AssertionError(f"{name}: card forward disagrees with the CPU")

    # random weights give flat maxima where DARK's Newton step divides by a
    # near-singular Hessian: there the 1e-7 rounding of the log map moves a
    # coordinate by up to 100 px (ROADMAP Queue 3 records), so the decode
    # is held to 1e-3 px on the joints whose step is well conditioned
    # (ops.decode.dark_conditioning), at least ZOO_MIN_WELL of them
    B = ZOO_DECODE_BATCH
    center = torch.tile(torch.tensor([size / 2, size / 2]), (B, 1))
    scale_ = torch.tile(torch.tensor([size / 200.0, size / 200.0]), (B, 1))
    kw = dict(post_process="unbiased", kernel=11)
    gen = torch.Generator(dev).manual_seed(2)
    n_img = n_well = n_close = 0
    blur_err = blur_of_max = well_err = val_err = all_err = 0.0
    while n_well < ZOO_MIN_WELL and n_img < ZOO_DECODE_MAX:
        with torch.no_grad():
            out = model(torch.randn(B, 3, size, size, generator=gen, device=dev)
                        .contiguous(memory_format=torch.channels_last))
        hm = unpack_outputs(out, K)[0]
        if hm.shape != (B, size // 4, size // 4, K):
            raise AssertionError(f"{name}: evaluated map {tuple(hm.shape)}")
        # the kernel against its plain twin on the blurred and rescaled maps
        # exp(log): a random model's maps sum to near zero in places, where
        # the log turns summation-order rounding into large absolute
        # differences that no decode reads (phase 2 holds the log values at
        # KERNEL_ATOL on Gaussian peaks). A float32 blur's rounding scales
        # with the largest |value| it sums, times the max-preserving rescale
        # (the map's max over its blurred max): the error is held to
        # ZOO_BLUR_RTOL of that, and printed relative to the map's max too
        hm_cpu = hm.cpu()
        plain = blur_log(hm_cpu)
        got_e, want_e = blur_log(hm).cpu().double().exp(), plain.double().exp()
        diff_e = (got_e - want_e).abs().amax(dim=(1, 2))
        maps = hm_cpu.double()
        rescale = (maps.amax(dim=(1, 2)) / torch.clamp(
            gaussian_blur(hm_cpu, 11).double().amax(dim=(1, 2)), min=1e-20))
        scale_e = torch.clamp(rescale.abs() * maps.abs().amax(dim=(1, 2)),
                              min=1e-30)
        blur_err = max(blur_err, float((diff_e / scale_e).max()))
        blur_of_max = max(blur_of_max, float(
            (diff_e / want_e.amax(dim=(1, 2))).max()))
        cpu = keypoints_from_heatmaps(hm_cpu, center, scale_, **kw)
        card = keypoints_from_heatmaps(hm, center.to(dev), scale_.to(dev), **kw)
        diff = (card[0].cpu() - cpu[0]).abs().amax(-1)
        val_err = max(val_err, float((card[2].cpu() - cpu[2]).abs().max()))
        well = dark_conditioning(hm_cpu, plain)[0]
        if well.any():
            well_err = max(well_err, float(diff[well].max()))
        all_err = max(all_err, float(diff.max()))
        n_close += int((diff <= 1e-3).sum())
        n_well += int(well.sum())
        n_img += B
    log(f"zoo {name}: blur_log on its maps, kernel vs plain max_abs_err of "
        f"exp(log) {blur_err:.3g} of the rescaled largest |value| (tolerance "
        f"{ZOO_BLUR_RTOL}), {blur_of_max:.3g} of the map's max; decode card "
        f"vs CPU over {n_img} images: hm_preds "
        f"max_abs_err {well_err:.3g} px on the {n_well} of {n_img * K} joints "
        f"whose DARK step is well conditioned (tolerance 1e-3, at least "
        f"{ZOO_MIN_WELL} joints), maxvals {val_err:.3g}; over all joints "
        f"{all_err:.3g} px, {n_close / (n_img * K):.1%} within 1e-3 px")
    if not (blur_err <= ZOO_BLUR_RTOL and val_err == 0.0
            and n_well >= ZOO_MIN_WELL and well_err <= 1e-3):
        raise AssertionError(f"{name}: card decode disagrees with the CPU")


def zoo_step64(dev, cfg, base, batch=None) -> None:
    """One B=2 float64 Adam step of ``base`` from the same weights and
    batch (``zoo_batch``, or ``batch``) on the card and on the CPU (TF32
    off, dropout at identity; the moments kernel takes float32 and bfloat16
    only, so LHN_FUSED_BN=0): loss to 1e-9, every gradient leaf to 1e-6 of
    its max (a leaf without a gradient counts as 0), BatchNorm statistics
    to 1e-9."""
    import copy

    from litehandnet_tpu_torch.train.distributed import (make_train_step,
                                                         to_device)
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config

    name = cfg.MODEL.name
    set_tf32(False)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=ZOO_TRAIN_STEPS)
    if batch is None:
        batch = zoo_batch(cfg, 2, seed=11, device=dev)
    models, loss = {}, {}
    os.environ["LHN_FUSED_BN"] = "0"
    try:
        for key, device in (("card", dev), ("cpu", torch.device("cpu"))):
            model = copy.deepcopy(base).double()
            set_dropout(model, 0.0)
            metrics = make_train_step(device)(
                state_on(device, model, cfg, tx),
                {k: to_device(v, device, torch.float64)
                 for k, v in batch.items()})
            loss[key] = float(metrics["loss"])
            models[key] = model
    finally:
        os.environ.pop("LHN_FUSED_BN")
    def grads(key):
        return [torch.zeros_like(p) if p.grad is None else p.grad.cpu()
                for p in models[key].parameters()]

    g_cpu = grads("cpu")
    floor = 1e-8 * max(float(g.abs().max()) for g in g_cpu)
    leaf = max(float((g_card - g).abs().max())
               / max(float(g.abs().max()), floor)
               for g_card, g in zip(grads("card"), g_cpu))
    stats = max(float((a.cpu() - b).abs().max()) / max(float(b.abs().max()),
                                                         1e-30)
                for a, b in zip(models["card"].buffers(),
                                models["cpu"].buffers())
                if a.is_floating_point())
    rel = abs(loss["card"] - loss["cpu"]) / abs(loss["cpu"])
    log(f"zoo {name}: one float64 step B=2, card vs CPU: loss {loss['cpu']:.12g} "
        f"relative {rel:.3g} (tolerance 1e-9), worst gradient leaf "
        f"{leaf:.3g} of its max (1e-6), BN statistics {stats:.3g} (1e-9)")
    if not (rel <= 1e-9 and leaf <= 1e-6 and stats <= 1e-9):
        raise AssertionError(f"{name}: card step disagrees with the CPU step")


def zoo_train(dev, cfg, rows: dict, n_sites: int, n_dw: int = 0,
              n_small: int = 0) -> None:
    """The train main path: ``Trainer.fit`` of ``ZOO_TRAIN_STEPS`` B=32
    float32 steps (random weights, pipeline-made batches, TF32 off) with the
    launch counts set to 0 just before and read just after (``moments``
    once per 128-channel BatchNorm per step; with ``n_dw``, under
    ``LHN_FUSED_DW=1``, ``dw_conv3x3_stats`` once per fusable depthwise
    RepConv per step); ms/step from the fit's own steps after the first,
    each synchronized, and the peak memory of the fit; with ``n_small``,
    ms/step with ``LHN_FUSED_BN_SMALLC`` off and on."""
    import shutil

    from litehandnet_tpu_torch.train.trainer import Trainer
    from litehandnet_tpu_torch.utils.weights import randomize_

    name = cfg.MODEL.name
    size = cfg.DATASET.image_size[0]
    steps = ZOO_TRAIN_STEPS
    run = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                       f"chip_smoke_run_{name}")
    shutil.rmtree(run, ignore_errors=True)
    cfg.TRAIN.total_epoches = 1
    cfg.CHECKPOINT.save_root = run + "/"
    cfg.CHECKPOINT.resume = False
    set_tf32(False)
    trainer = Trainer(cfg, steps_per_epoch=steps, device=dev)
    state = trainer.init_state(seed=SEED)
    randomize_(state.model, torch.Generator().manual_seed(SEED))
    batches = [zoo_batch(cfg, BATCH_TRAIN, seed=20 + i, device=dev)
               for i in range(steps)]
    losses, step_ms = [], []
    step_fn = trainer.train_step

    def recorded(state, batch, generator=None):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = step_fn(state, batch, generator)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(metrics["loss"])
        return metrics

    trainer.train_step = recorded
    torch.cuda.reset_peak_memory_stats()
    expected = {"moments": n_sites * steps} if n_sites else {}
    if n_dw:
        os.environ["LHN_FUSED_DW"] = "1"
        expected["dw_conv3x3_stats"] = n_dw * steps
    try:
        zero_counts()
        trainer.fit(state, lambda epoch: batches, seed=SEED)
        read_counts(rows, f"train:{name}", expected)
    finally:
        os.environ.pop("LHN_FUSED_DW", None)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if n_small:
        smallc_step_ms(f"zoo {name}", step_fn, state, batches, n_sites,
                       n_small)
    trainer.close()
    losses = [float(v) for v in losses]
    if not (len(losses) == steps and all(math.isfinite(v) for v in losses)):
        raise AssertionError(f"{name}: non-finite or missing train losses")
    med = statistics.median(step_ms[1:])
    dw_note = (f"; LHN_FUSED_DW=1, dw_conv3x3_stats {n_dw} x {steps}"
               if n_dw else "")
    log(f"zoo {name}: Trainer.fit {steps} steps of B={BATCH_TRAIN}, moments "
        f"{n_sites} x {steps}, losses {[round(v, 6) for v in losses]}; "
        f"float32, TF32 off: {med:.3f} ms/step median of steps 2-{steps} "
        f"(min {min(step_ms[1:]):.3f}, max {max(step_ms[1:]):.3f}), "
        f"{BATCH_TRAIN / med * 1e3:.1f} img/s, {size}x{size}; peak device "
        f"memory of the fit {peak:.3f} GiB{dw_note}")


def zoo_deploy(dev, cfg) -> None:
    """The deploy graph (``get_model(deploy=True)`` with ``fuse_params``
    weights) equals the train graph in eval mode on the card, float32, TF32
    off, within 1e-4 of the output's max, at B=8."""
    from litehandnet_tpu_torch.models import fuse_params, get_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    set_tf32(False)
    size = cfg.DATASET.image_size[0]
    train = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED))
    deploy = get_model(cfg, deploy=True, device="cpu")
    deploy.load_state_dict(fuse_params(train))
    x = torch.randn(8, 3, size, size, generator=torch.Generator().manual_seed(4))
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        want = train.to(dev, memory_format=torch.channels_last).eval()(x)
        got = deploy.to(dev, memory_format=torch.channels_last).eval()(x)
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    log(f"zoo {cfg.MODEL.name}: deploy graph vs train graph on the card, "
        f"float32, TF32 off, B=8: max_abs_err {err:.3g} (output max "
        f"{scale:.3g}, tolerance 1e-4 x max)")
    if not (torch.isfinite(got).all() and err <= 1e-4 * scale):
        raise AssertionError(f"{cfg.MODEL.name}: deploy graph disagrees")


def write_marked_dataset(disk_path: str, root: str) -> dict:
    """Phase 9's fixture (the splits of the experiment file ``disk_path``)
    copied under ``root`` with every joint marked: the field dimmed to 40%,
    then a disk of radius 4 px in the joint's own color (21 hues) at each
    of its joints, so that a model learns to find them in a few epochs.
    Returns the ``DATASET.train`` and ``DATASET.val`` splits."""
    import colorsys

    from PIL import Image

    from litehandnet_tpu_torch.config import get_config

    source = get_config(disk_path).DATASET
    colors = [np.array(colorsys.hsv_to_rgb(k / 21, 1.0, 0.6 + 0.4 * (k % 2)))
              * 255 for k in range(21)]
    yy, xx = np.mgrid[:DISK_IMAGE, :DISK_IMAGE]
    splits = {}
    for split in ("train", "val"):
        with open(source[split].ann_file) as f:
            anns = json.load(f)
        for image, ann in zip(anns["images"], anns["annotations"],
                              strict=True):
            pixels = np.asarray(Image.open(
                source[split].img_prefix + image["file_name"]), np.float32)
            pixels *= 0.4
            joints = np.asarray(ann["keypoints"]).reshape(-1, 3)
            for color, (x, y, _) in zip(colors, joints, strict=True):
                pixels[(xx - x) ** 2 + (yy - y) ** 2 <= 16] = color
            path = os.path.join(root, image["file_name"])
            os.makedirs(os.path.dirname(path), exist_ok=True)
            Image.fromarray(pixels.astype(np.uint8)).save(path, quality=95)
        ann_file = os.path.join(root, f"{split}.json")
        with open(ann_file, "w") as f:
            json.dump(anns, f)
        splits[split] = dict(ann_file=ann_file, img_prefix=root + "/")
    return splits


def zoo_from_disk(dev, rows: dict, config: str, disk_path: str) -> None:
    """``config`` trained by ``tools/train.main`` for ``MARKED_EPOCHS``
    epochs on phase 9's fixture with its joints marked
    (``write_marked_dataset``; counted: ``moments`` once per 128-channel
    BatchNorm per step), so that its maps have peaks, then
    ``tools/test.main --load-best`` on that run on the card (counted:
    ``blur_log`` once per batch, fast path) and on the CPU: the decoded
    batches as ``decoded_close`` holds them (at least ``ZOO_MIN_WELL``
    well-conditioned joints) and the metrics within one joint crossing a
    threshold (``assert_metrics_close``)."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm
    from litehandnet_tpu_torch.tools import test as test_cli
    from litehandnet_tpu_torch.tools import train as train_cli

    set_tf32(False)
    name = config.split("/")[0]
    root = os.path.join(os.path.dirname(disk_path), f"{name}_marked")
    t0 = time.perf_counter()
    splits = write_marked_dataset(disk_path, root)
    write_s = time.perf_counter() - t0
    path = write_experiment_file(
        os.path.join(root, f"{name}_from_disk.py"), config, {
            "DATASET.train": splits["train"], "DATASET.val": splits["val"],
            "DATASET.test": splits["val"],
            "CHECKPOINT.save_root": os.path.join(root, "run") + "/",
            "CHECKPOINT.resume": False, **MARKED_OPTIMIZER, **DISK_EXTRA})
    cfg = get_config(path)
    n_bn128 = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                  for m in get_model(cfg, device="cpu").modules())
    steps = MARKED_EPOCHS * (DISK_RECORDS["train"]
                             // int(cfg.TRAIN.batch_per_gpu))
    zero_counts()
    t0 = time.perf_counter()
    state = train_cli.main(["--cfg", path, "--epochs", str(MARKED_EPOCHS),
                            "--seed", str(SEED), "--device", str(dev)])
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    read_counts(rows, f"train_from_disk:{name}", {"moments": n_bn128 * steps})
    if state.step != steps:
        raise AssertionError(f"tools/train took {state.step} steps, not {steps}")
    n_batches = -(-DISK_RECORDS["val"] // EVAL_BATCH)
    results = {}
    zero_counts()
    t0 = time.perf_counter()
    with captured_results(results, "card"):
        card = test_cli.main(["--cfg", path, "--load-best", "--device",
                              str(dev)])
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t0
    read_counts(rows, f"test:{name}", {"blur_log": n_batches},
                {"blur_log": "fast"})
    with captured_results(results, "cpu"):
        cpu = test_cli.main(["--cfg", path, "--load-best", "--device", "cpu"])
    visible = visible_joints(cfg.DATASET.val.ann_file)
    gaps = decoded_close(results["card"], results["cpu"], f"test:{name}")
    assert_metrics_close(card, cpu, visible, f"test:{name}")
    fmt = lambda m: ", ".join(f"{k} {float(v):.6f}" for k, v in m.items())  # noqa: E731
    log(f"zoo {name}: tools/train.main {MARKED_EPOCHS} epochs of {steps} "
        f"steps from disk (joints marked; fixture {write_s:.2f} s) in "
        f"{fit_s:.2f} s (moments {n_bn128} x {steps}); tools/test.main "
        f"--load-best card {fmt(card)} in {eval_s:.2f} s, CPU {fmt(cpu)} "
        f"(within 1/{visible} and {EVAL_EPE_TOL} px); decoded maps card vs "
        f"CPU {gaps['maps']:.3g} of their max, hm_preds {gaps['well_hm']:.3g} "
        f"px on the {gaps['n_well']} of {gaps['n']} joints whose DARK step "
        f"is well conditioned (tolerance 1e-3, at least {ZOO_MIN_WELL}), "
        f"largest gap over all joints {gaps['max_px']:.4g} px "
        f"({card_line()})")


def phase_zoo(dev, rows: dict, zoo_sites: dict, disk_path: str,
              msrb_small: int) -> None:
    """The families of the model zoo at full width (random weights from
    ``SEED``): card forward = CPU forward and card decode = CPU decode;
    the counted bf16 serve path (``blur_log`` once per request, fast path;
    no ``moments`` in eval); a float64 step card = CPU; a counted
    ``Trainer.fit`` (``moments`` once per step at each of the family's
    ``zoo_sites``, which phase 6 held to its plain twin; for
    ``litehandnet_msrb`` under ``LHN_FUSED_DW=1`` also ``dw_conv3x3_stats``
    at each of its depthwise sites, at dilations 1 and 2, and ms/step with
    ``LHN_FUSED_BN_SMALLC`` off and on); for ``litehandnet_msrb`` the
    deploy graph against the train graph and a run trained from phase 9's
    fixture with its joints marked and evaluated by ``tools/test``; then ``tools/benchmark.main``
    over ``BENCH_MODELS``, serving at B=128 bf16 and training at B=32."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.tools import benchmark
    from litehandnet_tpu_torch.utils.weights import randomize_

    for config in ZOO_CONFIGS:
        cfg = get_config(config)
        name = cfg.MODEL.name
        wall = {}

        def part(label, fn, *args):
            t0 = time.perf_counter()
            fn(*args)
            wall[label] = round(time.perf_counter() - t0, 1)

        msrb = config == MSRB_CONFIG
        part("forward+decode", zoo_forward, dev, cfg)
        part("serve", serve_requests, dev, cfg, rows, ZOO_TIMED_REPS)
        if msrb:
            part("deploy", zoo_deploy, dev, cfg)
        base = randomize_(get_model(cfg, device="cpu"),
                          torch.Generator().manual_seed(SEED))
        sites, dw = zoo_sites[config]
        if (name == "litehrnet") != (not sites):
            raise AssertionError(f"{name}: {len(sites)} 128-channel sites")
        if msrb:
            if {d for _, d in dw} != {1, 2}:
                raise AssertionError(f"{name}: depthwise sites {dw}")
            # the float64 step under the fused switch: the depthwise kernel
            # takes float32 and bfloat16 only, so it routes as without it
            os.environ["LHN_FUSED_DW"] = "1"
        try:
            part("step64", zoo_step64, dev, cfg, base)
        finally:
            os.environ.pop("LHN_FUSED_DW", None)
        del base
        part("train", zoo_train, dev, cfg, rows, len(sites),
             len(dw) if msrb else 0, msrb_small if msrb else 0)
        if msrb:
            part("from disk", zoo_from_disk, dev, rows, config, disk_path)
        log(f"zoo {config}: wall s {wall}, {sum(wall.values()):.1f} s")

    # tools/benchmark over what no other phase times: the 8-stack hourglass
    # (tests/test_torch_benchmark_cli.py runs all eight DEFAULT_MODELS)
    for argv in (["--throughput", "--batch", str(BATCH), "--bf16"],
                 ["--train", "--batch", str(BATCH_TRAIN)]):
        argv += ["--reps", str(ZOO_BENCH_REPS), "--models", *BENCH_MODELS]
        t0 = time.perf_counter()
        set_tf32(False)
        results = benchmark.main(argv)
        log(f"tools/benchmark {' '.join(argv)}: "
            f"{time.perf_counter() - t0:.1f} s ({card_line()})")
        missing = set(BENCH_MODELS) - set(results)
        if missing:
            raise AssertionError(f"tools/benchmark failed on {sorted(missing)}")


# -- phase 12: multi-hand, the Gen-1 path ----------------------------------

MULTIHAND_EXPERIMENT = "mynet_stacked/freihand_256_region_simdr"
PYRAMID_EXPERIMENT = "srhandnet/freihand_256"
MULTIHAND_FRAMES = 8          # seeded demo images, MULTIHAND_FRAME px square
MULTIHAND_FRAME = 256
MULTIHAND_SCENES = 32         # B of the ResultParser check, with up to
                              # MULTIHAND_MAX_HANDS hands an image
PARSER_PX_TOL = 1e-3          # px, card vs CPU boxes and keypoints


def multihand_forward(dev, cfg, base) -> None:
    """The card's float32 forward of ``base`` (eval mode, TF32 off) equals
    the CPU's at B=2 on every output: each stack's K + 3 maps and the SimDR
    vectors, within 1e-4 of each output's max."""
    import copy

    size = cfg.DATASET.image_size[0]
    set_tf32(False)
    x = torch.randn(2, 3, size, size, generator=torch.Generator().manual_seed(1))
    card = copy.deepcopy(base).to(dev, memory_format=torch.channels_last).eval()
    with torch.no_grad():
        got = card(x.to(dev).contiguous(memory_format=torch.channels_last))
        want = base.eval()(x)
    gots, wants = [*got[0], got[1], got[2]], [*want[0], want[1], want[2]]
    errs = []
    for g, w in zip(gots, wants, strict=True):
        if not torch.isfinite(g).all():
            raise AssertionError("mynet_stacked: non-finite card forward")
        errs.append((float((g.cpu() - w).abs().max()),
                     max(1.0, float(w.abs().max()))))
    shapes = [tuple(g.shape) for g in gots]
    log(f"multihand: mynet_stacked f32 card vs CPU max_abs_err per output "
        f"{[f'{e:.3g} (max {m:.3g})' for e, m in errs]}, shapes {shapes} "
        f"(tolerance 1e-4 x max)")
    K = int(cfg.DATASET.num_joints)
    if shapes != [(2, K + 3, size // 4, size // 4)] * 2 + [(2, K, 2 * size)] * 2:
        raise AssertionError(f"mynet_stacked: output shapes {shapes}")
    if not all(e <= 1e-4 * m for e, m in errs):
        raise AssertionError("mynet_stacked: card forward disagrees with the CPU")


def multihand_train(dev, rows: dict, root: str, n_full: int,
                    n_half: int) -> str:
    """The train main path: ``tools/train_center_simdr.main`` for one epoch
    of phase 9's fixture at B=32 with ``--cd-prob 1.0``, the counts set to 0
    just before: ``moments`` once per 128-channel BatchNorm per step
    (``n_full`` a full-resolution step, ``n_half`` a half-resolution one),
    ``blur_log`` twice per val batch on its general path. ms/step of each
    resolution (each step synchronized) and the wall of
    ``evaluate_multihand_pck``. Returns the experiment file."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.tools import train_center_simdr as tcs

    splits = {split: dict(ann_file=os.path.join(root, f"{split}.json"),
                          img_prefix=root + "/") for split in DISK_RECORDS}
    path = write_experiment_file(
        os.path.join(root, "mynet_stacked_from_disk.py"), MULTIHAND_EXPERIMENT,
        {"DATASET.train": splits["train"], "DATASET.val": splits["val"],
         "DATASET.test": splits["val"], "TRAIN.total_epoches": 1,
         "CHECKPOINT.save_root": os.path.join(root, "run_multihand") + "/",
         "CHECKPOINT.resume": False})
    cfg = get_config(path)
    B = int(cfg.TRAIN.batch_per_gpu)
    steps = DISK_RECORDS["train"] // B
    val_batches = -(-DISK_RECORDS["val"] // B)
    step_ms, evals, held = {}, [], {}
    make_step, evaluate = tcs.make_train_step, tcs.evaluate_multihand_pck

    def timed_make_step(device, world=None):
        step = make_step(device, world)

        def timed(state, batch, generator=None):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            metrics = step(state, batch, generator)
            torch.cuda.synchronize()
            side = int(batch["img"].shape[1])
            step_ms.setdefault(side, []).append(
                (time.perf_counter() - t0) * 1e3)
            held[side] = batch
            return metrics
        return timed

    def timed_evaluate(*args, **kw):
        t0 = time.perf_counter()
        out = evaluate(*args, **kw)
        evals.append((time.perf_counter() - t0, out))
        return out

    set_tf32(False)
    tcs.make_train_step, tcs.evaluate_multihand_pck = (timed_make_step,
                                                       timed_evaluate)
    try:
        zero_counts()
        t0 = time.perf_counter()
        state = tcs.main(["--cfg", path, "--cd-prob", "1.0", "--seed",
                          str(SEED), "--device", str(dev)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        read_counts(rows, "multihand:train_center_simdr",
                    {"moments": (n_full + n_half) * steps,
                     "blur_log": 2 * val_batches}, {"blur_log": "general"})
    finally:
        tcs.make_train_step, tcs.evaluate_multihand_pck = make_step, evaluate
    size = cfg.DATASET.image_size[0]
    full, half = step_ms.get(size, []), step_ms.get(size // 2, [])
    if not (state.step == 2 * steps and len(full) == len(half) == steps):
        raise AssertionError(f"train_center_simdr took {state.step} steps "
                             f"({len(full)} full, {len(half)} half)")
    if not all(torch.isfinite(p).all() for p in state.model.parameters()):
        raise AssertionError("train_center_simdr left non-finite parameters")
    run = os.path.join(root, "run_multihand", "freihand", "mynet_stacked",
                       str(cfg.ID))
    if not os.path.exists(os.path.join(run, "checkpoint.pt")):
        raise AssertionError("train_center_simdr wrote no checkpoint.pt")
    eval_s, metrics = evals[0]
    if len(evals) != 1 or not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"evaluate_multihand_pck: {evals}")
    log(f"multihand: tools/train_center_simdr.main, 1 epoch of {steps} steps "
        f"of B={B} at {size}x{size} each followed by its cycle-detection step "
        f"at {size // 2}x{size // 2} (--cd-prob 1.0), and a val pass of "
        f"{val_batches} batches: {wall:.2f} s with model build, loaders and "
        f"checkpoints; moments {n_full} + {n_half} per step pair; ms/step "
        f"(synchronized) full {statistics.median(full[1:]):.3f} median of "
        f"steps 2-{steps} ({[round(v, 3) for v in full]}), half "
        f"{statistics.median(half[1:]):.3f} ({[round(v, 3) for v in half]}); "
        f"evaluate_multihand_pck {eval_s * 1e3:.1f} ms wall: {metrics} "
        f"({card_line()})")
    # where a step's time goes: one more step of each resolution, on a batch
    # of the run, under the profiler
    trainer = types.SimpleNamespace(train_step=make_step(dev))
    for side, n_sites in ((size, n_full), (size // 2, n_half)):
        profile_step(trainer, state, held[side],
                     f"exp 16 at {side}x{side}, TF32 off",
                     {"moments_kernel": n_sites, "chan_merge": 0})
    return path


def multihand_demo(dev, rows: dict, root: str, region_cfg: str,
                   topdown_cfg: str) -> None:
    """``tools/demo.main`` on ``MULTIHAND_FRAMES`` seeded images, each main
    path counted from 0: the region branch on ``region_cfg``'s checkpoint
    with ``--max-hands`` (``blur_log`` twice a frame, general path), the
    top-down branch on ``topdown_cfg``'s run (once a frame, fast path), and
    SRHandNet's ``--pyramid`` (no kernel); ms per frame from the demo's own
    frame loop."""
    from PIL import Image

    from litehandnet_tpu_torch.tools import demo

    frames = os.path.join(root, "frames")
    os.makedirs(frames, exist_ok=True)
    rng = np.random.RandomState(SEED + 12)
    inputs = []
    for i in range(MULTIHAND_FRAMES):
        low = rng.randint(0, 256, (7, 7, 3)).astype(np.uint8)
        field = np.asarray(Image.fromarray(low).resize(
            (MULTIHAND_FRAME, MULTIHAND_FRAME), Image.BILINEAR), np.float32)
        pixels = np.clip(field + rng.normal(0, 12, field.shape), 0, 255)
        inputs.append(os.path.join(frames, f"frame_{i}.png"))
        Image.fromarray(pixels.astype(np.uint8)).save(inputs[-1])
    n = MULTIHAND_FRAMES
    iter_frames = demo.iter_frames
    for label, cfg, extra, expected, paths in (
            ("region", region_cfg, ["--max-hands", str(MULTIHAND_MAX_HANDS)],
             {"blur_log": 2 * n}, {"blur_log": "general"}),
            ("topdown", topdown_cfg, [], {"blur_log": n}, {"blur_log": "fast"}),
            ("pyramid", PYRAMID_EXPERIMENT,
             ["--pyramid", "--max-hands", str(MULTIHAND_MAX_HANDS)], {}, None)):
        frame_ms = []

        def timed_frames(paths_):
            for item in iter_frames(paths_):
                t0 = time.perf_counter()
                yield item
                frame_ms.append((time.perf_counter() - t0) * 1e3)

        out_dir = os.path.join(root, f"demo_{label}")
        demo.iter_frames = timed_frames
        try:
            zero_counts()
            t0 = time.perf_counter()
            written = demo.main(["--cfg", cfg, "--inputs", *inputs,
                                 "--out-dir", out_dir, "--device", str(dev),
                                 *extra])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            read_counts(rows, f"multihand:demo_{label}", expected, paths)
        finally:
            demo.iter_frames = iter_frames
        if len(written) != n or not all(os.path.getsize(w) for w in written):
            raise AssertionError(f"demo {label} wrote {written}")
        log(f"multihand: tools/demo {label} ({cfg}) on {n} frames of "
            f"{MULTIHAND_FRAME}x{MULTIHAND_FRAME}: {wall:.2f} s with model "
            f"build; ms per frame (forward, decode, drawing, PNG write) median "
            f"{statistics.median(frame_ms[1:]):.3f} of frames 2-{n} (first "
            f"{frame_ms[0]:.3f}) ({card_line()})")


def multihand_scenes(B: int, M: int, seed: int, size=256, hm=64, K=21,
                     exact: bool = False):
    """Seeded multi-hand scenes: 1 to M hands an image (M with ``exact``),
    hand m in quadrant
    m with a jittered center and a box of 48-88 px (at size 256, scaled with
    the size); region maps (the center
    Gaussians summed, the w/h ratio patches) ``[B, hm, hm, 3]`` and
    unbiased Gaussian keypoint maps (the maximum over hands) ``[B, hm, hm,
    K]``; the boxes ``[B, M, 4]`` (cx, cy, w, h) and keypoints ``[B, M, K,
    3]`` (a slot past an image's hands is 0), and the hands per image."""
    from litehandnet_tpu_torch.ops.encode import msra_heatmaps, region_map

    rng = np.random.RandomState(seed)
    n_hands = rng.randint(1, M + 1, B)
    if exact:
        n_hands[:] = M
    region = torch.zeros(B, 3, hm, hm)
    kpt = torch.zeros(B, K, hm, hm)
    boxes = np.zeros((B, M, 4), np.float32)
    kpts = np.zeros((B, M, K, 3), np.float32)
    quads = [(0.25, 0.25), (0.75, 0.25), (0.25, 0.75), (0.75, 0.75)]
    for m in range(M):
        present = (n_hands > m).astype(np.float32)
        c = (np.array(quads[m % 4]) + rng.uniform(-12, 12, (B, 2)) / 256) * size
        wh = rng.uniform(48, 88, (B, 2)) * (size / 256)
        xywh = np.concatenate([c - wh / 2, wh], 1).astype(np.float32)
        mask = torch.from_numpy(present)[:, None, None, None]
        region += region_map(torch.from_numpy(xywh), (size, size), (hm, hm),
                             2.0) * mask
        joints = (c[:, None] + rng.uniform(-0.3, 0.3, (B, K, 2)) * wh[:, None]
                  ).astype(np.float32)
        target, _ = msra_heatmaps(torch.from_numpy(joints), torch.ones(B, K),
                                  (size, size), (hm, hm), 2.0, unbiased=True)
        kpt = torch.maximum(kpt, target * mask)
        boxes[:, m] = np.concatenate([c, wh], 1) * present[:, None]
        kpts[:, m, :, :2] = joints * present[:, None, None]
        kpts[:, m, :, 2] = present[:, None]
    return (region.permute(0, 2, 3, 1).contiguous(),
            kpt.permute(0, 2, 3, 1).contiguous(), boxes, kpts, n_hands)


def multihand_parser(dev, rows: dict, cfg) -> None:
    """``ResultParser`` on the card equals the CPU on ``multihand_scenes``
    (B = 32, M = 4): the same boxes within ``PARSER_PX_TOL`` px and
    confidences exactly; keypoints of the same boxes within
    ``PARSER_PX_TOL`` px and scores exactly; the same PCK and AP, which
    find every hand (AP50 1.0, PCK above 0.9). One main path, counted:
    ``blur_log`` twice (the centers, then the keypoints) on its general
    path at 19 taps."""
    from litehandnet_tpu_torch.eval.result_parser import ResultParser

    B, M = MULTIHAND_SCENES, MULTIHAND_MAX_HANDS
    region, kpt, gt_boxes, gt_kpts, n_hands = multihand_scenes(
        B, M, SEED + 5, cfg.DATASET.image_size[0], cfg.DATASET.heatmap_size[0],
        int(cfg.DATASET.num_joints))
    kw = dict(cd_enabled=False, max_num_bbox=M)
    cpu = ResultParser(cfg, device="cpu", **kw)
    card = ResultParser(cfg, device=dev, **kw)
    want_boxes = cpu.get_pred_bbox(region)
    want = cpu.get_group_keypoints(None, kpt, want_boxes)
    region_d, kpt_d = region.to(dev), kpt.to(dev)
    zero_counts()
    boxes = card.get_pred_bbox(region_d)
    got = card.get_group_keypoints(None, kpt_d, want_boxes)
    read_counts(rows, "multihand:parser", {"blur_log": 2},
                {"blur_log": "general"})
    box_err = float(np.abs(boxes[..., :4] - want_boxes[..., :4]).max())
    conf_same = np.array_equal(boxes[..., 4], want_boxes[..., 4])
    kpt_err = float(np.abs(got[..., :2] - want[..., :2]).max())
    score_same = np.array_equal(got[..., 2], want[..., 2])
    found = (boxes[..., 4] > 0).sum(1)
    gt_list = [g[:k].tolist() for g, k in zip(gt_boxes, n_hands)]
    pck = card.evaluate_pck(got, gt_kpts, gt_boxes)
    pck_cpu = cpu.evaluate_pck(want, gt_kpts, gt_boxes)
    ap = card.evaluate_ap(list(boxes), gt_list)
    ap_cpu = cpu.evaluate_ap(list(want_boxes), gt_list)
    log(f"multihand: ResultParser card vs CPU on {B} scenes of 1-{M} hands "
        f"({int(n_hands.sum())} hands, {int(found.sum())} boxes found): boxes "
        f"max_abs_err {box_err:.3g} px (tolerance {PARSER_PX_TOL}), "
        f"confidences equal {conf_same}; keypoints {kpt_err:.3g} px, scores "
        f"equal {score_same}; PCK {pck} (CPU {pck_cpu}), AP50/AP {ap} (CPU "
        f"{ap_cpu})")
    if not (box_err <= PARSER_PX_TOL and conf_same and kpt_err <= PARSER_PX_TOL
            and score_same and pck == pck_cpu and ap == ap_cpu):
        raise AssertionError("ResultParser on the card disagrees with the CPU")
    if not (np.array_equal(found, n_hands) and ap[0] == 1.0 and pck > 0.9):
        raise AssertionError(f"ResultParser missed hands: found {found}, "
                             f"AP {ap}, PCK {pck}")


def phase_multihand(dev, rows: dict, sites: tuple, disk_path: str) -> None:
    """The Gen-1 multi-hand path at exp 16's full width (seed-0 weights):
    forward and float64 step card = CPU, ``tools/train_center_simdr`` with
    the cycle-detection pass, ``tools/demo`` on its three branches and
    ``ResultParser`` card = CPU, each counted."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_disk")
    cfg = get_config(MULTIHAND_EXPERIMENT)
    n_full, n_half = (len(s) for s in sites)
    counted = sum(isinstance(m, torch.nn.BatchNorm2d) and m.num_features % 128 == 0
                  for m in get_model(cfg, device="cpu").modules())
    log(f"multihand: {MULTIHAND_EXPERIMENT}: {counted} BatchNorms with C % "
        f"128 == 0 in the model, {n_full} / {n_half} moments sites per "
        f"forward at full / half resolution")
    if not n_full == n_half == counted:
        raise AssertionError("moments sites differ from the model's count")
    wall = {}

    def part(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        wall[label] = round(time.perf_counter() - t0, 1)
        return out

    base = randomize_(get_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    part("forward", multihand_forward, dev, cfg, base)
    part("step64", zoo_step64, dev, cfg, base)
    del base
    path = part("train", multihand_train, dev, rows, root, n_full, n_half)
    part("demo", multihand_demo, dev, rows, root, path, disk_path)
    part("parser", multihand_parser, dev, rows, cfg)
    log(f"multihand: wall s {wall}, {sum(wall.values()):.1f} s")


# -- phase 13: the rest of the zoo ------------------------------------------

YOLO_CONFIG = "yolov6/cwb_hand_od"
ATT_CONFIG = "atthandnet/freihand_224"
# the classifier has no experiment: MobileNetV2 arch, 1000 classes, 224^2
CLASSIFIER = dict(MODEL=dict(name="classifier", num_classes=1000,
                             widen_factor=1.0),
                  DATASET=dict(num_joints=21, image_size=[224, 224],
                               heatmap_size=[56, 56]))
REST_FORWARD_BATCH = 8      # atthandnet's card vs CPU forward
REST_TIMED_STEPS = 3        # timed atthandnet steps after the counted one


def rest_configs() -> dict:
    from litehandnet_tpu_torch.config import config_from_dict, get_config

    return {"yolov6": get_config(YOLO_CONFIG),
            "atthandnet": get_config(ATT_CONFIG),
            "classifier": config_from_dict(CLASSIFIER)}


def close_to(got, want, what: str, tol: float = 1e-4) -> float:
    """Fails unless ``got`` (on the card) is finite and within ``tol`` of
    ``want``'s largest magnitude (at least 1); returns the error."""
    got = got.cpu()
    scale = max(1.0, float(want.abs().max()))
    err = float((got - want).abs().max())
    if not (torch.isfinite(got).all() and got.shape == want.shape
            and err <= tol * scale):
        raise AssertionError(f"{what}: max_abs_err {err:.3g} against "
                             f"{tol} x {scale:.3g}")
    return err


def train_forward_counted(dev, model, x, rows, path: str, n_sites: int):
    """One train-mode (batch statistics) float32 forward of ``model`` on
    the card with the counts set to 0 just before and read just after
    (``moments`` once per 128-channel BatchNorm)."""
    model = model.to(dev, memory_format=torch.channels_last).train()
    x = x.to(dev).contiguous(memory_format=torch.channels_last)
    zero_counts()
    with torch.no_grad():
        out = model(x)
    read_counts(rows, path, {"moments": n_sites})
    return out


def calibrate_bn_(model, x) -> None:
    """Sets every BatchNorm's running statistics to its batch statistics on
    ``x`` (one train-mode forward at momentum 1), so that the eval graph
    normalizes ``x`` as the train graph does: random weights with random
    statistics otherwise grow the activations layer by layer."""
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm

    bns = [m for m in model.modules() if isinstance(m, TorchBatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.momentum = 1.0
    model.train()
    with torch.no_grad():
        model(x)
    for m, momentum in zip(bns, momenta, strict=True):
        m.momentum = momentum
    model.eval()


def rest_yolov6(dev, cfg, rows: dict, n_sites: int) -> None:
    """YOLOv6 at width 0.25, depth 0.33, 256^2, B=32, with seeded weights
    and BatchNorm statistics calibrated on the batch it evaluates (so that
    its logits stay in the range of a trained detector, well inside the
    clip at 30): the card's eval rows equal the CPU's, every column within
    1e-4 of the column's max, for the train and the deploy graph, as do the
    raw maps; deploy = train on the card; and a counted train-mode forward
    (raw maps)."""
    import copy

    from litehandnet_tpu_torch.models import fuse_params, get_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    set_tf32(False)
    size = cfg.DATASET.image_size[0]
    train = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED))
    x = torch.randn(BATCH_TRAIN, 3, size, size,
                    generator=torch.Generator().manual_seed(1))
    calibrate_bn_(train, x)
    deploy = get_model(cfg, deploy=True, device="cpu")
    deploy.load_state_dict(fuse_params(train))
    xd = x.to(dev).contiguous(memory_format=torch.channels_last)

    def rows_and_maps(model, inp):
        with torch.no_grad():
            model.eval()
            out = model(inp)
            model.detect.training = True   # raw maps, BatchNorms in eval
            maps = model(inp)
            model.detect.training = False
        return out, maps

    errs, card = {}, {}
    for label, model in (("train", train), ("deploy", deploy)):
        cpu_rows, cpu_maps = rows_and_maps(model, x)
        card[label] = rows_and_maps(
            copy.deepcopy(model).to(dev, memory_format=torch.channels_last),
            xd)
        got_rows, got_maps = card[label]
        if got_rows.shape != (BATCH_TRAIN, sum((size // s) ** 2
                                               for s in (8, 16, 32)), 6):
            raise AssertionError(f"yolov6 rows {tuple(got_rows.shape)}")
        errs[label] = [close_to(got_rows[..., c], cpu_rows[..., c],
                                f"yolov6 {label} rows column {c}")
                       for c in range(got_rows.shape[-1])]
        errs[label] += [close_to(g, w, f"yolov6 {label} raw map")
                        for g, w in zip(got_maps, cpu_maps, strict=True)]
        if not torch.isfinite(got_rows).all():
            raise AssertionError(f"yolov6 {label}: non-finite rows")
    logits = max(float(m.abs().max()) for m in card["train"][1])
    if not logits < 30.0:
        raise AssertionError(f"yolov6: a raw logit of {logits:.3g} reaches "
                             "the clip of the w, h columns at 30")
    dep = [close_to(card["deploy"][0][..., c], card["train"][0][..., c].cpu(),
                    f"yolov6 deploy vs train column {c}")
           for c in range(card["train"][0].shape[-1])]
    dep += [close_to(g, w.cpu(), "yolov6 deploy vs train raw map")
            for g, w in zip(card["deploy"][1], card["train"][1])]
    raw = train_forward_counted(dev, train, x, rows, "train:yolov6", n_sites)
    if [tuple(m.shape) for m in raw] != [(BATCH_TRAIN, 6, size // s, size // s)
                                         for s in (8, 16, 32)]:
        raise AssertionError(f"yolov6 raw maps {[m.shape for m in raw]}")
    log(f"rest yolov6: B={BATCH_TRAIN} {size}x{size} f32, BatchNorm "
        f"statistics calibrated on the batch, largest |raw logit| "
        f"{logits:.3g}; card vs CPU max_abs_err per row column (cx, cy, w, "
        f"h, obj, cls) and raw map: train graph "
        f"{[f'{e:.3g}' for e in errs['train']]}, deploy graph "
        f"{[f'{e:.3g}' for e in errs['deploy']]}; deploy vs train on the card "
        f"{max(dep):.3g} (tolerance 1e-4 x max); train-mode forward moments "
        f"{n_sites}")


def coord_batch(size: int, B: int, seed: int, device) -> dict:
    """AttHandNet's batch made from a seed on ``device``: unit-normal
    images, coordinate targets in [0, 1], about 10% of joints invisible."""
    gen = torch.Generator(device).manual_seed(seed)
    return {"img": torch.randn(B, size, size, 3, generator=gen, device=device),
            "target": torch.rand(B, 21, 2, generator=gen, device=device),
            "target_weight": (torch.rand(B, 21, generator=gen,
                                         device=device) > 0.1).float()}


def rest_atthandnet(dev, cfg, rows: dict, n_sites: int) -> None:
    """AttHandNet at 224^2: the card's forward equals the CPU's at B=8, a
    float64 ``make_train_step`` on the card equals the CPU's at B=2 on
    coordinate targets in [0, 1] with ``target_weight``, then a counted
    float32 step at the config's batch (``moments`` at transition6 and 7),
    its ms/step and peak memory."""
    import copy

    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.utils.weights import randomize_

    set_tf32(False)
    size = cfg.DATASET.image_size[0]
    base = randomize_(get_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    x = torch.randn(REST_FORWARD_BATCH, 3, size, size,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = base.eval()(x)
        got = copy.deepcopy(base).to(dev, memory_format=torch.channels_last)(
            x.to(dev).contiguous(memory_format=torch.channels_last))
    err = close_to(got, want, "atthandnet forward")
    zoo_step64(dev, cfg, base, coord_batch(size, 2, 11, dev))

    B = int(cfg.TRAIN.batch_per_gpu)
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    model = copy.deepcopy(base)
    set_dropout(model, 0.0)
    state = state_on(dev, model, cfg, tx)
    step = make_train_step(dev)
    batches = [coord_batch(size, B, 20 + i, dev) for i in range(2)]
    step(state, batches[1])                      # warm-up, not counted
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    zero_counts()
    metrics = step(state, batches[0])
    read_counts(rows, "train:atthandnet", {"moments": n_sites})
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    step_ms = []
    for i in range(REST_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, batches[i % 2])
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    if not math.isfinite(float(metrics["loss"])):
        raise AssertionError(f"atthandnet loss {metrics}")
    log(f"rest atthandnet: f32 card vs CPU forward B={REST_FORWARD_BATCH} "
        f"max_abs_err {err:.3g}; float32 step B={B}, TF32 off: "
        f"{statistics.median(step_ms):.3f} ms/step median of "
        f"{REST_TIMED_STEPS} ({[round(v, 3) for v in step_ms]}), "
        f"{B / statistics.median(step_ms) * 1e3:.1f} img/s, peak device "
        f"memory of a step {peak:.3f} GiB; moments {n_sites} a step "
        f"({card_line()})")


def rest_classifier(dev, cfg, rows: dict, n_sites: int) -> None:
    """The MobileNetV2 classifier, 1000 classes, 224^2, B=32: the card's
    forward equals the CPU's; a counted train-mode forward (``moments`` at
    each 128-channel BatchNorm: C = 384, 1280 among them)."""
    import copy

    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    set_tf32(False)
    size = cfg.DATASET.image_size[0]
    base = randomize_(get_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    x = torch.randn(BATCH_TRAIN, 3, size, size,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = base.eval()(x)
        got = copy.deepcopy(base).to(dev, memory_format=torch.channels_last)(
            x.to(dev).contiguous(memory_format=torch.channels_last))
    err = close_to(got, want, "classifier forward")
    out = train_forward_counted(dev, base, x, rows, "train:classifier",
                                n_sites)
    if out.shape != (BATCH_TRAIN, 1000) or not torch.isfinite(out).all():
        raise AssertionError(f"classifier train-mode output {out.shape}")
    log(f"rest classifier: f32 card vs CPU B={BATCH_TRAIN} max_abs_err "
        f"{err:.3g} (tolerance 1e-4 x max); train-mode forward moments "
        f"{n_sites}")


def rest_rep_blocks(dev) -> None:
    """``rep_blocks.ConvBnAct`` fused by ``fuse_conv_bn`` equals its train
    graph in eval mode on the card (float32, TF32 off)."""
    from litehandnet_tpu_torch.models import rep_blocks
    from litehandnet_tpu_torch.utils.weights import randomize_

    set_tf32(False)
    train = randomize_(rep_blocks.ConvBnAct(64, 128, 3),
                       torch.Generator().manual_seed(SEED)).to(dev).eval()
    deploy = rep_blocks.ConvBnAct(64, 128, 3, deploy=True).to(dev).eval()
    deploy.load_state_dict(rep_blocks.fuse_conv_bn(train))
    x = torch.randn(BATCH_TRAIN, 64, 64, 64, device=dev)
    with torch.no_grad():
        err = close_to(deploy(x), train(x).cpu(), "rep_blocks fused")
    log(f"rest rep_blocks: ConvBnAct fused vs train graph on the card "
        f"[{BATCH_TRAIN}, 64, 64, 64] max_abs_err {err:.3g}")


def rest_import(dev, rows: dict, disk_path: str) -> None:
    """A seeded ``litehandnet_msrb`` state dict written as a reference
    ``.pth`` with ``module.`` keys, imported by ``tools/import_checkpoint``;
    ``tools/test --load-best`` on the card (counted: ``blur_log`` once per
    batch) gives the metrics of the same weights saved directly; then
    ``tools/analyze_weights`` on the imported run covers every
    parameter."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.losses import get_loss
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.tools import analyze_weights, import_checkpoint
    from litehandnet_tpu_torch.tools import test as test_cli
    from litehandnet_tpu_torch.train.checkpoint import CheckpointManager, run_dir
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.train.state import TrainState
    from litehandnet_tpu_torch.utils.weights import randomize_

    set_tf32(False)
    base = get_config(disk_path)
    root = os.path.dirname(disk_path)
    paths = {}
    for run in ("import", "direct"):
        paths[run] = write_experiment_file(
            os.path.join(root, f"msrb_{run}.py"), MSRB_CONFIG, {
                "DATASET.train": dict(base.DATASET.train),
                "DATASET.val": dict(base.DATASET.val),
                "DATASET.test": dict(base.DATASET.val),
                "CHECKPOINT.save_root": os.path.join(root, f"run_{run}") + "/",
                "CHECKPOINT.resume": False, **DISK_EXTRA})
    cfg = get_config(paths["direct"])
    model = randomize_(get_model(cfg, device="cpu"),
                       torch.Generator().manual_seed(SEED + 5))
    pth = os.path.join(root, "msrb_reference.pth")
    torch.save({"epoch": 1, "min_val_loss": 0.5, "state_dict": {
        f"module.{k}": v for k, v in model.state_dict().items()}}, pth)
    import_checkpoint.main(["--cfg", paths["import"], "--pth", pth,
                            "--device", str(dev), "--slot", "best"])
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=1)
    CheckpointManager(run_dir(cfg), cfg).save(
        TrainState.create(model, get_loss(cfg), tx), epoch=1, best=True)
    n_batches = -(-DISK_RECORDS["val"] // EVAL_BATCH)
    zero_counts()
    imported = test_cli.main(["--cfg", paths["import"], "--load-best",
                              "--device", str(dev)])
    read_counts(rows, "test:import_checkpoint", {"blur_log": n_batches},
                {"blur_log": "fast"})
    direct = test_cli.main(["--cfg", paths["direct"], "--load-best",
                            "--device", str(dev)])
    diff = {k: abs(float(imported[k]) - float(direct[k])) for k in direct}
    assert_metrics_close(imported, direct,
                         visible_joints(cfg.DATASET.val.ann_file),
                         "import_checkpoint round trip")
    out = os.path.join(root, "msrb_weights.json")
    hists = analyze_weights.main(["--cfg", paths["import"], "--load-best",
                                  "--out", out, "--top", "3", "--device",
                                  str(dev)])
    names = {n for n, _ in model.named_parameters()}
    if set(hists) != names:
        raise AssertionError(f"analyze_weights covers {len(hists)} of "
                             f"{len(names)} parameters")
    log(f"rest import_checkpoint: tools/test --load-best on the imported run "
        f"{ {k: round(float(v), 6) for k, v in imported.items()} }, on the "
        f"same weights saved directly, difference {diff}; analyze_weights "
        f"covers all {len(names)} parameters")


def phase_rest(dev, rows: dict, rest_sites: dict, disk_path: str) -> None:
    """YOLOv6, AttHandNet, the classifier and ``rep_blocks`` on the card
    (random weights from ``SEED``, float32, TF32 off), and the
    ``import_checkpoint`` round trip."""
    configs = rest_configs()
    wall = {}
    for label, fn, args in (
            ("yolov6", rest_yolov6, (configs["yolov6"], rows,
                                     len(rest_sites["yolov6"]))),
            ("atthandnet", rest_atthandnet, (configs["atthandnet"], rows,
                                             len(rest_sites["atthandnet"]))),
            ("classifier", rest_classifier, (configs["classifier"], rows,
                                             len(rest_sites["classifier"]))),
            ("rep_blocks", rest_rep_blocks, ()),
            ("import_checkpoint", rest_import, (rows, disk_path))):
        t0 = time.perf_counter()
        fn(dev, *args)
        wall[label] = round(time.perf_counter() - t0, 1)
    log(f"rest: wall s {wall}")


# -- phase 14: the rest of the package --------------------------------------

REST_SCENES = 32          # B of the HeatmapParser check, two hands an image
REST_PX_TOL = 1e-3        # px, card vs CPU boxes and keypoints
REST_HAND_PX = 12.0       # px, mean keypoint error of a parsed hand
PHOTO_TOL = 1e-3 * 255    # card vs CPU warped and mosaicked images
PHOTO_JOINT_TOL = 1e-3    # px
PHOTO_SIZE = 256          # px, the photometric batch's images (and S)


def hand_tags(boxes, n_hands, size: int, hm: int) -> torch.Tensor:
    """Shared tag maps ``[B, hm, hm, 1]`` of ``multihand_scenes``: hand m's
    value 1 + 4m where a cell is within 0.7 of the hand's w, h of its
    center, 0 elsewhere (the scenes of tests/test_torch_heatmap_parser.py)."""
    B, M = boxes.shape[:2]
    ys, xs = (g * (size / hm) for g in np.mgrid[0:hm, 0:hm])
    tag = np.zeros((B, hm, hm), np.float32)
    for m in range(M):
        cx, cy, w, h = (boxes[:, m, i][:, None, None] for i in range(4))
        inside = ((np.abs(xs - cx) < w * 0.7) & (np.abs(ys - cy) < h * 0.7)
                  & (n_hands > m)[:, None, None])
        tag = np.where(inside, np.float32(1.0 + 4.0 * m), tag)
    return torch.from_numpy(tag[..., None])


def max_err(got, want) -> float:
    got = got.detach().cpu() if torch.is_tensor(got) else torch.as_tensor(got)
    want = want.detach().cpu() if torch.is_tensor(want) else torch.as_tensor(want)
    return float((got.double() - want.double()).abs().max())


def rest_heatmap_parser(dev, rows: dict, cfg, card: str) -> None:
    """``HeatmapParser.parse`` on the card equals the CPU on seeded scenes
    of two hands an image (B = 32, 256² input, 64² maps, shared tags):
    boxes and keypoints within ``REST_PX_TOL`` px, confidences and tags
    exactly, both hands of every image found and their keypoints within
    ``REST_HAND_PX`` px of the truth; no kernel launched (its boxes are read
    at their raw cells). ``HeatmapParserSH.parse_single`` the same way;
    then the parse's device and host ms per batch."""
    from litehandnet_tpu_torch.eval.heatmap_parser import (
        HeatmapParser,
        HeatmapParserSH,
    )

    B, M = REST_SCENES, 2
    size, hm = cfg.DATASET.image_size[0], cfg.DATASET.heatmap_size[0]
    region, kpt, gt_boxes, gt_kpts, n_hands = multihand_scenes(
        B, M, SEED + 7, size, hm, int(cfg.DATASET.num_joints), exact=True)
    maps = (region[..., :1].contiguous(), region[..., 1:3].contiguous(), kpt,
            hand_tags(gt_boxes, n_hands, size, hm))
    cpu = HeatmapParser(cfg, max_num_bbox=M, device="cpu")
    on_card = HeatmapParser(cfg, max_num_bbox=M, device=dev)
    want_boxes, want_kpts = cpu.parse(*maps)
    maps_d = [m.to(dev) for m in maps]
    zero_counts()
    boxes, kpts = on_card.parse(*maps_d)
    read_counts(rows, "rest:heatmap_parser", {})
    box_err = float(np.abs(boxes[..., :4] - want_boxes[..., :4]).max())
    kpt_err = float(np.abs(kpts[..., :2] - want_kpts[..., :2]).max())
    same = (np.array_equal(boxes[..., 4], want_boxes[..., 4])
            and np.array_equal(kpts[..., 2:], want_kpts[..., 2:]))
    found = (boxes[..., 4] > 0).sum(1)
    stride = size / hm
    hand_err = []
    for b in range(B):
        for m in range(M):
            d = np.linalg.norm(boxes[b, :, :2] - gt_boxes[b, m, :2], axis=1)
            j = int(d.argmin())
            hand_err.append(float(np.abs(kpts[b, j, :, :2] * stride
                                         - gt_kpts[b, m, :, :2]).mean()))
    log(f"rest: HeatmapParser card vs CPU on {B} scenes of {M} hands: boxes "
        f"max_abs_err {box_err:.3g} px, keypoints {kpt_err:.3g} px "
        f"(tolerance {REST_PX_TOL}), confidences and tags equal {same}; "
        f"{int(found.sum())} of {B * M} hands found, mean keypoint error per "
        f"hand up to {max(hand_err):.3g} px (bound {REST_HAND_PX})")
    if not (box_err <= REST_PX_TOL and kpt_err <= REST_PX_TOL and same):
        raise AssertionError("HeatmapParser on the card disagrees with the CPU")
    if not ((found == M).all() and max(hand_err) < REST_HAND_PX):
        raise AssertionError(f"HeatmapParser missed hands: {found}, "
                             f"{max(hand_err)} px")

    single_cpu = HeatmapParserSH(cfg, device="cpu").parse_single(kpt)
    sh = HeatmapParserSH(cfg, device=dev)
    zero_counts()
    single = sh.parse_single(maps_d[2])
    read_counts(rows, "rest:heatmap_parser_single", {})
    single_err = float(np.abs(single - single_cpu).max())
    log(f"rest: HeatmapParserSH.parse_single card vs CPU max_abs_err "
        f"{single_err:.3g} px (tolerance {REST_PX_TOL})")
    if not single_err <= REST_PX_TOL:
        raise AssertionError("parse_single on the card disagrees with the CPU")

    # a parse is a few hundred small kernels: one call per event pair
    parse = lambda: on_card.parse_tensors(*maps_d)   # noqa: E731
    n_kernels, busy_ms, _ = profiled_kernels(parse)
    ms = device_ms(parse, n=1)
    lat = latency_ms(parse, 10)
    log(f"rest: HeatmapParser.parse per batch of {B}: device {ms:.4f} ms, "
        f"{n_kernels} kernels ({busy_ms:.4f} ms busy under the profiler), "
        f"latency from an idle card {lat:.4f} ms; {card}")


def rest_centermap(dev) -> None:
    """``pool_nms`` and ``decode_bbox`` on the card equal the CPU on the
    center maps of ``multihand_scenes`` with seeded size and offset maps."""
    from litehandnet_tpu_torch.utils.centermap import decode_bbox, pool_nms

    region, *_ = multihand_scenes(REST_SCENES, 4, SEED + 8)
    gen = torch.Generator().manual_seed(SEED + 8)
    heat = region[..., :1].contiguous()
    wh = torch.rand(heat.shape[:3] + (2,), generator=gen) * 16
    off = torch.rand(heat.shape[:3] + (2,), generator=gen)
    nms_same = torch.equal(pool_nms(heat.to(dev)).cpu(), pool_nms(heat))
    got = decode_bbox(heat.to(dev), wh.to(dev), off.to(dev), 0.3, 100)
    want = decode_bbox(heat, wh, off, 0.3, 100)
    err = max_err(got, want)
    log(f"rest: pool_nms card = CPU {nms_same}; decode_bbox [{REST_SCENES}, "
        f"100, 5] card vs CPU max_abs_err {err:.3g} (tolerance 1e-6), "
        f"{int((want[..., 4] > 0).sum())} boxes above 0.3")
    if not (nms_same and err <= 1e-6 and got.shape == (REST_SCENES, 100, 5)):
        raise AssertionError("centermap on the card disagrees with the CPU")


def smooth_batch(B: int, size: int, seed: int) -> torch.Tensor:
    """``[B, size, size, 3]`` float32 images in [0, 255]: a ramp and three
    broad Gaussians per channel, so a float32 ulp of a sampling coordinate
    moves a pixel by far less than ``PHOTO_TOL``."""
    g = torch.Generator().manual_seed(seed)
    ys, xs = torch.meshgrid(torch.arange(size, dtype=torch.float32),
                            torch.arange(size, dtype=torch.float32),
                            indexing="ij")
    u = lambda *shape: torch.rand(*shape, 1, 1, generator=g)  # noqa: E731
    acc = u(B, 3) * 40 + u(B, 3) * 0.3 * xs
    for _ in range(3):
        cx, cy, s = u(B, 3) * size, u(B, 3) * size, size / 8 + u(B, 3) * size / 5
        acc = acc + (50 + 100 * u(B, 3)) * torch.exp(
            -((xs - cx) ** 2 + (ys - cy) ** 2) / (2 * s * s))
    return acc.clamp(0, 255).permute(0, 2, 3, 1).contiguous()


def rest_photometric(dev, card: str) -> None:
    """``homography_warp`` and ``mosaic4`` on a B = 32 batch of 256² images
    on the card equal the CPU within ``PHOTO_TOL`` (of 255), joints within
    ``PHOTO_JOINT_TOL`` px (TF32 off); the other ops too. Device ms per
    batch."""
    from litehandnet_tpu_torch.ops import photometric as P

    set_tf32(False)
    B, S, K = BATCH_TRAIN, PHOTO_SIZE, 21
    gen = torch.Generator().manual_seed(SEED + 9)
    imgs = smooth_batch(B, S, SEED + 9)
    joints = torch.rand(B, K, 2, generator=gen) * S
    mats = torch.eye(3).repeat(B, 1, 1)
    mats = mats + torch.randn(B, 3, 3, generator=gen) * 0.05
    mats[:, 2, :2] = torch.randn(B, 2, generator=gen) * 2e-3
    mats[:, :2, 2] = (torch.rand(B, 2, generator=gen) - 0.5) * 10
    mats[:, 2, 2] = 1.0
    d = [t.to(dev) for t in (imgs, joints, mats)]
    errs = {}
    got, want = P.homography_warp(*d), P.homography_warp(imgs, joints, mats)
    errs["homography_warp"] = (max_err(got[0], want[0]),
                               max_err(got[1], want[1]))
    got = P.central_scale(d[0], d[1], 1.3)
    want = P.central_scale(imgs, joints, 1.3)
    errs["central_scale"] = (max_err(got[0], want[0]), max_err(got[1], want[1]))
    flip = list(range(K))[::-1]
    got = P.horizontal_flip(d[0], d[1], flip)
    want = P.horizontal_flip(imgs, joints, flip)
    errs["horizontal_flip"] = (max_err(got[0], want[0]),
                               max_err(got[1], want[1]))
    errs["adjust_gamma"] = (max_err(P.adjust_gamma(d[0], 0.7),
                                    P.adjust_gamma(imgs, 0.7)), 0.0)
    errs["adjust_sigmoid"] = (max_err(P.adjust_sigmoid(d[0], 0.4, 6.0),
                                      P.adjust_sigmoid(imgs, 0.4, 6.0)), 0.0)
    quads = torch.randint(0, 256, (B, 4, S, S, 3), generator=gen,
                          dtype=torch.uint8)
    qj = torch.rand(B, 4, K, 2, generator=gen) * S
    qv = torch.ones(B, 4, K)
    center = P.draw_mosaic_centers(S, (B,), gen)
    qd = [t.to(dev) for t in (quads, qj, qv)]
    center_d = center.to(dev)
    for out_size in (S, 3 * S):           # below 2S (antialiased), above
        got = P.mosaic4(*qd, None, out_size, center=center_d)
        want = P.mosaic4(quads, qj, qv, None, out_size, center=center)
        errs[f"mosaic4 to {out_size}"] = (
            max_err(got[0], want[0]),
            max(max_err(got[1], want[1]), max_err(got[2], want[2])))
    ms = {"homography_warp": device_ms(lambda: P.homography_warp(*d), n=1),
          "mosaic4": device_ms(
              lambda: P.mosaic4(*qd, None, S, center=center_d), n=1)}
    log(f"rest: photometric card vs CPU (image max_abs_err of 255, joint px) "
        f"{ {k: (float(f'{a:.3g}'), float(f'{b:.3g}')) for k, (a, b) in errs.items()} } "
        f"(tolerance {PHOTO_TOL:.3g}, {PHOTO_JOINT_TOL}); device ms per batch "
        f"of {B} at {S}²: { {k: round(v, 4) for k, v in ms.items()} }; {card}")
    bad = [k for k, (a, b) in errs.items()
           if not (a <= PHOTO_TOL and b <= PHOTO_JOINT_TOL)]
    if bad:
        raise AssertionError(f"photometric ops on the card disagree: {bad}")


def rest_profiling(dev, rows: dict, cfg) -> None:
    """``utils/profiling.trace`` around one served LiteHandNet request
    (counted: ``blur_log`` once, fast path) holds the card's kernels, the
    fast ``blur_log`` among them; ``cost_analysis`` of the flagship's
    deploy forward counts what ``tools/benchmark`` counts; ``set_seeds``."""
    from litehandnet_tpu_torch.serve import Predictor, deploy_model
    from litehandnet_tpu_torch.tools.benchmark import flops_of
    from litehandnet_tpu_torch.utils import profiling

    size = cfg.DATASET.image_size[0]
    predictor = Predictor(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    images = torch.randint(0, 256, (BATCH, size, size, 3), dtype=torch.uint8,
                           generator=torch.Generator(device=dev).manual_seed(4),
                           device=dev)
    center = torch.full((BATCH, 2), size / 2, device=dev)
    scale_ = torch.full((BATCH, 2), size / 200.0, device=dev)
    predictor(images, center, scale_)        # warm-up, not counted
    trace_dir = os.path.join(profiling.DEFAULT_TRACE_DIR, "chip_smoke")
    zero_counts()
    with profiling.trace(trace_dir) as prof:
        preds, _ = predictor(images, center, scale_)
    read_counts(rows, "rest:traced_request", {"blur_log": 1},
                {"blur_log": "fast"})
    names = profiling.device_kernel_names(prof)
    n_blur = sum("blur_log_fast" in n for n in names)
    size_kb = os.path.getsize(os.path.join(trace_dir, "trace.json")) / 1024
    log(f"rest: profiling.trace of one request of B={BATCH}: {len(names)} "
        f"kernel events on the card, blur_log_fast {n_blur}; "
        f"{trace_dir}/trace.json {size_kb:.0f} KiB")
    if not (names and n_blur == 1 and torch.isfinite(preds).all()):
        raise AssertionError("the trace holds no card kernel, or no blur_log")
    model = deploy_model(cfg, seed=SEED, device=dev)
    x = torch.randn(1, 3, size, size, device=dev).contiguous(
        memory_format=torch.channels_last)
    cost = profiling.cost_analysis(model, x)
    bench = flops_of(model, x)
    top = sorted(cost["flops_by_operator"].items(), key=lambda kv: -kv[1])[:3]
    log(f"rest: cost_analysis of the flagship's deploy forward at 1x{size}²: "
        f"{cost['flops'] / 1e9:.4f} GFLOPs (tools/benchmark {bench / 1e9:.4f}),"
        f" by operator {top}")
    if not (cost["flops"] == bench > 0):
        raise AssertionError("cost_analysis disagrees with tools/benchmark")
    seed = profiling.set_seeds(SEED)
    if seed != SEED + 1:
        raise AssertionError(f"set_seeds gave {seed}")


def rest_native_choice(disk_path: str) -> None:
    """The loader's decoder choice: ``native.available()`` where libjpeg's
    header and ``g++`` are (this card's machine has no ``jpeglib.h``: False,
    and the loader decodes with cv2, every canvas equal to
    ``_load_image``'s); where it is True, the native batch keeps the Python
    geometry."""
    import shutil

    from litehandnet_tpu_torch import native
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.data.image_io import _load_image
    from litehandnet_tpu_torch.data.loader import DataLoader

    header = any(os.path.exists(os.path.join(d, "jpeglib.h"))
                 for d in ("/usr/include", "/usr/local/include"))
    gxx = shutil.which("g++") is not None
    available = native.available()
    try:
        import cv2
        backend = f"cv2 {cv2.__version__}"
    except ImportError:
        backend = "PIL"
    cfg = get_config(disk_path)
    with DataLoader(cfg, "val", batch_size=8, use_device_pipeline=False,
                    num_workers=2) as loader:
        batch = next(iter(loader.batches(0, prefetch=0)))
        records = [loader.dataset.db[i] for i in range(8)]
        use_native = loader.use_native
        want = [_load_image(r["image_file"], loader.canvas_hw,
                            center=r["center"], scale=r["scale"],
                            margin=loader.roi_margin) for r in records]
    same = all(np.array_equal(batch["img_raw"][i], w[0])
               and np.array_equal(batch["offset"][i], w[1])
               for i, w in enumerate(want))
    log(f"rest: native decoder available {available} (jpeglib.h "
        f"{header}, g++ {gxx}); DataLoader use_native {use_native}, "
        f"{'native' if use_native else backend} decode; canvases and "
        f"offsets equal to _load_image's {same}")
    if use_native != available or (not header and available):
        raise AssertionError("the loader's decoder choice is wrong")
    if not use_native and not same:
        raise AssertionError("the cv2 path's batch differs from _load_image")


def phase_rest_of_package(dev, rows: dict, disk_path: str) -> None:
    """The modules of the last slice: ``HeatmapParser`` (and the single-hand
    parser), ``centermap``, the photometric ops, ``utils/profiling`` and the
    loader's native/cv2 choice, on the card against the CPU."""
    from litehandnet_tpu_torch.config import get_config

    card = card_line()
    cfg = get_config()
    wall = {}
    for label, fn, args in (
            ("heatmap_parser", rest_heatmap_parser, (dev, rows, cfg, card)),
            ("centermap", rest_centermap, (dev,)),
            ("photometric", rest_photometric, (dev, card)),
            ("profiling", rest_profiling, (dev, rows, cfg)),
            ("native", rest_native_choice, (disk_path,))):
        t0 = time.perf_counter()
        fn(*args)
        wall[label] = round(time.perf_counter() - t0, 1)
    log(f"rest of the package: wall s {wall}")


# -- phase 15: data parallel on one card ---------------------------------------

DP_RANKS = 2              # gloo ranks on cuda:0 in the two-rank steps
DP_BATCH = 32             # global rows of those steps (16 a rank)
DP_TIMED_STEPS = 10       # timed steps per setting, after 3 warm-up steps
DP_LOSS_RTOL = 1e-6       # world-1 vs one-process first-step loss
DP_PARAM_TOL = 1e-5       # world-1 vs one-process final weights (abs)
DP_STEP_RTOL = 1e-5       # two-rank SyncBN step vs one process: the loss
DP_STATS_RTOL = 1e-5      # per-rank BN: running statistics vs the ranks' mean
DP_SYNC_STATS_RTOL = 1e-4  # SyncBN step: running statistics vs one process
DP_DEADLINE_S = 300       # a spawned group of ranks must finish within this
RANK_SETUP_ENV = "CHIP_SMOKE_RANK_SETUP"


def rank_setup(setup: dict):
    """What a process of phase 15 sets before it trains: cuDNN determinism
    and TF32 as ``setup`` says, and with ``step_log`` each step of a
    ``Trainer`` built from now on appends its loss and its ``moments``
    launches to that file (one JSON line a step). A rank that ``tools/train``
    starts imports this file again (as ``__mp_main__``) and runs this with
    the ``RANK_SETUP_ENV`` that phase 15 put in its environment. Returns a
    function that undoes it."""
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.train import trainer as trainer_mod

    saved = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32, trainer_mod.make_train_step)
    torch.backends.cudnn.deterministic = bool(setup["deterministic"])
    set_tf32(bool(setup["tf32"]))
    make = trainer_mod.make_train_step

    def logged(*args, **kw):
        step = make(*args, **kw)

        def run(state, batch, generator=None):
            before = KERNELS["moments"].launches
            metrics = step(state, batch, generator)
            with open(setup["step_log"], "a") as f:
                f.write(json.dumps({
                    "loss": float(metrics["loss"]),
                    "moments": KERNELS["moments"].launches - before}) + "\n")
            return metrics
        return run

    if setup.get("step_log"):
        trainer_mod.make_train_step = logged

    def undo():
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         trainer_mod.make_train_step) = saved
    return undo


class ShardMeanLoss(torch.nn.Module):
    """``criterion`` on each of ``shards`` equal row blocks, averaged: what
    ``shards`` ranks compute (the balanced heatmap loss scales by each
    batch's own positive count, so it is not a mean over rows)."""

    def __init__(self, criterion, shards):
        super().__init__()
        self.criterion = criterion
        self.shards = shards

    def forward(self, out, batch):
        parts = [self.criterion(o, {k: v.chunk(self.shards)[i]
                                    for k, v in batch.items()})
                 for i, o in enumerate(out.chunk(self.shards))]
        return (sum(p[0] for p in parts) / self.shards,
                {k: sum(p[1][k] for p in parts) / self.shards
                 for k in parts[0][1]})


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def dp_rank(rank: int, world: int, backend: str, store: str, work: str,
            mode: str, device: str, cfg_dict: dict) -> None:
    """One rank of phase 15 (and 18) on ``device`` (a new process; every
    rank on the same card): joins a ``backend`` process group of ``world``
    ranks at ``store`` and builds the model of ``cfg_dict``. ``mode``
    "timed": the ms of ``DP_TIMED_STEPS`` steps (each synchronized) of its
    rows of ``work/batch.pt``, one process's step and the data-parallel one
    in turns; "steps": one SyncBN step and one per-rank-BN step on its rows
    of ``work/batch.pt`` from ``work/init.pt``, the second with the launch
    counts set to 0 just before and read just after; "remat" (phase 18,
    cuDNN deterministic): a plain and a rematerialized data-parallel step
    from ``work/init.pt``, dropout live from a generator seeded
    ``REMAT_GEN_SEED``, each counted. Writes ``work/rank<r>.pt``."""
    from datetime import timedelta

    import torch.distributed as dist

    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import set_sync_bn
    from litehandnet_tpu_torch.train.distributed import (
        batch_spec,
        initialize_multihost,
        make_mesh,
        make_train_step,
    )
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config

    dev = torch.device(device)
    initialize_multihost(f"file://{store}", world, rank, backend=backend,
                         device=dev, timeout=timedelta(minutes=5))
    try:
        set_tf32(False)
        cfg = config_from_dict(cfg_dict)
        mesh = make_mesh(device=dev)
        tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=TRAIN_STEPS)
        init = torch.load(os.path.join(work, "init.pt"), weights_only=True)
        batch = torch.load(os.path.join(work, "batch.pt"), weights_only=True)
        local = {k: v[batch_spec(mesh, len(batch["img"]))].to(dev)
                 for k, v in batch.items()}
        out = {"backend": dist.get_backend()}

        def fresh(sync, dropout=False):
            model = get_model(cfg, device="cpu")
            model.load_state_dict(init)
            if not dropout:
                set_dropout(model, 0.0)
            if sync:
                set_sync_bn(model, mesh.group)
            return state_on(dev, model, cfg, tx)

        if mode == "remat":
            torch.backends.cudnn.deterministic = True
            for label, remat in (("plain", False), ("remat", True)):
                state = fresh(False, dropout=True)
                step = make_train_step(dev, mesh, remat=remat)
                zero_counts()
                metrics = step(state, local, torch.Generator(dev).manual_seed(
                    REMAT_GEN_SEED))
                sync(dev)
                out[label] = dict(step_result(state, metrics), launches={
                    n: k.launches for n, k in KERNELS.items()})
        elif mode == "timed":
            # the same process, in turns: one process's step (no group in
            # the step) and the data-parallel step of this world
            runs = {"one process": (make_train_step(dev), fresh(False)),
                    "data parallel": (make_train_step(dev, mesh), fresh(False))}
            out["ms"] = {label: [] for label in runs}
            for label in ("one process", "data parallel", "data parallel",
                          "one process"):
                step, state = runs[label]
                out["ms"][label].append(dp_step_ms(step, state, local, dev))
        else:
            state = fresh(True)
            metrics = make_train_step(dev, mesh)(state, local)
            out["sync"] = {"loss": float(metrics["loss"]),
                           "grads": {k: p.grad.cpu() for k, p in
                                     state.model.named_parameters()
                                     if p.grad is not None},
                           "model": {k: v.cpu() for k, v in
                                     state.model.state_dict().items()}}
            state = fresh(False)
            step = make_train_step(dev, mesh)
            zero_counts()
            metrics = step(state, local)
            sync(dev)
            out["per_rank"] = {
                "loss": float(metrics["loss"]),
                "launches": {n: k.launches for n, k in KERNELS.items()},
                "model": {k: v.cpu() for k, v in
                          state.model.state_dict().items()}}
        torch.save(out, os.path.join(work, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dp_step_ms(step, state, batch, dev) -> list:
    """ms of ``DP_TIMED_STEPS`` steps of ``step`` on ``batch``, each ended by
    a synchronize, after 3 warm-up steps."""
    for _ in range(3):
        step(state, batch)
    sync(dev)
    ms = []
    for _ in range(DP_TIMED_STEPS):
        t = time.perf_counter()
        step(state, batch)
        sync(dev)
        ms.append((time.perf_counter() - t) * 1e3)
    return ms


def run_dp_ranks(world: int, backend: str, work: str, mode: str, dev,
                 cfg_dict: dict) -> list:
    """``dp_rank`` in ``world`` new processes; their outputs."""
    import shutil

    store = os.path.join(work, f"store_{backend}_{world}_{mode}")
    shutil.rmtree(store, ignore_errors=True)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ctx = torch.multiprocessing.start_processes(
        dp_rank, args=(world, backend, store, work, mode, str(dev), cfg_dict),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + DP_DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{world} {backend} ranks did not finish "
                                     f"in {DP_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


def max_abs_diff(a: dict, b: dict) -> float:
    return max(float((a[k].double() - b[k].double()).abs().max()) for k in a
               if a[k].is_floating_point())


def worst_stat(got: dict, want: dict) -> float:
    """The largest |got - want| over the BatchNorm running statistics of
    ``want``, each tensor's in units of its largest |value|."""
    return max(float((got[k] - want[k]).abs().max())
               / max(float(want[k].abs().max()), 1e-30)
               for k in want if k.endswith(("running_mean", "running_var")))


def step_excess(got: dict, want: dict, names) -> float:
    """The largest |got - want| less two float32 ulps of |want| over the
    parameters ``names``: Adam's first step moves each by ±lr, and at a
    warm-up LR of ~1e-6 the rounding of a weight near 1 is ~5% of it."""
    return max(float(((got[k].double() - want[k].double()).abs()
                      - 2.0 ** -22 * want[k].double().abs()).max())
               for k in names)


def grad_rel(got: dict, want: dict) -> float:
    """|got - want| / |want| over all gradient leaves of ``want``."""
    num = sum(float((got[k].double() - w.double()).square().sum())
              for k, w in want.items())
    return (num / sum(float(w.double().square().sum())
                      for w in want.values())) ** 0.5


def phase_data_parallel(dev, rows: dict, disk_path: str,
                        eval_metrics: dict) -> None:
    """Data parallelism on the one card: (a) ``tools/test --data-parallel``
    over the card count on phase 9's run equals phase 10's metrics, its
    decode counted; (b) ``tools/train --num-devices 1`` (one spawned rank,
    NCCL) equals the same run in this process, cuDNN deterministic and TF32
    off in both: first-step loss, ``moments`` per step in the rank, final
    weights; (c) two gloo ranks on cuda:0 at full width: a SyncBN step
    equals one process's step on the global batch, and a per-rank-BN step
    launches ``moments`` at each 128-channel site on each rank (counted per
    rank) with running statistics the ranks' mean; (d) ms/step of a world of
    1 over NCCL against one process's step, in turns in one new process."""
    import shutil

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.models.layers import TorchBatchNorm
    from litehandnet_tpu_torch.tools import test as test_cli
    from litehandnet_tpu_torch.tools import train as train_cli
    from litehandnet_tpu_torch.train.checkpoint import run_dir
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.utils.weights import randomize_

    card = card_line()
    cfg = get_config(disk_path)
    root = os.path.dirname(disk_path)
    n_devices = torch.cuda.device_count()

    # (a) tools/test --data-parallel on phase 9's run
    n_batches = -(-DISK_RECORDS["val"] // EVAL_BATCH)
    set_tf32(False)
    zero_counts()
    t0 = time.perf_counter()
    metrics = test_cli.main(["--cfg", disk_path, "--load-best",
                             "--data-parallel", "--device", str(dev)])
    sync(dev)
    wall = time.perf_counter() - t0
    read_counts(rows, "dp:test_data_parallel", {"blur_log": n_batches},
                {"blur_log": "fast"})
    equal = dict(metrics) == dict(eval_metrics)
    log(f"dp: tools/test --data-parallel over {n_devices} device(s), "
        f"{n_batches} batches of {EVAL_BATCH}: "
        f"{ {k: float(v) for k, v in metrics.items()} } in {wall:.2f} s; "
        f"phase 10's metrics equal: {equal} ({card})")
    if not equal:
        raise AssertionError(f"--data-parallel {metrics} != {eval_metrics}")

    # (b) tools/train --num-devices 1 against the same run in this process
    n_bn128 = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                  for m in get_model(cfg, device="cpu").modules())
    steps = DISK_RECORDS["train"] // int(cfg.TRAIN.batch_per_gpu)
    runs = {}
    for label, extra in (("one process", []), ("world 1", ["--num-devices", "1"])):
        name = label.replace(" ", "_")
        path = write_experiment_file(
            os.path.join(root, f"dp_{name}.py"), DISK_EXPERIMENT,
            dict(DISK_EXTRA, **{
                "DATASET.train": dict(cfg.DATASET.train),
                "DATASET.val": dict(cfg.DATASET.val),
                "DATASET.test": dict(cfg.DATASET.val),
                "CHECKPOINT.save_root": os.path.join(root, f"run_{name}") + "/",
                "CHECKPOINT.resume": False}))
        shutil.rmtree(os.path.join(root, f"run_{name}"), ignore_errors=True)
        step_log = os.path.join(root, f"dp_steps_{name}.jsonl")
        if os.path.exists(step_log):
            os.remove(step_log)
        setup = {"deterministic": True, "tf32": False, "step_log": step_log}
        argv = ["--cfg", path, "--epochs", "1", "--seed", str(SEED),
                "--device", dev.type] + extra
        t0 = time.perf_counter()
        if extra:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            os.environ[RANK_SETUP_ENV] = json.dumps(setup)
            try:
                train_cli.main(argv)
            finally:
                del os.environ[RANK_SETUP_ENV]
        else:
            undo = rank_setup(setup)
            try:
                train_cli.main(argv)
            finally:
                undo()
        sync(dev)
        with open(step_log) as f:
            logged = [json.loads(line) for line in f]
        saved = torch.load(os.path.join(run_dir(get_config(path)),
                                        "checkpoint.pt"), weights_only=True)
        runs[label] = (logged, saved, time.perf_counter() - t0)
    (one, one_ckpt, one_s), (w1, w1_ckpt, w1_s) = runs["one process"], runs["world 1"]
    if len(one) != steps or len(w1) != steps:
        raise AssertionError(f"steps: one process {len(one)}, world 1 "
                             f"{len(w1)}, expected {steps}")
    if any(r["moments"] != n_bn128 for r in w1):
        raise AssertionError(f"world 1 moments per step {[r['moments'] for r in w1]}"
                             f", expected {n_bn128}")
    rows["moments"].setdefault("paths", {})["dp:train_world1:rank0"] = sum(
        r["moments"] for r in w1)
    rel = abs(w1[0]["loss"] - one[0]["loss"]) / abs(one[0]["loss"])
    diff = max_abs_diff(w1_ckpt["model"], one_ckpt["model"])
    log(f"dp: tools/train --num-devices 1 (NCCL, one spawned rank) vs one "
        f"process, {steps} steps of B={cfg.TRAIN.batch_per_gpu}, cuDNN "
        f"deterministic, TF32 off: first-step loss {w1[0]['loss']!r} vs "
        f"{one[0]['loss']!r} (relative {rel:.3g}, tolerance {DP_LOSS_RTOL}); "
        f"last {w1[-1]['loss']!r} vs {one[-1]['loss']!r}; final weights max "
        f"|diff| {diff:.3g} (tolerance {DP_PARAM_TOL}); moments "
        f"{[r['moments'] for r in w1]} per step in the rank; wall {w1_s:.2f} "
        f"s vs {one_s:.2f} s with start-up ({card})")
    if rel > DP_LOSS_RTOL or diff > DP_PARAM_TOL:
        raise AssertionError(f"world 1 differs from one process: loss {rel}, "
                             f"weights {diff}")

    # (c) two gloo ranks on cuda:0, full width
    work = os.path.join(root, "dp_ranks")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    mcfg = get_config()
    size = mcfg.DATASET.image_size[0]
    base = randomize_(get_model(mcfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    n_sites = sum(isinstance(m, TorchBatchNorm) and m.num_features % 128 == 0
                  for m in base.modules())
    init = {k: v.clone() for k, v in base.state_dict().items()}
    torch.save(init, os.path.join(work, "init.pt"))
    batch = train_batch(DP_BATCH, size, seed=31, device="cpu")
    torch.save(batch, os.path.join(work, "batch.pt"))
    t0 = time.perf_counter()
    ranks = run_dp_ranks(DP_RANKS, "gloo", work, "steps", dev, mcfg.to_dict())
    ranks_s = time.perf_counter() - t0
    tx, schedule = make_optimizer_from_config(mcfg, steps_per_epoch=TRAIN_STEPS)
    lr = schedule(0)

    def one_process(rows_, criterion_shards=1):
        """(loss, state dict, gradients) of one step in this process."""
        model = get_model(mcfg, device="cpu")
        model.load_state_dict(init)
        set_dropout(model, 0.0)
        state = state_on(dev, model, mcfg, tx)
        if criterion_shards > 1:
            state.criterion = ShardMeanLoss(state.criterion, criterion_shards)
        m = make_train_step(dev)(state, {k: v[rows_].to(dev)
                                         for k, v in batch.items()})
        return (float(m["loss"]),
                {k: v.cpu() for k, v in state.model.state_dict().items()},
                {k: p.grad.cpu() for k, p in state.model.named_parameters()
                 if p.grad is not None})

    for r in ranks:
        if r["backend"] != "gloo":
            raise AssertionError(f"backend {r['backend']}")
    synced = [r["sync"] for r in ranks]
    if max_abs_diff(synced[0]["model"], synced[1]["model"]) != 0.0:
        raise AssertionError("SyncBN step: the ranks' weights differ")
    loss, want, want_grads = one_process(slice(0, DP_BATCH), DP_RANKS)
    checks = [
        # (what, value, tolerance)
        ("loss, relative", abs(synced[0]["loss"] - loss) / abs(loss),
         DP_STEP_RTOL),
        ("gradients, |g - g1| / |g1| over all leaves",
         grad_rel(synced[0]["grads"], want_grads), F32_GRAD_TOL),
        ("parameters after the Adam step, worst |diff| less 2 ulp of the "
         "weight", step_excess(synced[0]["model"], want, want_grads),
         PARAM_TOL * lr),
        ("BN running statistics, worst leaf over its max",
         worst_stat(synced[0]["model"], want), DP_SYNC_STATS_RTOL),
    ]
    log(f"dp: {DP_RANKS} gloo ranks on one card, SyncBN step of "
        f"{DP_BATCH // DP_RANKS} rows a rank vs one process on {DP_BATCH} rows "
        f"(the same per-rank loss), float32, TF32 off: loss "
        f"{synced[0]['loss']!r} vs {loss!r}")
    for what, value, tol in checks:
        log(f"dp:   SyncBN step, {what}: {value:.3g} (tolerance {tol:.3g})")
        if not value <= tol:
            raise AssertionError(f"SyncBN step vs one process: {what} {value}")

    per = [r["per_rank"] for r in ranks]
    for i, r in enumerate(per):
        got = r["launches"]
        log(f"dp: per-rank-BN step, rank {i}: kernel launches {got}")
        if got.get("moments") != n_sites or any(
                v for k, v in got.items() if k != "moments"):
            raise AssertionError(f"rank {i} launched {got}, expected moments "
                                 f"{n_sites}")
        rows["moments"].setdefault("paths", {})[f"dp:step_gloo:rank{i}"] = n_sites
    half = DP_BATCH // DP_RANKS
    alone = [one_process(slice(i * half, (i + 1) * half))[1]
             for i in range(DP_RANKS)]
    mean = {k: (alone[0][k] + alone[1][k]) / 2 for k in alone[0]
            if k.endswith(("running_mean", "running_var"))}
    worst = max(worst_stat(r["model"], mean) for r in per)
    log(f"dp: per-rank-BN step, running statistics vs the mean of each "
        f"rank's rows stepped alone: worst leaf over its max {worst:.3g} "
        f"(tolerance "
        f"{DP_STATS_RTOL}); the two-rank call took {ranks_s:.2f} s with "
        f"start-up ({card})")
    if worst > DP_STATS_RTOL:
        raise AssertionError(f"per-rank BN running statistics {worst}")

    # (d) ms/step: a world of 1 over NCCL against one process, in turns in
    # one new process
    torch.save(train_batch(DP_BATCH, size, seed=32, device="cpu"),
               os.path.join(work, "batch.pt"))
    timed = run_dp_ranks(1, "nccl" if dev.type == "cuda" else "gloo", work,
                         "timed", dev, mcfg.to_dict())[0]["ms"]
    med = {label: [round(statistics.median(v), 3) for v in runs]
           for label, runs in timed.items()}
    log(f"dp: ms/step of the flagship at B={DP_BATCH}, float32, TF32 off, "
        f"per-rank BN, in one process started for it, in turns (one "
        f"process, world of 1, world of 1, one process; medians of "
        f"{DP_TIMED_STEPS} synchronized steps): one process {med['one process']}"
        f", world of 1 over NCCL (DDP) {med['data parallel']}; all "
        f"{ {k: [[round(x, 3) for x in r] for r in v] for k, v in timed.items()} }"
        f" ({card})")


# -- phase 16: height-sharded batch-1 serving on one card ---------------------

SPATIAL_WORLDS = (2, 8)     # gloo ranks on cuda:0; 8 puts 1-row bands at 8²
# the served graphs, each at full width: the flagship (exp 2) first, then
# the other hand families (224²: 7-row deepest level, the last of 8 ranks
# without rows, [1,56,56,21] maps to decode), then the benchmark zoo of
# ZOO_CONFIGS at 256² (SRHandNet decodes its finest scale's 24 channels,
# [1,64,64,24]; the stacked hourglass its last stack)
SPATIAL_CONFIGS = ("litehandnet/freihand_256_dark_h4_ca_r4",
                   "litehandnet_msrb/freihand_256",
                   "mynet/_1_freihand2d_224x224",
                   "hourglass_ablation/freihand/"
                   "_5_freihand2d_224x224_dark_CBAM",
                   "srhandnet/freihand_256", "litehrnet/freihand_256_d30",
                   "resnet/freihand_256_r50", "mobilenetv2/freihand_256",
                   "hourglass/freihand_256_s2")
SPATIAL_REQUESTS = 8        # counted and timed batch-1 requests
SPATIAL_WARMUP = 2          # requests before them, not counted
# the families after the flagship in the world of 8, where a request takes
# ~1 s of gloo exchanges: this many counted requests after one warm-up
SPATIAL_FEW = 2
SPATIAL_MAP_TOL = 1e-4      # gathered maps vs one device, of the map max
# maxvals vs one device, of each request's largest maxval: the maps' own
# scale (a joint whose map peaks low carries the map's absolute rounding)
SPATIAL_MAXVAL_TOL = 1e-4
SPATIAL_DEADLINE_S = 240    # a world's ranks must finish within this
SPATIAL_ALLREDUCE_REPS = 20  # timed all-reduces of one halo-sized buffer


def spatial_plan(world: int, i: int) -> tuple:
    """(counted requests, warm-up requests) of ``SPATIAL_CONFIGS[i]`` in a
    world of ``world`` ranks."""
    if i == 0 or world == SPATIAL_WORLDS[0]:
        return SPATIAL_REQUESTS, SPATIAL_WARMUP
    return SPATIAL_FEW, 1


def spatial_rank(rank: int, world: int, store: str, work: str,
                 device: str, plan: list) -> None:
    """One rank of phase 16 on ``device`` (a new process; every rank on the
    same card): joins a gloo group of ``world`` ranks at ``store`` and serves
    each family of ``plan`` in turn (dicts of the config, the files of its
    weights and requests under ``work``, and its request counts): the
    spatial graph (``get_model(cfg, deploy=True)``, which the families
    without Rep modules ignore) with the saved weights, ``warmup``
    uncounted requests (the first requests again), then ``requests`` with
    the launch counts set to 0 just before and read just after, each timed
    on the host clock to a synchronize; then the gathered map of each
    request. Last, the ms of one all-reduce of a buffer the size of a
    level-0 halo fetch of exp 2 (``[1, 128, 4, 64]`` float32, 128 KB).
    Writes ``work/rank<r>.pt``."""
    from datetime import timedelta

    import torch.distributed as dist

    from litehandnet_tpu_torch.config import config_from_dict
    from litehandnet_tpu_torch.eval import make_spatial_serve
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.train.distributed import (
        initialize_multihost,
        make_mesh,
    )

    dev = torch.device(device)
    initialize_multihost(f"file://{store}", world, rank, backend="gloo",
                         device=dev, timeout=timedelta(minutes=5))
    try:
        set_tf32(False)
        # as the reference: a transposed convolution's cuDNN algorithm may
        # not give the same bits twice, and the map decoded in a request
        # must be the map ``serve.heatmaps`` gathers again
        torch.backends.cudnn.deterministic = True
        mesh = make_mesh(device=dev)
        families = {}
        for fam in plan:
            model = get_model(config_from_dict(fam["cfg"]), deploy=True,
                              device="cpu")
            model.load_state_dict(torch.load(fam["weights"],
                                             weights_only=True))
            model = model.to(dev, memory_format=torch.channels_last)
            req = torch.load(fam["requests_file"], weights_only=True)
            images = req["images"][:fam["requests"]].to(dev)
            center, scale = req["center"].to(dev), req["scale"].to(dev)
            serve = make_spatial_serve(model, mesh)
            for i in range(fam["warmup"]):
                serve(images[i], center, scale)
            zero_counts()
            outs, ms = [], []
            for img in images:
                t0 = time.perf_counter()
                outs.append(serve(img, center, scale))
                sync(dev)
                ms.append((time.perf_counter() - t0) * 1e3)
            launches = {n: k.launches for n, k in KERNELS.items()}
            paths = dict(KERNELS["blur_log"].path_launches)
            maps = torch.cat([serve.heatmaps(img) for img in images]).cpu()
            families[fam["config"]] = {
                "ms": ms, "launches": launches, "blur_log_paths": paths,
                "exchanges": serve.exchanges, "maps": maps,
                "preds": torch.cat([p for p, _ in outs]).cpu(),
                "maxvals": torch.cat([m for _, m in outs]).cpu()}
            del model, serve
        buf = torch.zeros(1, 128, 4, 64, device=dev)
        for _ in range(3):
            dist.all_reduce(buf)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(SPATIAL_ALLREDUCE_REPS):
            dist.all_reduce(buf)
        sync(dev)
        allreduce_ms = (time.perf_counter() - t0) * 1e3 / SPATIAL_ALLREDUCE_REPS
        torch.save({"backend": dist.get_backend(), "families": families,
                    "allreduce_ms": allreduce_ms},
                   os.path.join(work, f"rank{rank}.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_spatial_ranks(world: int, work: str, dev, plan: list) -> list:
    """``spatial_rank`` in ``world`` new processes; their outputs."""
    import shutil

    store = os.path.join(work, f"store_{world}")
    shutil.rmtree(store, ignore_errors=True)
    torch.cuda.empty_cache()
    ctx = torch.multiprocessing.start_processes(
        spatial_rank, args=(world, store, work, str(dev), plan),
        nprocs=world,
        join=False, start_method="spawn")
    deadline = time.monotonic() + SPATIAL_DEADLINE_S
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise AssertionError(f"{world} spatial ranks did not finish "
                                     f"in {SPATIAL_DEADLINE_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=True)
            for r in range(world)]


def spatial_reference(dev, name: str, i: int, work: str, card: str) -> dict:
    """The single-device serve of ``name`` on cuda:0 (its spatial graph,
    seed-0 weights, float32, TF32 off; forward, the served map
    (``eval.served_map``), K-innermost copy, decode) on
    ``SPATIAL_REQUESTS`` seeded batch-1 requests, timed after
    ``SPATIAL_WARMUP`` of them; saves the weights and the requests under
    ``work`` for the ranks. Returns the rank plan's entry with the
    reference's maps, preds, maxvals and ms."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.eval import served_map, spatial_model
    from litehandnet_tpu_torch.eval.decoder import unpack_outputs
    from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps

    cfg = get_config(name)
    size = cfg.DATASET.image_size[0]
    model = spatial_model(cfg, seed=SEED, device=dev)
    weights = os.path.join(work, f"weights{i}.pt")
    torch.save({k: v.cpu() for k, v in model.state_dict().items()}, weights)
    gen = torch.Generator().manual_seed(41 + i)
    images = torch.randn(SPATIAL_REQUESTS, 1, 3, size, size, generator=gen)
    center = torch.tensor([[size / 2, size / 2]])
    scale = torch.tensor([[size / 200.0, size / 200.0]])
    requests_file = os.path.join(work, f"requests{i}.pt")
    torch.save({"images": images, "center": center, "scale": scale},
               requests_file)
    images, center, scale = images.to(dev), center.to(dev), scale.to(dev)

    @torch.no_grad()
    def one_device(img):
        # the map the serve decodes: SRHandNet's finest scale, the
        # hourglass's last stack
        hm = served_map(model(img.contiguous(
            memory_format=torch.channels_last)))
        _, preds, maxvals = keypoints_from_heatmaps(
            unpack_outputs(hm, hm.shape[1])[0], center, scale,
            post_process="unbiased", kernel=11)
        return hm, preds, maxvals

    for img in images[:SPATIAL_WARMUP]:
        one_device(img)
    # why phase 16 runs deterministic cuDNN algorithms: the default ones'
    # two forwards of one request
    torch.backends.cudnn.deterministic = False
    drift = float((one_device(images[0])[0]
                   - one_device(images[0])[0]).abs().max())
    torch.backends.cudnn.deterministic = True
    ref, ms = [], []
    for img in images:
        sync(dev)
        t0 = time.perf_counter()
        ref.append(one_device(img))
        sync(dev)
        ms.append((time.perf_counter() - t0) * 1e3)
    graph = "deploy graph" if getattr(model, "deploy", False) else "eval mode"
    log(f"spatial: {name}: one device (cuda:0) at {size}², {graph}, float32, "
        f"TF32 off: batch-1 latency (forward + decode, host clock to a "
        f"synchronize) median {statistics.median(ms):.3f} ms of "
        f"{SPATIAL_REQUESTS} (min {min(ms):.3f}, max {max(ms):.3f}); with "
        f"cuDNN's default algorithms two forwards of request 0 {drift:.3g} "
        f"apart ({card})")
    return dict(config=name, cfg=cfg.to_dict(), weights=weights,
                requests_file=requests_file, center=center.cpu(),
                scale=scale.cpu(),
                # of the served map (SRHandNet's heatmap_size lists four)
                stride=size // ref[0][0].shape[-1], one_ms=ms,
                maps=torch.cat([r[0] for r in ref]).cpu(),
                preds=torch.cat([r[1] for r in ref]).cpu(),
                maxvals=torch.cat([r[2] for r in ref]).cpu())


def check_spatial_family(dev, world: int, ref: dict, ranks: list, n: int,
                         rows: dict, allreduce_ms: float, card: str) -> None:
    """One family's outputs in a world against its single-device reference
    ``ref`` (its first ``n`` requests): the gates, the exchanges, the
    launches per rank (recorded as main paths in ``rows``) and the
    latencies. Preds: 98% of the coordinates within 1e-3 heatmap px; the
    flagship's all within ``DECODE_MODEL_TOL``, the other
    families' within 1e-3 px on every joint whose DARK step is well
    conditioned (``ops.decode.dark_conditioning``, the zoo's rule); and
    for every family the one-device decode of the served maps within 1e-3
    px of the served preds."""
    from litehandnet_tpu_torch.eval.decoder import unpack_outputs
    from litehandnet_tpu_torch.ops.decode import (dark_conditioning,
                                                  keypoints_from_heatmaps)

    name = ref["config"]
    outs = [rank["families"][name] for rank in ranks]
    first = outs[0]
    same = all(torch.equal(first[k], o[k]) for o in outs[1:]
               for k in ("maps", "preds", "maxvals"))
    ref_maps, ref_preds = ref["maps"][:n], ref["preds"][:n]
    ref_maxvals = ref["maxvals"][:n]
    maps = max(float((first["maps"][i] - ref_maps[i]).abs().max())
               / float(ref_maps[i].abs().max()) for i in range(n))
    diff = (first["preds"] - ref_preds).abs() / ref["stride"]
    within = float((diff <= 1e-3).float().mean())
    # the joints whose DARK step is well conditioned on the one-device map;
    # elsewhere (the flat maxima of random weights) the Newton step divides
    # by a near-singular Hessian and magnifies the maps' 1e-6 rounding
    K = ref_maps.shape[1]
    well, det, step = dark_conditioning(unpack_outputs(ref_maps, K)[0])
    well_err = float(diff[well].max()) if well.any() else 0.0
    worst = int(diff.amax(-1).argmax())
    # the served preds against the one-device decode of the served maps:
    # the decode stage alone (phase 3's rule, 1e-3 px)
    _, own, _ = keypoints_from_heatmaps(
        unpack_outputs(first["maps"].to(dev), K)[0], ref["center"].to(dev),
        ref["scale"].to(dev), post_process="unbiased", kernel=11)
    redecode = float((own.cpu() - first["preds"]).abs().max()) / ref["stride"]
    # the flagship is held on every coordinate
    flagship = name == SPATIAL_CONFIGS[0]
    preds_ok = (within >= 0.98 and redecode <= 1e-3
                and (float(diff.max()) <= DECODE_MODEL_TOL if flagship
                     else well_err <= 1e-3))
    gap = (first["maxvals"] - ref_maxvals).abs()
    vals = float((gap.amax(dim=(1, 2))
                  / ref_maxvals.abs().amax(dim=(1, 2))).max())
    rel = float((gap / ref_maxvals.abs()).max())
    ex = first["exchanges"]
    log(f"spatial: {name}: world {world} (gloo ranks on cuda:0), {n} batch-1 "
        f"requests: gathered maps vs one device {maps:.3g} of the map max "
        f"(tolerance {SPATIAL_MAP_TOL}); preds max {float(diff.max()):.3g} "
        f"heatmap px (tolerance {DECODE_MODEL_TOL if flagship else 'none'}), "
        f"{within:.1%} of {diff.numel()} coordinates within 1e-3 px "
        f"(tolerance 98%), {well_err:.3g} px on the {int(well.sum())} of "
        f"{well.numel()} joints whose DARK step is well conditioned "
        f"(tolerance {'none' if flagship else 1e-3}); the worst joint's |det "
        f"H| {float(det.flatten()[worst]):.3g}, step "
        f"{float(step.flatten()[worst]):.3g} px; the one-device decode of "
        f"the served maps {redecode:.3g} px from the served preds (tolerance "
        f"1e-3); maxvals "
        f"{vals:.3g} of the request's largest (tolerance "
        f"{SPATIAL_MAXVAL_TOL}; of their own value at most {rel:.3g}); every "
        f"rank the same bits: {same}")
    log(f"spatial: {name}: world {world}: per request {ex.get('halo', 0)} "
        f"halo fetches, {ex.get('reduce', 0)} reduces, {ex.get('max', 0)} "
        f"maxima, {ex.get('gather', 0)} gather: {sum(ex.values())} "
        f"all-reduces")
    for r, out in enumerate(outs):
        if out["exchanges"] != ex:
            raise AssertionError(f"{name}: world {world} rank {r} exchanged "
                                 f"{out['exchanges']}, rank 0 {ex}")
        got, kpaths = out["launches"], out["blur_log_paths"]
        if (got.get("blur_log") != n or kpaths["fast"] != n
                or any(v for k, v in got.items() if k != "blur_log")):
            raise AssertionError(f"{name}: world {world} rank {r} launched "
                                 f"{got} (blur_log by path {kpaths}), "
                                 f"expected blur_log {n} on the fast path")
        path = f"spatial serve:{name}:world{world}:rank{r}"
        rows["blur_log"].setdefault("paths", {})[path] = got["blur_log"]
        rows["blur_log"].setdefault("kernel_paths", {})[path] = kpaths
    med = [statistics.median(out["ms"]) for out in outs]
    log(f"spatial: {name}: world {world}: batch-1 latency median "
        f"{med[0]:.3f} ms at rank 0 (ranks {min(med):.3f}-{max(med):.3f}; "
        f"rank 0 all {[round(x, 3) for x in first['ms']]}), one device "
        f"{statistics.median(ref['one_ms']):.3f} ms; x {sum(ex.values())} "
        f"all-reduces at {allreduce_ms:.3f} ms = "
        f"{allreduce_ms * sum(ex.values()):.1f} ms a request; blur_log {n} "
        f"launches a rank, fast path ({card})")
    if not (same and maps <= SPATIAL_MAP_TOL and preds_ok
            and vals <= SPATIAL_MAXVAL_TOL):
        raise AssertionError(f"{name}: world {world}: spatial serve "
                             f"disagrees with one device (maps {maps}, preds "
                             f"{float(diff.max())}, within {within}, well "
                             f"conditioned {well_err}, decode of the served "
                             f"maps {redecode}, maxvals {vals}, same bits "
                             f"{same})")


def phase_spatial_serve(dev, rows: dict) -> None:
    """Height-sharded batch-1 serving (``eval/spatial_serving.py``) of the
    hand families and the benchmark zoo of ``SPATIAL_CONFIGS`` at full
    width (seed-0 weights, the
    spatial graph, float32, TF32 off) in worlds of ``SPATIAL_WORLDS`` gloo
    ranks on the one card, each world started once for every family, each
    family against its single-device forward and decode on cuda:0: the
    gathered maps within ``SPATIAL_MAP_TOL`` of each map's max, preds as
    ``check_spatial_family`` holds them, maxvals within ``SPATIAL_MAXVAL_TOL`` of
    each request's largest, every rank's outputs the same bits, the same
    exchanges on every rank, ``blur_log`` once per request on each rank
    (fast path) and no other kernel; the median batch-1 latency of one
    device and of each world, and the exchanges per request."""
    import shutil

    card = card_line()
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_spatial")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    set_tf32(False)
    # deterministic cuDNN algorithms here and in the ranks: with the
    # default ones a deconvolution head does not give the same bits twice
    # (spatial_reference prints by how much)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    refs = []
    for i, name in enumerate(SPATIAL_CONFIGS):
        refs.append(spatial_reference(dev, name, i, work, card))
        torch.cuda.empty_cache()
    torch.backends.cudnn.deterministic = deterministic
    keys = ("config", "cfg", "weights", "requests_file")
    for world in SPATIAL_WORLDS:
        plan = []
        for i, ref in enumerate(refs):
            n, warmup = spatial_plan(world, i)
            plan.append({**{k: ref[k] for k in keys}, "requests": n,
                         "warmup": warmup})
        t0 = time.perf_counter()
        ranks = run_spatial_ranks(world, work, dev, plan)
        wall = time.perf_counter() - t0
        allreduce_ms = ranks[0]["allreduce_ms"]
        log(f"spatial: world {world}: backend {ranks[0]['backend']}; one "
            f"all-reduce of a 128 KB halo-sized buffer {allreduce_ms:.3f} ms "
            f"at rank 0 (mean of {SPATIAL_ALLREDUCE_REPS}); every rank shares "
            f"the one card and exchanges through gloo (host copies), so the "
            f"latencies are the cost of the exchange, not a speed-up; "
            f"{len(refs)} families in {wall:.1f} s with start-up ({card})")
        for ref, entry in zip(refs, plan):
            check_spatial_family(dev, world, ref, ranks, entry["requests"],
                                 rows, allreduce_ms, card)
    shutil.rmtree(work, ignore_errors=True)


TWIN_LOSS_RTOL = 1e-5    # step-0 loss: card vs stored, card vs CPU
TWIN_CUT = {"steps": 25, "eval_n": 32}   # the counted flagship run


def twin_sites(dev) -> dict:
    """``{tag: C % 128 BatchNorm shapes}`` of one train step of each stored
    twin run (``TWIN_RUNS``, its stored batch and 128² input): the
    ``moments`` sites of phase 17, held in phase 6."""
    from litehandnet_tpu_torch.tools import twin_accuracy as twin

    sites = {}
    for tag, run in twin.TWIN_RUNS.items():
        proto = twin.protocol(tag)
        model = twin.init_model(twin.build_config(
            run.experiment, run.overrides)).to(
                dev, memory_format=torch.channels_last)
        x = torch.zeros(proto["batch"], 3, proto["size"], proto["size"],
                        device=dev)
        sites[tag] = site_shapes(
            model, x.contiguous(memory_format=torch.channels_last))[0]
        log(f"sites twin {tag}: {len(sites[tag])} BatchNorms with C % 128 "
            f"== 0 at {sorted(set(sites[tag]))}")
    return sites


def phase_twin(dev, rows: dict, sites_by_tag: dict) -> None:
    """The twin-accuracy protocol (``tools/twin_accuracy.py``): for each
    stored run of ``TWIN_RUNS`` at 128² (its stored protocol, float32, TF32
    off) the init checksum equals the stored one and the step-0 loss on the
    card is within ``TWIN_LOSS_RTOL`` of the stored ``loss_first`` and of
    the same step on the CPU; then the flagship's run, cut to
    ``TWIN_CUT``, through ``main`` with the counts set to 0 just before
    and read just after (``moments`` once per C % 128 BatchNorm per step,
    ``blur_log`` once per decode on its fast path), run again to resume
    from its step-0 snapshot (the same json, bit for bit), and ``--side
    report``, which refuses the cut run's protocol against the stored one."""
    import shutil

    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.tools import twin_accuracy as twin

    card = card_line()
    cpu = torch.device("cpu")
    sites = {tag: len(shapes) for tag, shapes in sites_by_tag.items()}
    for tag, run in twin.TWIN_RUNS.items():
        proto = twin.protocol(tag)
        stored = twin.stored_side(tag, "torch")
        zero_counts()
        got = twin.step_zero(proto, dev)
        torch.cuda.synchronize()
        forward = KERNELS["moments"].launches
        want = twin.step_zero(proto, cpu)
        rel_stored = abs(got["loss_first"] / stored["loss_first"] - 1)
        rel_cpu = abs(got["loss_first"] / want["loss_first"] - 1)
        log(f"twin: {tag} ({run.experiment}, seed {proto['seed']}): init "
            f"{got['init_checksum'][1]} (stored {stored['init_checksum'][1]}, "
            f"CPU {want['init_checksum'][1]}); step-0 loss card "
            f"{got['loss_first']:.7f}, CPU {want['loss_first']:.7f}, stored "
            f"{stored['loss_first']:.7f}: {rel_stored:.3g} / {rel_cpu:.3g} "
            f"relative (tolerance {TWIN_LOSS_RTOL}); {forward} moments "
            f"launches in the step's forward, {sites[tag]} C % 128 sites")
        if not (got["init_checksum"] == want["init_checksum"]
                == stored["init_checksum"]):
            raise AssertionError(f"twin {tag}: the init does not reproduce")
        if not (rel_stored <= TWIN_LOSS_RTOL and rel_cpu <= TWIN_LOSS_RTOL):
            raise AssertionError(f"twin {tag}: step-0 loss off")
        if forward != sites[tag]:
            raise AssertionError(f"twin {tag}: {forward} moments launches, "
                                 f"{sites[tag]} sites")
    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_twin")
    shutil.rmtree(work, ignore_errors=True)
    argv = ["--side", "port", "--tag", "litehandnet", "--steps",
            str(TWIN_CUT["steps"]), "--eval-n", str(TWIN_CUT["eval_n"]),
            "--workdir", work, "--device", str(dev)]
    steps = TWIN_CUT["steps"]
    results = []
    for label, run_steps in (("twin:litehandnet", steps),
                             ("twin:litehandnet resumed", steps - 1)):
        zero_counts()
        t0 = time.perf_counter()
        out = twin.main(list(argv))
        wall = time.perf_counter() - t0
        read_counts(rows, label, {"moments": run_steps * sites["litehandnet"],
                                  "blur_log": 2}, {"blur_log": "fast"})
        with open(out) as f:
            results.append(json.load(f))
        log(f"twin: {label}: {run_steps} steps at {results[-1]['ms_step']:.3f} "
            f"ms/step (B={results[-1]['args']['batch']}, 128², float32, TF32 "
            f"off, deterministic cuDNN), main() {wall:.1f} s with the "
            f"corpus ({card})")
    full, resumed = results
    keys = ("init_checksum", "loss_first", "loss_tail", "train", "eval")
    same = {k: full[k] == resumed[k] for k in keys}
    log(f"twin: resumed run = uninterrupted run: {same}; eval {full['eval']}")
    if not all(same.values()):
        raise AssertionError("twin: the resumed run differs")
    try:
        twin.main(["--side", "report", "--workdir", work, "--report-out",
                   os.path.join(work, "report.md")])
    except AssertionError as e:
        log(f"twin: --side report refuses the cut run: {str(e)[:200]}")
        if "different protocols" not in str(e):
            raise
    else:
        raise AssertionError("twin: the report took a cut run")
    shutil.rmtree(work, ignore_errors=True)


# -- phase 18: the rematerialized train step ---------------------------------

REMAT_GEN_SEED = 5           # the dropout generator of each compared step
REMAT_COST_CONFIGS = (None, ATT_CONFIG, "hourglass/freihand_256_s2")
REMAT_TIMED_STEPS = 10       # timed steps per setting, after 3 warm-up steps


def state_diff(a: dict, b: dict) -> dict:
    """How two steps' results differ: the loss, and the largest |a - b| over
    the buffers, the gradients and the parameters, with the names of the
    tensors that are not bit for bit equal."""
    if set(a["grads"]) != set(b["grads"]):
        raise AssertionError("the steps gave gradients to other parameters")
    buffers = [k for k in a["model"] if k not in a["params"]]
    out = {"loss": a["loss"] - b["loss"]}
    for part, names, src in (("buffers", buffers, "model"),
                             ("grads", list(a["grads"]), "grads"),
                             ("params", list(a["params"]), "params")):
        x, y = a[src], b[src]
        out[part] = max(float((x[k].double() - y[k].double()).abs().max())
                        for k in names)
        out[f"{part}_unequal"] = [k for k in names if not torch.equal(x[k], y[k])]
    return out


def step_result(state, metrics) -> dict:
    """A step's loss, state dict, parameters and gradients, on the CPU."""
    return {"loss": float(metrics["loss"]),
            "model": {k: v.detach().cpu().clone()
                      for k, v in state.model.state_dict().items()},
            "params": {k: p.detach().cpu().clone()
                       for k, p in state.model.named_parameters()},
            "grads": {k: p.grad.cpu() for k, p in
                      state.model.named_parameters() if p.grad is not None}}


def assert_same_steps(what: str, plain: dict, remat: dict, card: str) -> None:
    """The rematerialized step equals the plain step bit for bit: loss,
    every buffer, gradient and parameter."""
    d = state_diff(remat, plain)
    log(f"remat: {what}: remat - plain loss {d['loss']!r}, max |diff| "
        f"buffers {d['buffers']!r}, gradients {d['grads']!r}, parameters "
        f"{d['params']!r} ({card})")
    unequal = {k: d[k] for k in ("buffers_unequal", "grads_unequal",
                                 "params_unequal") if d[k]}
    if d["loss"] != 0.0 or unequal:
        raise AssertionError(f"remat: {what}: the remat step differs from the "
                             f"plain step: loss {d['loss']}, {unequal}")


def remat_equal(dev, rows: dict, cfg, base, n_sites: int, n_dw: int,
                card: str) -> None:
    """Exp 2 at B=32: a plain and a remat step from the same weights, batch
    and dropout generator, ``LHN_FUSED_DW`` off and on, each counted: the
    remat step launches every kernel site twice (forward and recompute) and
    equals the plain step bit for bit."""
    import copy

    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config

    size = cfg.DATASET.image_size[0]
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=TRAIN_STEPS)
    batch = train_batch(BATCH_TRAIN, size, seed=41, device=dev)
    for fused in ("0", "1"):
        os.environ["LHN_FUSED_DW"] = fused
        dw = n_dw if fused == "1" else 0
        got = {}
        for label, remat in (("plain", False), ("remat", True)):
            state = state_on(dev, copy.deepcopy(base), cfg, tx)
            step = make_train_step(dev, remat=remat)
            times = 2 if remat else 1
            zero_counts()
            metrics = step(state, batch, torch.Generator(dev).manual_seed(
                REMAT_GEN_SEED))
            read_counts(rows, f"remat:{label}:fused_dw{fused}",
                        {"moments": times * n_sites,
                         "dw_conv3x3_stats": times * dw})
            got[label] = step_result(state, metrics)
            del state, step
        assert_same_steps(f"exp 2 B={BATCH_TRAIN} LHN_FUSED_DW={fused}, "
                          f"moments {n_sites} / {2 * n_sites}, "
                          f"dw_conv3x3_stats {dw} / {2 * dw} a step",
                          got["plain"], got["remat"], card)


def remat_cost(dev, name, card: str) -> dict:
    """ms/step (each step synchronized; the median of ``REMAT_TIMED_STEPS``
    after 3 warm-up steps) and the peak device memory of those steps, with
    remat off and on, for ``name`` (None: exp 2) at its batch, float32, TF32
    off, dropout live from a generator."""
    import copy

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.train.distributed import make_train_step
    from litehandnet_tpu_torch.train.optim import make_optimizer_from_config
    from litehandnet_tpu_torch.utils.weights import randomize_

    cfg = get_config(name) if name else get_config()
    size = cfg.DATASET.image_size[0]
    B = int(cfg.TRAIN.batch_per_gpu)
    base = randomize_(get_model(cfg, device="cpu"),
                      torch.Generator().manual_seed(SEED))
    if cfg.MODEL.name == "atthandnet":
        batches = [coord_batch(size, B, 50 + i, dev) for i in range(2)]
    elif cfg.MODEL.name == "litehandnet":
        batches = [train_batch(B, size, seed=50 + i, device=dev)
                   for i in range(2)]
    else:
        batches = [zoo_batch(cfg, B, 50 + i, dev) for i in range(2)]
    tx, _ = make_optimizer_from_config(cfg, steps_per_epoch=10)
    out = {}
    for remat in (False, True):
        state = state_on(dev, copy.deepcopy(base), cfg, tx)
        step = make_train_step(dev, remat=remat)
        gen = torch.Generator(dev).manual_seed(REMAT_GEN_SEED)
        for i in range(3):
            step(state, batches[i % 2], gen)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated() / 2 ** 30
        ms = []
        for i in range(REMAT_TIMED_STEPS):
            t0 = time.perf_counter()
            metrics = step(state, batches[i % 2], gen)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        if not math.isfinite(float(metrics["loss"])):
            raise AssertionError(f"remat: {cfg.MODEL.name} loss {metrics}")
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        out["on" if remat else "off"] = {
            "ms": statistics.median(ms), "all_ms": ms, "peak_gib": peak,
            "held_gib": held}
        del state, step, metrics
        torch.cuda.empty_cache()
    label = name or "exp 2"
    off, on = out["off"], out["on"]
    log(f"remat: {label} B={B} float32, TF32 off: ms/step (median of "
        f"{REMAT_TIMED_STEPS}) off {off['ms']:.3f}, on {on['ms']:.3f} "
        f"({on['ms'] / off['ms']:.3f}x); peak GiB off {off['peak_gib']:.3f}, "
        f"on {on['peak_gib']:.3f} ({on['peak_gib'] / off['peak_gib']:.3f}x; "
        f"held between steps {off['held_gib']:.3f} / {on['held_gib']:.3f}); "
        f"all ms off {[round(v, 3) for v in off['all_ms']]}, on "
        f"{[round(v, 3) for v in on['all_ms']]} ({card})")
    return out


def remat_ddp(dev, rows: dict, cfg, base, n_sites: int, card: str) -> None:
    """Phase 15's world of 1 (one spawned rank, NCCL, DDP) takes a plain and
    a remat step from the same weights, batch and dropout generator: equal
    bit for bit, ``moments`` at each site once and twice."""
    import shutil

    work = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "chip_smoke_remat")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    torch.save({k: v.clone() for k, v in base.state_dict().items()},
               os.path.join(work, "init.pt"))
    torch.save(train_batch(BATCH_TRAIN, cfg.DATASET.image_size[0], seed=42,
                           device="cpu"), os.path.join(work, "batch.pt"))
    os.environ["LHN_FUSED_DW"] = "0"
    rank = run_dp_ranks(1, "nccl" if dev.type == "cuda" else "gloo", work,
                        "remat", dev, cfg.to_dict())[0]
    for label, times in (("plain", 1), ("remat", 2)):
        got = rank[label]["launches"]
        log(f"remat: world of 1 (DDP) {label} step: kernel launches {got}")
        if got.get("moments") != times * n_sites or any(
                v for k, v in got.items() if k != "moments"):
            raise AssertionError(f"remat: world of 1 {label} step launched "
                                 f"{got}, expected moments {times * n_sites}")
        rows["moments"].setdefault("paths", {})[
            f"remat:ddp_world1:{label}:rank0"] = times * n_sites
    assert_same_steps(f"world of 1 over {rank['backend']} (DDP) "
                      f"B={BATCH_TRAIN}", rank["plain"], rank["remat"], card)
    shutil.rmtree(work, ignore_errors=True)


def phase_remat(dev, rows: dict, sites: tuple) -> None:
    """The rematerialized train step (``make_train_step(remat=True)``):
    exp 2's remat step equals its plain step bit for bit with every kernel
    site launched twice, ``LHN_FUSED_DW`` off and on, cuDNN deterministic
    and TF32 off; phase 15's world of 1 under DDP the same; then ms/step and
    peak memory off and on for exp 2, AttHandNet and hourglass-s2."""
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.utils.weights import randomize_

    card = card_line()
    set_tf32(False)
    deterministic = torch.backends.cudnn.deterministic
    fused = os.environ.get("LHN_FUSED_DW")
    torch.backends.cudnn.deterministic = True
    try:
        cfg = get_config()
        base = randomize_(get_model(cfg, device="cpu"),
                          torch.Generator().manual_seed(SEED))
        n_sites, n_dw = len(sites[0]), len(sites[1])
        if n_sites == 0 or n_dw == 0:
            raise AssertionError("the flagship has no moments or dw sites")
        remat_equal(dev, rows, cfg, base, n_sites, n_dw, card)
        remat_ddp(dev, rows, cfg, base, n_sites, card)
        os.environ["LHN_FUSED_DW"] = "0"
        for name in REMAT_COST_CONFIGS:
            remat_cost(dev, name, card)
    finally:
        torch.backends.cudnn.deterministic = deterministic
        if fused is None:
            os.environ.pop("LHN_FUSED_DW", None)
        else:
            os.environ["LHN_FUSED_DW"] = fused


# the benchmark cells' models (perfbench/configs/*.json "experiment") and
# their batches (perfbench/mixes/*.json), and the parked batch-1 mix's
GRAPH_CELLS = (("litehandnet/freihand_256_dark_h4_ca_r4", 128),
               ("resnet/freihand_256_r50", 128),
               ("litehrnet/freihand_256_d30", 512))
GRAPH_REPS = 6          # requests a round; rounds eager, graphed x 2, eager
GRAPH_B1_REPS = 64      # batch-1 requests a round


# what ``kernel_counts`` counts in a served request
TRACED_KERNELS = ("dw_conv_bias_act_kernel", "blur_log")


def kernel_counts(prof) -> tuple:
    """How many kernels of a finished ``torch.profiler`` trace hold each of
    ``TRACED_KERNELS`` in their name."""
    from litehandnet_tpu_torch.utils import profiling

    kernels = profiling.device_kernel_names(prof)
    return tuple(sum(n in k for k in kernels) for n in TRACED_KERNELS)


def device_busy_ms(fn) -> float:
    """Device milliseconds one call of ``fn`` keeps the card busy: the union
    of its kernels and copies in a ``torch.profiler`` trace."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False))
    busy, end = 0.0, float("-inf")
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    return busy / 1e3


def request_ms(predictor, images, center, scale, reps: int) -> tuple:
    """(median host ms to enqueue ``heatmaps``, median ms of a whole request
    with its answer on the host) over ``reps`` requests from an idle card."""
    enqueue, whole = [], []
    for i in range(reps):
        x = images[i % len(images)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hm = predictor.heatmaps(x)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue.append(t1 - t0)
        del hm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        preds, maxvals = predictor(x, center, scale)
        preds.cpu(), maxvals.cpu()
        whole.append(time.perf_counter() - t0)
    return (statistics.median(enqueue) * 1e3, statistics.median(whole) * 1e3)


def graphed_pair(dev, experiment: str, B: int):
    """A predictor of ``experiment`` (bfloat16, weights from ``SEED``), a
    copy of it on the same model that forgets its captures before every
    call (so each forward runs eagerly), and three pinned uint8 batches of
    ``B`` crops with their centers and scales."""
    import copy

    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.serve import Predictor
    from litehandnet_tpu_torch.utils.cuda_graphs import ForwardGraphs

    class EagerPredictor(Predictor):
        def heatmaps(self, images):
            self.graphs.clear()
            return super().heatmaps(images)

    cfg = get_config(experiment)
    size = cfg.DATASET.image_size[0]
    graphed = Predictor(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    eager = copy.copy(graphed)
    eager.__class__ = EagerPredictor
    eager.graphs = ForwardGraphs()
    gen = torch.Generator().manual_seed(5)
    images = [torch.randint(0, 256, (B, size, size, 3), generator=gen,
                            dtype=torch.uint8).pin_memory() for _ in range(3)]
    center = torch.full((B, 2), size / 2, device=dev)
    scale_ = torch.full((B, 2), size / 200.0, device=dev)
    return graphed, eager, images, center, scale_


def shared_pool(dev, graphed, eager, images, pool_gb: float) -> None:
    """More batch sizes through ``graphed`` (captured at the full batch
    already): each captured on its second call into the predictor's one
    pool from its one stream, its heatmaps equal to ``eager``'s bit for
    bit, and the memory reserved grows by less than three quarters of the
    first pool (``pool_gb``), where a pool or stream of its own per size
    would add about as much as the first."""
    torch.cuda.synchronize()
    reserved = torch.cuda.memory_reserved(dev)
    sizes = [len(images[0]) * 3 // 4, len(images[0]) // 2]
    equal = True
    for B in sizes:
        for x in images:
            equal &= torch.equal(graphed.heatmaps(x[:B]), eager.heatmaps(x[:B]))
    torch.cuda.synchronize()
    grown = (torch.cuda.memory_reserved(dev) - reserved) / 1e9
    pools = {(id(c.pool), id(c.stream))
             for c in graphed.graphs.chains.values()}
    log(f"graphs one pool: batches {sizes} after {len(images[0])}: "
        f"{len(graphed.graphs.chains)} chains on {len(pools)} pool and "
        f"stream, reserved +{grown:.3f} GB (the first pool {pool_gb:.3f} GB); heatmaps equal "
        f"bit for bit: {equal}")
    if not (equal and len(pools) == 1 and grown < 0.75 * pool_gb):
        raise AssertionError("more batch sizes: heatmaps differ, or the "
                             "chains do not share one pool")


def phase_serve_graphs(dev) -> None:
    """The served forward replayed as CUDA graphs (``utils/cuda_graphs``)
    against the same predictor run eagerly, for the benchmark cells' three
    models at their batches: the heatmaps equal bit for bit, the program
    counters move alike per batch (``dw_conv_bias_act`` once per routed
    depthwise conv), a profiled request of each runs on the card the
    ``dw_conv_bias_act`` and ``blur_log`` kernels its counters count and
    records the same spans; then host
    enqueue, device busy time, capture seconds, graph memory and request
    times in turns. Last, LiteHandNet's batch-1 request graphed and eager,
    as a finding."""
    from torch.profiler import ProfilerActivity

    from litehandnet_tpu_torch.kernels import dw_conv_bias_act
    from litehandnet_tpu_torch.models.layers import dw_kernel_spec
    from litehandnet_tpu_torch.serve import Predictor
    from litehandnet_tpu_torch.utils import cuda_graphs, profiling

    pairs = profiling.counters()
    for experiment, B in GRAPH_CELLS:
        graphed, eager, images, center, scale_ = graphed_pair(dev, experiment,
                                                              B)

        def counted(predictor, x):
            before = cuda_graphs.snapshot(pairs)
            out = predictor.heatmaps(x)
            return out, cuda_graphs.moved(pairs, before,
                                          cuda_graphs.snapshot(pairs))

        want = [counted(eager, x) for x in images]
        torch.cuda.synchronize()
        reserved = torch.cuda.memory_reserved(dev)
        c0, s0 = Predictor.graph_captures, Predictor.graph_capture_s
        got = [counted(graphed, x) for x in images + images]
        torch.cuda.synchronize()
        (chain,) = graphed.graphs.chains.values()
        pool_gb = (torch.cuda.memory_reserved(dev) - reserved) / 1e9
        worst = max(float((out.double() - want[i % 3][0].double()).abs().max())
                    for i, (out, _) in enumerate(got))
        equal = all(torch.equal(out, want[i % 3][0])
                    for i, (out, _) in enumerate(got))
        same_counts = all(c == want[i % 3][1] for i, (_, c) in enumerate(got))
        routed = sum(dw_kernel_spec(m) is not None
                     for m in graphed.model.modules())
        dw = {a: d for o, a, d in want[0][1] if o is dw_conv_bias_act}
        # a whole request of each under the profiler (the graphed one a
        # replay): the kernels that ran, by name, against what the counters
        # say ran; first the card's activity alone, as the benchmark's
        # counted stretch records it, then with the host's ops, which
        # gives the spans
        spans, ran, said = [], [], []
        for predictor in (graphed, eager):
            for activities in ([ProfilerActivity.CUDA],
                               [ProfilerActivity.CPU, ProfilerActivity.CUDA]):
                before = cuda_graphs.snapshot(pairs)
                profiling.reset()
                with torch.profiler.profile(activities=activities) as prof:
                    predictor(images[0], center, scale_)
                    torch.cuda.synchronize()
                moved = {(getattr(o, "__name__", o), a): d for o, a, d in
                         cuda_graphs.moved(pairs, before,
                                           cuda_graphs.snapshot(pairs))}
                ran.append(kernel_counts(prof))
                said.append(tuple(moved.get((name, "launches"), 0)
                                  for name in ("dw_conv_bias_act", "blur_log")))
            spans.append([(s.name, s.parent) for s in profiling.spans()])
        log(f"graphs {experiment} B={B}: {len(chain.graphs)} graphs, "
            f"{len(chain.steps) - len(chain.graphs)} span marks; captured in "
            f"{Predictor.graph_capture_s - s0:.3f} s "
            f"({Predictor.graph_captures - c0} capture), graph pool "
            f"{pool_gb:.3f} GB reserved; heatmaps equal bit for bit: {equal} "
            f"(largest difference {worst:.3g}); counters alike: {same_counts} "
            f"({[(getattr(o, '__name__', o), a, d) for o, a, d in want[0][1]]}"
            f"); spans alike: {spans[0] == spans[1]} ({len(spans[0])} a "
            f"request); dw_conv_bias_act and blur_log kernels in the device "
            f"trace of a request, graphed / eager: {ran[0]} / {ran[2]}, by "
            f"the counters {said[0]} / {said[2]} (with the host's ops "
            f"recorded {ran[1]} / {ran[3]}, by the counters {said[1]} / "
            f"{said[3]})")
        if not equal:
            raise AssertionError(
                f"{experiment}: graphed heatmaps differ from eager by up to "
                f"{worst}: the same kernels on the same input should give "
                "the same bits")
        if not (same_counts and spans[0] == spans[1]):
            raise AssertionError(f"{experiment}: a replay's counters or "
                                 "spans differ from an eager forward's")
        if dw.get("launches", 0) != routed:
            raise AssertionError(f"{experiment}: dw_conv_bias_act launched "
                                 f"{dw.get('launches', 0)} times a batch, "
                                 f"expected {routed}")
        if not (ran[0] == ran[2] == (routed, 1)
                and set(said) == {(routed, 1)}):
            raise AssertionError(
                f"{experiment}: the device trace of a request holds "
                f"{ran[0]} (graphed) / {ran[2]} (eager) dw_conv_bias_act and "
                f"blur_log kernels, the counters say {said}, expected "
                f"{(routed, 1)}")
        busy = {name: device_busy_ms(lambda: p.heatmaps(images[0]))
                for name, p in (("eager", eager), ("graphed", graphed))}
        times = {"eager": [], "graphed": []}
        for name in ("eager", "graphed", "graphed", "eager"):
            p = eager if name == "eager" else graphed
            times[name].append(request_ms(p, images, center, scale_,
                                          GRAPH_REPS))
        for name, runs in times.items():
            enq = [e for e, _ in runs]
            req = [r for _, r in runs]
            log(f"graphs {experiment} B={B} {name}: heatmaps enqueued in "
                f"{min(enq):.3f}-{max(enq):.3f} ms on the host, device busy "
                f"{busy[name]:.3f} ms; request {min(req):.3f}-{max(req):.3f} "
                f"ms ({B / max(req) * 1e3:.1f}-{B / min(req) * 1e3:.1f} img/s,"
                f" two rounds of {GRAPH_REPS})")
        if experiment == GRAPH_CELLS[0][0]:
            shared_pool(dev, graphed, eager, images, pool_gb)
        del graphed, eager, chain, got, want, p, predictor
        torch.cuda.empty_cache()

    # batch 1, as the parked cell litehandnet.serve_b1 sends it: a finding
    graphed, eager, images, center, scale_ = graphed_pair(dev, GRAPH_CELLS[0][0],
                                                          1)
    times = {"eager": [], "graphed": []}
    for name in ("eager", "graphed", "graphed", "eager"):
        p = eager if name == "eager" else graphed
        for x in images:
            p(x, center, scale_)
        times[name].append(request_ms(p, images, center, scale_,
                                      GRAPH_B1_REPS))
    busy = {name: device_busy_ms(lambda: p.heatmaps(images[0]))
            for name, p in (("eager", eager), ("graphed", graphed))}
    for name, runs in times.items():
        log(f"graphs batch 1 {name}: heatmaps enqueued in "
            f"{', '.join(f'{e:.3f}' for e, _ in runs)} ms, device busy "
            f"{busy[name]:.3f} ms; request p50 "
            f"{', '.join(f'{r:.3f}' for _, r in runs)} ms (two rounds of "
            f"{GRAPH_B1_REPS})")


def phase_serve_graphs_apart() -> None:
    """Phase 19 in a process of its own (``--serve-graphs-only``, phase 1's
    build then cached): late in a long process the profiler was seen to
    keep 8 or 9 of the 17 ``dw_conv_bias_act`` kernel records of a
    request, eager and replayed alike, so its trace could not stand for
    the counters there."""
    torch.cuda.empty_cache()
    sys.stdout.flush()
    rc = subprocess.run([sys.executable, os.path.abspath(__file__),
                         "--serve-graphs-only"]).returncode
    if rc:
        raise AssertionError(f"phase 19 in its own process exited {rc}")


def phase(label: str, fn, *args):
    """Run one phase and print its wall seconds."""
    t0 = time.perf_counter()
    out = fn(*args)
    log(f"phase {label}: {time.perf_counter() - t0:.1f} s wall")
    return out


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import litehandnet_tpu_torch  # noqa: F401  (fails here without the repo)

    kernels_only = "--kernels-only" in argv
    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    earlier = phase("1 build", phase_build)
    if "--serve-graphs-only" in argv:
        phase("19 serve graphs", phase_serve_graphs, dev)
        return 0
    rows = {"blur_log": phase("2 serve kernels", phase_kernels, dev, earlier),
            "softpool_2x2": phase("2 softpool", phase_softpool, dev, earlier),
            "dw_conv_bias_act": phase("2 dw conv bias act", phase_dw_bias_act,
                                      dev),
            "fuse_sum_relu": phase("2 fuse sum relu", phase_fuse_sum_relu,
                                   dev)}
    if not kernels_only:
        phase("3 serve", phase_serve, dev, rows)
        for name in SERVED_FAMILIES:
            phase(f"4 serve {name}", phase_serve_family, dev, name, rows)
        phase("5 attention", phase_attention, dev, rows)
    flagship = train_sites(dev)
    family = train_sites(dev, TRAINED_FAMILY)
    zoo_sites = {config: train_sites(dev, config) for config in ZOO_CONFIGS}
    rest_sites = {name: train_sites(dev, cfg)[0]
                  for name, cfg in rest_configs().items()}
    # the sites LHN_FUSED_BN_SMALLC=1 adds (C < 128), timed in phase 6 and
    # in the flagship's and litehandnet_msrb's train steps
    small = {"litehandnet": small_c_sites(dev),
             "litehandnet_msrb": small_c_sites(dev, MSRB_CONFIG)}
    # exp 16's sites at full and at half resolution (the cycle-detection
    # step): the same BatchNorms on other map sizes
    from litehandnet_tpu_torch.config import get_config

    half = get_config(MULTIHAND_EXPERIMENT).DATASET.image_size[0] // 2
    multihand_sites = (train_sites(dev, MULTIHAND_EXPERIMENT)[0],
                       train_sites(dev, MULTIHAND_EXPERIMENT, half)[0])
    twin = twin_sites(dev)   # B=16, 128²
    rows["moments"] = phase(
        "6 moments", phase_moments, dev,
        {"litehandnet": flagship[0], "hourglass_ablation": family[0],
         **{config.split("/")[0]: sites[0]
            for config, sites in zoo_sites.items() if sites[0]},
         "mynet_stacked": multihand_sites[0],
         "mynet_stacked_half": multihand_sites[1],
         **rest_sites,
         **{f"{name}_smallc": shapes for name, shapes in small.items()},
         **{f"twin_{tag}": shapes for tag, shapes in twin.items() if shapes}})
    rows["dw_conv3x3_stats"] = phase(
        "6 dw", phase_dw, dev,
        {"litehandnet": flagship[1],
         "litehandnet_msrb": zoo_sites[MSRB_CONFIG][1]})
    if kernels_only:
        log("kernels only: the serve, attention and train paths were not run")
        print(json.dumps({"kernels": list(rows.values())}), flush=True)
        return 0
    in_memory_ms = phase("7 train", phase_train, dev, rows,
                         len(small["litehandnet"]))
    phase("8 train family", phase_train_family, dev, TRAINED_FAMILY, rows)
    disk_path = phase("9 train from disk", phase_train_from_disk, dev, rows,
                      in_memory_ms)
    eval_metrics = phase("10 evaluate", phase_evaluate, dev, rows, disk_path)
    phase("11 zoo", phase_zoo, dev, rows, zoo_sites, disk_path,
          len(small["litehandnet_msrb"]))
    phase("12 multihand", phase_multihand, dev, rows, multihand_sites,
          disk_path)
    phase("13 rest of the zoo", phase_rest, dev, rows, rest_sites, disk_path)
    phase("14 rest of the package", phase_rest_of_package, dev, rows,
          disk_path)
    phase("15 data parallel", phase_data_parallel, dev, rows, disk_path,
          eval_metrics)
    phase("16 spatial serve", phase_spatial_serve, dev, rows)
    phase("17 twin", phase_twin, dev, rows, twin)
    phase("18 remat", phase_remat, dev, rows, flagship)
    phase("19 serve graphs", phase_serve_graphs_apart)
    kernels = []
    for name in ("blur_log", "moments", "dw_conv3x3_stats", "softpool_2x2",
                 "dw_conv_bias_act", "fuse_sum_relu"):
        # launches: the sum over the main paths that ran the kernel, each
        # counted from 0 just before it was driven; "paths" splits it
        row = rows[name]
        row["launches"] = sum(row.get("paths", {}).values())
        if row["launches"] == 0:
            raise AssertionError(f"{name} launched on no main path")
        kernels.append(row)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


# a rank that tools/train starts in phase 15 imports this file again as
# __mp_main__: it sets itself up as the phase asked
if os.environ.get(RANK_SETUP_ENV):
    rank_setup(json.loads(os.environ[RANK_SETUP_ENV]))

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
