"""Drive the PyTorch port on one CUDA card and check it end to end.

    python3 chip_smoke.py

Phases, each fatal on failure:

1. build: compile every hand-written kernel of the port from
   ``litehandnet_tpu_torch/csrc`` with ``nvcc`` (one process per source,
   all started together);
2. kernels: hold each kernel against its plain PyTorch version on the card
   at the serve path's shapes and at ragged ones, and time kernel, plain
   version and library yardstick with CUDA events;
3. serve: full-width LiteHandNet (``freihand_256_dark_h4_ca_r4``, random
   weights from a seed): train graph equals deploy graph in float32 on the
   card, and the card's deploy forward equals the CPU's; card decode
   (kernel) equals CPU decode (plain); then a few bfloat16 requests
   through ``Predictor`` with every kernel launch counter set to 0 just
   before and read just after, the serve rate, and the device time of one
   request by kernel (``torch.profiler``).

Prints the card's name and power limit, a ``{"kernels": [...]}`` line, and
last ``{"ok": true, "device": {...}}``. Exits non-zero without a CUDA card
or when any check fails. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

SEED = 0
BATCH = 128          # serve batch (bench.py's per-chip batch)
REQUESTS = 4         # batches served in the counted main-path run
TIMED_REPS = 5
KERNEL_REPS = 30
KERNEL_ATOL = 1e-4   # on log values: sum order differs, log turns relative
                     # error of the blurred map into absolute error
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM data sheet, FP32 outside tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = KERNEL_REPS, warmup: int = 3) -> float:
    """Median milliseconds of ``fn`` on the current stream (CUDA events)."""
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
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build():
    from litehandnet_tpu_torch.kernels import KERNELS, _build

    t0 = time.perf_counter()
    _build.build(KERNELS)
    seconds = time.perf_counter() - t0
    log(f"build: {sorted(KERNELS)} with nvcc in {seconds:.1f} s")
    for name in KERNELS:
        for line in _build.library_path(name).with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


def phase_kernels(dev) -> dict:
    from litehandnet_tpu_torch.kernels.blur_log import blur_log, blur_log_reference
    from litehandnet_tpu_torch.ops.blur import cv2_gaussian_kernel

    set_tf32(False)
    worst = 0.0
    for seed, shape in enumerate([(BATCH, 64, 64, 21), (4, 56, 56, 21),
                                  (3, 17, 23, 5)]):
        x = heatmap_probe(*shape, seed=seed).to(dev)
        got = blur_log(x, 11)
        want = blur_log_reference(x, 11)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        log(f"kernels: blur_log {list(shape)} max_abs_err {err:.3g} "
            f"(atol {KERNEL_ATOL})")
        if not err <= KERNEL_ATOL:
            raise AssertionError(f"blur_log disagrees at {shape}: {err}")
        # a strided [B, H, W, K] view of NCHW memory reads the same
        strided = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
        if not torch.equal(blur_log(strided, 11), got):
            raise AssertionError(f"blur_log differs on a strided view {shape}")

    x = heatmap_probe(BATCH, 64, 64, 21, seed=1).to(dev)
    ms = cuda_ms(lambda: blur_log(x, 11))
    # the same maps in [B, K, H, W] memory: each block then reads and writes
    # its own map contiguously, where the serve layout strides by K
    nchw = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    nchw_ms = cuda_ms(lambda: blur_log(nchw, 11))
    plain_ms = cuda_ms(lambda: blur_log_reference(x, 11))
    maps = torch.nn.functional.pad(
        x.permute(0, 3, 1, 2).reshape(-1, 1, 64, 64), (5, 5, 5, 5))
    taps = torch.as_tensor(cv2_gaussian_kernel(11, 0.0), device=dev)
    kv, kh = taps.view(1, 1, 11, 1), taps.view(1, 1, 1, 11)
    library_ms = cuda_ms(lambda: torch.nn.functional.conv2d(
        torch.nn.functional.conv2d(maps, kv), kh))
    n = x.numel()
    nbytes = 2 * n * 4                   # read once, write once
    flops = n * (4 * 11 + 2)             # two 11-tap FMA passes, rescale, log
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    bound_ms = max(t_bytes, t_ops)
    log(f"kernels: blur_log [128,64,64,21] kernel {ms:.4f} ms ({nchw_ms:.4f} "
        f"ms on [B,K,H,W] memory), plain {plain_ms:.4f} ms, two cuDNN "
        f"depthwise conv passes {library_ms:.4f} ms, bound "
        f"{bound_ms * 1e3:.1f} us ({nbytes / 1e6:.1f} MB moved, "
        f"{flops / 1e9:.3f} GFLOP)")
    return dict(
        name="blur_log", route="cuda",
        source="litehandnet_tpu_torch/csrc/blur_log.cu",
        replaces="litehandnet_tpu/ops/pallas_kernels.py:106",
        max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by="bytes" if t_bytes >= t_ops else "operations",
        library_ms=library_ms,
    )


def phase_serve(dev, kernel_rows: dict) -> None:
    from litehandnet_tpu_torch.config import get_config
    from litehandnet_tpu_torch.kernels import KERNELS
    from litehandnet_tpu_torch.models import get_model
    from litehandnet_tpu_torch.ops.decode import keypoints_from_heatmaps
    from litehandnet_tpu_torch.serve import Predictor, deploy_model
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

    # the main path: bf16 requests through the Predictor
    predictor = Predictor(cfg, device=dev, dtype=torch.bfloat16, seed=SEED)
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [torch.randint(0, 256, (BATCH, size, size, 3), generator=gen,
                             device=dev, dtype=torch.uint8)
               for _ in range(REQUESTS)]
    center, scale_ = center.to(dev), scale_.to(dev)
    predictor(batches[0], center, scale_)          # warm-up, not counted
    torch.cuda.synchronize()
    for wrapper in KERNELS.values():
        wrapper.launches = 0
    outs = [predictor(b, center, scale_) for b in batches]
    torch.cuda.synchronize()
    launches = {name: k.launches for name, k in KERNELS.items()}
    log(f"serve: {REQUESTS} requests of B={BATCH}, kernel launches {launches}")
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} was not launched on the path")
        kernel_rows[name]["launches"] = count
    if launches["blur_log"] != REQUESTS:
        raise AssertionError(f"blur_log launched {launches['blur_log']} times "
                             f"for {REQUESTS} requests")
    for preds, maxvals in outs:
        if preds.shape != (BATCH, 21, 2) or maxvals.shape != (BATCH, 21, 1):
            raise AssertionError(f"bad output shapes {preds.shape}, {maxvals.shape}")
        if not (torch.isfinite(preds).all() and torch.isfinite(maxvals).all()):
            raise AssertionError("non-finite serve output")

    # where the time goes, per batch, and the serve rate
    images = batches[0]
    fwd_ms = cuda_ms(lambda: predictor.heatmaps(images), reps=10)
    hm = predictor.heatmaps(images)
    dec_ms = cuda_ms(lambda: keypoints_from_heatmaps(hm, center, scale_, **kw),
                     reps=10)
    rates = []
    for _ in range(TIMED_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for b in batches:
            predictor(b, center, scale_)
        torch.cuda.synchronize()
        rates.append(REQUESTS * BATCH / (time.perf_counter() - t0))
    log(f"serve: per batch of {BATCH}: normalize+forward {fwd_ms:.3f} ms, "
        f"decode {dec_ms:.3f} ms")
    log(f"serve: {statistics.median(rates):.1f} img/s median of {TIMED_REPS} "
        f"(min {min(rates):.1f}, max {max(rates):.1f}), bf16, B={BATCH}, "
        f"{size}x{size}")
    profile_request(predictor, images, center, scale_)


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import litehandnet_tpu_torch  # noqa: F401  (fails here without the repo)

    dev = torch.device("cuda", 0)
    log(card_line())
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    phase_build()
    rows = {"blur_log": phase_kernels(dev)}
    phase_serve(dev, rows)
    print(json.dumps({"kernels": list(rows.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
