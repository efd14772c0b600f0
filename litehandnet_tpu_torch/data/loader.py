"""Host-side data loading (port of ``litehandnet_tpu/data/loader.py``): JPEG
decode into a fixed canvas, batching, and the fused device pipeline on the
card.

Replaces the reference's torch DataLoader + DistributedSampler stack
(datasets/dataloader.py:7-55): each rank of a process group reads its own
shard of the records (``local_indices``), shuffled per epoch from a seeded
rng; images are decoded by a thread pool (overlapped with
the device by ``prefetch_iter``), and each raw batch is a dict of stacked
numpy arrays. ``batches()`` moves each uint8 canvas batch to the device
(pinned, non-blocking) and runs ``DevicePipeline`` there. With
``decode_procs`` > 0 worker processes decode into shared memory instead
(``data/mp_decode.py``). With ``use_native`` (by default where it builds)
the batch is decoded by the native libjpeg-turbo ROI decoder
(``native/``); an image it cannot decode (PNG, CMYK, progressive, an IO
error) is decoded by the Python path, with the same geometry.

JAX's ``sharding`` argument (:198-209, :418-421) places a batch over the
local devices of one process for ``tools/test --data-parallel``; in the
port that command scatters the model's input itself (``torch.nn.parallel``),
so the loader keeps one device.
"""

from __future__ import annotations

import concurrent.futures as cf
from typing import Iterator, Optional

import numpy as np
import torch

from litehandnet_tpu_torch import native, resolve_device
from litehandnet_tpu_torch.data import build_dataset
from litehandnet_tpu_torch.data.device_pipeline import DevicePipeline
from litehandnet_tpu_torch.data.image_io import _load_image
from litehandnet_tpu_torch.train import distributed


def prefetch_iter(gen, size: int = 2):
    """Run ``gen`` in a background thread, keeping up to ``size`` items
    ready: overlaps host decode with device compute.

    Abandoning this iterator (break, exception, GC) stops the worker: the
    finally block sets ``stop`` and drains the queue so a blocked put()
    wakes up, and the worker closes ``gen`` so what it holds (the decode
    thread pool) is released."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=size)
    END = object()
    stop = threading.Event()

    def put(item) -> bool:
        """put() that gives up when the consumer has gone away."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            try:
                for item in gen:
                    if not put(item):
                        return
                put(END)
            except BaseException as e:  # surfaced on the consumer side
                put(e)
        finally:
            gen.close()

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is END:
                return
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        try:
            while True:
                q.get_nowait()
        except queue.Empty:
            pass


class DataLoader:
    """Iterates batches of host canvas images and metadata, optionally
    pushed through the fused device pipeline.

    Args:
        cfg: experiment config.
        data_type: 'train' | 'val' | 'test'.
        batch_size: batch size (``cfg.TRAIN.batch_per_gpu`` when None).
        canvas_hw: (H0, W0) decode canvas; defaults to twice the input size.
        use_device_pipeline: run augmentation and encoding on the device
            and yield train-ready batches; otherwise yield raw batches.
        num_workers: decode threads.
        decode_procs: decode worker processes (``ProcessDecodePool``)
            instead of the threads; 0 decodes in this process. Close the
            loader (``close()`` or ``with``) to stop them.
        drop_last: drop the last partial batch (default: in training); else
            it is padded to ``batch_size`` by repeating its last record.
        seed: dataset rng, shuffle (``seed + epoch``) and device generator
            (``seed * 100003 + epoch``) seed.
        device: where the pipeline runs.
        use_native: decode with the native ROI decoder (``native/``);
            by default where it builds on this host.
        shard: under a process group, read this rank's shard of the
            records; False reads them all (one rank's evaluation).

    Raises:
        RuntimeError: the pipeline's ``device`` is CUDA and no CUDA device
            is available.
    """

    def __init__(
        self,
        cfg,
        data_type: str = "train",
        batch_size: Optional[int] = None,
        canvas_hw=None,
        use_device_pipeline: bool = True,
        num_workers: int = 8,
        drop_last: Optional[bool] = None,
        seed: int = 0,
        device="cuda",
        decode_procs: int = 0,
        use_native: Optional[bool] = None,
        shard: bool = True,
    ):
        self.cfg = cfg
        self.data_type = data_type
        self.device = resolve_device(device) if use_device_pipeline else None
        self.dataset = build_dataset(cfg, data_type,
                                     rng=np.random.RandomState(seed))
        if batch_size is None:
            batch_size = int(cfg.TRAIN.batch_per_gpu)
        self.batch_size = batch_size
        self.is_train = data_type == "train"
        self.drop_last = self.is_train if drop_last is None else drop_last
        self.seed = seed
        if canvas_hw is None:
            w, h = cfg.DATASET.image_size
            canvas_hw = (int(h) * 2, int(w) * 2)
        self.canvas_hw = tuple(canvas_hw)
        # the ROI decode window covers the crop box under the largest scale
        # jitter; rotation is covered by _load_image's half-diagonal bound
        sf = float(cfg.PIPELINE.get("scale_factor", 0)) if self.is_train else 0.0
        self.roi_margin = (1.0 + sf) * 1.05
        self.num_workers = num_workers
        self.use_native = (
            native.available() if use_native is None else bool(use_native))
        self.pipeline = None
        if use_device_pipeline:
            self.pipeline = DevicePipeline(
                cfg, self.dataset.ann_info["flip_index"],
                is_train=self.is_train, device=self.device)
        # this rank's shard (DistributedSampler's): the records padded by
        # wrapping around to a multiple of the world size, every world-th
        # from this rank on. Equal shards, or a rank would join a collective
        # the others never reach and build another LR schedule (JAX
        # :236-247)
        n = len(self.dataset)
        rank, world = ((distributed.process_index(),
                        distributed.process_count()) if shard else (0, 1))
        padded = np.resize(np.arange(n), -(-n // world) * world)
        self.local_indices = padded[rank::world]
        self.decode_pool = None
        if decode_procs > 0:
            from litehandnet_tpu_torch.data.mp_decode import ProcessDecodePool

            self.decode_pool = ProcessDecodePool(
                decode_procs, self.batch_size, self.canvas_hw,
                roi_margin=self.roi_margin, use_native=self.use_native)

    def close(self):
        """Stop the decode worker processes and unlink their shared block
        (nothing to do without them: the decode threads belong to
        ``batches()``)."""
        if self.decode_pool is not None:
            self.decode_pool.close()
            self.decode_pool = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def __len__(self):
        n = len(self.local_indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _stack_canvases(self, canvases) -> np.ndarray:
        """Stack the canvases (a list, or the decode pool's ``[N, H0, W0,
        3]`` block), into page-locked memory when the pipeline runs on CUDA
        (the decode thread pins, and the copy to the card is asynchronous).
        The array's ``base`` is then that pinned tensor."""
        shape = (len(canvases),) + canvases[0].shape
        if self.device is not None and self.device.type == "cuda":
            out = torch.empty(shape, dtype=torch.uint8, pin_memory=True).numpy()
        else:
            out = np.empty(shape, np.uint8)
        return np.stack(canvases, out=out)

    def _decode_batch(self, records, pool):
        """A batch of records decoded into stacked ``[N, H0, W0, 3]``
        canvases and their geometry."""
        if self.decode_pool is not None:
            canvases, offset, fscale = self.decode_pool.decode(
                [r["image_file"] for r in records],
                np.stack([np.asarray(r["center"], np.float32)
                          for r in records]),
                np.stack([np.asarray(r["scale"], np.float32)
                          for r in records]))
            # copied out of the shared block: the next decode() reuses it
            return self._stack_canvases(canvases), offset, fscale
        if self.use_native:
            centers = np.stack(
                [np.asarray(r["center"], np.float32) for r in records])
            wxy = np.stack(
                [np.asarray(r["scale"], np.float32) for r in records]
            ) * 200.0 * float(self.roi_margin)
            halves = np.hypot(wxy[:, 0], wxy[:, 1]) / 2.0 + 4.0
            canvases, offset, fscale, status = native.decode_roi_batch(
                [r["image_file"] for r in records], self.canvas_hw,
                centers, halves.astype(np.float32),
                n_threads=self.num_workers)
            for i in np.nonzero(status)[0]:
                r = records[i]
                canvases[i], offset[i], fscale[i] = _load_image(
                    r["image_file"], self.canvas_hw, center=r["center"],
                    scale=r["scale"], margin=self.roi_margin)
            return (self._stack_canvases(canvases), offset.astype(np.float32),
                    fscale.astype(np.float32))
        loaded = list(pool.map(
            lambda r: _load_image(r["image_file"], self.canvas_hw,
                                  center=r["center"], scale=r["scale"],
                                  margin=self.roi_margin),
            records))
        images = self._stack_canvases([im for im, _, _ in loaded])
        offset = np.stack([o for _, o, _ in loaded])
        fscale = np.stack([f for _, _, f in loaded])
        return images, offset, fscale

    def _raw_batch(self, idxs, pool):
        records = [self.dataset.db[i] for i in idxs]
        images, offset, fscale = self._decode_batch(records, pool)
        joints = np.stack(
            [r["joints_3d"][:, :2].astype(np.float32) for r in records])
        center = np.stack([np.asarray(r["center"], np.float32) for r in records])
        scale = np.stack([np.asarray(r["scale"], np.float32) for r in records])
        bbox = np.stack([
            np.asarray(r.get("bbox", [0, 0, 0, 0]), np.float32)[:4]
            for r in records])
        return {
            "img_raw": images,
            # original-image coords (eval/decode space)
            "joints": joints,
            "center": center,
            "scale": scale,
            "bbox": bbox,
            # canvas coords (what the pixels in img_raw are)
            "joints_canvas": (joints - offset[:, None]) * fscale[:, None],
            "center_canvas": (center - offset) * fscale,
            "scale_canvas": scale * fscale,
            "bbox_canvas": np.concatenate(
                [(bbox[:, :2] - offset) * fscale, bbox[:, 2:] * fscale], axis=1),
            "offset": offset,
            "img_scale": fscale,
            "vis": np.stack(
                [r["joints_3d_visible"][:, 0].astype(np.float32) for r in records]),
            "rotation": np.zeros(len(records), np.float32),
            "image_file": [r["image_file"] for r in records],
            # fallback: the dataset-global record index (a batch-local one
            # would collide across batches in the evaluator's bbox_id dedup)
            "bbox_id": np.asarray([
                r.get("bbox_id", int(gi)) for gi, r in zip(idxs, records)]),
            "bbox_score": np.asarray(
                [r.get("bbox_score", 1.0) for r in records], np.float32),
        }

    def _raw_batches(self, epoch: int) -> Iterator[dict]:
        rng = np.random.RandomState(self.seed + epoch)
        idxs = self.local_indices.copy()
        if self.is_train:
            rng.shuffle(idxs)
        with cf.ThreadPoolExecutor(self.num_workers) as pool:
            for start in range(0, len(idxs), self.batch_size):
                chunk = idxs[start:start + self.batch_size]
                if len(chunk) < self.batch_size:
                    if self.drop_last:
                        break
                    # pad to the static batch size (repeat the last record)
                    pad = self.batch_size - len(chunk)
                    chunk = np.concatenate([chunk, chunk[-1:].repeat(pad)])
                yield self._raw_batch(chunk, pool)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """``a`` on the device, copied asynchronously from page-locked
        memory: a copy from pageable memory may wait for the stream, which
        would stall the host behind the previous step."""
        # the canvases' pinned tensor itself, so that its allocator keeps the
        # block until the copy is done
        t = a.base if isinstance(a.base, torch.Tensor) else torch.from_numpy(a)
        if self.device.type == "cuda" and not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def batches(self, epoch: int = 0, prefetch: int = 2) -> Iterator[dict]:
        """Batches of ``epoch``. With the device pipeline each holds its
        outputs (tensors on the device; ``center`` and ``scale`` back in
        original-image coords) beside the raw batch's host arrays."""
        raw_iter = self._raw_batches(epoch)
        if prefetch:
            # decode the next batch on a background thread while the device
            # works on the current one
            raw_iter = prefetch_iter(raw_iter, prefetch)
        if self.pipeline is None:
            yield from raw_iter
            return
        generator = None
        if self.is_train:
            generator = torch.Generator(self.device).manual_seed(
                self.seed * 100003 + epoch)
        for raw in raw_iter:
            dev = {k: self._to_device(raw[k]) for k in (
                "img_raw", "joints_canvas", "vis", "center_canvas",
                "scale_canvas", "rotation", "bbox_canvas", "img_scale",
                "offset")}
            out = self.pipeline(
                dev["img_raw"], dev["joints_canvas"], dev["vis"],
                dev["center_canvas"], dev["scale_canvas"], dev["rotation"],
                generator, bboxes=dev["bbox_canvas"])
            batch = dict(out)
            # center/scale back to original image coords, so decode and
            # transform_preds land in annotation space
            batch["center"] = out["center"] / dev["img_scale"] + dev["offset"]
            batch["scale"] = out["scale"] / dev["img_scale"]
            batch["img_raw"] = raw["img_raw"]
            batch["joints_src"] = raw["joints"]
            batch["vis_src"] = raw["vis"]
            if "bbox" in out:
                # the pipeline's bbox is in crop space (region configs)
                batch["bbox_crop"] = out["bbox"]
            batch["bbox"] = raw["bbox"]
            # canvas geometry, for consumers that re-crop img_raw
            for k in ("offset", "img_scale", "joints_canvas", "bbox_canvas",
                      "image_file", "bbox_id", "bbox_score"):
                batch[k] = raw[k]
            yield batch

    def __iter__(self):
        return self.batches(0)


def make_dataloader(cfg, data_type="train", **kw):
    """Reference-surface factory (datasets/dataloader.py:7-55)."""
    loader = DataLoader(cfg, data_type, **kw)
    return loader.dataset, loader
