"""Process-sharded batch decode: N OS processes feeding one shared-memory
canvas block (port of ``litehandnet_tpu/data/mp_decode.py``).

The loader's thread pool decodes with cv2, which releases the interpreter
lock, but everything around it (record plumbing, canvas assembly, the
train step's own Python) still shares one interpreter. A persistent pool of
worker processes, each decoding its contiguous slice of the batch straight
into one ``multiprocessing.shared_memory`` block, takes the decode out of
that interpreter: per batch only a few small arrays (offsets, scales) are
pickled; the canvases are written in place.

Per worker, the decode uses the native libjpeg-turbo ROI decoder
(``native/``) single-threaded where the caller's ``use_native`` asks for it
and it builds; an image it cannot decode takes ``_load_image``.

Workers are spawned, never forked: the parent holds a live CUDA context,
which a forked child cannot use. They import only numpy, cv2 or PIL,
``native/`` and ``data/image_io.py``: these modules import no torch, so no
worker starts CUDA.
"""

from __future__ import annotations

import multiprocessing as mp
import os
from multiprocessing import shared_memory
from typing import Sequence

import numpy as np

_worker: dict = {}


def _init_worker(shm_name: str, shape, use_native: bool) -> None:
    """Runs once per worker process: attach the shared canvas block, and
    decide once whether this worker decodes natively (never where the
    caller turned the native decoder off)."""
    from litehandnet_tpu_torch import native

    shm = shared_memory.SharedMemory(name=shm_name)
    _worker["shm"] = shm  # keep a reference, or the mapping is closed
    _worker["canvases"] = np.ndarray(shape, np.uint8, buffer=shm.buf)
    _worker["native"] = bool(use_native) and native.available()


def _decode_slice(args):
    """Decode ``paths`` into the shared canvas slots ``[i0, i0 + n)``."""
    from litehandnet_tpu_torch import native
    from litehandnet_tpu_torch.data.image_io import _load_image

    i0, paths, centers, scales, margin, canvas_hw = args
    n = len(paths)
    view = _worker["canvases"][i0:i0 + n]
    offsets = np.zeros((n, 2), np.float32)
    fscales = np.ones((n, 2), np.float32)
    statuses = np.ones(n, np.int32)
    if _worker["native"]:
        wxy = scales * 200.0 * margin
        halves = (np.hypot(wxy[:, 0], wxy[:, 1]) / 2.0 + 4.0).astype(
            np.float32)
        canv, off, fsc, statuses = native.decode_roi_batch(
            paths, canvas_hw, centers, halves, n_threads=1)
        view[:] = canv
        offsets[:], fscales[:] = off, fsc
    for i in np.nonzero(statuses)[0]:
        view[i], offsets[i], fscales[i] = _load_image(
            paths[i], canvas_hw, center=centers[i], scale=scales[i],
            margin=margin)
    return i0, offsets, fscales


class ProcessDecodePool:
    """Persistent decode-worker pool over one shared-memory canvas block.

    ``decode()`` fills the block for a batch and returns a view into it:
    the caller copies the batch out before it asks for the next one
    (``DataLoader`` copies it into its pinned buffer). ``close()`` stops
    the workers and unlinks the block; the loader calls it in its own
    ``close()``, and ``tools/test`` and ``tools/train`` in ``finally``.
    """

    def __init__(self, n_procs: int, batch_size: int, canvas_hw,
                 roi_margin: float = 1.1, use_native: bool = True):
        if n_procs < 1:
            raise ValueError(f"n_procs={n_procs} must be at least 1")
        self.n_procs = int(n_procs)
        self.batch = int(batch_size)
        self.canvas_hw = (int(canvas_hw[0]), int(canvas_hw[1]))
        self.margin = float(roi_margin)
        shape = (self.batch, *self.canvas_hw, 3)
        self._shm = shared_memory.SharedMemory(
            create=True, size=int(np.prod(shape)))
        self.name = self._shm.name
        self.canvases = np.ndarray(shape, np.uint8, buffer=self._shm.buf)
        self._pool = None
        try:
            self._pool = mp.get_context("spawn").Pool(
                self.n_procs, initializer=_init_worker,
                initargs=(self._shm.name, shape, bool(use_native)))
        except BaseException:
            self.close()
            raise

    def decode(self, paths: Sequence[str], centers: np.ndarray,
               scales: np.ndarray):
        """``(canvases [N, H, W, 3] u8 view, offsets [N, 2], scales [N, 2])``
        with ``_load_image``'s geometry: source coords map to canvas coords
        as ``(p - offset) * scale``.

        Raises:
            ValueError: more paths than the block's batch size.
        """
        n = len(paths)
        if n > self.batch:
            raise ValueError(f"{n} images for a block of {self.batch}")
        centers = np.ascontiguousarray(centers, np.float32)
        scales = np.ascontiguousarray(scales, np.float32)
        per = -(-n // self.n_procs)
        tasks = [
            (i0, list(paths[i0:i0 + per]), centers[i0:i0 + per],
             scales[i0:i0 + per], self.margin, self.canvas_hw)
            for i0 in range(0, n, per)
        ]
        offsets = np.zeros((n, 2), np.float32)
        fscales = np.ones((n, 2), np.float32)
        for i0, off, fsc in self._pool.imap_unordered(_decode_slice, tasks):
            k = len(off)
            offsets[i0:i0 + k] = off
            fscales[i0:i0 + k] = fsc
        return self.canvases[:n], offsets, fscales

    def close(self) -> None:
        """Stop the workers and unlink the block; a second call does
        nothing."""
        if self._pool is not None:
            self._pool.terminate()
            self._pool.join()
            self._pool = None
        if self._shm is not None:
            self.canvases = None
            self._shm.close()
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            self._shm = None


def default_procs() -> int:
    """Worker count for the host: leave 2 cores for the thread that drives
    the card and the loader's own thread, at least 1."""
    return max((os.cpu_count() or 1) - 2, 1)
