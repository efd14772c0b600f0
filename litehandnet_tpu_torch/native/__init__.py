"""Native (C++) host decode, bound through ctypes (port of
``litehandnet_tpu/native``).

``jpeg_roi.cpp`` is a batched libjpeg-turbo ROI decoder that replaces the
per-image Python decode of the reference's DataLoader workers
(datasets/data_pipeline/loading.py:6-89): partial scanline decode around the
bbox, DCT-domain downscaling, and a pthread pool that releases the
interpreter once per batch.

The library is compiled with ``g++ -ljpeg`` at first use into
``build/litehandnet_tpu_torch/`` beside the package, never into the package
directory. Its file name carries a hash of the source, the flags and the
host's CPU flags (it is built with ``-march=native``), so an edit or another
host rebuilds it. Where the toolchain or ``jpeglib.h`` is missing,
``available()`` is False and the loader decodes with cv2/PIL, as JAX's does.

This module imports no torch: the decode worker processes
(``data/mp_decode.py``) import it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "jpeg_roi.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_HERE)), "build",
                         "litehandnet_tpu_torch")
_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_LIBS = ("-ljpeg", "-lpthread")
_ABI_VERSION = 1

_lock = threading.Lock()
_lib = None
_lib_failed = False


def _cpu_flags() -> str:
    try:
        with open("/proc/cpuinfo") as f:
            return next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        return ""


def library_path() -> str:
    """Where this host's build of ``jpeg_roi.cpp`` lives."""
    h = hashlib.sha256()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_FLAGS + _LIBS).encode())
    h.update(_cpu_flags().encode())
    return os.path.join(BUILD_DIR, f"_jpeg_roi-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    """Compile into a private file, then move it into place, so processes
    that build at once never load a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    cmd = ["g++", *_FLAGS, _SRC, "-o", tmp, *_LIBS]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=120)
        if res.returncode != 0:
            return False
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.TimeoutExpired):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _open(path: str):
    lib = ctypes.CDLL(path)
    if lib.lhn_abi_version() != _ABI_VERSION:
        raise OSError("ABI mismatch")
    return lib


def _load():
    """Load (building if needed) the native library; None when unavailable."""
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("LHN_DISABLE_NATIVE"):
            _lib_failed = True
            return None
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            _lib_failed = True
            return None
        try:
            lib = _open(path)
        except OSError:
            # a stale or broken binary: rebuild once
            try:
                if not _build(path):
                    raise OSError("build failed")
                lib = _open(path)
            except OSError:
                _lib_failed = True
                return None
        lib.lhn_decode_roi_batch.argtypes = [
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int),
            ctypes.c_int,
        ]
        lib.lhn_decode_roi_batch.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    """True when the native decoder can be used on this host."""
    return _load() is not None


def decode_roi_batch(paths, canvas_hw, centers, halves, n_threads=8):
    """Batch-decode JPEGs into zero-padded canvases with ROI semantics.

    Mirrors ``data/image_io.py::_load_image``'s geometry exactly: source
    coords map to canvas coords as ``(p - offset) * scale``.

    Args:
        paths: list of N file paths.
        canvas_hw: (H0, W0) static canvas.
        centers: [N, 2] float ROI centers in source coords.
        halves: [N] float half-window size; negative = whole image.
        n_threads: decode workers.

    Returns:
        (canvases [N,H0,W0,3] u8, offsets [N,2] f32, scales [N,2] f32,
         statuses [N] i32): status != 0 means that image needs the Python
         decode (non-JPEG, progressive, CMYK, IO error).

    Raises:
        RuntimeError: the native decoder is unavailable.
    """
    lib = _load()
    if lib is None:
        raise RuntimeError("native decoder unavailable")
    n = len(paths)
    H0, W0 = int(canvas_hw[0]), int(canvas_hw[1])
    canvases = np.zeros((n, H0, W0, 3), np.uint8)
    centers = np.ascontiguousarray(centers, np.float32).reshape(n, 2)
    halves = np.ascontiguousarray(halves, np.float32).reshape(n)
    geoms = np.zeros((n, 4), np.float32)
    statuses = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    lib.lhn_decode_roi_batch(
        n,
        c_paths,
        canvases.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        H0,
        W0,
        centers.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        halves.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        geoms.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        statuses.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        int(n_threads),
    )
    return canvases, geoms[:, :2].copy(), geoms[:, 2:].copy(), statuses
