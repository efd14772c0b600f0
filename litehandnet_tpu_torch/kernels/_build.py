"""Build the port's CUDA C++ sources into shared libraries for ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/litehandnet_tpu_torch/`` beside the
package, at first use. The library's file name carries a hash of its source,
the shared ``csrc/*.cuh`` headers and the flags, so an edit rebuilds it. ``build`` starts one ``nvcc`` per
source, all at once, and waits for every one of them.

Counted in every process, as the wrappers count ``.launches``: ``compiles``
holds the ``nvcc`` runs by source name, ``seconds`` the host seconds spent
in ``build`` and in ``load``'s ``ctypes.CDLL`` calls. The benchmark's
``kernel_build_s.serve`` reads ``seconds``, and notes the sum of
``compiles`` beside it (0 where the libraries were already built).
``bind`` gives a kernel's entry point once its library and wrapper agree.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

_PKG_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR.parent / "build" / "litehandnet_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}

compiles: Dict[str, int] = {}   # nvcc runs by source name
seconds = 0.0                   # host seconds in build and in loading


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and os.path.exists(path):
            return path
    raise RuntimeError("nvcc not found: the port's CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    # the shared headers are hashed too, so an edited header rebuilds
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        source += header.read_bytes()
    digest = hashlib.sha1(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build(names: Iterable[str]) -> None:
    """Compile every named source that has no current library.

    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside each library as ``.log``.

    Raises:
        RuntimeError: ``nvcc`` is missing or failed on a source.
    """
    global seconds
    t0 = time.perf_counter()
    try:
        _compile_missing(names)
    finally:
        seconds += time.perf_counter() - t0


def _compile_missing(names: Iterable[str]) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        compiles[name] = compiles.get(name, 0) + 1
        jobs.append((name, proc, tmp, out))
    errors = []
    for name, proc, tmp, out in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    global seconds
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        t0 = time.perf_counter()
        lib = _LIBS[name] = ctypes.CDLL(str(library_path(name)))
        seconds += time.perf_counter() - t0
    return lib


# (a function of the library, its return type, its int arguments, the
# value the wrapper computes for them)
Probe = Tuple[str, type, Tuple[int, ...], int]


def bind(name: str, entry: str, argtypes: Sequence, probes: Sequence[Probe]):
    """The function ``entry`` of ``csrc/<name>.cu``'s library, loaded (and
    built) once, its ``argtypes`` declared and its result a C int. Raises
    RuntimeError where a probe reads another value than the wrapper's."""
    lib = load(name)
    for function, restype, args, want in probes:
        fn = getattr(lib, function)
        fn.argtypes = [ctypes.c_int] * len(args)
        fn.restype = restype
        if fn(*args) != want:
            raise RuntimeError(f"csrc/{name}.cu and kernels/{name}.py "
                               "disagree on the launch plan")
    fn = getattr(lib, entry)
    # without argtypes ctypes passes every int as a 32-bit C int and cuts
    # the pointers
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn
