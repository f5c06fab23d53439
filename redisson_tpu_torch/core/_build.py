"""Build and load the hand-written CUDA kernels of ``csrc/`` at first use.

Each ``.cu`` source has a plain C interface.  All of them are compiled at
once, one ``nvcc`` process each, into ``redisson_tpu_torch/_build/`` (listed
in .gitignore) for ``sm_90a``, and loaded with ctypes.  Every pointer and the
stream pass as ``c_void_p``; each entry point returns ``cudaGetLastError()``
after its launch, and ``check`` raises when that is not 0.  A library's file
name carries a digest of its sources and flags, so an edited source is
rebuilt and a stale library is never loaded.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _L, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float
_KEYS = [_P, _P, _P, _P, _P, _I, _I]  # tenant, lo, hi, words, nbytes, n_words, n
_PROBES = [_I, _I, _L, _U]  # n_valid, k, m, fastmod_magic(m)

# library -> {entry point: argtypes}; every entry point returns int.
SIGNATURES = {
    "bloom": {
        "rtpu_bloom_probe": [_P, _L, _L, *_KEYS, *_PROBES, _L, _I, _I, _P, _P],
        "rtpu_bloom_set": [_P, _L, _L, *_KEYS, *_PROBES, _L, _P],
        "rtpu_bloom_add": [_P, _L, _L, *_KEYS, *_PROBES, _I, _I, _P, _P, _P, _P, _P],
    },
    "hll": {
        "rtpu_hll_add": [_P, _L, _L, _I, *_KEYS, _I, _L, _P],
        "rtpu_hll_rows": [_P, _L, _P, _L, _P, _P, _L, _L, _P, _P, _F, _P],
    },
    "bitset": {
        "rtpu_bitset_get": [_P, _L, _P, _I, _L, _P, _P],
        "rtpu_bitset_set": [_P, _L, _P, _I, _I, _I, _L, _P, _P],
        "rtpu_bitset_get_groups": [_P, _I, _P, _P, _I, _P, _P],
        "rtpu_bitset_set_groups": [_P, _I, _I, _P, _P, _I, _P, _P],
    },
    "wordcount": {
        "rtpu_wc_words_auto": [_P, _L, _I, _I, _L, _P, _L, _P, _P, _P, _P],
        "rtpu_wc_words_deltas": [_P, _L, _P, _I, _I, _L, _P, _P, _P, _P, _P, _P],
        "rtpu_wc_sort_runs": [_P, _P, _P, _L, _L, _P, _P, _P, _P, _P, _P, _P, _P],
    },
    "segment": {
        "rtpu_segment_reduce": [_P, _I, _P, _I, _I, _L, _L, _P, _L, _P, _P],
    },
    "knn": {
        "rtpu_knn_score": [_P, _I, _P, _P, _P, _P, _L, _I, _L, _L, _I, _I, _P, _P],
        "rtpu_knn_select": [_P, _L, _L, _I, _P, _P, _P, _I, _L, _P, _P, _P],
        "rtpu_ivf_score": [_P, _I, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I, _I, _L, _I, _P, _P, _P],
    },
    "kmeans": {
        "rtpu_kmeans_assign": [_P, _P, _P, _L, _I, _I, _I, _P, _P],
        "rtpu_kmeans_update": [_P, _P, _P, _P, _L, _I, _I, _P, _P, _P],
    },
}

_lock = threading.Lock()
_libs: dict = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels build with the CUDA toolkit "
                       "(set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all() -> float:
    """Compile every library that is missing, all nvcc processes at once.
    Returns the wall seconds spent; nvcc's output goes to _build/*.log."""
    todo = [(name, _target(name)) for name in SIGNATURES]
    todo = [(name, t) for name, t in todo if not t.exists()]
    start = time.perf_counter()
    if todo:
        BUILD_DIR.mkdir(exist_ok=True)
        compiler = nvcc()
        procs = []
        for name, target in todo:
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            log = open(BUILD_DIR / f"{name}.log", "w")
            cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, target, tmp, log,
                          subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)))
        failed = []
        for name, target, tmp, log, proc in procs:
            rc = proc.wait()
            log.close()
            if rc == 0:
                os.replace(tmp, target)  # atomic: a reader never sees half a library
            else:
                failed.append(name)
        if failed:
            logs = "\n".join((BUILD_DIR / f"{n}.log").read_text() for n in failed)
            raise RuntimeError(f"nvcc failed for {failed}:\n{logs}")
    return time.perf_counter() - start


def bind(lib: ctypes.CDLL, name: str) -> ctypes.CDLL:
    """Set the argument and result types of library `name`'s entry points
    on a loaded handle of it."""
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    if name == "bloom":
        lib.rtpu_error_string.argtypes = [ctypes.c_int]
        lib.rtpu_error_string.restype = ctypes.c_char_p
    if name == "kmeans":
        lib.rtpu_kmeans_update_scratch.argtypes = [_L, _I]
        lib.rtpu_kmeans_update_scratch.restype = ctypes.c_int64
    if name == "wordcount":
        for fn in ("rtpu_wc_sort_region_bytes", "rtpu_wc_words_region_words"):
            getattr(lib, fn).argtypes = [_L]
            getattr(lib, fn).restype = ctypes.c_int64
    if name == "segment":
        lib.rtpu_segment_shared_keys.argtypes = []
        lib.rtpu_segment_shared_keys.restype = ctypes.c_int64
    return lib


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            _libs[name] = bind(ctypes.CDLL(str(_target(name))), name)
        return _libs[name]


def check(kernel: str, code: int) -> None:
    """Raise if a launch returned a CUDA error, in the shape torch gives its
    own (``torch.AcceleratorError("CUDA error: ...")``), so the server's
    fault taxonomy (``ioplane.is_retryable_device_fault``) reads a failed
    hand-kernel launch as it reads a failed torch op: -TRYAGAIN counted on
    the lane, or, for ``out of memory``, not retryable."""
    if code != 0:
        import torch

        msg = library("bloom").rtpu_error_string(code).decode()
        error = getattr(torch, "AcceleratorError", RuntimeError)
        raise error(f"CUDA error: {msg} (launching {kernel}, code {code})")
