"""ctypes loader for the host RESP library (``native/resp.cpp``).

The library is host C++ (the RESP tokenizer and reply encoder, CRC16 slot
hashing, the LZ4 block codec), not a device kernel.  It is built with g++
at first use into ``redisson_tpu_torch/_build/`` under a name that carries a
digest of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded.  Every entry point degrades to pure Python
when the toolchain or the library is missing, or under ``RTPU_NO_NATIVE=1``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "resp.cpp"
BUILD_DIR = _PKG / "_build"
GXX_FLAGS = ["-O3", "-fPIC", "-shared", "-std=c++17"]

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


class RtpuToken(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_int32),
        ("flags", ctypes.c_int32),
        ("val", ctypes.c_int64),
        ("off", ctypes.c_uint64),
    ]


def library_path() -> Path:
    """Where the library built from the current source lives."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"librtpu-{h.hexdigest()[:16]}.so"


def _build(dst: Path) -> bool:
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = dst.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, dst)  # atomic: a reader never sees half a library
        return True
    except Exception:  # noqa: BLE001 — no toolchain: the Python codec serves
        return False
    finally:
        if tmp.exists():
            tmp.unlink()


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare every entry point; raises AttributeError on a library built
    from an older resp.cpp (missing symbols)."""
    lib.rtpu_resp_scan.restype = ctypes.c_int64
    lib.rtpu_resp_scan.argtypes = [
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_uint64,
        ctypes.POINTER(RtpuToken),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rtpu_encode_reply.restype = ctypes.c_int64
    lib.rtpu_encode_reply.argtypes = [
        ctypes.c_void_p,  # int32* ops (op | marker<<8)
        ctypes.c_void_p,  # int64* vals
        ctypes.c_void_p,  # int64* offs
        ctypes.c_uint64,
        ctypes.c_void_p,  # byte pool
        ctypes.c_void_p,  # output arena
        ctypes.c_uint64,
    ]
    lib.rtpu_lz4_compress.restype = ctypes.c_int64
    lib.rtpu_lz4_compress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_uint64,
    ]
    lib.rtpu_lz4_decompress.restype = ctypes.c_int64
    lib.rtpu_lz4_decompress.argtypes = [
        ctypes.c_char_p,
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_char),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint64),
    ]
    lib.rtpu_crc16.restype = ctypes.c_uint16
    lib.rtpu_crc16.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.rtpu_calc_slots.restype = None
    lib.rtpu_calc_slots.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint16),
    ]
    return lib


def load() -> Optional[ctypes.CDLL]:
    """The native library, or None if unavailable (pure-Python fallback)."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if os.environ.get("RTPU_NO_NATIVE"):
            return None
        path = library_path()
        if not path.exists() and not _build(path):
            return None
        try:
            _lib = _bind(ctypes.CDLL(str(path)))
        except (OSError, AttributeError):
            return None
        return _lib
