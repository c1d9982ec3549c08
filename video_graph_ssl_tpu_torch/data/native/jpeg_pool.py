"""ctypes wrapper for the native JPEG decode pool (``jpeg_pool.cpp``).

Counterpart of ``video_graph_ssl_tpu/data/native/jpeg_pool.py``.  The pool
decodes a whole clip in one call on C++ threads with the GIL released,
using libjpeg's DCT-domain prescaling, then resizes bilinearly to the
canvas.  The shared object is built with g++ at first use into
``video_graph_ssl_tpu_torch/_build/`` (named by a hash of the source, so an
edited source builds anew) and loaded with ctypes.  When g++ or libjpeg is
missing, :class:`NativeJpegPool` raises with the build error: the port never
moves to another decoder on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "jpeg_pool.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-ljpeg", "-lpthread")

_lib = None
_lib_err: Optional[str] = None
_lock = threading.Lock()


def library_path() -> Path:
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(GXX_FLAGS + LIBS).encode())
    return BUILD_DIR / f"jpeg_pool-{digest.hexdigest()[:16]}.so"


def _build(so: Path) -> None:
    """g++ into a temporary file beside ``so``, then an atomic rename, so
    processes building at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        cmd = ["g++", *GXX_FLAGS, str(_SRC), "-o", tmp, *LIBS]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        if res.returncode != 0:
            raise RuntimeError(f"{' '.join(cmd)} failed:\n{res.stderr[-2000:]}")
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            so = library_path()
            if not so.exists():
                _build(so)
            lib = ctypes.CDLL(str(so))
            lib.jp_pool_create.restype = ctypes.c_void_p
            lib.jp_pool_create.argtypes = [ctypes.c_int]
            lib.jp_pool_destroy.argtypes = [ctypes.c_void_p]
            lib.jp_decode_batch.restype = ctypes.c_int
            lib.jp_decode_batch.argtypes = [
                ctypes.c_void_p, ctypes.POINTER(ctypes.c_char_p),
                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                ctypes.POINTER(ctypes.c_ubyte)]
            _lib = lib
        except Exception as e:   # g++ or libjpeg missing: kept for the error
            _lib_err = f"{type(e).__name__}: {e}"
    return _lib


def native_jpeg_available() -> bool:
    return _load() is not None


class NativeJpegPool:
    """Persistent decode pool; one instance per loader process."""

    def __init__(self, n_threads: Optional[int] = None):
        lib = _load()
        if lib is None:
            raise RuntimeError(f"INPUT.PRE_LOAD native: the native JPEG pool "
                               f"did not build: {_lib_err}")
        self._lib = lib
        n = n_threads or max(os.cpu_count() or 1, 1)
        self._pool = lib.jp_pool_create(int(n))

    def decode_batch(self, paths: List[str], out_h: int, out_w: int) -> np.ndarray:
        """Decode ``paths`` -> (N, out_h, out_w, 3) uint8 RGB (bilinear);
        raises when any decode fails."""
        n = len(paths)
        out = np.empty((n, out_h, out_w, 3), np.uint8)
        arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
        failed = self._lib.jp_decode_batch(
            self._pool, arr, n, int(out_h), int(out_w),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
        if failed:
            raise IOError(f"native jpeg pool: {failed}/{n} decodes failed")
        return out

    def close(self):
        if self._pool:
            self._lib.jp_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
