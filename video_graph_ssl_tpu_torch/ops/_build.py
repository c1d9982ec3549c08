"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper (``sm_90a``)
into one shared library with a plain C interface, loaded with ``ctypes``.
The library is built at first use, cached by a hash of the sources and
flags under ``video_graph_ssl_tpu_torch/_build/`` (listed in
``.gitignore``), and reused by later processes.  No PyTorch header is
compiled, so a build takes seconds.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` raises when that code is not 0 (a refused launch never runs
and ``torch.cuda.synchronize`` would not report it).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argument types (every function returns an int error code)
SIGNATURES = {
    # adj, x, out, B, T, F, transpose, is_bf16, stream
    "vgs_gcn_propagate": (_P, _P, _P, _I, _I, _L, _I, _I, _P),
    # q, k, theta, u_in, adj, s, p, u_out, B, T, D, is_bf16,
    # seed, temperature, sample, nei_size, stream
    "vgs_graph_adjacency": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _L, _I,
                            ctypes.c_ulonglong, _F, _I, _I, _P),
}

# seconds the last build of this process took (0.0 when it came from cache)
last_build_seconds = 0.0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = [os.path.join(home, "bin", "nvcc")] if home else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "video_graph_ssl_tpu_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    cu, cuh = _sources()
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in cu + cuh:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return BUILD_DIR / f"libvgs_kernels_{h.hexdigest()[:16]}.so"


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global last_build_seconds
    out = library_path()
    if not out.exists():
        cu, _ = _sources()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, cu)]
        t0 = time.perf_counter()
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed ({res.returncode}):\n"
                               f"{' '.join(cmd)}\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        last_build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(str(out))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(code: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point."""
    if code != 0:
        raise RuntimeError(f"{name}: CUDA error {code} at launch")
