"""Build and load the package's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` process per source, all started together, and the objects are
linked into one shared library with a plain C interface, loaded with
``ctypes``.
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
import tempfile
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-lineinfo")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C entry point -> argument types (every function returns an int error code)
SIGNATURES = {
    # adj, x, out, B, T, F, transpose, is_bf16, adj_f32, route, kpad,
    # blocks, per_warp, vec, stream
    "vgs_gcn_propagate": (_P, _P, _P, _I, _I, _L) + (_I,) * 8 + (_P,),
    # q, k, theta, u_in, adj, s, p, u_out, part, B, T, D, is_bf16, seed,
    # clip0, temperature, sample, nei_size, vec, tile, splits, per_split, stream
    "vgs_graph_adjacency": (_P,) * 9 + (_I, _I, _L, _I, ctypes.c_ulonglong, _I, _F)
                           + (_I,) * 6 + (_P,),
    # x, y, dy, dx, slabs, T, H, W, C, To, Ho, Wo, kt, kh, kw, st, sh, sw,
    # pt, ph, pw, group, threads, ts, hs, nxt, nxh, nyt, nyh, is_bf16, stream
    "vgs_maxpool3d_bwd": (_P, _P, _P, _P) + (_I,) * 26 + (_P,),
    # x, y, the call's 24 integers (a C int array: slabs, T, H, W, C, To, Ho,
    # Wo, kt, kh, kw, st, sh, sw, pt, ph, pw, group, threads, ts, hs, nxt,
    # nxh, is_bf16), stream
    "vgs_maxpool3d_fwd": (_P, _P, _P, _P),
    # x, w, bias (or null), frames (or null), y, the call's 43 integers (a C
    # long long array, ops/stem_conv.py:launch_args), stream
    "vgs_stem_conv3d_fwd": (_P,) * 7,
    # rows (a C long long array), the rows it holds: each instantiation's
    # NT, MT, launch bound and registers (ops/stem_conv.py:kernel_variants)
    "vgs_stem_conv3d_variants": (_P, _I),
    # x, g, ws, wt, g1, b1, g2, b2, mu1, var1, mu2, var2, f32 buffer,
    # compute-dtype buffer, dx, plan (int64 array), g's five strides,
    # g_vec, eps, stream
    "vgs_sepconv_bwd": (_P,) * 16 + (_L,) * 5 + (_I, _F, _P),
    # one stage of it (1, 2, 3): the same arguments with the fp32 output
    # buffer after the f32 one, and the reduced sums and global count
    # (null on one process) before the stream
    **{f"vgs_sepconv_bwd_stage{s}": (_P,) * 17 + (_L,) * 5 + (_I, _F, _P, _P, _P)
       for s in (1, 2, 3)},
    # fields of the plan array vgs_sepconv_bwd reads
    "vgs_sepconv_plan_fields": (),
}


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


def _run_all(cmds) -> None:
    """Start every command at once; after all have ended, raise on the
    first that failed."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for c in cmds]
    outputs = [p.communicate()[0] for p in procs]
    for cmd, p, output in zip(cmds, procs, outputs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{output}")


@functools.cache
def library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    out = library_path()
    if not out.exists():
        cu, _ = _sources()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
            objs = [os.path.join(tmp, f"{f.stem}.o") for f in cu]
            _run_all([[_nvcc(), *NVCC_FLAGS, "-c", "-o", o, str(f)]
                      for f, o in zip(cu, objs)])
            so = os.path.join(tmp, out.name)
            _run_all([[_nvcc(), *NVCC_FLAGS, "-shared", "-o", so, *objs]])
            os.replace(so, out)
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
