"""Build and load the package's CUDA kernels.

The sources are ``xsqueezeit_tpu_torch/csrc/*.cu``.  At first use they are
compiled with ``nvcc`` for Hopper (``sm_90a``) into one shared library with
a plain C interface, ``xsqueezeit_tpu_torch/build/libxsi_kernels.so``, which
is loaded with ctypes.  The library is rebuilt whenever a source is newer
than it.  Nothing here runs at import time: a machine without a CUDA
toolkit imports every module of the package and only fails when a kernel
is launched.

Every C entry point takes device pointers, sizes and the stream, launches
on that stream and returns ``cudaGetLastError()``; :func:`launch` passes
torch's current stream of the tensors' device and raises if that is not 0.
"""
from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading
import time

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
LIB_PATH = os.path.join(BUILD_DIR, "libxsi_kernels.so")

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_S = ctypes.c_size_t
#: C entry points: name -> argument types (each returns a cudaError_t).
ENTRY_POINTS = {
    "xsi_chain_encode": (_P, _P, _P, _I, _I, _I, _P),
    "xsi_chain_decode": (_P, _P, _P, _I, _I, _I, _I, _P),
    "xsi_chain_encode_cluster": (_P, _P, _P, _I, _I, _I, _I, _P),
    "xsi_chain_encode_parity": (_P, _P, _P, _I, _I, _I, _P),
    "xsi_chain_encode_parity_cluster": (_P, _P, _P, _I, _I, _I, _I, _P),
    "xsi_chain_decode_rows": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    "xsi_wah_expand": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "xsi_wah_compress": (_P, _I, _P, _P, _I, _I, _I, _I, _P),
    "xsi_rank_chain": (_P, _P, _P, _P, _P, _S, _I, _I, _P),
    "xsi_decode_scan_mixed": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _P),
    "xsi_decode_run_flush": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                             _I, _I, _I, _P),
    "xsi_sparse_lines": (_P, _P, _P, _P, _P, _I, _I, _S, _P),
    "xsi_dot_rows": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: Seconds the last nvcc run of this process took (None: no build ran).
last_build_seconds: float | None = None


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA "
                           "kernels cannot be built")
    return found


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB_PATH):
        return True
    built = os.path.getmtime(LIB_PATH)
    deps = sources() + glob.glob(os.path.join(CSRC_DIR, "*.cuh"))
    return any(os.path.getmtime(p) > built for p in deps)


def _run_all(cmds: list[list[str]]) -> None:
    """Run the commands side by side; raise with the output of the first
    one that fails, after all have ended."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, out in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError("nvcc failed:\n" + " ".join(c) + "\n" + out)


def build(force: bool = False) -> str:
    """Compile the kernels if the library is missing or stale; returns its
    path.  Each source compiles to an object in its own nvcc process, all
    at once, and one more links them.  The library is written under a
    temporary name and renamed into place, so a reader never sees a
    half-written file."""
    global last_build_seconds
    if not force and not _stale():
        return LIB_PATH
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = [os.path.join(BUILD_DIR, os.path.basename(src)[:-3] + f".{tag}.o")
            for src in sources()]
    tmp = f"{LIB_PATH}.{tag}"
    t0 = time.perf_counter()
    try:
        _run_all([[nvcc(), *NVCC_FLAGS, "-c", "-o", obj, src]
                  for src, obj in zip(sources(), objs)])
        _run_all([[nvcc(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.unlink(obj)
    os.replace(tmp, LIB_PATH)
    last_build_seconds = time.perf_counter() - t0
    return LIB_PATH


def library() -> ctypes.CDLL:
    """The loaded kernel library (built at first use)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            lib.xsi_cuda_error_string.argtypes = [ctypes.c_int]
            lib.xsi_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(device, name: str, *args) -> None:
    """Call C entry point `name` with `args` and the current stream of CUDA
    `device`; raise if its launch reported an error."""
    import torch

    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, name)(*args, stream)
    if rc != 0:
        msg = lib.xsi_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA error {rc} ({msg})")
