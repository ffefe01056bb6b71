"""Build and load the port's CUDA kernels.

The sources under ``catch_tpu_torch/csrc/`` are compiled by ``nvcc`` for
Hopper (``sm_90a``), one ``nvcc`` per source and all of them at once,
and linked into one shared library with a plain C interface, which is
loaded with ``ctypes``.  The build happens at first use, from
the checkout's own sources, into ``build/catch_tpu_torch/<hash>/`` next
to the package, keyed by a hash of the sources and the compiler flags,
so an edited source builds anew and an unchanged one loads at once.  A
failed build raises with the compiler's output.

Every C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``; ``check`` turns a nonzero
code into an exception.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

__all__ = ["library", "check", "ptr", "stream_of", "build_seconds"]

_PKG = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(os.path.dirname(_PKG), "build", "catch_tpu_torch")
LIB_NAME = "libcatch_tpu_torch.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int

# C signatures of every entry point (all return int: cudaGetLastError).
_SIGNATURES = {
    "ct_rolling_hash": [_P, _I64, _I64, _I32, _I64, _P, _P],
    "ct_lookup": [_P, _I64, _P, _I64, _P, _P, _P],
    "ct_expand": [_P, _P, _P, _I64, _P, _P, _I64, _P, _P],
    "ct_unique_flags": [_P, _I64, _P, _P],
    "ct_unique_emit": [_P, _P, _P, _I64, _P, _P, _P],
    "ct_verify_count": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
                        _I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                        _I64, _P, _P],
    "ct_verify_emit": [_P, _P, _P, _P, _P, _I64, _P, _P, _P, _P, _P,
                       _I64, _I32, _I32, _I32, _I32, _I32, _I32, _I32,
                       _I64, _P, _P, _P, _P, _P],
    "ct_verify_spans_count": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                              _I32, _I32, _I32, _I32, _P, _P],
    "ct_verify_spans_emit": [_P, _P, _P, _P, _P, _P, _P, _P, _I64, _I32,
                             _I32, _I32, _I32, _I32, _P, _P, _P, _P, _P],
    "ct_expand_join": [_P, _P, _P, _P, _I64, _P, _P, _I64, _P, _P],
    "ct_join_emit": [_P, _P, _P, _I64, _I64, _P, _P, _P],
    "ct_merge_block_scan": [_P, _P, _I64, _P, _P, _P, _P, _P],
    "ct_merge_carry": [_P, _P, _I64, _P, _P],
    "ct_merge_fixup": [_P, _P, _P, _I64, _P, _P, _P],
    "ct_merge_emit": [_P, _P, _P, _P, _I64, _P, _P, _P, _P],
    "ct_minhash_dists": [_P, _I64, _P, _I64, _I32, _P, _P],
    "ct_minhash_codes": [_P, _I64, _P, _I64, _I32, _I32, _I32, _P, _P],
    "ct_minhash_caps": [_P, _I64, _P, _I64, _I32, _I32, _P, _P],
    "ct_minhash_assign": [_P, _I64, _P, _I64, _I32, _I32, _P, _P, _P],
    "ct_minhash_sig": [_P, _I64, _I32, _P, _I32, _P, _P],
    "ct_pack_rows": [_P, _P, _P, _I64, _I32, _P, _P, _P],
    "ct_pack_escapes": [_P, _P, _P, _P, _I64, _P, _P, _P, _P],
}

_lock = threading.Lock()
_lib = None
# Wall seconds this process spent compiling (0.0 when the library was
# already built for these sources); None before the first load.
build_seconds = None


def sources():
    """The kernel sources, in a fixed order."""
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def source_hash():
    h = hashlib.sha256()
    for path in sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc was not found on PATH or under /usr/local/cuda; "
                       "the CUDA kernels cannot be built")


def _run(cmd):
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed (exit %d):\n%s\n%s\n%s" % (
            proc.returncode, " ".join(cmd), proc.stdout, proc.stderr))


def _compile(out_path):
    """One nvcc per source, all started together, then one link."""
    tag = f"{os.getpid()}.tmp"
    nvcc = _nvcc()
    cus = [p for p in sources() if p.endswith(".cu")]
    objs = [f"{out_path}.{os.path.basename(p)}.{tag}.o" for p in cus]
    with ThreadPoolExecutor(max_workers=len(cus)) as pool:
        list(pool.map(_run, [[nvcc] + NVCC_FLAGS + ["-c", src, "-o", obj]
                             for src, obj in zip(cus, objs)]))
    tmp = f"{out_path}.{tag}"
    _run([nvcc] + NVCC_FLAGS + ["-shared", "-o", tmp] + objs)
    for obj in objs:
        os.remove(obj)
    os.replace(tmp, out_path)


def library():
    """The loaded kernel library, built first if needed."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = os.path.join(BUILD_ROOT, source_hash())
        out_path = os.path.join(out_dir, LIB_NAME)
        t0 = time.time()
        if not os.path.exists(out_path):
            os.makedirs(out_dir, exist_ok=True)
            _compile(out_path)
        build_seconds = time.time() - t0
        lib = ctypes.CDLL(out_path)
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ct_error_string.argtypes = [ctypes.c_int]
        lib.ct_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err, name):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = _lib.ct_error_string(err).decode()
        raise RuntimeError(f"CUDA kernel {name} failed: error {err} ({msg})")


def ptr(t):
    """Device pointer of a contiguous tensor, for a c_void_p argument."""
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t):
    """The current CUDA stream of the tensor's device."""
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
