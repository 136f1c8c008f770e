"""Builder and loader of the hand-written CUDA kernels (``csrc/*.cu``).

At first use each source is compiled with ``nvcc`` for ``sm_90a`` (one
process per source, all started together), the objects are linked into
``build/torch_kernels/libbrpc_tpu_torch_kernels.so``, and the library is
loaded with ctypes. The build is keyed by a hash of the sources and flags
(a stamp file beside the library) and serialised by an ``fcntl`` lock.
Every C entry point returns ``cudaGetLastError()``; ``check`` raises on a
nonzero code. Nothing here runs at import time: this module imports on
machines without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC_DIR = os.path.join(_PKG, "csrc")
_REPO = os.path.dirname(_PKG)
BUILD_DIR = os.path.join(_REPO, "build", "torch_kernels")
LIB_PATH = os.path.join(BUILD_DIR, "libbrpc_tpu_torch_kernels.so")
PTXAS_LOG = os.path.join(BUILD_DIR, "ptxas.log")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Dtype codes shared with csrc/common.cuh.
DTYPE_FLOAT32 = 0
DTYPE_BFLOAT16 = 1

_lib = None


def _nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _sources() -> list:
    return sorted(f for f in os.listdir(_SRC_DIR) if f.endswith(".cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(os.listdir(_SRC_DIR)):
        h.update(name.encode())
        with open(os.path.join(_SRC_DIR, name), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


def build() -> str:
    """Compile and link the kernels if the stamp does not match the
    sources; returns the library path."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    stamp = LIB_PATH + ".sha256"
    want = _source_hash()
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if (os.path.exists(LIB_PATH) and os.path.exists(stamp)
                and open(stamp).read() == want):
            return LIB_PATH
        nvcc = _nvcc()
        procs = []
        for src in _sources():
            obj = os.path.join(BUILD_DIR, src[:-3] + ".o")
            procs.append((src, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", os.path.join(_SRC_DIR, src),
                 "-o", obj], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True)))
        logs = []
        for src, _, proc in procs:
            out, _ = proc.communicate()
            logs.append(f"== {src}\n{out}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{out[-6000:]}")
        with open(PTXAS_LOG, "w") as f:
            f.write("\n".join(logs))
        tmp = LIB_PATH + f".tmp{os.getpid()}"
        link = subprocess.run(
            [nvcc, "-shared", "-gencode", "arch=compute_90a,code=sm_90a",
             *[obj for _, obj, _ in procs], "-o", tmp],
            capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"kernel link failed:\n{link.stderr[-4000:]}")
        os.replace(tmp, LIB_PATH)
        with open(stamp, "w") as f:
            f.write(want)
    return LIB_PATH


def lib() -> ctypes.CDLL:
    """Build if needed, load once, and declare the entry points."""
    global _lib
    if _lib is not None:
        return _lib
    handle = ctypes.CDLL(build())
    i32, i64, f32, ptr = (ctypes.c_int, ctypes.c_longlong, ctypes.c_float,
                          ctypes.c_void_p)
    handle.brpc_rms_norm.argtypes = [i32, ptr, ptr, ptr, i64, i32, f32, ptr]
    handle.brpc_paged_decode_attention.argtypes = [
        i32, ptr, ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, i32,
        i64, i64, i64, f32, ptr]
    handle.brpc_prefill_attention.argtypes = [
        i32, ptr, ptr, ptr, ptr, i32, i32, i32, i32, i32, f32, ptr]
    for fn in (handle.brpc_rms_norm, handle.brpc_paged_decode_attention,
               handle.brpc_prefill_attention):
        fn.restype = ctypes.c_int
    _lib = handle
    return _lib


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
