"""Builder and loader of the native runtime (libtpurpc.so) for this package.

Compiles the C++ tree under ``cpp/`` with plain g++ (no cmake) into
``build/torch_native/libtpurpc.so`` (libstdc++ linked in statically and
only the ``trpc_*`` C API exported, see ``_build``), with an object cache
in ``build/torch_native/obj``, and loads it with ctypes. An ``fcntl`` lock
around the build keeps concurrent processes (test workers) from racing on
the same outputs. ``cpp/`` is compiled as it is, against the system's
zlib (``<zlib.h>``, ``-lz``).
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import platform
import re
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CPP_DIR = os.path.join(_REPO, "cpp")
_BUILD_DIR = os.path.join(_REPO, "build", "torch_native")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtpurpc.so")

_lib = None
_lib_mu = threading.Lock()

def _lib_srcs() -> list:
    """Library .cc list, parsed out of cpp/CMakeLists.txt's set(*_SRCS ...)
    blocks so this build and the cmake build compile the same units."""
    text = open(os.path.join(_CPP_DIR, "CMakeLists.txt")).read()
    srcs = []
    for block in re.findall(r"set\(\w+_SRCS\s*\n(.*?)\)", text, re.DOTALL):
        srcs += re.findall(r"^\s*([\w/]+\.cc)\s*$", block, re.MULTILINE)
    if not srcs:
        raise RuntimeError("could not parse *_SRCS from cpp/CMakeLists.txt")
    return srcs


def _newest_mtime(exts) -> float:
    newest = 0.0
    for root, _, files in os.walk(_CPP_DIR):
        for f in files:
            if f.endswith(exts):
                newest = max(newest, os.path.getmtime(os.path.join(root, f)))
    return newest


def _build(cxx: str) -> None:
    obj_dir = os.path.join(_BUILD_DIR, "obj")
    srcs = _lib_srcs()
    if platform.machine() in ("x86_64", "AMD64"):
        srcs.append("tsched/context_x86_64.S")
    elif platform.machine() in ("aarch64", "arm64"):
        srcs.append("tsched/context_aarch64.S")
    hdr_mtime = _newest_mtime((".h",))
    cflags = ["-std=c++20", "-fPIC", "-O2", "-pthread",
              "-fno-omit-frame-pointer", "-I", _CPP_DIR]

    def compile_one(src: str) -> str:
        src_path = os.path.join(_CPP_DIR, src)
        obj_path = os.path.join(obj_dir, src.replace("/", "_") + ".o")
        if (os.path.exists(obj_path)
                and os.path.getmtime(obj_path) > os.path.getmtime(src_path)
                and os.path.getmtime(obj_path) > hdr_mtime):
            return obj_path
        os.makedirs(obj_dir, exist_ok=True)
        proc = subprocess.run([cxx, *cflags, "-c", src_path, "-o", obj_path],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"native build failed: {src}\n{proc.stderr[-4000:]}")
        return obj_path

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 4) as pool:
        objs = list(pool.map(compile_one, srcs))
    tmp = _LIB_PATH + f".tmp{os.getpid()}"
    # The C++ runtime is linked in statically. Linked against the shared
    # libstdc++ instead, the runtime's metrics sampler thread crashed in
    # std::ostream number formatting (a locale facet lookup) in processes
    # that had PyTorch's CUDA libraries loaded (g++ 13, Ubuntu 24.04).
    # Every symbol but the C API is local: g++ gives template statics
    # (the tvar combiners' globals, trpc::Extension registries) the
    # process-wide STB_GNU_UNIQUE binding, so exported they would be merged
    # with those of the other copy of the runtime that the parity tests
    # load in the same process (the JAX package's, built against the
    # shared libstdc++).
    exports = os.path.join(_BUILD_DIR, "exports.map")
    with open(exports, "w") as f:
        f.write("{ global: trpc_*; local: *; };\n")
    proc = subprocess.run([cxx, "-shared", "-pthread", *objs, "-lz", "-ldl",
                           "-static-libstdc++", "-static-libgcc",
                           f"-Wl,--version-script={exports}",
                           "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native link failed:\n{proc.stderr[-4000:]}")
    os.replace(tmp, _LIB_PATH)


def build(force: bool = False) -> str:
    """Build libtpurpc.so if it is missing or older than any file under
    cpp/ or than this builder; returns its path."""
    if not os.path.isdir(_CPP_DIR):
        raise RuntimeError("cpp/ tree not present in this checkout")
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise RuntimeError("native build failed: no g++")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        stale = (force or not os.path.exists(_LIB_PATH)
                 or os.path.getmtime(_LIB_PATH)
                 < max(_newest_mtime((".h", ".cc", ".S", ".txt")),
                       os.path.getmtime(__file__)))
        if stale:
            _build(cxx)
    return _LIB_PATH


def lib() -> ctypes.CDLL:
    """Load (building if needed) and return the native library handle:
    one ``CDLL`` object per process, also when the first calls come from
    several threads at once (a second object would miss the argtypes and
    restypes ``runtime`` configures on the first)."""
    global _lib
    if _lib is None:
        with _lib_mu:
            if _lib is None:
                _lib = ctypes.CDLL(build())
    return _lib


if __name__ == "__main__":
    print(build(force=True))
