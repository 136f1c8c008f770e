"""The JAX package's native runtime, which the parity tests load through
``brpc_tpu.runtime``, built once for the whole test run.

``brpc_tpu/native.py`` builds ``build/libtpurpc.so`` (and the C++ test
binaries) on first use and takes no lock. Test workers that reach it at
the same moment run cmake and ninja in one directory at once and break
each other's configure or link: a cache that lost zlib, objects missing
from the link, a half-written library that segfaults when loaded. Every
worker imports this module while it collects, before any test runs, so
building here under a file lock leaves one fresh library for all of
them, and each later ``build()`` finds nothing stale.

A stopgap: it works only in runs that collect this file, and
``pytest --collect-only`` starts the native build too. Delete this module
once ``brpc_tpu/native.py`` takes its own lock, or once the test harness
builds the runtime before the tests start.
"""

import fcntl
import os

from brpc_tpu import native as jax_native

_BUILD_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")


def _build_once():
    """The library's path, or the build's error (left for the test below
    and for the tests that load the library to report)."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, ".jax_native_build.lock"),
              "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return jax_native.build()
        except RuntimeError as e:
            return e


_BUILT = _build_once()


def test_jax_native_runtime_built_before_the_tests():
    assert not isinstance(_BUILT, Exception), _BUILT
    assert os.path.exists(_BUILT)
