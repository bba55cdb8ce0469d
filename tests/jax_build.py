"""The JAX package's native library, built once a test process under a
lock between processes.

xsqueezeit_tpu.interop.native.build_native serializes its builds with a
thread lock only, and make writes the library in place: two pytest-xdist
workers that touch it first run make at once, and one of them can load a
half-written library ("file too short").  A port test module that calls
the JAX package's CLI or native library imports jax_native_built, an
autouse fixture, so the library is built under the lock before any of
its fixtures or tests run: one worker builds, the others wait for the
finished file.
"""
from __future__ import annotations

import fcntl

import pytest

from xsqueezeit_tpu.interop import native

_built = False


def build_jax_native() -> str:
    """Build (or find up to date) native/libxsqueezeit_tpu.so under an
    exclusive flock on a file beside it, once in this process; returns
    its path."""
    global _built
    if not _built:
        with open(native._LIB_PATH + ".lock", "a") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            native.build_native()
        _built = True
    return native._LIB_PATH


@pytest.fixture(scope="module", autouse=True)
def jax_native_built() -> str:
    """build_jax_native() before the importing module's first test."""
    return build_jax_native()
