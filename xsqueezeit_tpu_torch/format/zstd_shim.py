"""Lets the JAX package's container import where `zstandard` is missing.

xsqueezeit_tpu/format/container.py imports `zstandard` at module level,
though only files with zstd blocks (or `--zstd`) use it.  Importing this
module first makes the container importable without the package: when
`import zstandard` fails, a stand-in module takes its place whose
compressor and decompressor raise :class:`ZstdUnavailable`.  Files
without zstd blocks then compress and extract as usual; a zstd file, or
`--zstd`, fails with one clear line.  Where `zstandard` is installed this
module changes nothing.
"""
from __future__ import annotations

import sys
import types

MESSAGE = ("this .xsi uses zstd blocks (or --zstd was given); the "
           "`zstandard` package is not installed")


class ZstdUnavailable(RuntimeError):
    """A zstd block was to be read or written without `zstandard`."""


class _Unavailable:
    def __init__(self, *args, **kwargs):
        raise ZstdUnavailable(MESSAGE)


try:
    import zstandard  # noqa: F401
except ImportError:
    _stub = types.ModuleType("zstandard")
    _stub.__doc__ = "Stand-in for the missing zstandard package."
    _stub.ZstdCompressor = _Unavailable
    _stub.ZstdDecompressor = _Unavailable
    sys.modules["zstandard"] = _stub
