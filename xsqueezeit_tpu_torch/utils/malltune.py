"""glibc malloc tuning for allocation-heavy numpy pipelines.

glibc promotes allocations above 128 KB to mmap and returns them to the
kernel on free, so every block encode/decode pays a first-touch
page-fault storm on the same few-hundred-MB of temporaries over and over
(measured on the bench host: ~30x on a fresh 32 MB `np.where` chain).
Raising M_MMAP_THRESHOLD keeps the big blocks on the heap, where glibc
reuses them.  Applications tune their allocator; the library never calls
this on import — the CLI and bench entry points opt in.
"""
from __future__ import annotations

import ctypes
import sys

M_MMAP_THRESHOLD = -3


def tune_glibc_malloc(threshold: int = 1 << 30) -> bool:
    """Raise the mmap threshold so freed numpy buffers are reused.
    Returns True when applied; no-op (False) off glibc/Linux."""
    if not sys.platform.startswith("linux"):
        return False
    try:
        libc = ctypes.CDLL("libc.so.6")
        return bool(libc.mallopt(M_MMAP_THRESHOLD, threshold))
    except Exception:
        return False
