"""Host allocator tuning for large-buffer churn (flownet2_tpu/core/hostmem.py).

The loader's prefetch ring and the device cache's refresh thread allocate
and free multi-MB host buffers all the time (a batch of 384x512 pairs is
about 16 MB, a cache slab of 64 samples about 128 MB). With glibc's
defaults every allocation above M_MMAP_THRESHOLD (128 KB) is a fresh
anonymous mmap that is unmapped on free, so each one pays the kernel's page
zeroing again on first touch. ``tune_host_allocator`` raises the mmap
threshold and the trim threshold so that glibc serves big buffers from its
reused heap: the zeroing is paid once per high-water mark instead of once
per allocation. Freed big buffers stay with the process (its resident size
stays at the high-water mark), which a training host wants.

A no-op off glibc.
"""

from __future__ import annotations

import ctypes

# glibc mallopt parameter numbers (bits/malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3

_done = False


def tune_host_allocator() -> bool:
    """Raise glibc's mmap and trim thresholds to 1 GiB. Idempotent.

    Returns True if the tuning is in effect (glibc present and ``mallopt``
    accepted both settings), False otherwise."""
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        ok = bool(libc.mallopt(_M_MMAP_THRESHOLD, 1 << 30)) and bool(libc.mallopt(_M_TRIM_THRESHOLD, 1 << 30))
    except (OSError, AttributeError):  # not glibc
        return False
    _done = ok
    return ok
