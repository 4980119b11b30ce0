"""Host allocator tuning for the streaming input pipeline (counterpart of
agrl_tpu/utils/hostmem.py).

The ClipLoader allocates MB-scale numpy arrays every batch (clip items,
collated batches, decode scratch). glibc malloc serves allocations above
M_MMAP_THRESHOLD (128 KB default) with fresh `mmap` regions and returns
them to the OS on free — so every batch's buffers are NEW pages that must
be zero-faulted on first touch, a cost that grows on hosts whose memory
is backed lazily (VMs).

`tune_malloc_for_streaming()` raises M_MMAP_THRESHOLD and
M_TRIM_THRESHOLD so batch-sized buffers live on the brk heap and get
REUSED warm across iterations. Trade-off: freed heap memory is retained
by the process (bounded by the pipeline's peak working set — tens of MB
per in-flight batch). Best-effort: silently a no-op off glibc.
"""

from __future__ import annotations

_done = False

# glibc malloc.h mallopt parameter numbers
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3


def tune_malloc_for_streaming(threshold_bytes: int = 1 << 30) -> bool:
    """Idempotent; returns True if mallopt was applied."""
    global _done
    if _done:
        return True
    try:
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        ok1 = libc.mallopt(_M_MMAP_THRESHOLD, threshold_bytes)
        ok2 = libc.mallopt(_M_TRIM_THRESHOLD, threshold_bytes)
        _done = bool(ok1 and ok2)
    except Exception:
        _done = False
    return _done
