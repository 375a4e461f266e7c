"""Host allocator tuning for large-buffer serving workloads.

A copy of `tune_host_allocator` from `basic_pitch_tpu/utils/hostmem.py` (the
port imports nothing of the JAX package). A server allocates multi-MB PCM
and event buffers per request; glibc malloc serves blocks above its mmap
threshold from fresh ``mmap`` regions, so every request re-faults their
pages. ``tune_host_allocator`` raises glibc's mmap and trim thresholds via
``mallopt`` so freed large blocks stay on the warm heap and are reused.

Trade-off: the process keeps its high-water allocation instead of returning
memory to the OS, the usual posture of a long-running daemon. The call site
is the long-running engine (`serve.make_server`), never library import.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import logging

logger = logging.getLogger(__name__)

# glibc mallopt parameter numbers (malloc.h)
_M_TRIM_THRESHOLD = -1
_M_MMAP_THRESHOLD = -3
_M_ARENA_MAX = -8

_tuned = False


def tune_host_allocator(threshold_bytes: int = 1 << 30) -> bool:
    """Keep large freed blocks on the warm heap (idempotent, best-effort).

    Three settings: raised mmap/trim thresholds keep big freed blocks
    heap-resident, and ``M_ARENA_MAX=1`` routes worker threads (HTTP
    handlers, the dispatch thread) through the main arena — non-main glibc
    arenas cap their heaps at 64 MB, so a >64 MB buffer allocated on a
    worker thread falls back to mmap (and re-faults) no matter the
    threshold. Processes that want arena concurrency back can pass a larger
    arena cap via glibc env vars.

    Returns True when glibc accepted all settings; False (and logs once)
    on non-glibc platforms, where the call is a safe no-op.
    """
    global _tuned
    if _tuned:
        return True
    try:
        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        mallopt = libc.mallopt
        mallopt.argtypes = (ctypes.c_int, ctypes.c_int)
        mallopt.restype = ctypes.c_int
        ok = (
            bool(mallopt(_M_ARENA_MAX, 1))
            and bool(mallopt(_M_MMAP_THRESHOLD, threshold_bytes))
            and bool(mallopt(_M_TRIM_THRESHOLD, threshold_bytes))
        )
    except (OSError, AttributeError) as exc:  # non-glibc / static libc
        logger.info("host allocator tuning unavailable: %s", exc)
        return False
    if ok:
        _tuned = True
    else:
        logger.info("mallopt rejected allocator thresholds")
    return ok
