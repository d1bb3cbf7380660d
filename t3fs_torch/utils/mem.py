"""Process-memory accounting (reference src/memory/ analog).

The reference ships pluggable jemalloc/mimalloc shims behind
GlobalMemoryAllocator/OverrideCppNewDelete.h plus an AllocatedMemoryCounter
(src/memory/, 715 LoC).  t3fs's decision, recorded here:

- The Python data plane uses CPython's allocator — overriding it buys
  nothing (pymalloc already arena-pools small objects, and the hot path
  holds bytes/memoryviews whose backing stores come from the registered
  BufferPool, t3fs_torch/net/rdma.py, which is the real allocation-discipline
  seam).  No allocator shim is built for Python, deliberately.
- The native C++ chunk engine (t3fs_torch/csrc/chunk_engine.cpp) allocates at
  startup and per-WAL-record only; its buffers are caller-provided from
  the pooled registry, so a malloc override is similarly unwarranted.
- What the reference's AllocatedMemoryCounter delivers — live visibility
  of process memory in the metric pipeline — IS kept: MemoryWatcher below
  samples RSS / python-heap / native-lib counters into ValueRecorders that
  every server's monitor Collector reports.

The port of t3fs/utils/mem.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import gc
import os
import sys

from t3fs_torch.utils.metrics import ValueRecorder


def _statm_pages() -> tuple[int, int]:
    """(size, resident) in pages from /proc/self/statm (no psutil dep)."""
    try:
        with open("/proc/self/statm") as f:
            parts = f.read().split()
        return int(parts[0]), int(parts[1])
    except (OSError, IndexError, ValueError):
        return 0, 0


class MemoryWatcher:
    """Samples process-memory gauges on each monitor collection tick
    (AllocatedMemoryCounter analog: the reference reports per-allocator
    counters; here vsize/rss plus the GC's live-object census)."""

    def __init__(self, tags: dict[str, str] | None = None):
        self.page = os.sysconf("SC_PAGESIZE")
        self.vsize = ValueRecorder("mem.vsize_bytes", tags)
        self.rss = ValueRecorder("mem.rss_bytes", tags)
        self.py_alloc_blocks = ValueRecorder("mem.py_alloc_blocks", tags)
        self.gc_tracked = ValueRecorder("mem.gc_tracked_gen2", tags)

    def sample(self) -> dict[str, float]:
        size, resident = _statm_pages()
        self.vsize.set(size * self.page)
        self.rss.set(resident * self.page)
        # cheap counters only: len(gc.get_objects()) would materialize a
        # list of every live object on each tick
        self.py_alloc_blocks.set(sys.getallocatedblocks())
        self.gc_tracked.set(gc.get_count()[2])
        return {
            "vsize_bytes": size * self.page,
            "rss_bytes": resident * self.page,
        }
