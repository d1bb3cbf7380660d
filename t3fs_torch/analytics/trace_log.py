"""Structured event log: dataclass entries -> Parquet, async append.

Reference analog: src/analytics/ — SerdeObjectWriter/Reader bridge serde
objects to Apache Arrow/Parquet (SerdeObjectReader.h:2-4), and
StructuredTraceLog<T>::newEntry/append batches entries into row groups off
the hot path (StructuredTraceLog.h:84-96,239).  Storage writes one
StorageEventTrace per update (StorageOperator.h:153).

Entries are flat dataclasses (str/int/float/bool fields).  append() is
lock-cheap and never blocks on IO: a background thread flushes row groups.

The port of t3fs/analytics/trace_log.py, a copy: the same columns, so either
package reads the other's files.  pyarrow is imported where the reference
imports it, in StructuredTraceLog.__init__ and the readers, so a sink asked
for on a machine without pyarrow fails when it is opened.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
from dataclasses import dataclass
from typing import Any, Iterator

_log = logging.getLogger("t3fs_torch.analytics")


@dataclass
class StorageEventTrace:
    """Per-update trace row (reference StorageEventTrace fields trimmed to
    the t3fs update path: StorageOperator.cc:356-361,399,461-462,509)."""
    ts: float = 0.0
    node_id: int = 0
    target_id: int = 0
    chain_id: int = 0
    chunk_id: str = ""
    update_ver: int = 0
    commit_ver: int = 0
    update_type: str = ""      # write | truncate | remove
    length: int = 0
    checksum: int = 0
    forward_status: int = 0
    commit_status: int = 0
    latency_s: float = 0.0
    # write-pipeline decomposition (appended last for schema stability):
    # forward_s = time awaiting the successor leg, apply_s = local
    # CRC+apply leg; under overlap the two windows run concurrently, so
    # latency_s ≈ max(...) + commit instead of their sum
    forward_s: float = 0.0
    apply_s: float = 0.0


class StructuredTraceLog:
    """Async columnar appender for one dataclass type."""

    def __init__(self, entry_cls: type, path: str,
                 rows_per_group: int = 4096, flush_interval_s: float = 1.0):
        assert dataclasses.is_dataclass(entry_cls)
        self.entry_cls = entry_cls
        self.path = path
        self.rows_per_group = rows_per_group
        self._fields = [f.name for f in dataclasses.fields(entry_cls)]
        self._buf: list[tuple] = []
        self._lock = threading.Lock()
        self._flush_ev = threading.Event()
        self._stop = threading.Event()
        self._writer = None          # lazy pyarrow writer
        # import pyarrow HERE (caller's thread): first-importing it from the
        # flusher thread corrupts its C++ runtime when jax is also resident
        # (observed segfault in read_table, pyarrow 25.0.0)
        import pyarrow as pa
        import pyarrow.parquet as pq
        self._pa = (pa, pq)
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="t3fs-tracelog")
        self._flush_interval_s = flush_interval_s
        self.rows_written = 0
        self.rows_dropped = 0
        self._thread.start()

    MAX_BUFFERED = 1 << 16

    def append(self, entry: Any) -> None:
        row = tuple(getattr(entry, f) for f in self._fields)
        with self._lock:
            if len(self._buf) >= self.MAX_BUFFERED:
                # sink is stuck (disk full, EIO): shed oldest rather than
                # grow without bound on the hot path
                del self._buf[: self.rows_per_group]
                self.rows_dropped += self.rows_per_group
            self._buf.append(row)
            if len(self._buf) >= self.rows_per_group:
                self._flush_ev.set()

    def _run(self) -> None:
        while not self._stop.is_set():
            self._flush_ev.wait(self._flush_interval_s)
            self._flush_ev.clear()
            self._flush_safe()
        self._flush_safe()
        if self._writer is not None:
            try:
                self._writer.close()   # parquet footer
            except Exception:
                _log.exception("trace log close failed: %s", self.path)

    def _flush_safe(self) -> None:
        """A failing sink must never kill the flusher thread — the log is
        best-effort observability, not the data path."""
        try:
            self._flush_once()
        except Exception:
            _log.exception("trace log flush failed: %s", self.path)

    def _flush_once(self) -> None:
        with self._lock:
            rows, self._buf = self._buf, []
        if not rows:
            return
        pa, pq = self._pa
        cols = list(zip(*rows))
        table = pa.table({name: list(col)
                          for name, col in zip(self._fields, cols)})
        if self._writer is None:
            self._writer = pq.ParquetWriter(self.path, table.schema)
        self._writer.write_table(table)
        self.rows_written += len(rows)

    def close(self) -> None:
        self._stop.set()
        self._flush_ev.set()
        self._thread.join(timeout=5)


def read_trace(path: str, entry_cls: type | None = None) -> Iterator[Any]:
    """Read a trace file back as entry_cls instances (or dicts)."""
    import pyarrow.parquet as pq
    # use_threads=False: pyarrow's threaded reader segfaults when jax's CPU
    # runtime is resident in the same process (observed with pyarrow 25.0.0)
    table = pq.read_table(path, use_threads=False)
    for row in table.to_pylist():
        yield entry_cls(**row) if entry_cls is not None else row
