"""Meta event log + parallel table scan.

Reference analog: src/meta/event/Event.{h,cc} — typed meta events carrying a
JSON payload, mirrored to the server log AND appended as a flat
MetaEventTrace row into the structured trace (-> Parquet) — and
src/meta/event/Scan.{h,cc} — MetaScan, a parallel range scan of the
INOD/DENT tables (Options{threads,coroutines,items_per_getrange}).

t3fs keeps both halves, asyncio-idiomatic:

- ``MetaEventLog`` appends :class:`MetaEventTrace` rows to an analytics
  :class:`~t3fs_torch.analytics.trace_log.StructuredTraceLog` (Parquet) and mirrors
  each event as one JSON line on the ``t3fs_torch.meta.event`` logger (the
  reference's ``Event::log()``).  Appends are post-commit only: an aborted
  transaction must not leave an event behind.
- ``MetaScan`` shards the 8-byte big-endian id keyspace into N ranges and
  pages each shard with short snapshot transactions (the reference uses
  threads x coroutines against FDB; here each shard is one asyncio task and
  every page is its own transaction so no long-running read version is held).

The port of t3fs/meta/events.py, a copy with its imports re-pointed: the same
MetaEventTrace columns, so either package reads the other's Parquet.
"""

from __future__ import annotations

import asyncio
import enum
import json
import logging
import struct
import time
from dataclasses import dataclass

from t3fs_torch.kv.engine import KVEngine
from t3fs_torch.kv.prefixes import KeyPrefix
from t3fs_torch.meta.schema import DirEntry, Inode
from t3fs_torch.utils import serde

_event_log = logging.getLogger("t3fs_torch.meta.event")


class MetaEventType(str, enum.Enum):
    """Event::Type (src/meta/event/Event.h:27)."""
    CREATE = "create"
    MKDIR = "mkdir"
    HARDLINK = "hardlink"
    REMOVE = "remove"
    TRUNCATE = "truncate"
    OPEN_WRITE = "open_write"
    CLOSE_WRITE = "close_write"
    RENAME = "rename"
    SYMLINK = "symlink"
    GC = "gc"


@dataclass
class MetaEventTrace:
    """Flat trace row (reference MetaEventTrace, src/meta/event/Event.h:51-73,
    trimmed to fields t3fs tracks)."""
    ts: float = 0.0
    event: str = ""
    inode_id: int = 0
    parent_id: int = 0
    entry_name: str = ""
    dst_parent_id: int = 0
    dst_entry_name: str = ""
    inode_type: str = ""
    nlink: int = 0
    length: int = 0
    client_id: str = ""
    recursive_remove: bool = False
    removed_chunks: int = 0
    symlink_target: str = ""


class MetaEventLog:
    """Post-commit meta event sink: JSON log line + optional Parquet trace."""

    def __init__(self, trace_path: str | None = None,
                 rows_per_group: int = 1024):
        self._trace = None
        if trace_path:
            from t3fs_torch.analytics.trace_log import StructuredTraceLog
            self._trace = StructuredTraceLog(
                MetaEventTrace, trace_path, rows_per_group=rows_per_group)
        self.appended = 0

    def emit(self, etype: MetaEventType, **fields) -> None:
        row = MetaEventTrace(ts=time.time(), event=etype.value, **fields)
        self.appended += 1
        if _event_log.isEnabledFor(logging.INFO):
            payload = {k: v for k, v in row.__dict__.items() if v or k == "ts"}
            _event_log.info("%s", json.dumps(payload, sort_keys=True))
        if self._trace is not None:
            self._trace.append(row)

    def close(self) -> None:
        if self._trace is not None:
            self._trace.close()


def _shard_bounds(prefix: bytes, shards: int) -> list[tuple[bytes, bytes]]:
    """Split ``prefix + 8-byte-BE-id`` keyspace into ``shards`` ranges."""
    step, bounds = (1 << 64) // shards, []
    for i in range(shards):
        begin = prefix + struct.pack(">Q", i * step)
        end = prefix + (b"\xff" if i == shards - 1
                        else struct.pack(">Q", (i + 1) * step))
        bounds.append((begin, end))
    return bounds


@dataclass
class MetaScanOptions:
    """Scan tuning (reference MetaScan::Options, src/meta/event/Scan.h:33-44;
    threads x coroutines collapses to one asyncio task per shard)."""
    shards: int = 8
    items_per_getrange: int = 1024
    backoff_min_wait_s: float = 0.05
    backoff_max_wait_s: float = 2.0
    max_retries: int = 8


class MetaScan:
    """Parallel full-table scan of the meta KV (inodes / dirents)."""

    def __init__(self, kv: KVEngine, options: MetaScanOptions | None = None):
        self.kv = kv
        self.opt = options or MetaScanOptions()

    async def _scan_shard(self, begin: bytes, end: bytes) -> list:
        out, cursor, backoff = [], begin, self.opt.backoff_min_wait_s
        retries = 0
        while True:
            txn = self.kv.transaction()
            try:
                rows = await txn.get_range(cursor, end,
                                           limit=self.opt.items_per_getrange,
                                           snapshot=True)
            except Exception:
                retries += 1
                if retries > self.opt.max_retries:
                    raise
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, self.opt.backoff_max_wait_s)
                continue
            retries, backoff = 0, self.opt.backoff_min_wait_s
            if not rows:
                return out
            out.extend(serde.loads(v) for _, v in rows)
            cursor = rows[-1][0] + b"\x00"

    async def _scan(self, prefix: bytes) -> list:
        parts = await asyncio.gather(
            *(self._scan_shard(b, e)
              for b, e in _shard_bounds(prefix, self.opt.shards)))
        return [row for part in parts for row in part]

    async def inodes(self) -> list[Inode]:
        return await self._scan(KeyPrefix.INODE.value)

    async def dirents(self) -> list[DirEntry]:
        return await self._scan(KeyPrefix.DENTRY.value)
