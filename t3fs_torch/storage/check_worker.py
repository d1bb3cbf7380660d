"""CheckWorker: periodic disk-health probes per storage target.

Reference analog: src/storage/worker/CheckWorker — probe each target's disk
and flip its local state to OFFLINE on failure so heartbeats propagate it
and mgmtd pulls the target out of its chains (the passive half of the
write-error path in StorageOperator.cc:604-606).

The health tick also CRC-verifies a rotating window of stored chunks
(the local half of the cluster scrub, storage/scrub_scheduler.py).  A
corrupt chunk used to be log-and-forget — detection that triggered
nothing.  Now every mismatch goes through
`corrupt_sink`, whose in-process wiring is ScrubScheduler.note_corrupt:
the owning stripe gets queued for priority rescan + repair, so node-side
detection actually repairs the data instead of rotting in a log line.

The port of t3fs/storage/check_worker.py; the chunk verify runs the port's
host CRC (t3fs_torch/ops/codec.py).
"""

from __future__ import annotations

import asyncio
import logging
import os

from t3fs_torch.mgmtd.types import LocalTargetState
from t3fs_torch.ops.codec import crc32c
from t3fs_torch.storage.types import ChunkState
from t3fs_torch.utils.aio import reap_task

log = logging.getLogger("t3fs_torch.storage.check")

PROBE_NAME = ".t3fs-health-probe"


def _verify_chunk_window(engine, start: int, count: int):
    """CRC-verify up to `count` committed chunks starting at rotating
    cursor `start`; returns (next_cursor, checked, corrupt_chunk_ids).

    Runs ON the target's update worker (run_update) so the read+meta pair
    is serialized against mutations — a chunk mid-update can never show a
    transient content/checksum mismatch."""
    metas = engine.all_metas()
    metas.sort(key=lambda m: (m.chunk_id.inode, m.chunk_id.index))
    n = len(metas)
    if n == 0:
        return 0, 0, []
    window = min(count, n)
    checked, corrupt = 0, []
    for i in range(window):
        m = metas[(start + i) % n]
        if m.state != ChunkState.COMMIT:
            continue       # in-flight CRAQ updates settle via the chain
        checked += 1
        if crc32c(engine.read(m.chunk_id, 0, m.length)) != m.checksum:
            corrupt.append(m.chunk_id)
    return (start + window) % n, checked, corrupt


def probe_target_dir(root: str) -> None:
    """Write+fsync+read+unlink a probe file; raises OSError on disk failure."""
    path = os.path.join(root, PROBE_NAME)
    fd = os.open(path, os.O_RDWR | os.O_CREAT | os.O_TRUNC, 0o600)
    try:
        os.pwrite(fd, b"t3fs-probe", 0)
        os.fsync(fd)
        if os.pread(fd, 10, 0) != b"t3fs-probe":
            raise OSError("probe readback mismatch")
    finally:
        os.close(fd)
        try:
            os.unlink(path)
        except OSError:
            pass


class CheckWorker:
    """Probes every target's data dir; marks failing ones OFFLINE.
    Also scrubs a rotating window of stored chunks per tick, feeding
    corrupt ones to `corrupt_sink` (ScrubScheduler.note_corrupt)."""

    def __init__(self, node, period_s: float = 5.0, *,
                 corrupt_sink=None, verify_chunks_per_tick: int = 16):
        self.node = node
        self.period_s = period_s
        self.corrupt_sink = corrupt_sink        # callable(ChunkId) -> bool
        self.verify_chunks_per_tick = verify_chunks_per_tick
        self._verify_cursor: dict[int, int] = {}
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()
        self.probes = 0
        self.failures = 0
        self.chunks_verified = 0
        self.corrupt_found = 0

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="check-worker")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "chunk check worker")

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.period_s)
            try:
                await self.check_once()
                # piggyback housekeeping on the health tick: expire idle
                # update channels so the dedupe map stays bounded
                self.node.reliable_update.sweep()
            except Exception:
                log.exception("check worker tick failed")

    async def check_once(self) -> int:
        """Probe all targets; returns number of newly-failed ones."""
        failed = 0
        for tid, target in list(self.node.targets.items()):
            if self.node.local_states.get(tid) == LocalTargetState.OFFLINE:
                continue
            self.probes += 1
            try:
                await asyncio.to_thread(probe_target_dir, target.engine.root)
            except OSError as e:
                self.failures += 1
                failed += 1
                log.error("target %d: disk probe failed, going OFFLINE: %s",
                          tid, e)
                self.node.local_states[tid] = LocalTargetState.OFFLINE
                continue
            if self.verify_chunks_per_tick > 0:
                await self._verify_some(tid, target)
        return failed

    async def _verify_some(self, tid: int, target) -> None:
        """CRC-scrub the next window of this target's chunks; corrupt
        ones go to the sink (never just the log)."""
        cursor = self._verify_cursor.get(tid, 0)
        next_cursor, checked, corrupt = await target.run_update(
            _verify_chunk_window, target.engine, cursor,
            self.verify_chunks_per_tick)
        self._verify_cursor[tid] = next_cursor
        self.chunks_verified += checked
        for cid in corrupt:
            self.corrupt_found += 1
            log.error("target %d: chunk %s failed CRC verify", tid, cid)
            if self.corrupt_sink is not None:
                try:
                    self.corrupt_sink(cid)
                except Exception:
                    log.exception("corrupt_sink failed for %s", cid)


class MaintenanceWorker:
    """Background space/metadata maintenance per target.

    Reference analogs: PunchHoleWorker (hole-punch freed blocks so the
    filesystem reclaims their space), SyncMetaKvWorker + DumpWorker (flush
    and snapshot chunk metadata — here the native engine's WAL compaction).
    Each tick runs on worker threads via each target's update executor so
    engine locking stays off the event loop.
    """

    def __init__(self, node, period_s: float = 30.0,
                 punch_batch: int = 1024):
        self.node = node
        self.period_s = period_s
        self.punch_batch = punch_batch
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()
        self.bytes_reclaimed = 0
        self.ticks = 0

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="maint-worker")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "maintenance worker")

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.period_s)
            try:
                await self.tick()
            except Exception:
                log.exception("maintenance tick failed")

    async def tick(self) -> int:
        """One maintenance pass over all targets; returns bytes reclaimed."""
        reclaimed = 0
        for tid, target in list(self.node.targets.items()):
            if self.node.local_states.get(tid) == LocalTargetState.OFFLINE:
                continue
            engine = target.engine
            if hasattr(engine, "punch_freed"):
                reclaimed += await target.run_update(
                    engine.punch_freed, self.punch_batch)
            # no unconditional compact here: the native engine already
            # snapshots threshold-based on mutation and on close; forcing a
            # full metadata rewrite every tick is pure write amplification
        self.bytes_reclaimed += reclaimed
        self.ticks += 1
        return reclaimed
