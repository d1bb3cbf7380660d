"""Write-behind batching for the KVCache serving tier.

Inference workers emit KV blocks in bursts at token-generation cadence;
paying a full CRAQ chain round-trip per block puts the chain on the
serving critical path.  The write-behind buffer takes the write off that
path: ``put`` lands in a bounded dirty buffer and returns, a background
flusher drains the buffer in chain-grouped batches, and ``flush()`` is
the durability barrier for callers that need one (e.g. before publishing
a session's prefix to other workers).

Invariants:

- **Coalescing**: entries are keyed by ChunkId — rewriting a block (or a
  colliding key mapping to the same chunk) replaces the pending entry, so
  at most one write per chunk is ever in the buffer and superseded
  versions are never flushed.
- **Backpressure**: ``put`` blocks while ``dirty_bytes`` is at the cap;
  the producer runs at most one buffer ahead of the chains.
- **Read-your-writes**: ``lookup`` overlays pending + in-flight entries
  so a get issued after a put sees the value before it is durable; an
  entry holding a *different* key for the requested chunk is reported as
  a known-collision (definite miss) rather than falling through to the
  soon-to-be-overwritten stored block.
- **Flush barrier**: every put gets a monotonically increasing seq;
  ``flush()`` waits until all seqs assigned so far are either durable or
  superseded by a later put to the same chunk.

Failure policy: a flush that keeps failing after ``flush_retries``
attempts drops the entry and counts it in ``stats["flush_dropped"]`` —
a cache may drop writes, but a barrier must never wedge on a dead chain.

The port of t3fs/kvcache/writebehind.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from t3fs_torch.lib.kvcache import KVCacheStore, _pack_block
from t3fs_torch.storage.types import ChunkId
from t3fs_torch.utils import tracing
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.kvcache")


@dataclass
class WriteBehindConfig:
    max_dirty_bytes: int = 8 << 20    # backpressure cap
    flush_batch: int = 64             # entries drained per flusher round
    flush_interval_s: float = 0.02    # max time a put sits un-flushed
    flush_concurrency: int = 32       # parallel chunk writes per round
    flush_retries: int = 3


@dataclass
class _Dirty:
    key: bytes
    value: bytes
    chain: int
    cid: ChunkId
    seq: int
    expiry: float = 0.0
    attempts: int = 0
    size: int = field(init=False)

    def __post_init__(self) -> None:
        self.size = len(self.key) + len(self.value)


class WriteBehind:
    """Bounded dirty buffer + background flusher over one KVCacheStore.

    ``on_flushed(key, size, expiry, update_ver)`` fires after each entry
    becomes durable — the tier hooks the namespace ledger here so a PUT
    record can never reference a block that was never written.
    """

    def __init__(self, store: KVCacheStore,
                 config: WriteBehindConfig | None = None,
                 on_flushed=None):
        self.store = store
        self.cfg = config or WriteBehindConfig()
        self.on_flushed = on_flushed
        self._pending: dict[ChunkId, _Dirty] = {}
        self._inflight: dict[ChunkId, _Dirty] = {}
        self.dirty_bytes = 0
        # bytes promised to reserve() callers but not yet in the buffer;
        # lets the backpressure wait happen BEFORE the caller takes any
        # admission window (see KVCacheTier.put)
        self.reserved_bytes = 0
        self._seq = 0
        self._outstanding: set[int] = set()
        self._cond = asyncio.Condition()
        self._task: asyncio.Task | None = None
        self._stopping = False
        self.stats = {"puts": 0, "coalesced": 0, "flushed": 0,
                      "flush_errors": 0, "flush_dropped": 0,
                      "backpressure_waits": 0, "peak_dirty_bytes": 0}

    # --- producer side ---

    async def start(self) -> None:
        if self._task is None:
            self._stopping = False
            self._task = asyncio.create_task(self._flusher(),
                                             name="t3fs-kvcache-flusher")

    async def reserve(self, nbytes: int) -> None:
        """Wait for buffer space and claim it, WITHOUT inserting anything.

        The tier calls this before taking its admission window: the
        backpressure wait (unbounded when a chain is down and flushes
        retry) must not happen while holding admission slots that the
        read path shares — that is exactly the starvation the soak's
        crash fault surfaces.  A later ``put(..., reserved=nbytes)``
        converts the claim into a buffer entry; ``unreserve`` releases a
        claim that won't be used (caller errored/cancelled in between)."""
        async with self._cond:
            if self.dirty_bytes + self.reserved_bytes \
                    >= self.cfg.max_dirty_bytes:
                self.stats["backpressure_waits"] += 1
                await self._cond.wait_for(
                    lambda: self.dirty_bytes + self.reserved_bytes
                    < self.cfg.max_dirty_bytes or self._stopping)
            self.reserved_bytes += nbytes

    async def unreserve(self, nbytes: int) -> None:
        async with self._cond:
            self.reserved_bytes = max(0, self.reserved_bytes - nbytes)
            self._cond.notify_all()

    async def put(self, key: bytes, value: bytes,
                  expiry: float = 0.0, reserved: int = 0) -> None:
        if len(_pack_block(key, value)) > self.store.cfg.block_size:
            # surface the size error at the call site, not from the
            # flusher minutes later (an unused reservation stays the
            # caller's to release — they hold the except path)
            raise make_error(
                StatusCode.INVALID_ARG,
                f"block {len(key) + len(value)}B exceeds block_size "
                f"{self.store.cfg.block_size}")
        chain, cid = self.store.locate(key)
        async with self._cond:
            if reserved:
                self.reserved_bytes = max(0, self.reserved_bytes - reserved)
            elif self.dirty_bytes >= self.cfg.max_dirty_bytes:
                self.stats["backpressure_waits"] += 1
                await self._cond.wait_for(
                    lambda: self.dirty_bytes < self.cfg.max_dirty_bytes
                    or self._stopping)
            self._seq += 1
            entry = _Dirty(key, value, chain, cid, self._seq, expiry)
            old = self._pending.pop(cid, None)
            if old is not None:
                self.stats["coalesced"] += 1
                self.dirty_bytes -= old.size
                self._outstanding.discard(old.seq)   # superseded
            self._pending[cid] = entry
            self._outstanding.add(entry.seq)
            self.dirty_bytes += entry.size
            self.stats["puts"] += 1
            self.stats["peak_dirty_bytes"] = max(
                self.stats["peak_dirty_bytes"], self.dirty_bytes)
            self._cond.notify_all()

    def lookup(self, keys: list[bytes]
               ) -> tuple[dict[bytes, bytes], set[bytes]]:
        """(key -> buffered value, keys known-collided).  A collided key's
        chunk holds a different pending key, so the store's answer is
        about to be invalidated — report a definite miss instead."""
        found: dict[bytes, bytes] = {}
        collided: set[bytes] = set()
        for key in keys:
            _, cid = self.store.locate(key)
            entry = self._pending.get(cid) or self._inflight.get(cid)
            if entry is None:
                continue
            if entry.key == key:
                found[key] = entry.value
            else:
                collided.add(key)
        return found, collided

    @property
    def durable_through(self) -> int:
        return (self._seq if not self._outstanding
                else min(self._outstanding) - 1)

    async def flush(self) -> None:
        """Barrier: every put enqueued before this call is durable (or
        superseded by a later put to the same chunk) on return."""
        with tracing.start_root("kvcache.flush") as sp:
            async with self._cond:
                target = self._seq
                sp.set_tag("target_seq", target)
                self._cond.notify_all()     # wake the flusher immediately
                await self._cond.wait_for(
                    lambda: self.durable_through >= target)

    async def stop(self) -> None:
        if self._task is None:
            return
        await self.flush()
        self._stopping = True
        async with self._cond:
            self._cond.notify_all()
        await self._task
        self._task = None

    # --- flusher ---

    async def _flusher(self) -> None:
        while True:
            async with self._cond:
                if not self._pending:
                    if self._stopping:
                        return
                    try:
                        await asyncio.wait_for(
                            self._cond.wait(), self.cfg.flush_interval_s)
                    except asyncio.TimeoutError:
                        continue
                if not self._pending:
                    continue
                batch = []
                for cid in list(self._pending)[:self.cfg.flush_batch]:
                    entry = self._pending.pop(cid)
                    self._inflight[cid] = entry
                    batch.append(entry)
            # all chains progress concurrently (one slow chain can't
            # serialize the rest); bounded so a burst can't open
            # unbounded write channels
            sem = asyncio.Semaphore(self.cfg.flush_concurrency)
            with tracing.start_root("kvcache.flush_batch", n=len(batch)):
                results = await asyncio.gather(
                    *(self._flush_one(e, sem) for e in batch),
                    return_exceptions=True)
            for r in results:
                if isinstance(r, asyncio.CancelledError):
                    raise r
                if isinstance(r, Exception):
                    # _flush_one handles expected failures itself; anything
                    # escaping it is a bug — log it rather than killing the
                    # flusher (a dead flusher wedges every flush() barrier)
                    log.error("kvcache write-behind flush crashed",
                              exc_info=r)

    async def _flush_one(self, entry: _Dirty,
                         sem: asyncio.Semaphore) -> None:
        try:
            async with sem:
                ver = await self.store.put(entry.key, entry.value)
        except (StatusError, OSError) as e:
            entry.attempts += 1
            async with self._cond:
                self._inflight.pop(entry.cid, None)
                self.stats["flush_errors"] += 1
                if entry.cid in self._pending:
                    # a newer put claimed the chunk while we were failing;
                    # this version is superseded, not lost
                    self._retire(entry)
                elif entry.attempts < self.cfg.flush_retries \
                        and not self._stopping:
                    self._pending[entry.cid] = entry     # retry next round
                else:
                    log.warning("kvcache write-behind dropping %r "
                                "after %d attempts: %s",
                                entry.key[:32], entry.attempts, e)
                    self.stats["flush_dropped"] += 1
                    self._retire(entry)
                self._cond.notify_all()
            return
        async with self._cond:
            if self._inflight.get(entry.cid) is entry:
                del self._inflight[entry.cid]
            self.stats["flushed"] += 1
            self._retire(entry)
            self._cond.notify_all()
        if self.on_flushed is not None:
            try:
                self.on_flushed(entry.key, len(entry.value), entry.expiry,
                                ver)
            except Exception:
                # the durability callback (the tier's ledger hook) must not
                # take the flusher down with it: the data IS durable
                log.exception("kvcache on_flushed callback failed for %r",
                              entry.key[:32])

    def _retire(self, entry: _Dirty) -> None:
        # caller holds the condition lock
        self._outstanding.discard(entry.seq)
        self.dirty_bytes -= entry.size
