"""Ledger-driven eviction for the KVCache serving tier.

The worker replays the namespace ledger into a table (key -> size,
expiry, last-hit epoch), picks victims, and drives the data plane's
``remove_keys`` in keep-budget passes:

1. **Hard TTL first**: every entry whose expiry has passed goes,
   regardless of budget — expired KV state must not be servable.
2. **Capacity (LRU-by-epoch)**: while the table's live bytes exceed
   ``byte_budget``, evict coldest-first (smallest last-hit epoch) down to
   ``byte_budget * low_watermark`` so passes don't thrash at the line.

Every victim is **verify-probed** before removal (probe_many reads just
header + key): a 64-bit index collision means the victim's chunk may hold
a *different live key's* block, and blind removal would evict the
collision winner.  Probed versions become remove fences, so a put racing
the pass keeps its newer block (the remove comes back CHUNK_STALE_UPDATE
and is dropped).  After removal the worker appends DEL tombstones to its
own ledger lane; a crash between remove and tombstone just means the next
pass probes the key, finds the chunk absent, and tombstones it then —
replay converges without coordination.

Removals are paced by a token bucket (``remove_rate`` removals/s,
``remove_burst`` bucket depth) so GC never competes with serving traffic
for chain IOPS — the knob the reference tunes as "GC removal IOPS".
The same ``_TokenBucket`` paces the ledger compactor's segment
retirement (t3fs_torch/kvcache/compact.py).

GC and compaction compose without coordination: GC's DEL tombstones are
ordinary ledger records, so a compaction pass folds them into its LWW
replay (dead entries simply don't get re-emitted), and a tombstone GC
appends *during* a compaction pass lands at the writer's tail — above
every base the compactor will checkpoint — so it survives retirement.
The crashed-GC convergence story (probe → absent → tombstone) is
unchanged by compaction because it never depended on ledger history,
only on the data plane's ground truth.

The port of t3fs/kvcache/gc.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass

from t3fs_torch.kvcache.ledger import (
    OP_DEL, LedgerReader, LedgerTable, LedgerWriter,
)
from t3fs_torch.lib.kvcache import KVCacheStore

log = logging.getLogger("t3fs_torch.kvcache")


@dataclass
class EvictionConfig:
    byte_budget: int = 0              # 0 = TTL-only, no capacity eviction
    low_watermark: float = 0.9        # evict down to budget * this
    batch: int = 64                   # victims probed/removed per burst
    remove_rate: float = 2000.0       # token bucket: removals per second
    remove_burst: int = 256           # bucket depth
    interval_s: float = 1.0           # pass cadence in run()


class _TokenBucket:
    def __init__(self, rate: float, burst: int):
        self.rate = rate
        self.burst = burst
        self.tokens = float(burst)
        self.last = time.monotonic()

    async def take(self, n: int) -> None:
        while True:
            now = time.monotonic()
            self.tokens = min(self.burst,
                              self.tokens + (now - self.last) * self.rate)
            self.last = now
            if self.tokens >= n:
                self.tokens -= n
                return
            await asyncio.sleep((n - self.tokens) / self.rate)


class EvictionWorker:
    """One namespace's GC: incremental ledger scan + paced removal.

    The caller owns the reader/table/writer (the tier shares its table
    with stats reporting); `run()` loops passes until `stop()`.
    """

    def __init__(self, store: KVCacheStore, reader: LedgerReader,
                 table: LedgerTable, writer: LedgerWriter,
                 config: EvictionConfig | None = None):
        self.store = store
        self.reader = reader
        self.table = table
        self.writer = writer
        self.cfg = config or EvictionConfig()
        self._bucket = _TokenBucket(self.cfg.remove_rate,
                                    self.cfg.remove_burst)
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()
        self.stats = {"passes": 0, "scanned_records": 0,
                      "ttl_evicted": 0, "lru_evicted": 0,
                      "fence_lost": 0, "collided": 0, "removed": 0}

    def _pick_victims(self, now: float) -> tuple[list[bytes], int]:
        """(victim keys in eviction order, count that are TTL kills)."""
        ttl = [k for k, e in self.table.entries.items()
               if e.expiry and e.expiry <= now]
        victims = list(ttl)
        chosen = set(ttl)
        if self.cfg.byte_budget:
            live = self.table.live_bytes \
                - sum(self.table.entries[k].size for k in ttl)
            target = int(self.cfg.byte_budget * self.cfg.low_watermark)
            if live > self.cfg.byte_budget:
                # coldest first: smallest last-hit epoch
                for k, e in sorted(self.table.entries.items(),
                                   key=lambda kv: kv[1].hit_ts):
                    if live <= target:
                        break
                    if k in chosen:
                        continue
                    victims.append(k)
                    chosen.add(k)
                    live -= e.size
        return victims, len(ttl)

    async def run_pass(self, now: float | None = None) -> dict:
        """One scan + evict pass; returns this pass's counters."""
        now = time.time() if now is None else now
        records = await self.reader.scan()
        self.table.apply(records)
        victims, n_ttl = self._pick_victims(now)
        out = {"scanned": len(records), "victims": len(victims),
               "ttl": n_ttl, "removed": 0, "fence_lost": 0, "collided": 0}
        for i in range(0, len(victims), self.cfg.batch):
            batch = victims[i:i + self.cfg.batch]
            await self._bucket.take(len(batch))
            probes = await self.store.probe_many(batch)
            to_remove: list[bytes] = []
            fences: list[int] = []
            for key, (match, ver) in zip(batch, probes):
                if match:
                    to_remove.append(key)
                    fences.append(ver)
                else:
                    # absent (already gone / crashed earlier pass) or an
                    # index collision replaced the block with another
                    # key's — either way there is nothing of ours to
                    # remove; tombstone so replay forgets the entry
                    out["collided"] += 1 if ver else 0
                    self._tombstone(key, now)
            if to_remove:
                flags = await self.store.remove_keys(to_remove,
                                                     fences=fences)
                for key, removed in zip(to_remove, flags):
                    if removed:
                        out["removed"] += 1
                        self._tombstone(key, now)
                    else:
                        # fenced out: a put raced us past the probed
                        # version; its ledger PUT (newer ts) keeps the
                        # entry alive, so drop nothing
                        out["fence_lost"] += 1
        if self.writer.buffered:
            await self.writer.flush()
        self.stats["passes"] += 1
        self.stats["scanned_records"] += out["scanned"]
        self.stats["ttl_evicted"] += min(n_ttl, out["removed"])
        self.stats["lru_evicted"] += max(0, out["removed"] - n_ttl)
        self.stats["removed"] += out["removed"]
        self.stats["fence_lost"] += out["fence_lost"]
        self.stats["collided"] += out["collided"]
        return out

    def _tombstone(self, key: bytes, now: float) -> None:
        self.writer.append(OP_DEL, key, ts=now)
        self.table.entries.pop(key, None)

    # --- background loop ---

    async def start(self) -> None:
        if self._task is None:
            self._stop.clear()
            self._task = asyncio.create_task(self._loop(),
                                             name="t3fs-kvcache-gc")

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.run_pass()
            except Exception:
                # a transient store/ledger error must not kill eviction
                # for the life of the process — retry next interval
                log.exception("kvcache gc pass failed; retrying")
            try:
                await asyncio.wait_for(self._stop.wait(),
                                       self.cfg.interval_s)
            except asyncio.TimeoutError:
                pass

    async def stop(self) -> None:
        if self._task is not None:
            self._stop.set()
            await self._task
            self._task = None
