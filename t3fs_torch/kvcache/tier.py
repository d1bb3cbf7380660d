"""KVCache serving tier: the facade inference fleets talk to.

Layers, bottom-up (each its own module, composable in tests):

- ``KVCacheStore`` (t3fs_torch/lib/kvcache.py) — raw blocks over chains.
- ``LedgerWriter/Reader/Table`` (ledger.py) — what lives here, how big,
  when last hit, when it expires.  Stored as ordinary chunks.
- ``WriteBehind`` (writebehind.py) — puts land in a bounded dirty buffer
  and batch to the chains off the serving path.
- ``EvictionWorker`` (gc.py) — TTL + capacity eviction driven by ledger
  replay, paced removals, fenced against racing puts.
- ``LedgerCompactor`` (compact.py) — rewrites each namespace's live
  ledger tail and retires the historical prefix, bounding replay to
  O(live keys).
- ``AdmissionController`` (admission.py) — per-namespace in-flight
  windows plus value-size-class windows, so one tenant's large-value
  burst can't monopolize the shared client's channels.  With
  ``admit_scope = "host"`` the windows live in a shm token arena shared
  by every process on the host, and ``admit_shards`` hashes namespaces
  onto weighted shards so a hot tenant saturates its slice, not the
  host.

``KVCacheTier`` wires them together: get overlays the dirty buffer
(read-your-writes), put records PUT ledger entries only after the block
is durable, hits are sampled into HIT records (the eviction LRU epoch),
and ``stats()`` is one JSON-able snapshot.  Set ``T3FS_KVCACHE_STATS=
<path-prefix>`` to dump every live tier's snapshot at process exit
(merged fleet-wide by ``admin kvcache-stats``).

The port of t3fs/kvcache/tier.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import atexit
import json
import os
import time
import weakref
from dataclasses import dataclass, field

from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.kvcache.admission import (
    ADMIT_CLASS_BOUNDS, ADMIT_CLASS_NAMES, AdmissionConfig,
    AdmissionController, resolve_plane,
)
from t3fs_torch.kvcache.compact import CompactionConfig, LedgerCompactor
from t3fs_torch.kvcache.gc import EvictionConfig, EvictionWorker
from t3fs_torch.kvcache.ledger import (
    DEFAULT_LANES, SEGMENT_SIZE, OP_HIT, OP_PUT, LedgerReader, LedgerTable,
    LedgerWriter,
)
from t3fs_torch.kvcache.writebehind import WriteBehind, WriteBehindConfig
from t3fs_torch.lib.kvcache import KVCacheConfig, KVCacheStore
from t3fs_torch.utils.metrics import (
    CallbackGauge, CountRecorder, DistributionRecorder,
)

__all__ = [
    "ADMIT_CLASS_BOUNDS", "ADMIT_CLASS_NAMES", "AdmissionController",
    "KVCacheTier", "KVCacheTierConfig", "render_kvcache_stats",
]


@dataclass
class KVCacheTierConfig:
    block_size: int = 64 << 10
    read_hedging: str = "on"          # forwarded to KVCacheConfig
    default_ttl_s: float = 0.0        # 0 = no TTL unless put() passes one
    # ledger
    lanes: int = DEFAULT_LANES
    segment_bytes: int = SEGMENT_SIZE
    hit_sample: int = 16              # record 1-in-N get hits as HIT
    ledger_flush_interval_s: float = 0.25
    # write-behind ("on"/"off"; off = puts write through synchronously)
    write_behind: str = "on"
    max_dirty_bytes: int = 8 << 20
    flush_batch: int = 64
    flush_interval_s: float = 0.02
    flush_concurrency: int = 32
    # eviction (byte_budget=0 disables capacity eviction; TTL still runs)
    byte_budget: int = 0
    low_watermark: float = 0.9
    gc_interval_s: float = 1.0
    remove_rate: float = 2000.0
    remove_burst: int = 256
    gc_batch: int = 64
    # admission (see t3fs_torch/kvcache/admission.py for scope/shard semantics)
    admit_window: int = 128           # per-namespace in-flight ops
    admit_class_windows: tuple = (96, 48, 16)    # small/medium/large
    admit_scope: str = "process"      # "process" | "host" (shm arena)
    admit_group: str = ""             # shared-plane rendezvous; "" = private
    admit_shards: int = 1
    admit_shard_weights: tuple = ()
    # ledger compaction (run_compaction=True in start() to enable)
    compact_trigger_segments: int = 64
    compact_interval_s: float = 10.0
    compact_rate: float = 200.0       # segment removals/s
    compact_burst: int = 64
    compact_del_grace_s: float = 5.0


# live tiers for the T3FS_KVCACHE_STATS exit dump
_LIVE_TIERS: list = []


def _autodump() -> None:
    prefix = os.environ.get("T3FS_KVCACHE_STATS")
    if not prefix:
        return
    snaps = [t.stats() for ref in _LIVE_TIERS
             if (t := ref()) is not None]
    if not snaps:
        return
    path = f"{prefix}.{os.getpid()}.json"
    try:
        with open(path, "w") as f:
            json.dump({"pid": os.getpid(), "tiers": snaps}, f)
    except OSError:
        pass


atexit.register(_autodump)


class KVCacheTier:
    """One namespace's serving handle.  ``await start()`` before use,
    ``await stop()`` to flush and halt the background workers."""

    def __init__(self, client: StorageClient, chains: list[int],
                 namespace: str = "default",
                 config: KVCacheTierConfig | None = None,
                 writer_id: int | None = None):
        self.cfg = config or KVCacheTierConfig()
        self.namespace = namespace
        self.store = KVCacheStore(
            client, chains, namespace=namespace,
            config=KVCacheConfig(block_size=self.cfg.block_size,
                                 read_hedging=self.cfg.read_hedging))
        wid = os.getpid() if writer_id is None else writer_id
        self.ledger = LedgerWriter(self.store, wid, lanes=self.cfg.lanes,
                                   segment_bytes=self.cfg.segment_bytes)
        self.reader = LedgerReader(self.store, lanes=self.cfg.lanes)
        self.table = LedgerTable()
        self.plane = resolve_plane(AdmissionConfig(
            window=self.cfg.admit_window,
            class_windows=tuple(self.cfg.admit_class_windows),
            shards=max(1, self.cfg.admit_shards),
            shard_weights=tuple(self.cfg.admit_shard_weights),
            scope=self.cfg.admit_scope,
            group=self.cfg.admit_group))
        self.admission = self.plane.controller(namespace)
        self.wb: WriteBehind | None = None
        if self.cfg.write_behind == "on":
            self.wb = WriteBehind(
                self.store,
                WriteBehindConfig(
                    max_dirty_bytes=self.cfg.max_dirty_bytes,
                    flush_batch=self.cfg.flush_batch,
                    flush_interval_s=self.cfg.flush_interval_s,
                    flush_concurrency=self.cfg.flush_concurrency),
                on_flushed=self._on_flushed)
        self.gc = EvictionWorker(
            self.store, self.reader, self.table, self.ledger,
            EvictionConfig(byte_budget=self.cfg.byte_budget,
                           low_watermark=self.cfg.low_watermark,
                           batch=self.cfg.gc_batch,
                           remove_rate=self.cfg.remove_rate,
                           remove_burst=self.cfg.remove_burst,
                           interval_s=self.cfg.gc_interval_s))
        self.compactor = LedgerCompactor(
            self.store, self.ledger, lanes=self.cfg.lanes,
            config=CompactionConfig(
                trigger_segments=self.cfg.compact_trigger_segments,
                del_grace_s=self.cfg.compact_del_grace_s,
                remove_rate=self.cfg.compact_rate,
                remove_burst=self.cfg.compact_burst,
                interval_s=self.cfg.compact_interval_s))
        self.counters = {"puts": 0, "gets": 0, "hits": 0, "misses": 0}
        self._hit_tick = 0
        self._ledger_task: asyncio.Task | None = None
        self._stopping = False
        tags = {"namespace": namespace}
        self._m_hits = CountRecorder(f"kvcache.{namespace}.hits", tags)
        self._m_miss = CountRecorder(f"kvcache.{namespace}.misses", tags)
        self._m_get = DistributionRecorder(
            f"kvcache.{namespace}.get_s", tags)
        self._m_dirty = CallbackGauge(
            f"kvcache.{namespace}.dirty_bytes",
            lambda: self.wb.dirty_bytes if self.wb else 0, tags)
        # ledger depth gauges: how much history a fresh reader replays
        self._m_segments = CallbackGauge(
            "kvcache.ledger.segments",
            self.reader.live_segments, tags)
        self._m_replay = CallbackGauge(
            "kvcache.ledger.replay_records",
            lambda: self.reader.records_scanned, tags)
        self._m_compactions = CallbackGauge(
            "kvcache.ledger.compactions",
            lambda: max(self.compactor.stats["compactions"],
                        self.reader.last_checkpoint.compactions), tags)
        _LIVE_TIERS.append(weakref.ref(self))

    # --- lifecycle ---

    async def start(self, *, run_gc: bool = False,
                    run_compaction: bool = False) -> None:
        await self.ledger.attach()
        if self.wb is not None:
            await self.wb.start()
        self._ledger_task = asyncio.create_task(
            self._ledger_loop(), name="t3fs-kvcache-ledger")
        if run_gc:
            await self.gc.start()
        if run_compaction:
            await self.compactor.start()

    async def stop(self) -> None:
        self._stopping = True
        await self.compactor.stop()
        await self.gc.stop()
        if self.wb is not None:
            await self.wb.stop()
        if self._ledger_task is not None:
            self._ledger_task.cancel()
            try:
                await self._ledger_task
            except asyncio.CancelledError:
                pass
            self._ledger_task = None
        if self.ledger.buffered:
            await self.ledger.flush()

    async def _ledger_loop(self) -> None:
        # the single writer for this process's lane: HIT/PUT/DEL appends
        # are sync buffer ops on the serving path; durability happens here
        while True:
            await asyncio.sleep(self.cfg.ledger_flush_interval_s)
            if self.ledger.buffered:
                await self.ledger.flush()

    # --- serving path ---

    def _on_flushed(self, key: bytes, size: int, expiry: float,
                    _ver: int) -> None:
        # the block is durable; now (and only now) the ledger may claim it
        self.ledger.append(OP_PUT, key, size=size, expiry=expiry,
                           ts=time.time())

    async def put(self, key: bytes, value: bytes,
                  ttl_s: float | None = None) -> None:
        ttl = self.cfg.default_ttl_s if ttl_s is None else ttl_s
        expiry = time.time() + ttl if ttl else 0.0
        self.counters["puts"] += 1
        if self.wb is not None:
            # buffer-space wait BEFORE the admission window.  The wait is
            # unbounded when flushes retry against a dead chain; holding
            # namespace/class slots across it let wedged puts starve
            # get_many (which shares the namespace window) — the
            # interference the mixed-workload soak's crash fault found.
            nbytes = len(key) + len(value)
            await self.wb.reserve(nbytes)
            try:
                async with self.admission.admit(len(value)):
                    await self.wb.put(key, value, expiry=expiry,
                                      reserved=nbytes)
            except BaseException:
                await self.wb.unreserve(nbytes)
                raise
        else:
            async with self.admission.admit(len(value)):
                await self.store.put(key, value)
                self._on_flushed(key, len(value), expiry, 0)

    async def get(self, key: bytes) -> bytes | None:
        return (await self.get_many([key]))[0]

    async def get_many(self, keys: list[bytes],
                       stats: dict | None = None) -> list[bytes | None]:
        self.counters["gets"] += len(keys)
        overlay: dict[bytes, bytes] = {}
        collided: set[bytes] = set()
        if self.wb is not None:
            overlay, collided = self.wb.lookup(keys)
        fetch = [k for k in keys if k not in overlay and k not in collided]
        fetched: dict[bytes, bytes | None] = {}
        if fetch:
            async with self.admission.admit(self.cfg.block_size):
                t0 = time.perf_counter()
                values = await self.store.get_many(fetch, stats=stats)
                self._m_get.add(time.perf_counter() - t0)
            fetched = dict(zip(fetch, values))
        out: list[bytes | None] = []
        now = time.time()
        for key in keys:
            v = overlay.get(key)
            if v is None and key not in collided:
                v = fetched.get(key)
            out.append(v)
            if v is None:
                self.counters["misses"] += 1
                self._m_miss.add()
            else:
                self.counters["hits"] += 1
                self._m_hits.add()
                self._hit_tick += 1
                if self._hit_tick % max(1, self.cfg.hit_sample) == 0:
                    # sampled LRU epoch bump; 1-in-N keeps the ledger
                    # write rate a fraction of the serving rate
                    self.ledger.append(OP_HIT, key, ts=now)
        return out

    async def flush(self) -> None:
        """Durability barrier: buffered puts AND their ledger records."""
        if self.wb is not None:
            await self.wb.flush()
        if self.ledger.buffered:
            await self.ledger.flush()

    async def run_gc_pass(self) -> dict:
        return await self.gc.run_pass()

    async def run_compaction_pass(self, force: bool = False) -> dict:
        return await self.compactor.run_pass(force=force)

    # --- observability ---

    def stats(self) -> dict:
        c = self.counters
        hit_rate = c["hits"] / max(1, c["hits"] + c["misses"])
        out = {
            "namespace": self.namespace,
            "puts": c["puts"], "gets": c["gets"],
            "hits": c["hits"], "misses": c["misses"],
            "hit_rate": round(hit_rate, 4),
            "admission_waits": self.admission.waits,
            "admission": self.admission.stats(),
            "admission_plane": self.plane.stats(),
            "ledger_segments_flushed": self.ledger.segments_flushed,
            "ledger_live_segments": self.reader.live_segments(),
            "ledger_replay_records": self.reader.records_scanned,
            "ledger_hits_coalesced": self.ledger.hits_coalesced,
            "ledger_live_keys": len(self.table),
            "ledger_live_bytes": self.table.live_bytes,
            "gc": dict(self.gc.stats),
            "compaction": dict(self.compactor.stats),
        }
        if self.wb is not None:
            out["write_behind"] = dict(self.wb.stats)
            out["dirty_bytes"] = self.wb.dirty_bytes
        return out


def render_kvcache_stats(snaps: list[dict]) -> str:
    """Merge T3FS_KVCACHE_STATS dumps (one per process) into one
    per-namespace table for ``admin kvcache-stats``."""
    merged: dict[str, dict] = {}
    for snap in snaps:
        for tier in snap.get("tiers", []):
            ns = tier.get("namespace", "?")
            cur = merged.setdefault(ns, {
                "puts": 0, "gets": 0, "hits": 0, "misses": 0,
                "dirty_bytes": 0, "removed": 0, "fence_lost": 0,
                "live_bytes": 0, "live_keys": 0, "procs": 0,
                "segments": 0, "compactions": 0, "waits": 0,
                "shard": "-", "scope": "-"})
            cur["procs"] += 1
            for k in ("puts", "gets", "hits", "misses"):
                cur[k] += tier.get(k, 0)
            cur["dirty_bytes"] += tier.get("dirty_bytes", 0)
            gc = tier.get("gc", {})
            cur["removed"] += gc.get("removed", 0)
            cur["fence_lost"] += gc.get("fence_lost", 0)
            # table views overlap across processes: keep the max, not sum
            cur["live_bytes"] = max(cur["live_bytes"],
                                    tier.get("ledger_live_bytes", 0))
            cur["live_keys"] = max(cur["live_keys"],
                                   tier.get("ledger_live_keys", 0))
            # ledger depth is one namespace-wide fact: max across views
            cur["segments"] = max(cur["segments"],
                                  tier.get("ledger_live_segments", 0))
            comp = tier.get("compaction", {})
            cur["compactions"] = max(cur["compactions"],
                                     comp.get("compactions", 0))
            adm = tier.get("admission", {})
            cur["waits"] += adm.get("waits", tier.get("admission_waits", 0))
            cur["shard"] = str(adm.get("shard", cur["shard"]))
            cur["scope"] = adm.get("scope", cur["scope"])
    if not merged:
        return "no kvcache stats"
    headers = ["namespace", "procs", "puts", "gets", "hit%", "dirty_B",
               "live_keys", "live_B", "removed", "fence_lost",
               "led_segs", "compactions", "shard", "scope", "adm_waits"]
    rows = []
    for ns in sorted(merged):
        m = merged[ns]
        hr = 100.0 * m["hits"] / max(1, m["hits"] + m["misses"])
        rows.append([ns, m["procs"], m["puts"], m["gets"], f"{hr:.1f}",
                     m["dirty_bytes"], m["live_keys"], m["live_bytes"],
                     m["removed"], m["fence_lost"], m["segments"],
                     m["compactions"], m["shard"], m["scope"],
                     m["waits"]])
    cols = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
    lines = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for r in cols[1:]:
        lines.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(lines)
