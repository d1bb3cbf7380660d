"""Background ledger compaction for the KVCache serving tier.

The namespace ledger is an append-only segment log: PUT/HIT/DEL churn
grows replay cost and segment count without bound, so a namespace that
lives for weeks of production traffic pays O(history) on every attach
and scan.  The compactor bounds that to O(live keys):

1. **Scan**: walk every lane from its checkpoint ``base`` to the first
   absent seq, collecting segment payloads and their chunk
   ``update_ver``s (the remove fences).
2. **Replay**: apply all collected records into a fresh
   ``LedgerTable`` — the ts-ordered last-writer-wins resolution every
   reader would compute.
3. **Re-emit the live tail** through the tier's OWN LedgerWriter (new
   seqs at the writer lane's tail): one PUT per live key, one HIT where
   the hit epoch outruns the put, plus DEL tombstones younger than
   ``del_grace_s`` (a DEL older than the grace window has already
   fenced out every record it could ever kill; a *recent* DEL may still
   need to beat a laggy writer's in-flight PUT record, so it rides
   along).  Re-emitted records keep their ORIGINAL ts — replaying a
   record twice is idempotent under LWW, which is what makes every
   crash point below resumable.
4. **Checkpoint**: bump each lane's base past the scanned prefix
   (``write_checkpoint``), BEFORE any removal — attach()'s binary
   search is only monotone above the base, so the base must move before
   holes appear.
5. **Retire**: fence-REMOVE the scanned segments (``remove_fence_ver``
   = the scanned update_ver, the same machinery GC uses against racing
   puts, t3fs_torch/storage/chunk_replica.py): anything that somehow rewrote
   a retired seq wins and the remove reports ``fence_lost``.

Crash-idempotence (exercised in tests/test_kvcache_compact.py): die
after (3) and the next pass re-reads the same prefix and re-emits
duplicates (idempotent); die after (4) and orphaned segments sit below
the base until the next pass's orphan sweep removes them; attach and
scans are correct at every intermediate state because the base moved
first.  Removal is token-bucket paced so compaction never competes
with serving traffic for chain IOPS.

One compactor per namespace is the deployment contract (same as the
eviction worker); concurrent compactors in two processes would race
checkpoint writes.

The port of t3fs/kvcache/compact.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass

from t3fs_torch.kvcache.gc import _TokenBucket
from t3fs_torch.kvcache.ledger import (
    OP_DEL, OP_HIT, OP_PUT, LedgerCheckpoint, LedgerTable, LedgerWriter,
    ledger_inode, parse_segment, read_checkpoint, segment_chunk,
    write_checkpoint,
)
from t3fs_torch.lib.kvcache import KVCacheStore
from t3fs_torch.storage.types import ReadIO, UpdateType
from t3fs_torch.utils.status import StatusCode, StatusError

log = logging.getLogger("t3fs_torch.kvcache")


@dataclass
class CompactionConfig:
    trigger_segments: int = 64        # min retirable segments to act on
    del_grace_s: float = 5.0          # DELs younger than this ride along
    remove_rate: float = 200.0        # token bucket: segment removals/s
    remove_burst: int = 64
    remove_batch: int = 32            # fenced REMOVEs per paced burst
    scan_window: int = 16             # segments batch-read per lane/round
    interval_s: float = 10.0          # pass cadence in the background loop


class _InjectedCrash(RuntimeError):
    """Raised at a configured crash point (kill-and-restart tests)."""


class LedgerCompactor:
    """One namespace's compactor.  The caller owns the writer (the
    tier shares its live LedgerWriter so re-emitted records land on an
    already-attached lane); ``start()`` runs passes until ``stop()``."""

    def __init__(self, store: KVCacheStore, writer: LedgerWriter,
                 lanes: int | None = None,
                 config: CompactionConfig | None = None):
        self.store = store
        self.writer = writer
        self.lanes = writer.lanes if lanes is None else lanes
        self.cfg = config or CompactionConfig()
        self.inode = ledger_inode(store.namespace)
        self._bucket = _TokenBucket(self.cfg.remove_rate,
                                    self.cfg.remove_burst)
        self._task: asyncio.Task | None = None
        self._stop = asyncio.Event()
        self.crash_point: str | None = None   # test hook: "emitted"/"checkpointed"
        self.stats = {"passes": 0, "skipped": 0, "compactions": 0,
                      "segments_in": 0, "segments_retired": 0,
                      "records_in": 0, "records_out": 0,
                      "fence_lost": 0, "orphans_removed": 0}

    def _chain(self, lane: int) -> int:
        return self.store.chains[lane % len(self.store.chains)]

    def _maybe_crash(self, point: str) -> None:
        if self.crash_point == point:
            raise _InjectedCrash(f"injected crash at {point}")

    # ---- scan ----

    async def _scan_segments(self, ckpt: LedgerCheckpoint
                             ) -> dict[int, list[tuple[int, bytes, int]]]:
        """Walk every lane from its base to the first absent seq:
        lane -> [(seq, payload, update_ver)] in seq order."""
        segs: dict[int, list[tuple[int, bytes, int]]] = {
            lane: [] for lane in range(self.lanes)}
        cursor = {lane: ckpt.base(lane) for lane in range(self.lanes)}
        active = set(cursor)
        while active:
            ios: list[ReadIO] = []
            slots: list[tuple[int, int]] = []
            for lane in sorted(active):
                base = cursor[lane]
                for seq in range(base, base + self.cfg.scan_window):
                    ios.append(ReadIO(
                        chunk_id=segment_chunk(self.inode, lane, seq),
                        chain_id=self._chain(lane), offset=0, length=0))
                    slots.append((lane, seq))
            results, payloads = await self.store.client.batch_read(ios)
            by_lane: dict[int, list[tuple[int, bytes, int]]] = {}
            hit_end: set[int] = set()
            for (lane, seq), result, payload in zip(slots, results,
                                                    payloads):
                code = StatusCode(result.status.code)
                if code == StatusCode.OK:
                    by_lane.setdefault(lane, []).append(
                        (seq, payload, result.update_ver))
                elif code == StatusCode.CHUNK_NOT_FOUND:
                    hit_end.add(lane)
                else:
                    raise StatusError(code, result.status.message)
            for lane in sorted(active):
                next_seq = cursor[lane]
                for seq, payload, ver in sorted(by_lane.get(lane, []),
                                                key=lambda t: t[0]):
                    if seq != next_seq:
                        break            # hole = lane end at scan time
                    segs[lane].append((seq, payload, ver))
                    next_seq += 1
                advanced = next_seq - cursor[lane]
                cursor[lane] = next_seq
                if advanced < self.cfg.scan_window or lane in hit_end:
                    active.discard(lane)
        return segs

    # ---- retire ----

    async def _remove_segments(self, targets: list[tuple[int, int, int]]
                               ) -> tuple[int, int]:
        """Fence-REMOVE (lane, seq, fence_ver) segment chunks, paced;
        returns (removed, fence_lost)."""
        removed = fence_lost = 0

        async def one(lane: int, seq: int, fence: int) -> bool | None:
            result = await self.store.client.write_chunk(
                self._chain(lane), segment_chunk(self.inode, lane, seq),
                0, b"", self.writer.segment_bytes,
                update_type=UpdateType.REMOVE, remove_fence_ver=fence)
            code = StatusCode(result.status.code)
            if code in (StatusCode.OK, StatusCode.CHUNK_NOT_FOUND):
                return True
            if code == StatusCode.CHUNK_STALE_UPDATE:
                return False             # fence lost: the rewrite wins
            raise StatusError(code, result.status.message)

        for i in range(0, len(targets), self.cfg.remove_batch):
            batch = targets[i:i + self.cfg.remove_batch]
            await self._bucket.take(len(batch))
            settled = await asyncio.gather(
                *(one(lane, seq, fence) for lane, seq, fence in batch),
                return_exceptions=True)
            for r in settled:
                if isinstance(r, BaseException):
                    raise r
                if r:
                    removed += 1
                else:
                    fence_lost += 1
        return removed, fence_lost

    async def _sweep_orphans(self, ckpt: LedgerCheckpoint) -> int:
        """Remove segments stranded BELOW a lane's base — the leftovers
        of a compactor that died between checkpoint bump and retire.
        Orphans are contiguous directly below the base (retire removes
        the whole scanned prefix or none of it survives the resume), so
        one header probe per lane per step finds them all."""
        swept = 0
        probe = {lane: ckpt.base(lane) - 1 for lane in range(self.lanes)
                 if ckpt.base(lane) > 0}
        while probe:
            ios, lanes = [], []
            for lane, seq in sorted(probe.items()):
                ios.append(ReadIO(
                    chunk_id=segment_chunk(self.inode, lane, seq),
                    chain_id=self._chain(lane), offset=0, length=0))
                lanes.append(lane)
            results, _payloads = await self.store.client.batch_read(ios)
            targets: list[tuple[int, int, int]] = []
            for lane, result in zip(lanes, results):
                code = StatusCode(result.status.code)
                seq = probe[lane]
                if code == StatusCode.OK:
                    targets.append((lane, seq, result.update_ver))
                    if seq > 0:
                        probe[lane] = seq - 1
                    else:
                        del probe[lane]
                elif code == StatusCode.CHUNK_NOT_FOUND:
                    del probe[lane]
                else:
                    raise StatusError(code, result.status.message)
            if targets:
                removed, lost = await self._remove_segments(targets)
                swept += removed
                self.stats["fence_lost"] += lost
        return swept

    # ---- the pass ----

    async def run_pass(self, force: bool = False,
                       now: float | None = None) -> dict:
        """One scan → replay → re-emit → checkpoint → retire pass.
        ``force=True`` compacts below the segment trigger (tests,
        ``admin``-driven passes, and the scale bench's forced cycle)."""
        now = time.time() if now is None else now
        out = {"segments": 0, "records_in": 0, "records_out": 0,
               "retired": 0, "fence_lost": 0, "orphans": 0,
               "compacted": False}
        ckpt = await read_checkpoint(self.store)
        orphans = await self._sweep_orphans(ckpt)
        out["orphans"] = orphans
        self.stats["orphans_removed"] += orphans
        segs = await self._scan_segments(ckpt)
        total = sum(len(v) for v in segs.values())
        out["segments"] = total
        self.stats["passes"] += 1
        if total == 0 or (not force and total < self.cfg.trigger_segments):
            self.stats["skipped"] += 1
            return out

        # replay the scanned prefix into the LWW resolution
        records = []
        for lane_segs in segs.values():
            for _seq, payload, _ver in lane_segs:
                records.extend(parse_segment(payload))
        table = LedgerTable()
        table.apply(records)
        out["records_in"] = len(records)

        # recent DELs ride along: only those not already beaten by a
        # live PUT, and only within the grace window (see module doc)
        recent_dels: dict[bytes, float] = {}
        for r in records:
            if r.op == OP_DEL and r.ts >= now - self.cfg.del_grace_s \
                    and r.key not in table.entries:
                recent_dels[r.key] = max(recent_dels.get(r.key, 0.0), r.ts)

        # re-emit the live tail at the writer lane's tail (new seqs)
        if self.writer.seq is None:
            await self.writer.attach(base=ckpt.base(self.writer.lane))
        emitted = 0
        for key, e in table.entries.items():
            self.writer.append(OP_PUT, key, size=e.size, expiry=e.expiry,
                               ts=e.put_ts)
            emitted += 1
            if e.hit_ts > e.put_ts:
                self.writer.append(OP_HIT, key, ts=e.hit_ts)
                emitted += 1
        for key, dts in recent_dels.items():
            self.writer.append(OP_DEL, key, ts=dts)
            emitted += 1
        out["records_out"] = emitted
        await self.writer.flush()
        self._maybe_crash("emitted")

        # bump bases BEFORE removing anything: attach()'s search is only
        # monotone above the base, so the base moves first
        new_bases = dict(ckpt.bases)
        uptos: dict[int, int] = {}
        for lane, lane_segs in segs.items():
            if lane_segs:
                uptos[lane] = lane_segs[-1][0] + 1
                new_bases[lane] = max(new_bases.get(lane, 0), uptos[lane])
        await write_checkpoint(self.store, LedgerCheckpoint(
            version=ckpt.version + 1, compactions=ckpt.compactions + 1,
            bases=new_bases))
        self._maybe_crash("checkpointed")

        # retire the scanned prefix, fenced and paced
        targets = [(lane, seq, ver)
                   for lane, lane_segs in segs.items()
                   for seq, _payload, ver in lane_segs]
        removed, lost = await self._remove_segments(targets)
        out["retired"] = removed
        out["fence_lost"] = lost
        out["compacted"] = True
        self.stats["compactions"] += 1
        self.stats["segments_in"] += total
        self.stats["segments_retired"] += removed
        self.stats["records_in"] += out["records_in"]
        self.stats["records_out"] += emitted
        self.stats["fence_lost"] += lost
        return out

    # ---- background loop ----

    async def start(self) -> None:
        if self._task is None:
            self._stop.clear()
            self._task = asyncio.create_task(
                self._loop(), name="t3fs-kvcache-compactor")

    async def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                await self.run_pass()
            except Exception:
                # a transient store error must not end compaction for
                # the life of the process — retry next interval
                log.exception("kvcache compaction pass failed; retrying")
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
