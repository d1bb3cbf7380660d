"""Namespace ledger: a segment-log of cache-key records stored as ordinary
chunks — no metadata service in the loop.

The serving tier needs to answer "what lives in this namespace, how big is
it, when did each key last get hit, and when does it expire" without a
directory or an index server.  The ledger is that answer: an append-only
log of fixed-framed records (PUT / HIT / DEL), batched into **segment**
chunks that live in a reserved slice of the namespace's ChunkId space and
are placed over the same chains as the data blocks.

Coordination is by **lanes**, not CAS (the chunk layer has none):

- The ledger inode is ``(1 << 63) | blake2b-63(namespace, person="t3fs-led")``
  — disjoint from both meta-allocated inodes and the data-block inode
  (different personalization).
- A segment's chunk index is ``(lane << 32) | seq``.  Each writer process
  owns one lane (``writer_id % lanes``) and appends segments at strictly
  increasing ``seq`` with **no holes by construction** — so both attach
  recovery and incremental scans are "walk seq until the first absent
  chunk", no listing RPC required.
- Readers keep a per-lane frontier and batch-read a window of segments
  per scan; cross-lane ordering is by the wall-clock ``ts`` stamped in
  every record (last-writer-wins, the same semantics the data blocks
  already have under index collisions).

A crashed GC pass may remove blocks without writing their DEL tombstones;
replay then still lists the keys, the next eviction pass probes them,
finds them absent, and appends the tombstones — the table converges
(idempotent recovery, exercised in tests/test_kvcache_tier.py).

Compaction (t3fs_torch/kvcache/compact.py) bounds replay to O(live keys): a
per-namespace **checkpoint chunk** at a reserved index records each
lane's ``base`` seq — the first live segment.  Attach recovery starts
its binary search at the base (absent() is only monotone from there),
and readers jump a frontier that fell below a lane's base (the retired
prefix's live content was re-emitted at the writer's tail before the
base moved, so nothing is lost).  Re-emitted records carry their
ORIGINAL ts, so replaying them twice is idempotent under the ts-ordered
last-writer-wins table — the property every compaction crash-resume
path leans on.

Hot keys are HIT-coalesced at the writer: per-key HITs buffered within
one flush window collapse to a single record carrying the max ts, so a
popular prefix stops bloating the log even before compaction runs.

The port of t3fs/kvcache/ledger.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from dataclasses import dataclass, field

from t3fs_torch.lib.kvcache import KVCacheStore
from t3fs_torch.storage.types import ChunkId, ReadIO
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

_LED_MAGIC = 0x7C3F1ED6
_SEG_HDR = struct.Struct("<IQII")       # magic, writer_id, seq, nrec
_REC = struct.Struct("<BHIdd")          # op, klen, size, expiry, ts

OP_PUT = 0
OP_HIT = 1
OP_DEL = 2

DEFAULT_LANES = 32
# segment chunks use one allocation class; a segment flushes before it
# outgrows this (power of two so the engine's size classes line up)
SEGMENT_SIZE = 16 << 10


def ledger_inode(namespace: str) -> int:
    h = int.from_bytes(
        hashlib.blake2b(namespace.encode(), digest_size=8,
                        person=b"t3fs-led").digest(), "big")
    return (1 << 63) | (h >> 1)


def segment_chunk(inode: int, lane: int, seq: int) -> ChunkId:
    return ChunkId(inode, (lane << 32) | seq)


# ---------------------------------------------------------------------------
# Compaction checkpoint: per-lane base seqs in one reserved chunk
# ---------------------------------------------------------------------------

# reserved "lane" for the checkpoint chunk — real lanes are tiny ints
# (writer_id % lanes), so this index can never collide with a segment
CKPT_LANE = 0xFFFFFFFF
_CKPT_MAGIC = 0x7C3FC4D7
_CKPT_HDR = struct.Struct("<IQII")      # magic, version, compactions, nlanes
_CKPT_REC = struct.Struct("<II")        # lane, base


def checkpoint_chunk(inode: int) -> ChunkId:
    return ChunkId(inode, CKPT_LANE << 32)


@dataclass
class LedgerCheckpoint:
    """What compaction has retired: lane -> first live seq (``base``).
    Lanes absent from ``bases`` start at 0.  ``version`` increments on
    every write; ``compactions`` counts completed compaction passes."""

    version: int = 0
    compactions: int = 0
    bases: dict[int, int] = field(default_factory=dict)

    def base(self, lane: int) -> int:
        return self.bases.get(lane, 0)


def pack_checkpoint(ckpt: LedgerCheckpoint) -> bytes:
    parts = [_CKPT_HDR.pack(_CKPT_MAGIC, ckpt.version, ckpt.compactions,
                            len(ckpt.bases))]
    for lane in sorted(ckpt.bases):
        parts.append(_CKPT_REC.pack(lane, ckpt.bases[lane]))
    return b"".join(parts)


def parse_checkpoint(blob: bytes) -> LedgerCheckpoint:
    """Torn/foreign blobs parse to the empty checkpoint (all bases 0):
    pre-compaction namespaces and a torn write both degrade to 'nothing
    retired yet', which is always safe — never a fault."""
    if len(blob) < _CKPT_HDR.size:
        return LedgerCheckpoint()
    magic, version, compactions, nlanes = _CKPT_HDR.unpack_from(blob)
    if magic != _CKPT_MAGIC:
        return LedgerCheckpoint()
    bases: dict[int, int] = {}
    off = _CKPT_HDR.size
    for _ in range(nlanes):
        if off + _CKPT_REC.size > len(blob):
            return LedgerCheckpoint()
        lane, base = _CKPT_REC.unpack_from(blob, off)
        bases[lane] = base
        off += _CKPT_REC.size
    return LedgerCheckpoint(version, compactions, bases)


async def read_checkpoint(store: KVCacheStore) -> LedgerCheckpoint:
    inode = ledger_inode(store.namespace)
    ios = [ReadIO(chunk_id=checkpoint_chunk(inode),
                  chain_id=store.chains[0], offset=0, length=0)]
    results, payloads = await store.client.batch_read(ios)
    code = StatusCode(results[0].status.code)
    if code == StatusCode.OK:
        return parse_checkpoint(payloads[0])
    if code == StatusCode.CHUNK_NOT_FOUND:
        return LedgerCheckpoint()
    raise StatusError(code, results[0].status.message)


async def write_checkpoint(store: KVCacheStore,
                           ckpt: LedgerCheckpoint) -> None:
    inode = ledger_inode(store.namespace)
    blob = pack_checkpoint(ckpt)
    result = await store.client.write_chunk(
        store.chains[0], checkpoint_chunk(inode), 0, blob, SEGMENT_SIZE)
    code = StatusCode(result.status.code)
    if code != StatusCode.OK:
        raise StatusError(code, result.status.message)


@dataclass(frozen=True)
class LedgerRecord:
    op: int
    key: bytes
    size: int = 0           # stored block bytes (PUT)
    expiry: float = 0.0     # absolute deadline; 0 = no TTL (PUT)
    ts: float = 0.0         # writer wall clock; cross-lane order + LRU epoch


def _pack_segment(writer_id: int, seq: int,
                  records: list[LedgerRecord]) -> bytes:
    parts = [_SEG_HDR.pack(_LED_MAGIC, writer_id, seq, len(records))]
    for r in records:
        parts.append(_REC.pack(r.op, len(r.key), r.size, r.expiry, r.ts))
        parts.append(r.key)
    return b"".join(parts)


def parse_segment(blob: bytes) -> list[LedgerRecord]:
    """Decode one segment; torn/foreign chunks parse to [] (a scan must
    never fault on a half-written tail segment)."""
    if len(blob) < _SEG_HDR.size:
        return []
    magic, _writer, _seq, nrec = _SEG_HDR.unpack_from(blob)
    if magic != _LED_MAGIC:
        return []
    out: list[LedgerRecord] = []
    off = _SEG_HDR.size
    for _ in range(nrec):
        if off + _REC.size > len(blob):
            return []                    # torn mid-record: drop the segment
        op, klen, size, expiry, ts = _REC.unpack_from(blob, off)
        off += _REC.size
        if off + klen > len(blob):
            return []
        out.append(LedgerRecord(op, bytes(blob[off:off + klen]),
                                size, expiry, ts))
        off += klen
    return out


class LedgerWriter:
    """One process's append handle: owns lane ``writer_id % lanes``,
    buffers records, and flushes them as whole segment chunks.

    ``attach()`` recovers the lane's seq frontier after a restart by
    probing for the first absent segment (doubling + binary search on
    header-only reads — O(log seq) RPCs, no listing), starting at the
    lane's compaction base (below it, absence is not monotone: retired
    segments leave holes)."""

    def __init__(self, store: KVCacheStore, writer_id: int,
                 lanes: int = DEFAULT_LANES,
                 segment_bytes: int = SEGMENT_SIZE):
        self.store = store
        self.writer_id = writer_id
        self.lanes = lanes
        self.segment_bytes = segment_bytes
        self.inode = ledger_inode(store.namespace)
        self.lane = writer_id % lanes
        self.chain = store.chains[self.lane % len(store.chains)]
        self.seq: int | None = None      # assigned by attach()
        self._buf: list[LedgerRecord] = []
        self._hits: dict[bytes, LedgerRecord] = {}   # coalesced HITs
        self._buf_bytes = _SEG_HDR.size
        self._flush_lock = asyncio.Lock()
        self.segments_flushed = 0
        self.hits_coalesced = 0

    async def _absent(self, seq: int) -> bool:
        ios = [ReadIO(chunk_id=segment_chunk(self.inode, self.lane, seq),
                      chain_id=self.chain, offset=0, length=_SEG_HDR.size)]
        results, _ = await self.store.client.batch_read(ios)
        code = StatusCode(results[0].status.code)
        if code in (StatusCode.OK,):
            return False
        if code == StatusCode.CHUNK_NOT_FOUND:
            return True
        raise StatusError(code, results[0].status.message)

    async def attach(self, base: int | None = None) -> int:
        """Find the first absent seq on this lane at or past ``base``;
        that's where we write.  No holes by construction FROM THE BASE,
        so absent(seq) is monotone there.  ``base=None`` reads the
        namespace's compaction checkpoint (one chunk read) — callers
        that already hold the checkpoint pass the lane's base in."""
        if base is None:
            base = (await read_checkpoint(self.store)).base(self.lane)
        if await self._absent(base):
            self.seq = base
            return base
        span = 1
        while not await self._absent(base + span):
            span <<= 1
        lo = base + (span >> 1)          # present
        hi = base + span
        while hi - lo > 1:
            mid = (lo + hi) // 2
            if await self._absent(mid):
                hi = mid
            else:
                lo = mid
        self.seq = hi
        return hi

    def append(self, op: int, key: bytes, size: int = 0,
               expiry: float = 0.0, *, ts: float) -> bool:
        """Buffer one record; returns True when the buffer crossed the
        segment size and the caller should flush().  HITs coalesce: a
        key already holding a buffered HIT keeps one record at the max
        ts instead of growing the log."""
        if len(key) > 0xFFFF:
            raise make_error(StatusCode.INVALID_ARG,
                             f"ledger key {len(key)}B exceeds u16 frame")
        rec = LedgerRecord(op, key, size, expiry, ts)
        if op == OP_HIT:
            cur = self._hits.get(key)
            if cur is not None:
                self.hits_coalesced += 1
                if ts > cur.ts:
                    self._hits[key] = rec
                return self._buf_bytes >= self.segment_bytes
            self._hits[key] = rec
        else:
            self._buf.append(rec)
        self._buf_bytes += _REC.size + len(key)
        return self._buf_bytes >= self.segment_bytes

    @property
    def buffered(self) -> int:
        return len(self._buf) + len(self._hits)

    async def flush(self) -> int:
        """Write all buffered records as segment chunks (splitting if a
        burst outgrew one segment); returns segments written.  Serialized
        internally: the periodic flusher and an explicit barrier racing
        here would otherwise both write (different!) segments at the
        same seq."""
        if self.seq is None:
            raise make_error(StatusCode.INVALID_ARG,
                             "LedgerWriter.flush before attach()")
        # serialized by design (see docstring): two flushers racing
        # would write different segments at the same seq
        async with self._flush_lock:  # t3fslint: allow(async-lock-await-discipline)
            return await self._flush_locked()

    async def _flush_locked(self) -> int:
        wrote = 0
        if self._hits:
            # fold the coalesced HIT window into the outgoing buffer;
            # intra-lane order is irrelevant (replay sorts by ts)
            self._buf.extend(self._hits.values())
            self._hits.clear()
        while self._buf:
            batch: list[LedgerRecord] = []
            nbytes = _SEG_HDR.size
            while self._buf:
                need = _REC.size + len(self._buf[0].key)
                if batch and nbytes + need > self.segment_bytes:
                    break
                r = self._buf.pop(0)
                batch.append(r)
                nbytes += need
            blob = _pack_segment(self.writer_id, self.seq, batch)
            cid = segment_chunk(self.inode, self.lane, self.seq)
            result = await self.store.client.write_chunk(
                self.chain, cid, 0, blob, self.segment_bytes)
            code = StatusCode(result.status.code)
            if code != StatusCode.OK:
                # put the batch back so a retry doesn't lose records
                self._buf[0:0] = batch
                raise StatusError(code, result.status.message)
            self.seq += 1
            wrote += 1
            self.segments_flushed += 1
        self._buf_bytes = _SEG_HDR.size
        return wrote


class LedgerReader:
    """Frontier-based incremental scan over every lane.

    Each ``scan()`` batch-reads a window of segments per lane, advances
    the per-lane frontier past every present segment, and returns the
    new records.  Re-scanning is cheap: lanes with no new segments cost
    one CHUNK_NOT_FOUND read per scan.

    Every scan refreshes the compaction checkpoint first: a frontier
    that fell below a lane's base jumps forward (the prefix it was
    about to read is retired; its live content was re-emitted at the
    writer's tail, which this reader has not consumed yet — nothing is
    skipped, and re-applied duplicates are ts-idempotent)."""

    def __init__(self, store: KVCacheStore, lanes: int = DEFAULT_LANES,
                 window: int = 8):
        self.store = store
        self.lanes = lanes
        self.window = window
        self.inode = ledger_inode(store.namespace)
        self.frontier: dict[int, int] = {lane: 0 for lane in range(lanes)}
        self.segments_read = 0
        self.records_scanned = 0
        self.frontier_jumps = 0
        self.last_checkpoint = LedgerCheckpoint()

    def _chain(self, lane: int) -> int:
        return self.store.chains[lane % len(self.store.chains)]

    def live_segments(self) -> int:
        """Ledger depth as this reader sees it: segments between each
        lane's compaction base and the scanned frontier."""
        bases = self.last_checkpoint.bases
        return sum(max(0, f - bases.get(lane, 0))
                   for lane, f in self.frontier.items())

    async def refresh_bases(self) -> LedgerCheckpoint:
        ckpt = await read_checkpoint(self.store)
        self.last_checkpoint = ckpt
        for lane in self.frontier:
            base = ckpt.base(lane)
            if self.frontier[lane] < base:
                self.frontier[lane] = base
                self.frontier_jumps += 1
        return ckpt

    async def scan(self) -> list[LedgerRecord]:
        await self.refresh_bases()
        out: list[LedgerRecord] = []
        active = set(self.frontier)
        while active:
            ios = []
            slots: list[tuple[int, int]] = []
            for lane in sorted(active):
                base = self.frontier[lane]
                for seq in range(base, base + self.window):
                    ios.append(ReadIO(
                        chunk_id=segment_chunk(self.inode, lane, seq),
                        chain_id=self._chain(lane), offset=0, length=0))
                    slots.append((lane, seq))
            results, payloads = await self.store.client.batch_read(
                ios, hedging=self.store._hedging)
            hit_end: set[int] = set()
            by_lane: dict[int, list[tuple[int, bytes]]] = {}
            for (lane, seq), result, payload in zip(slots, results,
                                                    payloads):
                code = StatusCode(result.status.code)
                if code == StatusCode.OK:
                    by_lane.setdefault(lane, []).append((seq, payload))
                elif code == StatusCode.CHUNK_NOT_FOUND:
                    hit_end.add(lane)
                else:
                    raise StatusError(code, result.status.message)
            for lane in sorted(active):
                # consume contiguous seqs only: a hole means "the lane's
                # end", anything past it is from a concurrent writer we
                # will pick up next scan
                next_seq = self.frontier[lane]
                for seq, payload in sorted(by_lane.get(lane, [])):
                    if seq != next_seq:
                        break
                    out.extend(parse_segment(payload))
                    next_seq = seq + 1
                    self.segments_read += 1
                advanced = next_seq - self.frontier[lane]
                self.frontier[lane] = next_seq
                if advanced < self.window or lane in hit_end:
                    active.discard(lane)
        self.records_scanned += len(out)
        return out


@dataclass
class LedgerEntry:
    size: int = 0
    expiry: float = 0.0
    put_ts: float = 0.0
    hit_ts: float = 0.0      # LRU epoch: max(put_ts, last HIT ts)


@dataclass
class LedgerTable:
    """Replayed view: key -> live entry.  Records apply in ts order with
    last-writer-wins (mirrors the data plane, where the newest block wins
    an index collision): a DEL only deletes what it postdates, a stale
    PUT cannot resurrect a newer delete."""

    entries: dict[bytes, LedgerEntry] = field(default_factory=dict)

    def apply(self, records: list[LedgerRecord]) -> None:
        for r in sorted(records, key=lambda r: r.ts):
            e = self.entries.get(r.key)
            if r.op == OP_PUT:
                if e is None:
                    self.entries[r.key] = LedgerEntry(
                        r.size, r.expiry, r.ts, r.ts)
                elif r.ts >= e.put_ts:
                    e.size, e.expiry, e.put_ts = r.size, r.expiry, r.ts
                    e.hit_ts = max(e.hit_ts, r.ts)
            elif r.op == OP_HIT:
                if e is not None:
                    e.hit_ts = max(e.hit_ts, r.ts)
            elif r.op == OP_DEL:
                if e is not None and r.ts >= e.put_ts:
                    del self.entries[r.key]

    @property
    def live_bytes(self) -> int:
        return sum(e.size for e in self.entries.values())

    def __len__(self) -> int:
        return len(self.entries)
