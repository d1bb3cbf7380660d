"""KvService: the transactional KV as a standalone replicated service.

Reference analog: the FoundationDB role (src/fdb/HybridKvEngine.h:13-31) and
the fork's CustomKvEngine (external KV reached over the network via
cluster_endpoints, CustomKvEngine.h:14-29).  t3fs runs its own KV service:
a primary applies SSI transactions against its local engine (WAL-durable)
and synchronously ships every committed batch to followers before acking,
so any follower can be promoted without losing acknowledged commits.

Replication protocol:
  - commits are PIPELINED on the primary (the FDB commit-pipeline
    role): admission (conflict checks + seq/version
    assignment) happens under a short lock hold, replication to followers
    runs concurrently across in-flight commits, applies land strictly in
    seq order via a single applier loop, and the WAL fsync barrier
    overlaps across commits (engine group commit).  A failed commit
    cascade-aborts every in-flight successor and rolls seq back;
  - followers apply batches strictly in sequence, parking briefly on
    out-of-order arrivals (the pipeline ships concurrently); a real gap
    (follower restarted behind the primary) answers KV_REPLICA_GAP and
    the primary pushes a full snapshot, then resumes incremental
    shipping;
  - promotion is an admin op (Kv.promote); clients fail over by probing
    their address list for whoever accepts commits (KV_NOT_PRIMARY
    redirects them) — the same manual-failover model as the fork's external
    custom KV, with mgmtd-style lease election layered above when desired.

The port of t3fs/kv/service.py (host code; no device work): the same wire
structs, the same WAL records, so either package's clients and followers
speak to the other's groups.
"""

from __future__ import annotations

import asyncio
import bisect
import logging
from collections import deque
from dataclasses import dataclass, field

from t3fs_torch.kv.engine import KVEngine, Transaction
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.utils.lock_manager import ExpiringMap
from t3fs_torch.utils import serde
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.kv.service")


@serde_struct
@dataclass
class KvReadReq:
    keys: list[bytes] = field(default_factory=list)
    version: int = -1              # -1: read at current (and return it)


@serde_struct
@dataclass
class KvReadRsp:
    version: int = 0
    # parallel to keys; None encoded as missing flag list
    values: list[bytes] = field(default_factory=list)
    found: list[bool] = field(default_factory=list)


@serde_struct
@dataclass
class KvRangeReq:
    begin: bytes = b""
    end: bytes = b""
    limit: int = 0
    version: int = -1


@serde_struct
@dataclass
class KvRangeRsp:
    version: int = 0
    keys: list[bytes] = field(default_factory=list)
    values: list[bytes] = field(default_factory=list)


@serde_struct
@dataclass
class KvCommitReq:
    read_version: int = 0
    read_keys: list[bytes] = field(default_factory=list)
    range_begins: list[bytes] = field(default_factory=list)
    range_ends: list[bytes] = field(default_factory=list)
    write_keys: list[bytes] = field(default_factory=list)
    write_values: list[bytes] = field(default_factory=list)
    write_deletes: list[bool] = field(default_factory=list)
    clear_begins: list[bytes] = field(default_factory=list)
    clear_ends: list[bytes] = field(default_factory=list)


@serde_struct
@dataclass
class KvCommitRsp:
    version: int = 0


@serde_struct
@dataclass
class KvReplicateReq:
    seq: int = 0
    version: int = 0               # primary's MVCC version for this batch
    write_keys: list[bytes] = field(default_factory=list)
    write_values: list[bytes] = field(default_factory=list)
    write_deletes: list[bool] = field(default_factory=list)
    clear_begins: list[bytes] = field(default_factory=list)
    clear_ends: list[bytes] = field(default_factory=list)
    # primary's applied seq at ship time: every batch <= floor was already
    # acked by ALL followers, so a follower holding seq < floor is missing
    # batches that will never be re-shipped — it answers KV_REPLICA_GAP
    # immediately instead of parking for an in-flight predecessor.
    # APPENDED last: serde cross-version compat is positional.
    floor: int = 0


@serde_struct
@dataclass
class KvSnapshotReq:
    seq: int = 0
    version: int = 0               # primary's MVCC version at snapshot time
    keys: list[bytes] = field(default_factory=list)
    values: list[bytes] = field(default_factory=list)


@serde_struct
@dataclass
class KvOkRsp:
    ok: bool = True
    seq: int = 0


@serde_struct
@dataclass
class KvShardRangeReq:
    """Shard-surgery range ops (kv/surgery.py): freeze/unfreeze,
    delete_range."""
    begin: bytes = b""
    end: bytes = b""
    ttl_s: float = 30.0            # shard_freeze: auto-expiry bound


@serde_struct
@dataclass
class KvShardOwnedReq:
    """Replace this group's owned-range list wholesale (idempotent — the
    mover recomputes the full list from the target map on every run).
    An EMPTY list means "owns nothing" (fully drained group); a group
    with NO owned record at all is unrestricted (pre-surgery)."""
    begins: list[bytes] = field(default_factory=list)
    ends: list[bytes] = field(default_factory=list)


@serde_struct
@dataclass
class KvShardLoadReq:
    """Bulk row ingest during a move (bypasses owned/frozen gates)."""
    keys: list[bytes] = field(default_factory=list)
    values: list[bytes] = field(default_factory=list)


@serde_struct
@dataclass
class KvRangeStatsReq:
    """Per-range load accounting pull (kv/distributor.py).  The caller
    (the distributor) passes ITS view of this group's ranges — the live
    ShardMap slice — and the service rebuckets its decaying counters to
    those bounds, so stats always align with the map the planner scores
    against.  Empty lists keep the current bucketing."""
    begins: list[bytes] = field(default_factory=list)
    ends: list[bytes] = field(default_factory=list)
    # compute rows/approx_bytes per range (an O(rows) engine scan —
    # cheap at planner tick frequency, skippable for gauge polls)
    include_sizes: bool = True


@serde_struct
@dataclass
class KvRangeStatsRsp:
    """Parallel lists, one entry per tracked range.  Rates are decayed
    EWMA ops/s and bytes/s; `split_keys[i]` is the sampled median
    accessed key (b"" = not enough samples / degenerate), so a split
    lands where the traffic is, not at the byte midpoint."""
    begins: list[bytes] = field(default_factory=list)
    ends: list[bytes] = field(default_factory=list)
    read_ops_s: list[float] = field(default_factory=list)
    write_ops_s: list[float] = field(default_factory=list)
    read_bytes_s: list[float] = field(default_factory=list)
    write_bytes_s: list[float] = field(default_factory=list)
    rows: list[int] = field(default_factory=list)
    approx_bytes: list[int] = field(default_factory=list)
    split_keys: list[bytes] = field(default_factory=list)


@serde_struct
@dataclass
class KvPrepareReq:
    """2PC phase 1: one shard's slice of a cross-shard transaction.

    `decider` names the shard group holding the transaction's decision
    record (the coordinator uses the first touched shard); `is_decider`
    marks that shard's own prepare.  Presumed-abort: no decision record
    means aborted."""
    txn_id: str = ""
    body: KvCommitReq = field(default_factory=KvCommitReq)
    decider: list[str] = field(default_factory=list)
    is_decider: bool = False
    # decider-only: every participant group's addresses — COMMIT-record GC
    # must confirm each group resolved before deleting the verdict
    participants: list[list[str]] = field(default_factory=list)


@serde_struct
@dataclass
class KvFinishReq:
    txn_id: str = ""


@serde_struct
@dataclass
class KvDecisionReq:
    txn_id: str = ""


@serde_struct
@dataclass
class KvDecisionRsp:
    # "C" committed | "A" aborted (tombstone) | "P" decider's own prepare
    # still pending | "U" no trace (presumed abort)
    decision: str = "U"
    # answered by the group's primary?  A follower's "U" may just be a
    # stale/replaced replica — GC must not treat it as proof of resolution
    authoritative: bool = False


# internal key prefixes for durable 2PC state (outside every user prefix —
# user keys in t3fs are printable 4-byte tags, KeyPrefix-def analog)
PREP_PREFIX = b"\x00t3fs2pc\x00p\x00"
DEC_PREFIX = b"\x00t3fs2pc\x00d\x00"


class _LoadBucket:
    """One range's decaying load counters + split-point reservoir.

    Counters decay exponentially (half-life `RangeLoadTracker.HALF_LIFE_S`)
    so the planner sees recent load, not lifetime totals; a rate is the
    decayed count divided by the mean window (half_life / ln 2).  The key
    reservoir is a uniform sample of accessed keys — its median is where
    a split would cut the TRAFFIC in half, which for a skewed hot spot is
    nowhere near the byte midpoint (the FDB data distributor's
    "split by sampled bandwidth" behavior)."""

    __slots__ = ("begin", "end", "read_ops", "write_ops", "read_bytes",
                 "write_bytes", "stamp", "samples", "accesses")

    SAMPLE_CAP = 128

    def __init__(self, begin: bytes, end: bytes, now: float):
        self.begin = begin
        self.end = end
        self.read_ops = 0.0
        self.write_ops = 0.0
        self.read_bytes = 0.0
        self.write_bytes = 0.0
        self.stamp = now
        self.samples: list[bytes] = []
        self.accesses = 0

    def decay(self, now: float, half_life_s: float) -> None:
        dt = now - self.stamp
        if dt <= 0:
            return
        f = 2.0 ** (-dt / half_life_s)
        self.read_ops *= f
        self.write_ops *= f
        self.read_bytes *= f
        self.write_bytes *= f
        self.stamp = now

    def sample(self, key: bytes) -> None:
        import random
        self.accesses += 1
        if len(self.samples) < self.SAMPLE_CAP:
            self.samples.append(key)
        else:
            i = random.randrange(self.accesses)
            if i < self.SAMPLE_CAP:
                self.samples[i] = key

    def split_key(self) -> bytes:
        """Median sampled key, or b"" when a split point can't be
        suggested (thin sample, or every access hit one key — splitting
        AT begin/end would make a degenerate empty range)."""
        if len(self.samples) < 8:
            return b""
        ordered = sorted(self.samples)
        mid = ordered[len(ordered) // 2]
        if mid <= self.begin or mid >= self.end:
            return b""
        return mid


class RangeLoadTracker:
    """Per-range load accounting for one KV group (tentpole layer 1).

    Buckets are keyed by range bounds that the DISTRIBUTOR supplies (its
    live ShardMap view of this group, via Kv.range_stats) — the service
    itself only knows its owned union, which after a map-only split is
    still one contiguous span.  Until the first range_stats call the
    whole keyspace is one bucket.  note_* calls are O(log ranges) and
    allocation-free on the hot path; internal \\x00-namespace keys are
    never tracked (surgery/2PC bookkeeping isn't user load)."""

    HALF_LIFE_S = 30.0

    def __init__(self):
        import time
        self._bounds: list[tuple[bytes, bytes]] = []
        self._begins: list[bytes] = []
        self.buckets: list[_LoadBucket] = []
        self.set_bounds([(b"", b"\xff" * 17)], now=time.time())

    def set_bounds(self, pairs: list[tuple[bytes, bytes]],
                   now: float | None = None) -> None:
        """Rebucket to new bounds.  Counters of an old bucket are split
        among its covering new bounds proportionally to where its
        SAMPLED keys fall (the best estimate we have of how the load
        divides); samples re-partition exactly."""
        import time
        now = time.time() if now is None else now
        pairs = sorted(set((bytes(b), bytes(e)) for b, e in pairs if b < e))
        if pairs == self._bounds:
            return
        fresh = [_LoadBucket(b, e, now) for b, e in pairs]
        begins = [b for b, _ in pairs]
        for old in self.buckets:
            old.decay(now, self.HALF_LIFE_S)
            hits: dict[int, int] = {}
            for k in old.samples:
                i = bisect.bisect_right(begins, k) - 1
                if 0 <= i < len(fresh) and k < fresh[i].end:
                    hits[i] = hits.get(i, 0) + 1
                    nb = fresh[i]
                    if len(nb.samples) < nb.SAMPLE_CAP:
                        nb.samples.append(k)
            total = sum(hits.values())
            if not total:
                continue
            for i, n in hits.items():
                frac = n / total
                nb = fresh[i]
                nb.read_ops += old.read_ops * frac
                nb.write_ops += old.write_ops * frac
                nb.read_bytes += old.read_bytes * frac
                nb.write_bytes += old.write_bytes * frac
                nb.accesses += int(old.accesses * frac)
        self._bounds = pairs
        self._begins = begins
        self.buckets = fresh

    def _bucket(self, key: bytes) -> _LoadBucket | None:
        i = bisect.bisect_right(self._begins, key) - 1
        if 0 <= i < len(self.buckets) and key < self.buckets[i].end:
            return self.buckets[i]
        return None

    def note_read(self, key: bytes, nbytes: int, now: float) -> None:
        if key.startswith(b"\x00"):
            return
        b = self._bucket(key)
        if b is None:
            return
        b.decay(now, self.HALF_LIFE_S)
        b.read_ops += 1.0
        b.read_bytes += nbytes
        b.sample(key)

    def note_write(self, key: bytes, nbytes: int, now: float) -> None:
        if key.startswith(b"\x00"):
            return
        b = self._bucket(key)
        if b is None:
            return
        b.decay(now, self.HALF_LIFE_S)
        b.write_ops += 1.0
        b.write_bytes += nbytes
        b.sample(key)

    def totals(self) -> tuple[float, float, float]:
        """(read_ops_s, write_ops_s, bytes_s) across all buckets — the
        monitor gauge surface."""
        import math
        import time
        now = time.time()
        window = self.HALF_LIFE_S / math.log(2)
        r = w = by = 0.0
        for b in self.buckets:
            b.decay(now, self.HALF_LIFE_S)
            r += b.read_ops
            w += b.write_ops
            by += b.read_bytes + b.write_bytes
        return r / window, w / window, by / window


class _Footprint:
    """A prepared transaction's conflict footprint: everything its slice
    read or will write.  Between phase 1 and phase 2 the shard admits
    OTHER commits freely as long as their mutations stay off every
    registered footprint — this is what lets phase 2 apply
    unconditionally without holding the shard's commit lock across the
    inter-phase window (the FDB role's conflict-set commit admission,
    ITransaction.h analog).

    Conflict rule: a candidate's WRITES and CLEARS are checked against
    the whole footprint (a mutation of a prepared read invalidates the
    prepare-time validation phase 2 relies on; a mutation of a prepared
    write reorders against an acked commit), and a candidate's READS
    and READ RANGES are checked against the footprint's writes and
    clears.  The read side is load-bearing for cross-shard consistency:
    after phase 2 applied on shard A but not yet on
    shard B, a transaction that read T1's X on A and validates a read
    of pre-T1 Y on B would commit having observed T1 half-applied
    (T1<T2 on A, T2<T1 on B — a serializability cycle).  The old
    lock-hold prevented this by stalling B's commit/validation until
    T1's slice applied and the version bump failed the SSI check; the
    footprint read-check is the lock-free equivalent.  Read-vs-read
    never conflicts."""

    __slots__ = ("write_keys", "read_keys", "clear_ranges", "read_ranges")

    def __init__(self, txn: Transaction):
        self.write_keys = frozenset(txn._writes)
        self.read_keys = frozenset(txn._read_keys)
        self.clear_ranges = tuple(txn._range_clears)
        self.read_ranges = tuple(txn._read_ranges)

    def blocks(self, write_keys, clear_ranges,
               read_keys=(), read_ranges=()) -> str | None:
        """First conflict between a candidate txn and this footprint, or
        None."""
        for k in write_keys:
            if k in self.write_keys or k in self.read_keys:
                return f"key {k!r}"
            for b, e in self.clear_ranges:
                if b <= k < e:
                    return f"key {k!r} in prepared clear [{b!r},{e!r})"
            for b, e in self.read_ranges:
                if b <= k < e:
                    return f"key {k!r} in prepared read range [{b!r},{e!r})"
        for cb, ce in clear_ranges:
            for k in self.write_keys:
                if cb <= k < ce:
                    return f"clear [{cb!r},{ce!r}) covers prepared key {k!r}"
            for k in self.read_keys:
                if cb <= k < ce:
                    return f"clear [{cb!r},{ce!r}) covers prepared read {k!r}"
            for b, e in (*self.clear_ranges, *self.read_ranges):
                if cb < e and b < ce:
                    return f"clear [{cb!r},{ce!r}) overlaps [{b!r},{e!r})"
        for k in read_keys:
            if k in self.write_keys:
                return f"read of {k!r} (prepared write)"
            for b, e in self.clear_ranges:
                if b <= k < e:
                    return f"read of {k!r} in prepared clear [{b!r},{e!r})"
        for rb, re_ in read_ranges:
            for k in self.write_keys:
                if rb <= k < re_:
                    return (f"read range [{rb!r},{re_!r}) covers "
                            f"prepared write {k!r}")
            for b, e in self.clear_ranges:
                if rb < e and b < re_:
                    return (f"read range [{rb!r},{re_!r}) overlaps "
                            f"prepared clear [{b!r},{e!r})")
        return None


class _PipeEntry:
    """One admitted-but-not-yet-applied commit in the primary's pipeline
    (the FDB commit-pipeline role).  Admission assigns seq +
    MVCC version under a short _commit_lock hold; replication to every
    follower runs CONCURRENTLY across entries (followers reorder by seq);
    the applier loop applies strictly in seq order; the durability
    barrier (group fsync) overlaps across entries.  `fp` keeps later
    admissions' READS off this entry's writes until it applies — the
    engine's conflict check can't see un-applied writes."""

    __slots__ = ("seq", "version", "txn", "fp", "rep_task", "done")

    def __init__(self, seq: int, version: int, txn: Transaction):
        self.seq = seq
        self.version = version
        self.txn = txn
        self.fp = _Footprint(txn)
        self.rep_task: asyncio.Task | None = None
        # resolves to the engine's phase-B (durability) awaitable once the
        # entry is replicated + applied; exception on failure/cascade
        self.done: asyncio.Future = asyncio.get_running_loop().create_future()


@service("Kv")
class KvService:
    def __init__(self, engine: KVEngine, *, primary: bool = True,
                 followers: list[str] | None = None, client=None,
                 prepare_timeout_s: float = 30.0):
        self.engine = engine
        self.primary = primary
        self.followers = list(followers or [])
        self.client = client            # net Client for follower shipping
        self.seq = 0                    # last ASSIGNED batch seq
        self._commit_lock = asyncio.Lock()
        # commit pipeline state (primary): admitted entries awaiting
        # ordered apply; see _PipeEntry
        self._pipe: deque[_PipeEntry] = deque()
        self._pipe_event = asyncio.Event()
        self._applier_task: asyncio.Task | None = None
        self._apply_mu = asyncio.Lock()   # quiesces applies (snapshot push)
        self._applied_seq = 0             # seq of last locally applied batch
        self._push_locks: dict[str, asyncio.Lock] = {}
        # follower: reorder buffer — concurrently-shipped batches can
        # arrive out of seq order; appliers park here until their
        # predecessor lands (bounded; timeout answers KV_REPLICA_GAP)
        self._fol_cv = asyncio.Condition()
        self.replica_park_timeout_s = 8.0
        # 2PC: txn_id -> (validated Transaction, expiry timer, prepare
        # req).  The commit lock is held only WITHIN each phase — across
        # the inter-phase window the prepared txn is protected by its
        # registered footprint instead (see _Footprint), so unrelated
        # commits keep flowing while a cross-shard txn is in flight
        # (one prepared txn would otherwise serialize the whole shard).
        self._prepared: dict[str, tuple] = {}
        # txn_id -> _Footprint for every prepared-but-unresolved txn;
        # registered under the commit lock in prepare (and synchronously
        # in recover_prepared), dropped only once the slice's phase-2
        # apply (or abort) succeeded
        self._footprints: dict[str, _Footprint] = {}
        self._resolving: set[str] = set()   # mid-resolution txn ids
        # txn_id -> final verdict ("C"/"A") for txns recently finished on
        # this shard.  Closes two races around late/duplicate prepares:
        # an abort_prepared that beats its prepare to the shard (the late
        # prepare would otherwise register and hold the shard-wide commit
        # lock until expiry), and a duplicate prepare landing after phase 2
        # completed (it would re-register and later RE-APPLY the slice on
        # the decider's durable "C" — a lost update for interleaved
        # writers).  TTL covers the realistic duplicate-delivery window.
        self._resolved_tombstones: ExpiringMap = ExpiringMap(
            ttl_s=2 * prepare_timeout_s + 60.0, capacity=8192)
        self._push_tasks: set[asyncio.Task] = set()  # in-flight pushes
        self.prepare_timeout_s = prepare_timeout_s
        self.decision_gc_ttl_s = 3600.0
        self.decision_gc_period_s = 300.0
        self._gc_task: asyncio.Task | None = None
        self.replicated = 0             # observability
        self.snapshots_pushed = 0
        # shard surgery state (kv/surgery.py): owned ranges + freeze are
        # DURABLE (replicated records) so a restart/failover mid-move
        # keeps refusing what it must.  "unloaded" = lazy (from the
        # engine); None = no record, unrestricted; [] = owns NOTHING
        # (a fully-drained group) — the two must not be conflated or a
        # drained source silently reverts to accepting everything.
        self._owned: list | None | str = "unloaded"
        self._frozen: tuple[bytes, bytes, float] | None | str = "unloaded"
        # per-range load accounting (kv/distributor.py pulls it via
        # Kv.range_stats); cheap enough to run unconditionally
        self.load = RangeLoadTracker()

    def ensure_decision_gc(self) -> None:
        """Start the decision-record GC loop (primary-only duty); called at
        boot for a born-primary and again on promote — a promoted follower
        is a decider too."""
        if self._gc_task is None or self._gc_task.done():
            self._gc_task = asyncio.create_task(self._gc_loop())

    def stop_decision_gc(self) -> None:
        if self._gc_task is not None:
            self._gc_task.cancel()
            self._gc_task = None
        for t in list(self._push_tasks):
            t.cancel()
        self._push_tasks.clear()
        if self._applier_task is not None:
            self._applier_task.cancel()
            self._applier_task = None
        if self._pipe:
            self._cascade_fail(make_error(StatusCode.INTERNAL,
                                          "KV service stopping"))

    async def _gc_loop(self) -> None:
        while True:
            await asyncio.sleep(self.decision_gc_period_s)
            try:
                n = await self.gc_decisions(self.decision_gc_ttl_s)
                if n:
                    log.info("gc'd %d 2pc decision records", n)
            except Exception:
                log.exception("2pc decision GC failed; will retry")

    # ---- client-facing transactional API ----

    def _require_primary(self) -> None:
        if not self.primary:
            raise make_error(StatusCode.KV_NOT_PRIMARY,
                             "this KV node is a follower")

    @rpc_method
    async def get_version(self, req, payload, conn):
        self._require_primary()
        return KvCommitRsp(version=self.engine.current_version()), b""

    @rpc_method
    async def read(self, req: KvReadReq, payload, conn):
        self._require_primary()
        self._check_read_owned(req.keys)
        ver = req.version if req.version >= 0 \
            else self.engine.current_version()
        import time as _time
        now = _time.time()
        values, found = [], []
        for k in req.keys:
            v = self.engine.read_at(k, ver)
            found.append(v is not None)
            values.append(v if v is not None else b"")
            self.load.note_read(k, len(k) + len(values[-1]), now)
        return KvReadRsp(version=ver, values=values, found=found), b""

    @rpc_method
    async def read_range(self, req: KvRangeReq, payload, conn):
        self._require_primary()
        self._check_range_owned(req.begin, req.end)
        ver = req.version if req.version >= 0 \
            else self.engine.current_version()
        rows = self.engine.range_at(req.begin, req.end, ver, req.limit)
        if rows:
            import time as _time
            # charge the scan to the range's FIRST user row (one op, the
            # scanned bytes) — per-row op counts would make one readdir
            # look like a thousand point reads
            self.load.note_read(rows[0][0],
                                sum(len(k) + len(v) for k, v in rows),
                                _time.time())
        return KvRangeRsp(version=ver, keys=[k for k, _ in rows],
                          values=[v for _, v in rows]), b""

    # ---- shard surgery: durable owned ranges + freeze (kv/surgery.py) ----
    # A group refuses keys outside its owned ranges (KV_WRONG_SHARD: the
    # client's shard map is stale) and mutations into a frozen range
    # (KV_SHARD_FROZEN: a move is copying it).  Both records replicate
    # like data, so a promoted follower keeps enforcing them — without
    # that, a failover between a move's snapshot and its map flip would
    # accept writes the copied snapshot does not contain.

    OWNED_KEY = b"\x00t3fsshard\x00owned"
    FROZEN_KEY = b"\x00t3fsshard\x00frozen"

    def _shard_state(self) -> None:
        if self._owned == "unloaded":
            raw = self.engine.read_at(self.OWNED_KEY,
                                      self.engine.current_version())
            self._owned = serde.loads(raw) if raw is not None else None
        if self._frozen == "unloaded":
            raw = self.engine.read_at(self.FROZEN_KEY,
                                      self.engine.current_version())
            self._frozen = tuple(serde.loads(raw)) if raw else None

    def _owns(self, key: bytes) -> bool:
        if key.startswith(b"\x00"):
            return True                    # internal bookkeeping namespace
        if self._owned is None:
            return True                    # no restriction recorded
        return any(b <= key < e for b, e in self._owned)

    def _frozen_hit(self, key: bytes) -> bool:
        fr = self._frozen
        if fr is None or key.startswith(b"\x00"):
            return False
        b, e, deadline = fr
        import time as _time
        if _time.time() > deadline:
            self._frozen = None            # TTL lapsed (record GC'd lazily)
            return False
        return b <= key < e

    def _check_shard_gates(self, txn: Transaction) -> None:
        """Refuse mutations that a stale shard map or an in-flight move
        must not accept.  Reads are NOT gated here (they are gated in the
        read RPCs against owned only — frozen ranges still serve)."""
        self._shard_state()
        for k in txn._writes:
            if not self._owns(k):
                raise make_error(StatusCode.KV_WRONG_SHARD,
                                 f"key {k!r} not owned by this group")
            if self._frozen_hit(k):
                raise make_error(StatusCode.KV_SHARD_FROZEN,
                                 f"key {k!r} frozen for an in-flight move")
        for b, e in txn._range_clears:
            # a clear must be FULLY owned (checking only its begin would
            # let a stale client's wide clear half-apply) and must not
            # OVERLAP a frozen range anywhere (a clear starting before
            # the frozen begin would delete already-copied rows, which
            # then resurrect on the move target after the flip)
            self._check_range_owned(b, e)
            fr = self._frozen
            # clamp to the user portion: a clear straddling the internal
            # boundary must still honor the freeze over its
            # user slice, or already-copied rows resurrect on the target
            ub = max(b, self._USER_FLOOR)
            if fr is not None and ub < e:
                fb, fe, _dl = fr
                if ub < fe and fb < e and self._frozen_hit(fb):
                    raise make_error(
                        StatusCode.KV_SHARD_FROZEN,
                        f"clear [{b!r},{e!r}) overlaps the frozen range")

    def _check_read_owned(self, keys) -> None:
        self._shard_state()
        for k in keys:
            if not self._owns(k):
                raise make_error(StatusCode.KV_WRONG_SHARD,
                                 f"key {k!r} not owned by this group")

    def _check_range_owned(self, begin: bytes, end: bytes) -> None:
        """The whole requested range must sit inside the owned union — a
        stale client scanning a moved-away slice would silently read
        stale rows otherwise.  Only WHOLLY internal ranges (end at or
        below _USER_FLOOR) bypass; a range straddling the boundary
        (e.g. [b'\\x00', user_key)) is checked over
        its user portion, else a stale client could scan unowned user
        rows off a drained source."""
        self._shard_state()
        if self._owned is None or end <= self._USER_FLOOR:
            return
        begin = max(begin, self._USER_FLOOR)
        if not self._owned:
            raise make_error(StatusCode.KV_WRONG_SHARD,
                             "group owns no ranges (drained by a move)")
        cur = begin
        for b, e in sorted(self._owned):
            if cur >= end:
                return
            if b <= cur < e:
                cur = e
        if cur < end:
            raise make_error(
                StatusCode.KV_WRONG_SHARD,
                f"range [{begin!r},{end!r}) not fully owned here")

    async def _put_record(self, key: bytes, value: bytes | None) -> None:
        # replication order MUST equal commit order: the 2PC pipeline
        # admits under _commit_lock by design, so the replicate+apply
        # awaits below deliberately hold it (see _replicate_and_apply)
        async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
            rec = Transaction(self.engine,
                              read_version=self.engine.current_version())
            rec._writes[key] = value
            await self._replicate_and_apply(rec)

    @rpc_method
    async def shard_set_owned(self, req: KvShardOwnedReq, payload, conn):
        self._require_primary()
        # an EMPTY list is a real record ("owns nothing"), distinct from
        # no record at all ("unrestricted")
        owned = sorted(zip(req.begins, req.ends))
        await self._put_record(self.OWNED_KEY,
                               serde.dumps([list(r) for r in owned]))
        self._owned = [tuple(r) for r in owned]
        return KvOkRsp(), b""

    @rpc_method
    async def shard_freeze(self, req: KvShardRangeReq, payload, conn):
        import time as _time
        self._require_primary()
        fr = (req.begin, req.end, _time.time() + req.ttl_s)
        await self._put_record(self.FROZEN_KEY, serde.dumps(list(fr)))
        self._frozen = fr
        return KvOkRsp(), b""

    @rpc_method
    async def shard_unfreeze(self, req: KvShardRangeReq, payload, conn):
        self._require_primary()
        await self._put_record(self.FROZEN_KEY, None)
        self._frozen = None
        return KvOkRsp(), b""

    # surgery ops act on USER rows only: the first map range begins at
    # b"" but the \x00-prefixed internal namespace (2PC records, owned/
    # frozen state, the map itself) must never be copied to another group
    # nor deleted by a move's cleanup
    _USER_FLOOR = b"\x01"

    @rpc_method
    async def shard_snapshot(self, req: KvRangeReq, payload, conn):
        """Paginated row dump for a move (freeze first for consistency;
        cursor = pass last key + b'\\x00' as the next begin)."""
        self._require_primary()
        rows = self.engine.range_at(max(req.begin, self._USER_FLOOR),
                                    req.end,
                                    self.engine.current_version(),
                                    req.limit)
        return KvRangeRsp(version=self.engine.current_version(),
                          keys=[k for k, _ in rows],
                          values=[v for _, v in rows]), b""

    @rpc_method
    async def shard_load(self, req: KvShardLoadReq, payload, conn):
        """Bulk ingest (move target): replicated like any batch, but
        bypasses the owned/frozen gates — the target does not own the
        range until the map flips."""
        self._require_primary()
        async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
            rec = Transaction(self.engine,
                              read_version=self.engine.current_version())
            for k, v in zip(req.keys, req.values):
                rec._writes[k] = v
            # prepared slices are protected by footprints, not the lock
            # a bulk load over one would be erased/resurrected by
            # the later unconditional phase-2 apply
            self._check_footprints(rec)
            await self._replicate_and_apply(rec)
        return KvOkRsp(), b""

    @rpc_method
    async def shard_delete_range(self, req: KvShardRangeReq, payload, conn):
        self._require_primary()
        async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
            rec = Transaction(self.engine,
                              read_version=self.engine.current_version())
            rec._range_clears.append((max(req.begin, self._USER_FLOOR),
                                      req.end))
            # a drain/cleanup clear over a prepared slice would delete
            # rows the unconditional phase-2 apply then resurrects (or
            # erase its pending writes): refuse, surgery retries once
            # the 2pc resolves (prepare_timeout_s bounds the wait)
            self._check_footprints(rec)
            await self._replicate_and_apply(rec)
        return KvOkRsp(), b""

    def _check_footprints(self, txn: Transaction,
                          exclude: str | None = None) -> None:
        """Admission control vs prepared-but-unresolved txns: refuse any
        mutation that lands on a registered footprint (TXN_CONFLICT —
        retryable; with_transaction re-runs once the 2PC resolves).
        Phase-2 applies skip this entirely (their own footprint IS the
        guarantee that they still apply cleanly)."""
        if not self._footprints:
            return
        writes = txn._writes
        clears = txn._range_clears
        reads = txn._read_keys
        read_ranges = txn._read_ranges
        for txn_id, fp in self._footprints.items():
            if txn_id == exclude:
                continue
            hit = fp.blocks(writes, clears, reads, read_ranges)
            if hit is not None:
                raise make_error(
                    StatusCode.TXN_CONFLICT,
                    f"{hit} conflicts with prepared 2pc txn {txn_id}")

    def _note_writes(self, txn: Transaction) -> None:
        """Account a user commit's writes (called from commit/prepare
        admission ONLY — shard_load bulk ingest and internal records are
        surgery traffic, not load the planner should chase)."""
        import time as _time
        now = _time.time()
        for k, v in txn._writes.items():
            self.load.note_write(k, len(k) + (len(v) if v else 0), now)

    @rpc_method
    async def range_stats(self, req: KvRangeStatsReq, payload, conn):
        """Per-range load + size report for the distributor.  Rebuckets
        to the caller-supplied bounds (clamped: a range the map assigns
        elsewhere just reads zero here) so rates align with the live
        map, then reports decayed rates, sizes, and split suggestions."""
        import math
        import time as _time
        self._require_primary()
        if req.begins:
            self.load.set_bounds(list(zip(req.begins, req.ends)))
        now = _time.time()
        window = RangeLoadTracker.HALF_LIFE_S / math.log(2)
        rsp = KvRangeStatsRsp()
        ver = self.engine.current_version()
        for b in self.load.buckets:
            b.decay(now, RangeLoadTracker.HALF_LIFE_S)
            rsp.begins.append(b.begin)
            rsp.ends.append(b.end)
            rsp.read_ops_s.append(b.read_ops / window)
            rsp.write_ops_s.append(b.write_ops / window)
            rsp.read_bytes_s.append(b.read_bytes / window)
            rsp.write_bytes_s.append(b.write_bytes / window)
            if req.include_sizes:
                rows = self.engine.range_at(
                    max(b.begin, self._USER_FLOOR), b.end, ver)
                rsp.rows.append(len(rows))
                rsp.approx_bytes.append(
                    sum(len(k) + len(v) for k, v in rows))
            else:
                rsp.rows.append(-1)
                rsp.approx_bytes.append(-1)
            rsp.split_keys.append(b.split_key())
        return rsp, b""

    def export_load_gauges(self, group: str = "") -> None:
        """Register this group's load with the monitor.  The metrics
        registry is NAME-keyed, so in-process multi-group deployments
        (LocalCluster) pass a distinct `group` suffix; kv_main's one
        service per process uses the bare names."""
        from t3fs_torch.utils.metrics import CallbackGauge
        sfx = f".{group}" if group else ""
        CallbackGauge(f"kv.range.reads{sfx}", lambda: self.load.totals()[0],
                      tags={"group": group} if group else None)
        CallbackGauge(f"kv.range.writes{sfx}", lambda: self.load.totals()[1],
                      tags={"group": group} if group else None)
        CallbackGauge(f"kv.range.bytes{sfx}", lambda: self.load.totals()[2],
                      tags={"group": group} if group else None)

    def _txn_from_req(self, req: KvCommitReq) -> Transaction:
        txn = Transaction(self.engine, read_version=req.read_version)
        for k in req.read_keys:
            txn._read_keys.add(k)
        txn._read_ranges = list(zip(req.range_begins, req.range_ends))
        for k, v, is_del in zip(req.write_keys, req.write_values,
                                req.write_deletes):
            txn._writes[k] = None if is_del else v
        txn._range_clears = list(zip(req.clear_begins, req.clear_ends))
        return txn

    # ---- commit pipeline (primary) ----

    def _check_pipeline(self, txn: Transaction) -> None:
        """Admission control vs in-flight (admitted, not yet applied)
        pipeline entries: the engine's conflict check can only see
        APPLIED writes, so a candidate's reads must additionally prove
        they don't overlap any in-flight entry's writes/clears — the
        candidate read at a snapshot that predates them, and admitting
        it would serialize it after writes it never saw.  Write-write
        overlap needs no check: applies land strictly in seq order, so
        the later admission wins exactly as SSI orders them."""
        for e in self._pipe:
            hit = e.fp.blocks((), (), txn._read_keys, txn._read_ranges)
            if hit is not None:
                raise make_error(
                    StatusCode.TXN_CONFLICT,
                    f"{hit} conflicts with in-flight commit seq {e.seq}")

    def _enqueue_locked(self, txn: Transaction) -> _PipeEntry:
        """Admit a validated txn: assign seq + version, start replication
        immediately (concurrent across entries), queue for ordered apply.
        Caller holds _commit_lock."""
        self._ensure_applier()
        self.seq += 1
        version = (self._pipe[-1].version if self._pipe
                   else self.engine.applied_version()) + 1
        entry = _PipeEntry(self.seq, version, txn)
        entry.rep_task = asyncio.create_task(self._replicate(KvReplicateReq(
            seq=entry.seq,
            version=version,
            floor=self._applied_seq,
            write_keys=list(txn._writes.keys()),
            write_values=[v if v is not None else b""
                          for v in txn._writes.values()],
            write_deletes=[v is None for v in txn._writes.values()],
            clear_begins=[b for b, _ in txn._range_clears],
            clear_ends=[e for _, e in txn._range_clears])))
        self._pipe.append(entry)
        self._pipe_event.set()
        return entry

    def _ensure_applier(self) -> None:
        if self._applier_task is None or self._applier_task.done():
            self._applier_task = asyncio.create_task(self._apply_loop())

    async def _apply_loop(self) -> None:
        """Single ordered applier: per entry, wait for its replication
        (all followers hold the batch — nothing becomes visible on the
        primary before that, same invariant as the serialized path),
        then apply via the engine's phase A in strict seq order.  The
        durability barrier (phase B) is NOT awaited here — each waiter
        awaits its own, so N commits' fsyncs collapse into the engine's
        group-commit window.  Any failure cascade-aborts every queued
        entry (their admission checks assumed the failed predecessor's
        writes would land) and rolls seq back so the next commit reuses
        it — the follower-side GAP + snapshot push heals divergence."""
        while True:
            while not self._pipe:
                self._pipe_event.clear()
                await self._pipe_event.wait()
            entry = self._pipe[0]
            try:
                await asyncio.shield(entry.rep_task)
            except asyncio.CancelledError:
                raise               # the applier itself is being stopped
            except BaseException as e:
                self._cascade_fail(e)
                continue
            try:
                async with self._apply_mu:
                    # the local apply is inside the cascade scope: if the
                    # WAL append fails (disk full) after followers applied
                    # this seq, seq reuse + snapshot push resets them to
                    # the primary's true (unapplied) state
                    barrier = await self.engine.commit_submit(entry.txn)
                    self._applied_seq = entry.seq
            except asyncio.CancelledError:
                raise
            except BaseException as e:
                self._cascade_fail(e)
                continue
            self._pipe.popleft()
            if not entry.done.done():
                entry.done.set_result(barrier)

    def _cascade_fail(self, exc: BaseException) -> None:
        """Fail the pipeline head and every queued successor, SYNCHRONOUSLY
        (no awaits): admissions hold _commit_lock and run without yielding,
        so a synchronous cascade can't interleave with one — every entry
        present now is the complete set that assumed the failed
        predecessor, and seq rolls back atomically with their removal."""
        entries = list(self._pipe)
        self._pipe.clear()
        if not entries:
            return
        first = entries[0].seq
        self.seq = first - 1
        for i, e in enumerate(entries):
            if e.rep_task is not None and not e.rep_task.done():
                e.rep_task.cancel()
            if e.rep_task is not None:
                e.rep_task.add_done_callback(
                    lambda f: f.cancelled() or f.exception())
            if not e.done.done():
                err = exc if i == 0 else make_error(
                    StatusCode.KV_REPLICATION_FAILED,
                    f"pipeline predecessor seq {first} failed; this "
                    f"batch (seq {e.seq}) may exist on some followers")
                e.done.set_exception(err)
                # mark retrieved: an enqueuer cancelled mid-await must not
                # leave a never-retrieved-exception warning
                e.done.exception()
        log.warning("commit pipeline cascade: %d entries aborted from "
                    "seq %d (%s)", len(entries), first, exc)

    async def _await_entry(self, entry: _PipeEntry) -> None:
        """Wait out an entry end-to-end: replicated + applied (done) and
        durable (the engine's phase-B barrier)."""
        barrier = await entry.done
        await barrier

    async def _replicate_and_apply(self, txn: Transaction) -> None:
        """Enqueue + wait end-to-end.  Caller holds _commit_lock and has
        already conflict-checked; internal record writes keep the old
        fully-serialized semantics by awaiting inline under the lock."""
        if not (txn._writes or txn._range_clears):
            return
        await self._await_entry(self._enqueue_locked(txn))

    @rpc_method
    async def commit(self, req: KvCommitReq, payload, conn):
        self._require_primary()
        txn = self._txn_from_req(req)
        async with self._commit_lock:
            # Admission: conflict-check against applied state (engine),
            # prepared 2PC footprints, and in-flight pipeline entries —
            # then assign seq/version and release the lock.  Replication,
            # ordered apply, and the fsync barrier all overlap with later
            # commits' (this lock hold has NO awaits in it).
            self._check_shard_gates(txn)
            self._check_footprints(txn)
            self._check_pipeline(txn)
            self.engine.check_conflicts(txn)
            if not (txn._writes or txn._range_clears):
                # read-only validation (sharded multi-shard read path):
                # nothing to pipeline once the reads proved valid
                return KvCommitRsp(
                    version=self.engine.current_version()), b""
            self._note_writes(txn)
            entry = self._enqueue_locked(txn)
        await self._await_entry(entry)
        return KvCommitRsp(version=entry.version), b""

    # ---- 2PC surface (cross-shard transactions; see t3fs_torch/kv/shard.py) ----

    @rpc_method
    async def prepare(self, req: "KvPrepareReq", payload, conn):
        """Phase 1: validate this shard's slice of a cross-shard txn,
        durably record it, and register its FOOTPRINT.  The commit lock
        is held only for the validation+record step; across the
        inter-phase window the footprint keeps every later commit and
        prepare off the slice's reads and writes (TXN_CONFLICT), which
        is what entitles phase 2 to apply unconditionally.  The durable
        record (replicated like any write) lets a restarted/failed-over
        shard finish the txn per the decider's verdict instead of
        tearing it."""
        self._require_primary()
        if not req.txn_id:
            raise make_error(StatusCode.INVALID_ARG, "empty txn_id")
        if self._refuse_stale_prepare(req.txn_id):
            return KvOkRsp(seq=self.seq), b""
        txn = self._txn_from_req(req.body)
        async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
            # re-check under the lock: phase 2 / an abort may have raced
            # this prepare while it sat queued on the lock — registering
            # now would re-apply an already-committed slice via the
            # resolver (commit case) or resurrect an aborted one
            if self._refuse_stale_prepare(req.txn_id):
                return KvOkRsp(seq=self.seq), b""
            self._check_shard_gates(txn)
            self._check_footprints(txn)
            self._check_pipeline(txn)
            self.engine.check_conflicts(txn)
            self._note_writes(txn)
            rec = Transaction(self.engine,
                              read_version=self.engine.current_version())
            rec._writes[PREP_PREFIX + req.txn_id.encode()] = \
                serde.dumps(req)
            await self._replicate_and_apply(rec)
            # register BEFORE the lock releases: from this instant no
            # commit may touch the slice until the verdict applies
            self._footprints[req.txn_id] = _Footprint(txn)
        timer = asyncio.create_task(self._resolve_later(req.txn_id))
        self._prepared[req.txn_id] = (txn, timer, req)
        return KvOkRsp(seq=self.seq), b""

    def _refuse_stale_prepare(self, txn_id: str) -> bool:
        """Duplicate/late-prepare gate (checked both outside AND under the
        commit lock).  True = ack idempotently without registering: the
        txn is live here (original prepare's record + footprint stand) or
        already committed (a coordinator retry proceeding to phase 2 gets
        KV_TXN_NOT_FOUND and converges via the decider).  Raises for a
        txn this shard already aborted — presumed-abort's answer."""
        if (txn_id in self._prepared or txn_id in self._resolving
                or txn_id in self._footprints):
            return True
        verdict = self._resolved_tombstones.get(txn_id)
        if verdict == b"A":
            raise make_error(StatusCode.KV_TXN_NOT_FOUND,
                             f"{txn_id} already aborted")
        return verdict == b"C"

    def _finish_txn(self, txn: Transaction, req: KvPrepareReq,
                    decision: bytes | None) -> Transaction:
        """Merge 2PC bookkeeping into the slice: drop the prepare record
        and, on the decider, persist the decision — one atomic batch.
        Decision records carry a timestamp so gc_decisions can expire
        them once every participant has surely resolved."""
        import struct as _struct
        import time as _time
        txn._writes[PREP_PREFIX + req.txn_id.encode()] = None
        if req.is_decider and decision is not None:
            payload = decision + _struct.pack("<d", _time.time())
            if decision == b"C":
                # the COMMIT verdict embeds the participant groups so GC
                # can confirm everyone resolved before deleting it
                payload += serde.dumps(list(req.participants))
            txn._writes[DEC_PREFIX + req.txn_id.encode()] = payload
        return txn

    async def gc_decisions(self, ttl_s: float = 3600.0) -> int:
        """Expire decision records.  ABORT tombstones go by TTL alone —
        losing one degrades to "U", which resolves to the SAME abort
        verdict.  COMMIT records are load-bearing for participants that
        are still down, so they are deleted only once every embedded
        participant group answers get_decision != "P" (an unreachable
        group keeps the record).  Returns removals."""
        import struct as _struct
        import time as _time
        now = _time.time()
        ver = self.engine.current_version()
        rows = self.engine.range_at(DEC_PREFIX, DEC_PREFIX + b"\xff",
                                    ver, 0)
        stale = []
        for k, v in rows:
            ts = _struct.unpack("<d", v[1:9])[0] if len(v) >= 9 else 0.0
            if now - ts <= ttl_s:
                continue
            if v[:1] == b"C":
                try:
                    participants = serde.loads(v[9:]) if len(v) > 9 else None
                except Exception:
                    participants = None
                # an EMPTY list is indistinguishable from "coordinator
                # didn't populate the field" (serde default) — keep those
                # forever too, like legacy records
                if not participants or not await self._all_resolved(
                        k[len(DEC_PREFIX):].decode(), participants):
                    continue        # legacy/unconfirmed: keep the verdict
            stale.append(k)
        if not stale:
            return 0
        async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
            drop = Transaction(self.engine,
                               read_version=self.engine.current_version())
            for k in stale:
                drop._writes[k] = None
            await self._replicate_and_apply(drop)
        return len(stale)

    async def _all_resolved(self, txn_id: str,
                            participants: list[list[str]]) -> bool:
        """True iff every participant group AUTHORITATIVELY confirms it no
        longer holds a PREP record for txn_id.  A "P" from anyone vetoes;
        a resolved answer counts only from the group's PRIMARY (a stale
        follower's "U" proves nothing); an unreachable-or-primaryless
        group vetoes."""
        if self.client is None:
            return False
        for group in participants:
            confirmed = False
            for addr in group:
                try:
                    rsp, _ = await self.client.call(
                        addr, "Kv.get_decision",
                        KvDecisionReq(txn_id=txn_id), timeout=5.0)
                    if rsp.decision == "P":
                        return False
                    if getattr(rsp, "authoritative", False):
                        confirmed = True
                        break
                except StatusError:
                    continue
            if not confirmed:
                return False
        return True

    def _spawn_push(self, preq: "KvPrepareReq", commit: bool) -> None:
        """Decider-side push notification: once this
        shard's verdict is durable, nudge every other participant group
        with phase 2 immediately instead of leaving laggards that missed
        the coordinator's phase 2 to poll get_decision on a timer.  The
        poll path stays as the fallback (a push lost to a partition
        changes nothing — the timer still fires)."""
        if self.client is None or not preq.is_decider \
                or not preq.participants:
            return
        task = asyncio.create_task(self._push_decision(preq, commit))
        self._push_tasks.add(task)
        task.add_done_callback(self._push_tasks.discard)

    async def _push_decision(self, preq: "KvPrepareReq",
                             commit: bool) -> None:
        method = "Kv.commit_prepared" if commit else "Kv.abort_prepared"
        req = KvFinishReq(txn_id=preq.txn_id)
        for group in preq.participants:
            if list(group) == list(preq.decider):
                continue                   # own group: verdict already local
            for addr in group:
                try:
                    await self.client.call(addr, method, req, timeout=5.0)
                    break                  # group handled
                except StatusError as e:
                    if e.code == StatusCode.KV_TXN_NOT_FOUND:
                        break              # already resolved there
                    continue               # follower/unreachable: next addr

    async def _resolve_later(self, txn_id: str,
                             initial_delay: float | None = None) -> None:
        await asyncio.sleep(self.prepare_timeout_s
                            if initial_delay is None else initial_delay)
        while txn_id in self._prepared:
            try:
                done = await self._resolve_once(txn_id)
            except Exception:
                log.exception("2pc resolution of %s failed; retrying", txn_id)
                done = False
            if done:
                return
            await asyncio.sleep(min(2.0, self.prepare_timeout_s))

    async def _resolve_once(self, txn_id: str) -> bool:
        """Coordinator went quiet: resolve via the decider (presumed
        abort).  Returns False when the outcome is still pending.  The
        entry is popped only AFTER the apply succeeds — a transient
        replication failure leaves it armed for the next retry — and is
        flagged `resolving` so a late coordinator phase-2 can't race the
        apply (it gets KV_TXN_NOT_FOUND; the state still converges on the
        decider's verdict)."""
        entry = self._prepared.get(txn_id)
        if entry is None:
            return True
        if txn_id in self._resolving:
            # another resolver (duplicate timer) is mid-apply; let it
            # finish — proceeding here would double-apply the slice and
            # double-release the commit lock
            return False
        txn, _timer, req = entry
        if req.is_decider:
            # no decision record can exist (commit_prepared would have
            # consumed this entry): decide ABORT with a tombstone so a
            # late coordinator commit_prepared cannot resurrect the txn
            self._resolving.add(txn_id)
            try:
                async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
                    drop = Transaction(
                        self.engine,
                        read_version=self.engine.current_version())
                    self._finish_txn(drop, req, b"A")
                    await self._replicate_and_apply(drop)
                self._resolved_tombstones.set(txn_id, b"A")
            finally:
                self._resolving.discard(txn_id)
            self._prepared.pop(txn_id, None)
            self._footprints.pop(txn_id, None)
            log.warning("2pc %s: decider expired -> ABORT tombstone", txn_id)
            self._spawn_push(req, commit=False)
            return True
        # flag BEFORE the decider RPC: a phase-2 call landing during that
        # await must be refused (KV_TXN_NOT_FOUND), or it would pop+apply
        # concurrently with this resolver — double apply + a release() of
        # a lock the resolver no longer owns
        self._resolving.add(txn_id)
        try:
            decision = await self._ask_decider(req)
            if decision == "P":
                return False                # decider undecided: retry later
            if self._prepared.get(txn_id) is not entry:
                return True                 # consumed while asking (defense)
            if decision == "C":
                # a decided COMMIT applies UNCONDITIONALLY: the footprint
                # kept interleaved commits off the slice, and conflict
                # re-checking against the (now old) read version could
                # veto the decider's global verdict and wedge the txn
                txn._read_keys.clear()
                txn._read_ranges.clear()
                self._finish_txn(txn, req, None)
                async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
                    await self._replicate_and_apply(txn)
                self._resolved_tombstones.set(txn_id, b"C")
                log.warning("2pc %s: decider says COMMITTED -> applied",
                            txn_id)
            else:                           # "A" or no trace: abort
                async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
                    drop = Transaction(
                        self.engine,
                        read_version=self.engine.current_version())
                    self._finish_txn(drop, req, None)
                    await self._replicate_and_apply(drop)
                self._resolved_tombstones.set(txn_id, b"A")
                log.warning("2pc %s: resolved as aborted (%s)", txn_id,
                            decision)
        finally:
            self._resolving.discard(txn_id)
        # on apply failure the exception escapes above: entry stays armed
        self._prepared.pop(txn_id, None)
        self._footprints.pop(txn_id, None)
        return True

    async def _ask_decider(self, req: KvPrepareReq) -> str:
        """Resolve via the decider group.  Durable verdicts ("C"/"A") and
        pending ("P") are trusted from any group member — a follower can
        hold a replicated decision/PREP record but cannot fabricate one.
        "U" (no trace = presumed abort) is trusted ONLY from the group's
        primary: a stale/re-seeded follower answers "U" for a txn whose
        decider durably COMMITTED, and acting on that tears the txn.  A
        non-authoritative "U" means "keep polling" (same rule
        _all_resolved applies on the GC side)."""
        if self.client is None or not req.decider:
            return "U"                      # no path to the decider: abort
        timeout = min(5.0, max(0.5, self.prepare_timeout_s))
        for addr in req.decider:
            try:
                rsp, _ = await self.client.call(
                    addr, "Kv.get_decision",
                    KvDecisionReq(txn_id=req.txn_id), timeout=timeout)
                if rsp.decision != "U" or getattr(
                        rsp, "authoritative", False):
                    return rsp.decision
                # non-authoritative "U": inconclusive, try the next member
            except StatusError:
                continue
        return "P"                          # unreachable: keep waiting

    @rpc_method
    async def get_decision(self, req: KvDecisionReq, payload, conn):
        key = req.txn_id.encode()
        ver = self.engine.current_version()
        dec = self.engine.read_at(DEC_PREFIX + key, ver)
        if dec is not None:
            return KvDecisionRsp(decision=chr(dec[0]),
                                 authoritative=self.primary), b""
        if self.engine.read_at(PREP_PREFIX + key, ver) is not None \
                or req.txn_id in self._prepared:
            return KvDecisionRsp(decision="P",
                                 authoritative=self.primary), b""
        return KvDecisionRsp(decision="U",
                             authoritative=self.primary), b""

    @rpc_method
    async def commit_prepared(self, req: "KvFinishReq", payload, conn):
        """Phase 2 commit.  On the decider this also persists the COMMIT
        decision record atomically with the slice; KV_TXN_NOT_FOUND means
        the prepare was already resolved (expiry/abort) — the coordinator
        checks the decider before concluding anything tore."""
        self._require_primary()
        if req.txn_id in self._resolving:
            # a resolver is mid-apply; the decider's verdict governs
            raise make_error(StatusCode.KV_TXN_NOT_FOUND, req.txn_id)
        entry = self._prepared.pop(req.txn_id, None)
        if entry is None:
            raise make_error(StatusCode.KV_TXN_NOT_FOUND, req.txn_id)
        txn, timer, preq = entry
        timer.cancel()
        # a decided COMMIT applies UNCONDITIONALLY: the footprint kept
        # every interleaved commit off the slice's reads and writes, and
        # re-checking against the (now old) read version could veto the
        # decider's global verdict and wedge the txn
        txn._read_keys.clear()
        txn._read_ranges.clear()
        self._finish_txn(txn, preq, b"C")
        # _resolving guards the window where the entry is out of
        # _prepared but the apply (awaiting the commit lock) hasn't
        # landed — a duplicate prepare/abort must not slip in
        self._resolving.add(req.txn_id)
        try:
            async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
                await self._replicate_and_apply(txn)
            self._resolved_tombstones.set(req.txn_id, b"C")
            # verdict applied: the slice is ordinary committed state now
            self._footprints.pop(req.txn_id, None)
        except BaseException:
            # the slice did NOT apply; put the entry back (footprint
            # still registered) so resolution or a coordinator retry can
            # finish it
            timer2 = asyncio.create_task(self._resolve_later(req.txn_id))
            self._prepared[req.txn_id] = (txn, timer2, preq)
            raise
        finally:
            self._resolving.discard(req.txn_id)
        self._spawn_push(preq, commit=True)
        return KvCommitRsp(version=self.engine.current_version()), b""

    @rpc_method
    async def abort_prepared(self, req: "KvFinishReq", payload, conn):
        # primaries only: a follower answering OK for a txn it doesn't
        # hold would make a pusher/coordinator believe the group's
        # primary was notified
        self._require_primary()
        if req.txn_id in self._resolving:
            return KvOkRsp(), b""   # resolver owns it now
        entry = self._prepared.pop(req.txn_id, None)
        if entry is None:
            # the prepare may still be queued on the commit lock (or in
            # flight); tombstone the id so it is refused on arrival
            # instead of holding the shard's commit lock until expiry.
            # Never downgrade a COMMIT verdict: a stray abort push racing
            # a completed commit must not make later prepare retries
            # report "already aborted" for a txn this shard committed.
            if self._resolved_tombstones.get(req.txn_id) != b"C":
                self._resolved_tombstones.set(req.txn_id, b"A")
        if entry is not None:
            txn, timer, preq = entry
            timer.cancel()
            self._resolving.add(req.txn_id)
            try:
                async with self._commit_lock:  # t3fslint: allow(async-lock-await-discipline)
                    drop = Transaction(
                        self.engine,
                        read_version=self.engine.current_version())
                    self._finish_txn(drop, preq, None)
                    await self._replicate_and_apply(drop)
                self._resolved_tombstones.set(req.txn_id, b"A")
                self._footprints.pop(req.txn_id, None)
            except BaseException:
                # the PREP record still exists: re-arm so a resolver
                # retires it (mirrors commit_prepared), or every other
                # participant polls "P" forever against an orphan record
                timer2 = asyncio.create_task(
                    self._resolve_later(req.txn_id, initial_delay=1.0))
                self._prepared[req.txn_id] = (txn, timer2, preq)
                raise
            finally:
                self._resolving.discard(req.txn_id)
        return KvOkRsp(), b""   # idempotent: unknown/expired is fine

    async def recover_prepared(self) -> int:
        """Post-restart/post-promote hook: re-arm durable prepare records
        so the crash/failover didn't tear any cross-shard txn.  Returns
        the number of records found.  Re-registration is SYNCHRONOUS
        (pure memory: entry + footprint + resolution timer) — the
        footprints must stand before this primary admits its first
        post-recovery commit, or a commit could land on a prepared
        slice's reads/writes ahead of the verdict.  Nothing blocks on
        the commit lock here, so two shards recovering each other's
        deciders start cleanly."""
        ver = self.engine.current_version()
        rows = self.engine.range_at(PREP_PREFIX,
                                    PREP_PREFIX + b"\xff", ver, 0)
        n = 0
        for _k, blob in rows:
            req: KvPrepareReq = serde.loads(blob)
            if req.txn_id in self._prepared:
                continue
            n += 1
            txn = self._txn_from_req(req.body)
            self._footprints[req.txn_id] = _Footprint(txn)
            # resolve promptly: the crash already consumed wall time, and
            # the coordinator that would drive phase 2 is likely gone
            timer = asyncio.create_task(
                self._resolve_later(req.txn_id, initial_delay=0.5))
            self._prepared[req.txn_id] = (txn, timer, req)
            log.warning("2pc: recovered prepared txn %s from durable "
                        "record", req.txn_id)
        return n

    # ---- replication ----

    async def _replicate(self, req: KvReplicateReq) -> None:
        """Synchronously ship one batch to every follower IN PARALLEL; a
        gap triggers a full snapshot push.  A follower that stays
        unreachable fails the commit (sync replication: no acked write may
        exist only on the primary)."""
        results = await asyncio.gather(
            *(self._replicate_one(a, req) for a in self.followers),
            return_exceptions=True)
        for addr, res in zip(self.followers, results):
            if isinstance(res, BaseException):
                # NOTE: another follower may already hold this batch — the
                # commit outcome is ambiguous under a later failover, which
                # the client surfaces as TXN_MAYBE_COMMITTED
                raise make_error(
                    StatusCode.KV_REPLICATION_FAILED,
                    f"follower {addr} unreachable: {res}")

    async def _replicate_one(self, addr: str, req: KvReplicateReq) -> None:
        try:
            await self.client.call(addr, "Kv.apply_replica", req,
                                   timeout=10.0)
            self.replicated += 1
            return
        except StatusError as e:
            if e.code != StatusCode.KV_REPLICA_GAP:
                raise
        # GAP: the follower restarted (or fell behind a healed wipe).
        # Serialize heals per follower — under the pipeline, several
        # in-flight batches hit the same restarted follower at once and
        # concurrent snapshot pushes would interleave with applies.
        lock = self._push_locks.setdefault(addr, asyncio.Lock())
        last: StatusError | None = None
        for round_ in range(3):
            async with lock:  # t3fslint: allow(async-lock-await-discipline)
                try:
                    # a predecessor's push may have healed us already
                    await self.client.call(addr, "Kv.apply_replica", req,
                                           timeout=10.0)
                    self.replicated += 1
                    return
                except StatusError as e:
                    if e.code != StatusCode.KV_REPLICA_GAP:
                        raise
                    last = e
                await self._push_snapshot(addr)
            # outside the lock: the batch may PARK on the follower while
            # predecessors (already acked to this follower pre-restart,
            # so never re-sent) reach it via the applier's next push
        raise last

    async def _push_snapshot(self, addr: str) -> None:
        """Reset a follower to the primary's APPLIED state.  Quiesces the
        applier (_apply_mu) so rows, seq, and version are one consistent
        cut — under the pipeline the engine may otherwise be mid-apply of
        a later seq than the row scan reflects."""
        async with self._apply_mu:
            rows = self.engine.snapshot_rows()
            seq = self._applied_seq
            version = self.engine.applied_version()
        await self.client.call(addr, "Kv.load_snapshot", KvSnapshotReq(
            seq=seq, version=version,
            keys=[k for k, _ in rows], values=[v for _, v in rows]),
            timeout=60.0)
        self.snapshots_pushed += 1
        log.info("pushed snapshot (%d keys, seq %d) to %s",
                 len(rows), seq, addr)

    @rpc_method
    async def apply_replica(self, req: KvReplicateReq, payload, conn):
        if self.primary:
            raise make_error(StatusCode.INVALID_ARG,
                             "primary cannot apply replica batches")
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.replica_park_timeout_s
        async with self._fol_cv:
            # reorder buffer: the primary ships pipelined batches
            # concurrently, so seq N+1 can land before N — park until the
            # predecessor applies (bounded: a predecessor lost to a
            # primary-side cascade never arrives, and the pipelined
            # sender heals the resulting GAP with a snapshot)
            while req.seq > self.seq + 1:
                if self.primary:
                    # promoted while this batch sat parked: it came from
                    # the DEPOSED primary's pipeline — applying it now
                    # would write phantom state and collide seqs with
                    # our own pipeline
                    raise make_error(StatusCode.INVALID_ARG,
                                     "primary cannot apply replica batches")
                if self.seq < req.floor:
                    # the predecessor we'd park for was already acked by
                    # every follower (it is at or below the primary's
                    # applied floor) — we LOST it (restart/wipe); it will
                    # never be re-shipped, so fail fast to the snapshot
                    raise make_error(
                        StatusCode.KV_REPLICA_GAP,
                        f"have seq {self.seq}, got {req.seq} "
                        f"(floor {req.floor}: predecessors already acked)")
                remaining = deadline - loop.time()
                if remaining <= 0:
                    raise make_error(
                        StatusCode.KV_REPLICA_GAP,
                        f"have seq {self.seq}, got {req.seq} "
                        f"(predecessor never arrived)")
                try:
                    await asyncio.wait_for(self._fol_cv.wait(), remaining)
                except TimeoutError:
                    continue        # loop re-checks seq, then expires
            if self.primary:
                raise make_error(StatusCode.INVALID_ARG,
                                 "primary cannot apply replica batches")
            if req.seq <= self.seq:
                # stale or duplicate — NOT idempotent-ok: after a
                # primary-side cascade the same seq re-ships with
                # DIFFERENT content, and acking would silently diverge
                raise make_error(StatusCode.KV_REPLICA_GAP,
                                 f"have seq {self.seq}, got {req.seq}")
            txn = Transaction(self.engine)
            for k, v, is_del in zip(req.write_keys, req.write_values,
                                    req.write_deletes):
                txn._writes[k] = None if is_del else v
            txn._range_clears = list(zip(req.clear_begins, req.clear_ends))
            # stamp this batch with the PRIMARY's version so versions stay
            # comparable across a promotion (pinned read_versions, SSI)
            if req.version > 0:
                self.engine.advance_version(req.version - 1)
            # phase A (apply) in seq order under the cv; the durability
            # barrier is awaited OUTSIDE it so parked successors start
            # their appends and the follower's fsyncs group too
            barrier = await self.engine.commit_submit(txn)  # no reads
            self.seq = req.seq
            self._fol_cv.notify_all()
        await barrier
        return KvOkRsp(seq=self.seq), b""

    @rpc_method
    async def load_snapshot(self, req: KvSnapshotReq, payload, conn):
        if self.primary:
            raise make_error(StatusCode.INVALID_ARG,
                             "primary cannot load snapshots")
        async with self._fol_cv:
            self.engine.clear_all()
            txn = Transaction(self.engine)
            for k, v in zip(req.keys, req.values):
                txn._writes[k] = v
            await self.engine.commit_async(txn)
            # fast-forward to the primary's clock: post-promotion, reads
            # pinned at old-primary versions resolve against this snapshot
            # and new writes version strictly above it (conflict checks
            # stay sound)
            self.engine.advance_version(req.version)
            self.seq = req.seq
            # parked out-of-order batches re-check against the new seq:
            # successors of the snapshot apply in order, stale ones GAP
            self._fol_cv.notify_all()
        return KvOkRsp(seq=self.seq), b""

    # ---- admin ----

    @rpc_method
    async def promote(self, req, payload, conn):
        """Failover: this follower becomes the primary (operator/lease-
        driven; the old primary must be fenced off first).  Replicated
        2PC prepare records re-arm so a failover mid-cross-shard-txn
        still resolves it."""
        self.primary = True
        # everything this follower applied is the new primary's truth:
        # the commit pipeline starts empty at the applied watermark
        self._applied_seq = self.seq
        # drain the reorder buffer: parked batches from the deposed
        # primary must re-check self.primary and be refused, not apply
        # into the new primary's pipeline
        async with self._fol_cv:
            self._fol_cv.notify_all()
        # shard-surgery caches reload from the replicated records: the
        # promoted copy must enforce exactly what the old primary did
        self._owned = "unloaded"
        self._frozen = "unloaded"
        recovered = await self.recover_prepared()
        self.ensure_decision_gc()
        log.warning("KV node promoted to primary at seq %d "
                    "(%d prepared txns re-armed)", self.seq, recovered)
        return KvOkRsp(seq=self.seq), b""

    @rpc_method
    async def status(self, req, payload, conn):
        return KvOkRsp(ok=self.primary, seq=self.seq), b""
