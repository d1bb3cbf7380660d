"""Range-sharded KV: the FoundationDB role at horizontal scale.

Reference analog: FoundationDB's range partitioning behind
src/fdb/HybridKvEngine.h — the reference outsources sharding to fdb; t3fs
builds it over its own replicated KV groups (t3fs_torch/kv/service.py): a static
ShardMap splits the keyspace into contiguous ranges, each served by one
replicated group, and a client-side router (`ShardedKVEngine`) implements
the same KVEngine/Transaction interface meta and mgmtd already consume.

Transaction protocol:
  - reads route to the owning shard at a per-shard read version (pinned on
    first touch); range reads split at shard boundaries and merge;
  - a commit touching ONE shard uses that group's plain one-shot commit
    (no extra round trips vs the unsharded service);
  - a commit touching SEVERAL shards runs 2PC: prepare on every shard in
    shard order (each shard validates its slice's conflicts and registers
    its FOOTPRINT — reads, writes, clears), then commit_prepared
    everywhere.  Footprints make the prepare set a consistent cut without
    holding any shard's commit lock across the inter-phase window:
    unrelated commits keep flowing, and anything touching a registered
    footprint gets TXN_CONFLICT (retryable) until the verdict applies
    (KvService._Footprint; the FDB conflict-set admission analog).
    Prepare expiry (server-side timer) bounds a crashed coordinator.

Isolation: per-shard SSI.  Every cross-shard read is revalidated by its
owning shard during prepare and then SHIELDED by the registered footprint
until the verdict applies, so any write that slipped between read and
prepare aborts the transaction (TXN_CONFLICT -> with_transaction
retries), and none can slip between prepare and commit — optimistic
serializability, the same contract single-shard transactions have.

Crash safety: prepares are DURABLE (replicated records in each shard's
engine) and the protocol is presumed-abort with a decision record — the
decider's commit_prepared atomically persists a COMMIT record; resolvers
on quiet shards consult it and finish (or tombstone-abort) their slice,
including after a primary restart/failover (recover_prepared).  A caller
seeing TXN_MAYBE_COMMITTED therefore means "outcome decided by the
decider, possibly still propagating" — never a permanently torn txn.

The port of t3fs/kv/shard.py (host code; no device work).
"""

from __future__ import annotations

import asyncio
import logging
import uuid
from dataclasses import dataclass, field

from t3fs_torch.kv.engine import KVEngine
from t3fs_torch.kv.remote import RemoteKVEngine
from t3fs_torch.kv.service import KvFinishReq, KvPrepareReq
from t3fs_torch.net.client import Client
from t3fs_torch.utils import serde
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.kv.shard")


class _ShardClientStats:
    """Process-wide sharded-client observability: map refreshes were
    invisible before — a surgery could flip the map and nothing in the
    monitor moved.  Module-level singleton + gauges (the metrics registry
    is name-keyed; the rdma.py idiom)."""

    def __init__(self):
        self.map_version = 0           # highest map version seen
        self.wrong_shard_bounces = 0   # KV_WRONG_SHARD/KV_SHARD_FROZEN hits
        self.map_refreshes = 0         # refreshes that actually changed it


SHARD_STATS = _ShardClientStats()


def _register_shard_gauges() -> None:
    from t3fs_torch.utils.metrics import CallbackGauge
    CallbackGauge("kv.shard.map_version",
                  lambda: SHARD_STATS.map_version)
    CallbackGauge("kv.shard.wrong_shard_bounces",
                  lambda: SHARD_STATS.wrong_shard_bounces)
    CallbackGauge("kv.shard.map_refreshes",
                  lambda: SHARD_STATS.map_refreshes)


_register_shard_gauges()

KEY_MAX = b"\xff" * 17          # beyond any real key (prefix keys are short)

# map-home record: the authoritative versioned ShardMap lives in the KV
# itself (a designated, never-moving group) — FDB keeps its shard map in
# system keyspace the same way
MAP_KEY = b"\x00t3fsshard\x00map"


@serde_struct
@dataclass
class ShardRange:
    begin: bytes = b""
    end: bytes = KEY_MAX
    addresses: list[str] = field(default_factory=list)


@serde_struct
@dataclass
class ShardMap:
    """Contiguous, sorted, gap-free ranges covering [b"", KEY_MAX)."""
    ranges: list[ShardRange] = field(default_factory=list)
    # bumped by shard surgery (kv/surgery.py); clients refresh from the
    # map-home record when a group answers KV_WRONG_SHARD
    version: int = 0

    def validate(self) -> "ShardMap":
        if not self.ranges:
            raise make_error(StatusCode.INVALID_ARG, "empty shard map")
        cur = b""
        for r in self.ranges:
            if r.begin != cur:
                raise make_error(
                    StatusCode.INVALID_ARG,
                    f"shard map gap/overlap at {r.begin!r} (expected {cur!r})")
            if r.end <= r.begin:
                raise make_error(StatusCode.INVALID_ARG,
                                 f"empty shard range at {r.begin!r}")
            if not r.addresses:
                raise make_error(StatusCode.INVALID_ARG,
                                 f"shard at {r.begin!r} has no addresses")
            cur = r.end
        if cur != KEY_MAX:
            raise make_error(StatusCode.INVALID_ARG,
                             f"shard map ends at {cur!r}, not KEY_MAX")
        return self

    def shard_of(self, key: bytes) -> int:
        for i, r in enumerate(self.ranges):
            if r.begin <= key < r.end:
                return i
        raise make_error(StatusCode.INVALID_ARG, f"key beyond map: {key!r}")

    def shards_overlapping(self, begin: bytes,
                           end: bytes) -> list[tuple[int, bytes, bytes]]:
        """(shard_idx, clipped_begin, clipped_end) for every shard the
        range [begin, end) intersects."""
        out = []
        for i, r in enumerate(self.ranges):
            b, e = max(begin, r.begin), min(end, r.end)
            if b < e:
                out.append((i, b, e))
        return out


class ShardedTransaction:
    """Client-side transaction over several shard groups."""

    def __init__(self, engine: "ShardedKVEngine"):
        self.engine = engine
        self._subs: dict[int, object] = {}      # shard -> RemoteTransaction
        self._committed = False

    def _sub(self, shard: int):
        sub = self._subs.get(shard)
        if sub is None:
            sub = self._subs[shard] = \
                self.engine.groups[shard].transaction()
        return sub

    async def _retag_stale_map(self, coro):
        """KV_WRONG_SHARD / KV_SHARD_FROZEN mean the map moved under this
        transaction (or a move is mid-copy): refresh the map and surface
        TXN_CONFLICT so the with_transaction retry loop re-runs against
        fresh routing."""
        try:
            return await coro
        except StatusError as e:
            if e.code in (StatusCode.KV_WRONG_SHARD,
                          StatusCode.KV_SHARD_FROZEN):
                SHARD_STATS.wrong_shard_bounces += 1
                try:
                    await self.engine.refresh_map()
                except Exception as re:   # map home briefly unreachable:
                    log.warning("shard map refresh failed: %s", re)
                    # the retry path still heals once it comes back
                raise make_error(
                    StatusCode.TXN_CONFLICT,
                    f"shard map changed under txn: {e}") from None
            raise

    # --- reads ---

    async def get(self, key: bytes, *, snapshot: bool = False):
        return await self._retag_stale_map(
            self._sub(self.engine.map.shard_of(key)).get(
                key, snapshot=snapshot))

    async def snapshot_get(self, key: bytes):
        return await self.get(key, snapshot=True)

    async def get_many(self, keys: list[bytes], *,
                       snapshot: bool = False) -> list[bytes | None]:
        """Batched point reads: keys group by owning shard and each
        shard answers its whole slice in ONE RPC (with the snapshot pin
        folded into it), so a batch of N keys costs O(touched shards)
        round trips instead of O(N) per-key version+read RPC pairs."""
        by_shard: dict[int, list[tuple[int, bytes]]] = {}
        for i, key in enumerate(keys):
            by_shard.setdefault(self.engine.map.shard_of(key),
                                []).append((i, key))
        out: list[bytes | None] = [None] * len(keys)

        async def one(shard: int, slice_: list[tuple[int, bytes]]):
            vals = await self._retag_stale_map(self._sub(shard).get_many(
                [k for _, k in slice_], snapshot=snapshot))
            for (i, _k), v in zip(slice_, vals):
                out[i] = v

        await asyncio.gather(*(one(s, sl) for s, sl in by_shard.items()))
        return out

    async def get_range(self, begin: bytes, end: bytes, *, limit: int = 0,
                        snapshot: bool = False):
        out = []
        for shard, b, e in self.engine.map.shards_overlapping(begin, end):
            remaining = limit - len(out) if limit else 0
            rows = await self._retag_stale_map(self._sub(shard).get_range(
                b, e, limit=remaining, snapshot=snapshot))
            out.extend(rows)
            if limit and len(out) >= limit:
                return out[:limit]   # shards are key-ordered: safe to stop
        return out

    # --- writes ---

    def set(self, key: bytes, value: bytes) -> None:
        self._sub(self.engine.map.shard_of(key)).set(key, value)

    def clear(self, key: bytes) -> None:
        self._sub(self.engine.map.shard_of(key)).clear(key)

    def clear_range(self, begin: bytes, end: bytes) -> None:
        for shard, b, e in self.engine.map.shards_overlapping(begin, end):
            self._sub(shard).clear_range(b, e)

    def add_read_conflict_key(self, key: bytes) -> None:
        self._sub(self.engine.map.shard_of(key)).add_read_conflict_key(key)

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        for shard, b, e in self.engine.map.shards_overlapping(begin, end):
            self._sub(shard).add_read_conflict_range(b, e)

    # --- commit ---

    async def commit(self) -> None:
        return await self._retag_stale_map(self._commit_inner())

    async def _commit_inner(self) -> None:
        assert not self._committed, "transaction reused after commit"
        mutating = sorted(
            s for s, sub in self._subs.items()
            if sub._writes or sub._range_clears)
        touched = sorted(self._subs)
        if not mutating:
            if len(touched) <= 1:
                # single-shard read-only: one pinned snapshot IS a
                # consistent cut — no validation round trip (else a full
                # read-set RPC per batch_stat)
                self._committed = True
                return
            # multi-shard read-only: the shards were pinned at different
            # moments, so each shard's reads must validate (the one-shot
            # read-only commit skips the RPC now — use the explicit
            # validation path)
            for s in touched:
                await self._subs[s].validate_reads()
            self._committed = True
            return
        if len(touched) == 1:
            await self._subs[touched[0]].commit()
            self._committed = True
            return
        # cross-shard: 2PC over every touched shard (read-only shards
        # prepare too — their validation must be inside the locked cut).
        # The FIRST touched shard is the decider: its commit_prepared
        # lands the durable COMMIT decision record, and phase 2 drives it
        # first, so every later shard can recover the verdict.
        txn_id = uuid.uuid4().hex
        decider_addrs = list(self.engine.map.ranges[touched[0]].addresses)
        participant_groups = [list(self.engine.map.ranges[s].addresses)
                              for s in touched]
        for s in touched:
            sub = self._subs[s]
            # pin the read version on subs that registered conflicts
            # without ever reading (add_read_conflict_*): version 0 would
            # conflict against ALL history, livelocking the txn
            if sub.read_version is None and (sub._read_keys
                                             or sub._read_ranges):
                await sub._ver()
        prepared: list[int] = []
        try:
            for s in touched:               # shard order: no lock cycles
                await self.engine.groups[s]._call(
                    "Kv.prepare",
                    KvPrepareReq(txn_id=txn_id,
                                 body=self._subs[s].to_commit_req(),
                                 decider=decider_addrs,
                                 is_decider=(s == touched[0]),
                                 participants=(participant_groups
                                               if s == touched[0] else [])))
                prepared.append(s)
        except BaseException:
            # abort EVERY touched shard incl. the one whose prepare call
            # failed: a client-side timeout may have landed server-side,
            # and abort_prepared is idempotent — this bounds the stall
            # instead of waiting out prepare_timeout_s
            for s in touched[:len(prepared) + 1]:
                try:
                    await self.engine.groups[s]._call(
                        "Kv.abort_prepared", KvFinishReq(txn_id=txn_id))
                except Exception:
                    log.warning("abort_prepared failed on shard %d "
                                "(prepare will expire)", s)
            raise
        # phase 2, DECIDER FIRST and alone: until its COMMIT decision
        # record lands, nothing may be applied anywhere — committing other
        # shards while the decider's outcome is unknown could tear the
        # txn against a later ABORT tombstone
        try:
            await self.engine.groups[touched[0]]._call(
                "Kv.commit_prepared", KvFinishReq(txn_id=txn_id),
                commit_ambiguous=True)
        except StatusError as e:
            if e.code == StatusCode.TXN_MAYBE_COMMITTED:
                # decision unknown: leave every shard to resolve via the
                # decider (they self-heal to whichever verdict stands)
                raise make_error(
                    StatusCode.TXN_MAYBE_COMMITTED,
                    f"cross-shard txn {txn_id}: decider outcome "
                    f"unknown: {e}") from None
            # decider definitively did not commit: clean abort everywhere
            for s in touched:
                try:
                    await self.engine.groups[s]._call(
                        "Kv.abort_prepared", KvFinishReq(txn_id=txn_id))
                except Exception:
                    pass
            raise
        # decision record = COMMITTED.  Drive the rest; any failure here
        # self-heals to COMMIT via its resolver, but the caller must know
        # propagation isn't complete yet.
        failures: list[tuple[int, StatusError]] = []
        for s in touched[1:]:
            try:
                await self.engine.groups[s]._call(
                    "Kv.commit_prepared", KvFinishReq(txn_id=txn_id),
                    commit_ambiguous=True)
            except StatusError as e:
                if e.code == StatusCode.KV_TXN_NOT_FOUND:
                    # the decider's COMMIT record is durable, so a shard
                    # with no prepare entry has ALREADY applied commit —
                    # typically via the decider's push racing this loop.
                    # (Abort is impossible here: resolvers only abort on
                    # a decider verdict, and the verdict is COMMIT.)
                    continue
                failures.append((s, e))
        if failures:
            raise make_error(
                StatusCode.TXN_MAYBE_COMMITTED,
                f"cross-shard txn {txn_id} COMMITTED (decision record "
                f"landed) but shards {[(s, str(e)) for s, e in failures]} "
                f"have not applied yet; they self-heal via the decider")
        self._committed = True


class ShardedKVEngine(KVEngine):
    """KVEngine over a range-sharded deployment of replicated KV groups."""

    def __init__(self, shard_map: ShardMap, client: Client | None = None,
                 timeout_s: float = 15.0,
                 map_home: list[str] | None = None):
        self.map = shard_map.validate()
        SHARD_STATS.map_version = max(SHARD_STATS.map_version,
                                      self.map.version)
        self.client = client or Client()
        self.timeout_s = timeout_s
        # map home: addresses of the (never-moving) group holding the
        # authoritative versioned map record; None = static deployment
        self.map_home = list(map_home or [])
        self._map_group = (RemoteKVEngine(self.map_home, client=self.client,
                                          timeout_s=timeout_s)
                           if self.map_home else None)
        self._rebuild_groups()

    def _rebuild_groups(self) -> None:
        self.groups = [RemoteKVEngine(r.addresses, client=self.client,
                                      timeout_s=self.timeout_s)
                       for r in self.map.ranges]

    async def refresh_map(self) -> bool:
        """Reload the shard map from the map home; True when it changed.
        Called by transactions that hit KV_WRONG_SHARD/KV_SHARD_FROZEN —
        the surgery mover bumped the version."""
        if self._map_group is None:
            return False
        txn = self._map_group.transaction()
        raw = await txn.get(MAP_KEY, snapshot=True)
        if raw is None:
            return False
        new: ShardMap = serde.loads(raw)
        if new.version <= self.map.version:
            return False
        self.map = new.validate()
        self._rebuild_groups()
        SHARD_STATS.map_version = max(SHARD_STATS.map_version, new.version)
        SHARD_STATS.map_refreshes += 1
        log.info("shard map refreshed to v%d (%d ranges)",
                 new.version, len(new.ranges))
        return True

    def transaction(self) -> ShardedTransaction:
        return ShardedTransaction(self)

    async def commit_async(self, txn) -> None:  # pragma: no cover
        raise NotImplementedError("ShardedTransaction commits via RPC")

    def clear_all(self) -> None:
        raise NotImplementedError("clear_all is a local-engine test helper")

    async def close(self) -> None:
        await self.client.close()
