"""Online shard surgery: split and move key ranges between KV groups.

Reference role: FoundationDB's data distributor — the range partitioning
behind src/fdb/FDBKVEngine.h moves and splits shards online; a static map
could never rebalance a hot INOD range without downtime.

Protocol (move):
  1. write a durable MOVE INTENT to the map home (resume after a crash);
  2. freeze the range on the source group (durable + TTL-bounded);
  3. clear any partial copy on the target, then snapshot-copy the frozen
     range in pages;
  4. target takes ownership (shard_set_owned with its full new list);
  5. source DROPS ownership (refuses the range with KV_WRONG_SHARD even
     after the freeze lapses) — BEFORE the map flips, so a mover death
     here costs a bounded unavailability window (stale clients bounce
     off KV_WRONG_SHARD until resume() republishes) instead of an
     acked-write-loss window (with the other order a mover dead past
     freeze_ttl_s would leave the source acking writes that step-6
     cleanup then deletes);
  6. publish map version+1 — clients start routing to the target;
  7. source deletes the moved rows and unfreezes; clear the intent.

Every step is idempotent and the intent records src/dst, so `resume()`
finishes a move killed at ANY point: before the source's ownership drop
it re-runs from the freeze (fresh snapshot — the TTL'd freeze guarantees
no lost writes); after the drop the source accepts nothing in the range,
so re-copy and map publish are race-free however long the mover stays
dead.  Ownership and freeze records replicate inside each group, so a
failover mid-move keeps refusing exactly what it must (see KvService
shard gates).

Clients converge lazily: a group answering KV_WRONG_SHARD makes the
sharded transaction refresh the map and retry (TXN_CONFLICT path).

The port of t3fs/kv/surgery.py (host code; no device work).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

from t3fs_torch.kv.remote import RemoteKVEngine
from t3fs_torch.kv.service import (
    KvRangeReq, KvShardLoadReq, KvShardOwnedReq, KvShardRangeReq,
)
from t3fs_torch.kv.shard import KEY_MAX, MAP_KEY, ShardMap, ShardRange
from t3fs_torch.net.client import Client
from t3fs_torch.utils import serde
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.kv.surgery")

INTENT_KEY = b"\x00t3fsshard\x00move"


@serde_struct
@dataclass
class MoveIntent:
    begin: bytes = b""
    end: bytes = b""
    src: list[str] = field(default_factory=list)
    dst: list[str] = field(default_factory=list)
    # "move" | "merge" — APPENDED last: serde cross-version compat is
    # positional, and an old driver resuming a new intent must still
    # decode the fields it knows
    kind: str = "move"


class ShardAdmin:
    """Admin-side surgery driver over the map home + shard groups.

    `budget_mbps` paces the move snapshot-copy page loop with the shared
    TokenBucketPacer discipline (waits are backpressure, never errors) so
    a bulk move can't starve foreground metadata traffic; 0 disables."""

    def __init__(self, map_home: list[str], client: Client | None = None,
                 page_rows: int = 1024, freeze_ttl_s: float = 30.0,
                 budget_mbps: float = 0.0):
        from t3fs_torch.client.repair import TokenBucketPacer
        self.map_home = list(map_home)
        self.client = client or Client()
        self.page_rows = page_rows
        self.freeze_ttl_s = freeze_ttl_s
        self.pacer = TokenBucketPacer(budget_mbps, floor_bytes=1)
        self._home = RemoteKVEngine(self.map_home, client=self.client)

    # --- map-home records ---

    async def load_map(self) -> ShardMap:
        txn = self._home.transaction()
        raw = await txn.get(MAP_KEY, snapshot=True)
        if raw is None:
            raise make_error(StatusCode.NOT_FOUND,
                             "no shard map published at the map home "
                             "(publish_map first)")
        return serde.loads(raw).validate()

    async def publish_map(self, m: ShardMap,
                          base_version: int | None = None) -> None:
        """Publish the map; with base_version set, a compare-and-swap —
        the commit conflicts if another surgery op raced this one (the
        read registers a conflict key, so SSI catches the interleave)."""
        m.validate()
        txn = self._home.transaction()
        raw = await txn.get(MAP_KEY)        # NON-snapshot: conflict-checked
        if base_version is not None:
            cur = serde.loads(raw).version if raw else 0
            if cur != base_version:
                raise make_error(
                    StatusCode.TXN_CONFLICT,
                    f"map moved v{base_version} -> v{cur} under this "
                    f"operation; reload and retry")
        txn.set(MAP_KEY, serde.dumps(m))
        await txn.commit()

    async def _load_intent(self) -> MoveIntent | None:
        txn = self._home.transaction()
        raw = await txn.get(INTENT_KEY, snapshot=True)
        return serde.loads(raw) if raw else None

    async def _put_intent(self, intent: MoveIntent | None) -> None:
        txn = self._home.transaction()
        if intent is None:
            txn.clear(INTENT_KEY)
        else:
            txn.set(INTENT_KEY, serde.dumps(intent))
        await txn.commit()

    def _group(self, addresses: list[str]) -> RemoteKVEngine:
        return RemoteKVEngine(list(addresses), client=self.client)

    # --- operations ---

    async def split(self, split_key: bytes) -> ShardMap:
        """Split the range containing split_key IN PLACE (both halves
        stay on the same group): a map-only change that makes the halves
        independently movable."""
        m = await self.load_map()
        idx = m.shard_of(split_key)
        r = m.ranges[idx]
        if split_key in (r.begin, r.end):
            return m                      # already a boundary: idempotent
        halves = [ShardRange(r.begin, split_key, list(r.addresses)),
                  ShardRange(split_key, r.end, list(r.addresses))]
        m.ranges[idx: idx + 1] = halves
        base = m.version
        m.version += 1
        await self.publish_map(m, base_version=base)
        log.info("split shard at %r -> map v%d", split_key, m.version)
        return m

    async def move(self, begin: bytes, end: bytes,
                   to_addresses: list[str]) -> ShardMap:
        """Move the EXACT map range [begin, end) to another group."""
        m = await self.load_map()
        match = [r for r in m.ranges if (r.begin, r.end) == (begin, end)]
        if not match:
            raise make_error(
                StatusCode.INVALID_ARG,
                f"[{begin!r},{end!r}) is not a map range (split first)")
        src = list(match[0].addresses)
        if sorted(src) == sorted(to_addresses):
            return m                       # already there: idempotent
        pending = await self._load_intent()
        if pending is not None and (pending.begin, pending.end,
                                    list(pending.dst)) != \
                (begin, end, list(to_addresses)):
            raise make_error(
                StatusCode.BUSY,
                f"another move ([{pending.begin!r},{pending.end!r}) -> "
                f"{pending.dst}) is pending; kv-move-resume it first")
        intent = MoveIntent(begin=begin, end=end, src=src,
                            dst=list(to_addresses))
        await self._put_intent(intent)
        out = await self._drive(m, intent)
        # the intent is the crash-recovery record: it clears ONLY after
        # the whole move (incl. source cleanup) succeeded — a failure
        # leaves it armed for kv-move-resume
        await self._put_intent(None)
        return out

    async def merge(self, begin: bytes, end: bytes,
                    move_first: bool = False) -> ShardMap:
        """Merge the two adjacent map ranges spanning EXACTLY [begin, end)
        back into one — the inverse of split.  Same-group merges are
        map-only (one CAS publish + an idempotent owned re-assert); when
        the halves live on different groups the merge refuses unless
        `move_first`, which first runs a full durable move of the right
        half onto the left's group (its own intent lifecycle — never two
        intents pending at once; a crash mid-move resumes as a move, and
        the next planner tick re-notices the now-same-group merge)."""
        m = await self.load_map()
        span = [r for r in m.ranges if r.begin < end and r.end > begin]
        if len(span) == 1 and (span[0].begin, span[0].end) == (begin, end):
            return m                      # already one range: idempotent
        if (len(span) != 2 or span[0].begin != begin
                or span[-1].end != end):
            raise make_error(
                StatusCode.INVALID_ARG,
                f"[{begin!r},{end!r}) does not span exactly two map "
                f"ranges (map v{m.version})")
        left, right = span
        if sorted(left.addresses) != sorted(right.addresses):
            if not move_first:
                raise make_error(
                    StatusCode.INVALID_ARG,
                    f"halves live on different groups ({left.addresses} "
                    f"vs {right.addresses}); pass move_first or move one")
            await self.move(right.begin, right.end, list(left.addresses))
            m = await self.load_map()
        pending = await self._load_intent()
        if pending is not None and \
                (pending.begin, pending.end, pending.kind) != \
                (begin, end, "merge"):
            raise make_error(
                StatusCode.BUSY,
                f"another surgery ({pending.kind} "
                f"[{pending.begin!r},{pending.end!r})) is pending; "
                f"resume it first")
        intent = MoveIntent(begin=begin, end=end,
                            src=list(left.addresses),
                            dst=list(left.addresses), kind="merge")
        await self._put_intent(intent)
        out = await self._drive_merge(await self.load_map(), intent)
        await self._put_intent(None)
        return out

    async def resume(self) -> ShardMap | None:
        """Finish a surgery whose driver died mid-way (the chaos path);
        None when no intent is pending."""
        intent = await self._load_intent()
        if intent is None:
            return None
        m = await self.load_map()
        if intent.kind == "merge":
            out = await self._drive_merge(m, intent)
        else:
            out = await self._drive(m, intent)
        await self._put_intent(None)
        return out

    async def _drive_merge(self, m: ShardMap,
                           intent: MoveIntent) -> ShardMap:
        """Idempotent merge executor: every step re-derived from the map
        just loaded.  No data moves and the owned UNION is unchanged, so
        there is no freeze and no unavailability window — the only
        ordered steps are the CAS map publish and an owned re-assert
        (which a crash can skip and resume repeats harmlessly)."""
        begin, end = intent.begin, intent.end
        span = [r for r in m.ranges if r.begin < end and r.end > begin]
        if len(span) == 1 and (span[0].begin, span[0].end) == (begin, end):
            # map already merged (we crashed after publish): re-assert
            # owned so the group's record collapses to the merged bounds
            await self._group(span[0].addresses)._call(
                "Kv.shard_set_owned",
                self._owned_req(m, list(span[0].addresses)))
            return m
        if (len(span) != 2 or span[0].begin != begin
                or span[-1].end != end):
            raise make_error(
                StatusCode.INVALID_ARG,
                f"[{begin!r},{end!r}) is no longer two exact map ranges; "
                f"resolve the merge intent manually (map v{m.version})")
        left, right = span
        if sorted(left.addresses) != sorted(right.addresses):
            raise make_error(
                StatusCode.INVALID_ARG,
                f"merge halves diverged onto different groups "
                f"({left.addresses} vs {right.addresses}); move first")
        merged = ShardRange(begin, end, list(left.addresses))
        new_map = ShardMap(
            ranges=[merged if r is left else r
                    for r in m.ranges if r is not right],
            version=m.version + 1)
        await self.publish_map(new_map, base_version=m.version)
        await self._group(left.addresses)._call(
            "Kv.shard_set_owned",
            self._owned_req(new_map, list(left.addresses)))
        log.info("merged [%r,%r) on %s, map v%d", begin, end,
                 left.addresses, new_map.version)
        return new_map

    async def _paced(self, nbytes: int, src_g: RemoteKVEngine,
                     freeze: KvShardRangeReq) -> None:
        """Charge a copied page to the byte budget, waiting in
        freeze-safe slices: each slice's wait is bounded well under the
        freeze TTL and the freeze is re-extended before the next, so a
        tight budget slows the copy down (backpressure, never an error)
        without ever letting the source thaw mid-copy — a lapsed freeze
        would accept writes into already-copied pages, which the map
        flip then silently loses."""
        if self.pacer.rate <= 0:
            return
        slice_bytes = max(1, int(self.pacer.rate * self.freeze_ttl_s / 4))
        off = 0
        while off < nbytes:
            take = min(slice_bytes, nbytes - off)
            await self.pacer.acquire(take)
            off += take
            if off < nbytes:
                await src_g._call("Kv.shard_freeze", freeze)

    async def _drive(self, m: ShardMap, intent: MoveIntent) -> ShardMap:
        begin, end = intent.begin, intent.end
        src_g = self._group(intent.src)
        dst_g = self._group(intent.dst)
        cur = [r for r in m.ranges if (r.begin, r.end) == (begin, end)]
        if not cur:
            # the map's boundaries changed under the intent (e.g. an
            # intervening split) — cleanup here would delete live rows
            raise make_error(
                StatusCode.INVALID_ARG,
                f"[{begin!r},{end!r}) is no longer an exact map range; "
                f"resolve the intent manually (map v{m.version})")
        flipped = sorted(cur[0].addresses) == sorted(intent.dst)
        if not flipped:
            # freeze + copy + take ownership + flip.  The freeze is
            # RE-EXTENDED on every copied page: a copy outlasting one
            # TTL would otherwise let the source accept writes into
            # already-copied pages, and the flip would lose them.
            freeze = KvShardRangeReq(begin=begin, end=end,
                                     ttl_s=self.freeze_ttl_s)
            await src_g._call("Kv.shard_freeze", freeze)
            await dst_g._call("Kv.shard_delete_range",
                              KvShardRangeReq(begin=begin, end=end))
            cursor = begin
            copied = 0
            while True:
                rsp = await src_g._call("Kv.shard_snapshot", KvRangeReq(
                    begin=cursor, end=end, limit=self.page_rows))
                if not rsp.keys:
                    break
                await dst_g._call("Kv.shard_load", KvShardLoadReq(
                    keys=rsp.keys, values=rsp.values))
                copied += len(rsp.keys)
                await src_g._call("Kv.shard_freeze", freeze)  # extend TTL
                if len(rsp.keys) < self.page_rows:
                    break
                await self._paced(
                    sum(len(k) + len(v)
                        for k, v in zip(rsp.keys, rsp.values)),
                    src_g, freeze)
                cursor = rsp.keys[-1] + b"\x00"
            # target's full owned list under the NEW map
            new_map = ShardMap(
                ranges=[ShardRange(r.begin, r.end, list(intent.dst))
                        if (r.begin, r.end) == (begin, end) else r
                        for r in m.ranges],
                version=m.version + 1)
            await dst_g._call("Kv.shard_set_owned",
                              self._owned_req(new_map, intent.dst))
            # source refuses the range BEFORE the flip: dying between
            # the drop and the publish leaves stale clients bouncing off
            # KV_WRONG_SHARD (bounded unavailability, resume() heals) —
            # never an acked write the cleanup below would delete
            await src_g._call("Kv.shard_set_owned",
                              self._owned_req(new_map, intent.src))
            await self.publish_map(new_map, base_version=m.version)
            m = new_map
            log.info("moved [%r,%r) to %s (%d rows), map v%d",
                     begin, end, intent.dst, copied, m.version)
        # source-side cleanup (also the resume-after-flip path; the
        # owned re-assert is idempotent and covers intents written by a
        # pre-reorder driver that flipped the map first)
        await src_g._call("Kv.shard_set_owned",
                          self._owned_req(m, intent.src))
        await src_g._call("Kv.shard_delete_range",
                          KvShardRangeReq(begin=begin, end=end))
        await src_g._call("Kv.shard_unfreeze",
                          KvShardRangeReq(begin=begin, end=end))
        return m

    @staticmethod
    def _owned_req(m: ShardMap, addresses: list[str]) -> KvShardOwnedReq:
        # order-insensitive group identity: an operator listing an
        # existing group's addresses in a different order must not make
        # shard_set_owned's wholesale replace omit that group's live
        # ranges (an outage that would need manual repair)
        want = sorted(addresses)
        ranges = [(r.begin, r.end) for r in m.ranges
                  if sorted(r.addresses) == want]
        return KvShardOwnedReq(begins=[b for b, _ in ranges],
                               ends=[e for _, e in ranges])

    async def close(self) -> None:
        await self.client.close()
