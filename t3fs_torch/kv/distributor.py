"""KVDistributor: the FoundationDB data-distribution analog.

The sharded KV has the *mechanisms* — versioned ShardMap, crash-resumable
split/move/merge surgery (kv/surgery.py) — but until now no *brain*: the
map was static until an operator ran `admin kv-split` by hand, so a hot
DENT range stayed pinned to one replicated group forever.  This planner
closes the loop, reusing the rebalancer's proven convergent-tick +
resumable-job discipline (the reference's migration/rebalancer.py):

  every tick re-derives EVERYTHING from fresh state —
    1. the live intent record (a pending surgery, ours or an operator's,
       means the planner submits nothing and skips its ranges: mutual
       exclusion by construction; an intent that outlives
       `resume_after_s` is an orphan from a crashed driver and gets
       admin.resume()'d, which is idempotent at every step);
    2. the live map;
    3. Kv.range_stats from every distinct group (decaying EWMA rates +
       sampled split points, kv/service.py RangeLoadTracker);
  then scores three surgery kinds and executes at most `max_inflight`
  through ShardAdmin, paced by its byte budget (MOVE is scored first:
  under a fresh hot spot the split loop alone would consume a small
  budget every tick and starve rebalancing):
    MOVE   the hottest range off the most-loaded group to the
           least-loaded one, when the groups' load ratio exceeds the
           hysteresis band AND the move strictly shrinks the gap
           (0 < range ops < hot-cold; a lone whole-keyspace range
           therefore splits before anything moves, instead of
           ping-ponging between groups);
    SPLIT  a range that is hot (ops/s) or oversized (bytes), at the
           sampled median accessed key — where the traffic is, not the
           byte midpoint;
    MERGE  two cold same-group adjacents whose combined size stays
           clear of the split thresholds (the distributor never merges
           across groups — ShardAdmin.merge(move_first=True) exists for
           operators, but auto-moving data just to merge map entries is
           churn with no load payoff).

Flap protection: every executed surgery arms a per-range cooldown (keyed
by range begin; a split arms BOTH halves), and merge additionally
requires load below `merge_ops_threshold` while split requires above
`split_ops_threshold`, with merge_ops << split_ops — the hysteresis gap
plus the cooldown makes split->merge oscillation structurally
impossible: a just-split range cannot merge before `cooldown_s`, and by
then its EWMA (half-life 30 s) reflects the true post-burst load.

Crash safety: the distributor itself holds NO durable state.  Its only
persistent artifact is the surgery intent ShardAdmin already writes; a
distributor killed mid-surgery and restarted heals it via resume() in
start() and then converges to the same map any other replica of the
planner would, because every input is re-pulled each tick.

The port of t3fs/kv/distributor.py (host code; no device work).
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from t3fs_torch.kv.service import KvRangeStatsReq
from t3fs_torch.kv.surgery import ShardAdmin
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusError

log = logging.getLogger("t3fs_torch.kv.distributor")


@dataclass
class _RangeStat:
    """One map range's merged view: map placement + pulled load."""
    begin: bytes
    end: bytes
    addresses: list[str]
    read_ops_s: float = 0.0
    write_ops_s: float = 0.0
    bytes_s: float = 0.0
    rows: int = 0
    approx_bytes: int = 0
    split_key: bytes = b""

    @property
    def ops_s(self) -> float:
        return self.read_ops_s + self.write_ops_s

    @property
    def group(self) -> tuple[str, ...]:
        return tuple(sorted(self.addresses))


@serde_struct
@dataclass
class KvDistStatusReq:
    pass


@serde_struct
@dataclass
class KvDistStatusRsp:
    ticks: int = 0
    splits: int = 0
    merges: int = 0
    moves: int = 0
    resumed: int = 0
    skipped_intent: int = 0
    skipped_cooldown: int = 0
    errors: int = 0
    map_version: int = 0
    last_actions: list[str] = field(default_factory=list)
    paced_waits: int = 0
    paced_wait_s: float = 0.0


@serde_struct
@dataclass
class KvDistTickReq:
    pass


@serde_struct
@dataclass
class KvDistTickRsp:
    actions: list[str] = field(default_factory=list)
    map_version: int = 0


@service("KvDist")
class KVDistributor:
    """Convergent split/merge/move planner over one sharded KV
    deployment.  Thresholds are deliberately asymmetric (hysteresis):
    `merge_ops_threshold` must sit far below `split_ops_threshold`."""

    MAX_ACTION_HISTORY = 64

    def __init__(self, map_home: list[str], client: Client | None = None, *,
                 tick_period_s: float = 5.0,
                 split_ops_threshold: float = 200.0,
                 split_bytes_threshold: int = 64 << 20,
                 merge_ops_threshold: float = 10.0,
                 imbalance_ratio: float = 2.0,
                 cooldown_s: float = 60.0,
                 max_inflight: int = 1,
                 resume_after_s: float = 120.0,
                 budget_mbps: float = 0.0,
                 page_rows: int = 1024,
                 freeze_ttl_s: float = 30.0,
                 known_groups: list[list[str]] | None = None):
        assert merge_ops_threshold < split_ops_threshold, \
            "hysteresis requires merge threshold << split threshold"
        # candidate MOVE targets beyond what the map names: a freshly
        # provisioned group serves no range yet, so the map alone can
        # never route load to it (FDB's DD knows every storage team the
        # same way — from the cluster registry, not the shard map)
        self.known_groups = [list(g) for g in (known_groups or [])]
        self.admin = ShardAdmin(map_home, client=client,
                                page_rows=page_rows,
                                freeze_ttl_s=freeze_ttl_s,
                                budget_mbps=budget_mbps)
        self.tick_period_s = tick_period_s
        self.split_ops_threshold = split_ops_threshold
        self.split_bytes_threshold = split_bytes_threshold
        self.merge_ops_threshold = merge_ops_threshold
        self.imbalance_ratio = imbalance_ratio
        self.cooldown_s = cooldown_s
        self.max_inflight = max_inflight
        self.resume_after_s = resume_after_s
        # range-begin -> monotonic deadline before which no surgery may
        # touch the range again (flap protection)
        self._cooldowns: dict[bytes, float] = {}
        # (serialized intent bytes, first seen monotonic) for orphan aging
        self._intent_seen: tuple[bytes, float] | None = None
        self.ticks = 0
        self.splits = 0
        self.merges = 0
        self.moves = 0
        self.resumed = 0
        self.skipped_intent = 0
        self.skipped_cooldown = 0
        self.errors = 0
        self.last_map_version = 0
        self.last_actions: list[str] = []
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    # ---- lifecycle ----

    async def start(self) -> None:
        """Heal any orphaned surgery intent FIRST (satellite: a mover
        crashed mid-copy must not strand its range frozen/dropped), then
        run the planner loop."""
        try:
            healed = await self.admin.resume()
            if healed is not None:
                self.resumed += 1
                log.info("healed orphaned surgery intent at startup "
                         "(map v%d)", healed.version)
        except StatusError as e:
            # an unresolvable intent (map changed shape under it) must
            # not keep the planner down; it is surfaced via status
            self.errors += 1
            log.warning("startup intent resume failed: %s", e)
        self._stopped.clear()
        self._task = asyncio.create_task(self._loop(), name="kvdist-plan")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "kv distributor loop")
            self._task = None

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # every tick re-derives everything; skipping one is safe
                self.errors += 1
                log.warning("kv distributor tick failed: %s", e)
            # sleep on the stop event, not a bare sleep: this
            # interpreter's wait_for eats a cancel that lands after the
            # awaited RPC future resolved but before the tick resumed
            # (bpo-37658), which would leave stop() waiting a whole
            # period — the event makes shutdown immediate either way
            try:
                await asyncio.wait_for(self._stopped.wait(),
                                       self.tick_period_s)
            except asyncio.TimeoutError:
                pass

    # ---- views ----

    async def _pull_stats(self, m) -> list[_RangeStat]:
        """Kv.range_stats from every distinct group, keyed back onto the
        map's ranges.  A group that can't answer contributes zeros (the
        planner must not stall on one sick group)."""
        by_group: dict[tuple[str, ...], list] = {}
        for r in m.ranges:
            by_group.setdefault(tuple(sorted(r.addresses)), []).append(r)
        stats = {(r.begin, r.end): _RangeStat(r.begin, r.end,
                                              list(r.addresses))
                 for r in m.ranges}
        async def one(group_key, ranges):
            req = KvRangeStatsReq(begins=[r.begin for r in ranges],
                                  ends=[r.end for r in ranges])
            try:
                rsp = await self.admin._group(
                    list(group_key))._call("Kv.range_stats", req)
            except (StatusError, OSError, asyncio.TimeoutError) as e:
                log.warning("range_stats from %s failed: %s", group_key, e)
                return
            for i in range(len(rsp.begins)):
                st = stats.get((rsp.begins[i], rsp.ends[i]))
                if st is None:
                    continue
                st.read_ops_s = rsp.read_ops_s[i]
                st.write_ops_s = rsp.write_ops_s[i]
                st.bytes_s = rsp.read_bytes_s[i] + rsp.write_bytes_s[i]
                st.rows = rsp.rows[i]
                st.approx_bytes = rsp.approx_bytes[i]
                st.split_key = rsp.split_keys[i]
        await asyncio.gather(*(one(g, rs) for g, rs in by_group.items()))
        # map order (adjacency matters for merge scoring)
        return [stats[(r.begin, r.end)] for r in m.ranges]

    # ---- the planner ----

    def _cold(self, begin: bytes, now: float) -> bool:
        return self._cooldowns.get(begin, 0.0) <= now

    def _arm_cooldown(self, *begins: bytes) -> None:
        deadline = time.monotonic() + self.cooldown_s
        for b in begins:
            self._cooldowns[b] = deadline

    def _prune_cooldowns(self, now: float) -> None:
        for b in [b for b, d in self._cooldowns.items() if d <= now]:
            del self._cooldowns[b]

    async def tick(self) -> KvDistTickRsp:
        self.ticks += 1
        now = time.monotonic()
        self._prune_cooldowns(now)

        # 1. mutual exclusion with any in-flight surgery: a live intent
        #    (an operator's kv-move, or our own crashed driver) means no
        #    NEW surgery this tick.  An intent unchanged for longer than
        #    resume_after_s is an orphan — no live driver runs that long
        #    without finishing a step — and resume() (idempotent at every
        #    step boundary) completes it.
        intent = await self.admin._load_intent()
        if intent is not None:
            from t3fs_torch.utils import serde
            blob = serde.dumps(intent)
            if self._intent_seen is None or self._intent_seen[0] != blob:
                self._intent_seen = (blob, now)
            age = now - self._intent_seen[1]
            if age >= self.resume_after_s:
                log.warning("surgery intent (%s [%r,%r)) stale for %.0fs: "
                            "resuming as orphan", intent.kind, intent.begin,
                            intent.end, age)
                healed = await self.admin.resume()
                self.resumed += 1
                self._intent_seen = None
                return self._done([f"resumed {intent.kind} "
                                   f"[{intent.begin!r},{intent.end!r})"],
                                  healed.version if healed else 0)
            self.skipped_intent += 1
            return self._done([], 0)
        self._intent_seen = None

        # 2-3. fresh map + per-range load
        m = await self.admin.load_map()
        self.last_map_version = m.version
        stats = await self._pull_stats(m)

        group_load: dict[tuple[str, ...], float] = {}
        for st in stats:
            group_load[st.group] = group_load.get(st.group, 0.0) + st.ops_s
        for g in self.known_groups:
            group_load.setdefault(tuple(sorted(g)), 0.0)

        actions: list[str] = []
        budget = self.max_inflight

        # MOVE: hottest movable range off the most-loaded group onto the
        # least-loaded, when the imbalance exceeds the hysteresis band.
        # Runs BEFORE split: under a fresh hot spot every range is above
        # the split threshold for many ticks, and with a small budget the
        # split loop would consume it all — rebalancing would starve.
        # A candidate must strictly improve the spread: moving u ops/s
        # from the hot group (H) to the cold one (C) turns the gap H-C
        # into |H-C-2u|, an improvement only when 0 < u < H-C.  This is
        # also what stops a lone whole-keyspace range from ping-ponging
        # between groups — it must split before anything can move.
        if budget > 0 and len(group_load) > 1:
            hot_g = max(group_load, key=lambda g: group_load[g])
            cold_g = min(group_load, key=lambda g: group_load[g])
            mean = sum(group_load.values()) / len(group_load)
            gap = group_load[hot_g] - group_load[cold_g]
            if (group_load[hot_g] > self.imbalance_ratio
                    * max(group_load[cold_g], mean / self.imbalance_ratio)
                    and group_load[hot_g] > self.merge_ops_threshold):
                cands = sorted(
                    (st for st in stats if st.group == hot_g
                     and 0.0 < st.ops_s < gap
                     and self._cold(st.begin, now)),
                    key=lambda st: st.ops_s, reverse=True)
                if not cands:
                    self.skipped_cooldown += 1
                for st in cands[:1]:
                    try:
                        m = await self.admin.move(st.begin, st.end,
                                                  list(cold_g))
                    except StatusError as e:
                        self.errors += 1
                        log.warning("move [%r,%r) failed: %s",
                                    st.begin, st.end, e)
                        continue
                    self.moves += 1
                    budget -= 1
                    self._arm_cooldown(st.begin)
                    actions.append(
                        f"move [{st.begin!r},{st.end!r}) "
                        f"({st.ops_s:.0f} ops/s) {list(hot_g)} -> "
                        f"{list(cold_g)} v{m.version}")

        # SPLIT: hot or oversized ranges, at the sampled traffic median
        for st in stats:
            if budget <= 0:
                break
            hot = st.ops_s >= self.split_ops_threshold
            fat = 0 < self.split_bytes_threshold <= st.approx_bytes
            if not (hot or fat):
                continue
            if not st.split_key:
                continue          # no usable sample (e.g. one hot KEY)
            if not self._cold(st.begin, now):
                self.skipped_cooldown += 1
                continue
            try:
                m = await self.admin.split(st.split_key)
            except StatusError as e:
                self.errors += 1
                log.warning("split at %r failed: %s", st.split_key, e)
                continue
            self.splits += 1
            budget -= 1
            self._arm_cooldown(st.begin, st.split_key)
            actions.append(f"split [{st.begin!r},{st.end!r}) at "
                           f"{st.split_key!r} "
                           f"({st.ops_s:.0f} ops/s) -> v{m.version}")

        # MERGE: adjacent same-group cold pairs, combined size well
        # under the split threshold (or a later tick would re-split)
        i = 0
        while budget > 0 and i + 1 < len(stats):
            a, b = stats[i], stats[i + 1]
            i += 1
            if a.group != b.group:
                continue
            if a.ops_s > self.merge_ops_threshold \
                    or b.ops_s > self.merge_ops_threshold:
                continue
            if self.split_bytes_threshold > 0 and \
                    a.approx_bytes + b.approx_bytes \
                    > self.split_bytes_threshold // 2:
                continue
            if not (self._cold(a.begin, now) and self._cold(b.begin, now)):
                self.skipped_cooldown += 1
                continue
            try:
                m = await self.admin.merge(a.begin, b.end)
            except StatusError as e:
                self.errors += 1
                log.warning("merge [%r,%r) failed: %s", a.begin, b.end, e)
                continue
            self.merges += 1
            budget -= 1
            self._arm_cooldown(a.begin)
            actions.append(f"merge [{a.begin!r},{b.end!r}) on "
                           f"{list(a.group)} -> v{m.version}")
            i += 1            # skip the consumed right half

        return self._done(actions, m.version)

    def _done(self, actions: list[str], version: int) -> KvDistTickRsp:
        if actions:
            self.last_actions.extend(actions)
            del self.last_actions[:-self.MAX_ACTION_HISTORY]
            self.last_map_version = max(self.last_map_version, version)
            for a in actions:
                log.info("kvdist: %s", a)
        return KvDistTickRsp(actions=actions, map_version=version)

    # ---- RPC surface (admin/status; tests use trigger) ----

    @rpc_method
    async def status(self, req, payload, conn):
        return KvDistStatusRsp(
            ticks=self.ticks, splits=self.splits, merges=self.merges,
            moves=self.moves, resumed=self.resumed,
            skipped_intent=self.skipped_intent,
            skipped_cooldown=self.skipped_cooldown, errors=self.errors,
            map_version=self.last_map_version,
            last_actions=list(self.last_actions[-16:]),
            paced_waits=self.admin.pacer.waits,
            paced_wait_s=self.admin.pacer.waited_s), b""

    @rpc_method
    async def trigger(self, req, payload, conn):
        return await self.tick(), b""

    async def close(self) -> None:
        await self.stop()
