"""Mgmtd: cluster manager service.

Reference analogs (SURVEY.md §2.4): MgmtdState (lease, MgmtdState.h:28),
MgmtdOperator ops (heartbeat, getRoutingInfo, setChainTable, updateChain...),
background MgmtdHeartbeatChecker (dead after T), MgmtdChainsUpdater applying
the LocalState x PublicState transition table (updateChain.h:38
generateNewChain; docs/design_notes.md:201-231), MgmtdLeaseExtender.

State lives in the transactional KV (same store as file metadata, like the
reference persists its lease/chains in FoundationDB); heartbeat liveness is
in-memory (a restarted mgmtd re-learns it within one heartbeat period).

The port of t3fs/mgmtd/service.py; the chain state machine
(next_chain_state, rotate_last_srv, rotate_as_preferred_order) is the
reference's line for line.  Not ported: the health puller, which needs
the monitor service — MgmtdServer.start() raises when monitor_address is
set rather than run without it.
"""

from __future__ import annotations

import asyncio
import logging
import time
from dataclasses import dataclass, field

from t3fs_torch.kv.engine import KVEngine, with_transaction
from t3fs_torch.kv.prefixes import KeyPrefix
from t3fs_torch.mgmtd.types import (
    ChainInfo, ChainTable, ChainTargetInfo, ClientSession, LocalTargetState,
    NodeInfo, PublicTargetState, RoutingInfo,
)
from t3fs_torch.mgmtd.types import NodeStatus as NodeStatusEnum
from t3fs_torch.monitor.health import ClusterHealth
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.net.wire import OkRsp
from t3fs_torch.utils import serde
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.config import ConfigBase, citem
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.mgmtd")


@serde_struct
@dataclass
class HeartbeatReq:
    node: NodeInfo = field(default_factory=NodeInfo)
    target_states: dict[int, LocalTargetState] = field(default_factory=dict)
    routing_version: int = 0
    # targets whose engine booted on a VIRGIN directory and have not yet
    # completed a resync: the chain state machine must never reseat such
    # a target as an authority (fresh-LASTSRV demotion; append-only
    # field — old nodes simply never report any)
    fresh_targets: list[int] = field(default_factory=list)


@serde_struct
@dataclass
class HeartbeatRsp:
    routing_version: int = 0
    primary: bool = True
    # mgmtd's failure-detection window: the node self-fences (stops
    # serving writes) when it hasn't completed a heartbeat for lease_s/2,
    # so a partitioned stale head stops acking BEFORE mgmtd promotes a
    # successor (reference: suicide at lease/2, src/common/utils/
    # suicide.cc:7, docs/design_notes.md:177)
    lease_s: float = 0.0


@serde_struct
@dataclass
class GetRoutingInfoReq:
    known_version: int = 0
    # appended (serde add-only, like the trace fields): scorecard
    # version the caller already holds; 0 asks for whatever is cached
    known_health_version: int = 0
    # appended: caller can apply RoutingDelta — opt-in, because a
    # pre-delta client interprets info=None as "up to date" and
    # would silently drop an unsolicited delta
    want_delta: bool = False


@serde_struct
@dataclass
class RoutingDelta:
    """Incremental routing update: only the chains that
    changed between base_version and version, plus the (small) full node
    and chain-table maps.  A caller whose cached version != base_version
    must discard the delta and do a full refresh."""
    version: int = 0
    base_version: int = 0
    chains: list[ChainInfo] = field(default_factory=list)
    removed_chains: list[int] = field(default_factory=list)
    nodes: dict[int, NodeInfo] = field(default_factory=dict)
    chain_tables: dict[int, ChainTable] = field(default_factory=dict)
    bootstrapping: bool = False


@serde_struct
@dataclass
class GetRoutingInfoRsp:
    info: RoutingInfo | None = None   # None when caller is up to date
    # appended (add-only): cluster health scorecard piggyback — present
    # when the primary has pulled one from the monitor AND the caller's
    # known_health_version is behind; old clients drop the extra fields,
    # old servers leave them at defaults (None/0)
    health: ClusterHealth | None = None
    health_version: int = 0
    # appended: incremental update when the caller sent
    # want_delta and the change log covers its version; info stays None
    delta: RoutingDelta | None = None


@serde_struct
@dataclass
class ClusterHealthReq:
    pass


@serde_struct
@dataclass
class ClusterHealthRsp:
    health: ClusterHealth | None = None
    health_version: int = 0


@serde_struct
@dataclass
class SetChainsReq:
    chains: list[ChainInfo] = field(default_factory=list)
    tables: list[ChainTable] = field(default_factory=list)


@serde_struct
@dataclass
class LeaseInfo:
    holder_node: int = 0
    holder_address: str = ""
    expires_at: float = 0.0


@serde_struct
@dataclass
class NodeStatus:
    node: NodeInfo = field(default_factory=NodeInfo)
    last_heartbeat_age_s: float = -1.0
    alive: bool = False


@serde_struct
@dataclass
class ListNodesRsp:
    nodes: list[NodeStatus] = field(default_factory=list)


@serde_struct
@dataclass
class SetConfigTemplateReq:
    node_type: str = ""
    toml: str = ""


@serde_struct
@dataclass
class GetConfigTemplateReq:
    node_type: str = ""


@serde_struct
@dataclass
class GetConfigTemplateRsp:
    toml: str = ""
    found: bool = False


@dataclass
class MgmtdConfig(ConfigBase):
    """Hot-updatable service knobs (ConfigBase.h CONFIG_HOT_UPDATED_ITEM
    analog) — the background loops read these live each iteration."""
    heartbeat_timeout_s: float = citem(2.0, validator=lambda v: v > 0)
    chains_update_period_s: float = citem(0.25, validator=lambda v: v > 0)
    lease_ttl_s: float = citem(10.0, validator=lambda v: v > 0)
    lease_extend_period_s: float = citem(3.0, validator=lambda v: v > 0)
    client_session_ttl_s: float = citem(60.0, validator=lambda v: v > 0)
    sessions_check_period_s: float = citem(5.0, validator=lambda v: v > 0)
    # cluster health plane: the primary pulls the scorecard
    # from the monitor and piggybacks it on GetRoutingInfoRsp.  Empty
    # monitor_address disables the puller (pre-health deployments)
    monitor_address: str = citem("")
    health_pull_period_s: float = citem(1.0, validator=lambda v: v > 0)
    health_window_s: float = citem(30.0, validator=lambda v: v > 0)


class MgmtdState:
    """Persistent cluster state over the KV + in-memory liveness."""

    def __init__(self, kv: KVEngine, node_id: int, address: str,
                 cfg: MgmtdConfig):
        self.kv = kv
        self.node_id = node_id
        self.address = address
        self.cfg = cfg
        self.last_heartbeat: dict[int, float] = {}
        self.local_states: dict[int, LocalTargetState] = {}   # target -> state
        # targets currently reporting a virgin disk (HeartbeatReq.
        # fresh_targets); in-memory like local_states — re-learned from
        # the next heartbeats after an mgmtd restart
        self.fresh_targets: set[int] = set()
        self._persisted_states: dict[int, LocalTargetState] = {}
        # targets whose node silently restarted: demote from SERVING so they
        # resync (cleared by the chains updater AFTER a successful save)
        self.restarted_targets: set[int] = set()
        # node records whose generation changed: persisted by the chains
        # updater IN THE SAME transaction as the demotions, so an mgmtd
        # failover can't see the new generation without the demotions
        self.pending_node_saves: dict[int, NodeInfo] = {}
        self._routing_cache: RoutingInfo | None = None
        # which node last reported each target (live info from heartbeats;
        # feeds listOrphanTargets — not persisted, best-effort by design)
        self.target_reporter: dict[int, int] = {}
        # latest scrub/repair health per reporting source (pushed by
        # report_repair_status; in-memory like last_heartbeat)
        self.repair_statuses: dict[str, "RepairStatus"] = {}
        # cluster health scorecard pulled from the monitor (in-memory,
        # like liveness: re-pulled within one period after a failover).
        # health_version bumps on every refreshed pull so clients can
        # version-gate the GetRoutingInfoRsp piggyback
        self.health: ClusterHealth | None = None
        self.health_version: int = 0
        # startup grace: a restarted mgmtd has an empty liveness map — treat
        # every node as alive until one full heartbeat window has passed, or
        # the first updater tick would demote the whole healthy cluster
        self.started_at: float = time.time()
        # routing change log — version -> chain ids changed at
        # that version (empty tuple = node/table-only bump).  In-memory:
        # a restarted/failed-over mgmtd starts with an empty log and
        # clients simply fall back to one full refresh.  Any version
        # missing from the window forces the full path too, so the log
        # can never serve a delta it cannot prove complete.
        self.change_log: dict[int, tuple[int, ...]] = {}

    CHANGE_LOG_CAP = 256

    def _log_change(self, version: int, chain_ids) -> None:
        prev = self.change_log.get(version, ())
        self.change_log[version] = tuple(set(prev) | set(chain_ids))
        while len(self.change_log) > self.CHANGE_LOG_CAP:
            self.change_log.pop(min(self.change_log))

    def build_delta(self, known_version: int) -> "RoutingDelta | None":
        """Delta covering (known_version, current]; None when the change
        log cannot prove completeness (gap, restart, or caller too far
        behind) — the caller then gets the full RoutingInfo."""
        info = self.routing()
        if known_version <= 0 or known_version >= info.version:
            return None
        changed: set[int] = set()
        for v in range(known_version + 1, info.version + 1):
            entry = self.change_log.get(v)
            if entry is None:
                return None
            changed.update(entry)
        if len(changed) * 2 >= max(1, len(info.chains)):
            return None            # most chains moved: full is cheaper
        return RoutingDelta(
            version=info.version, base_version=known_version,
            chains=[info.chains[c] for c in sorted(changed)
                    if c in info.chains],
            removed_chains=sorted(c for c in changed
                                  if c not in info.chains),
            nodes=dict(info.nodes),
            chain_tables=dict(info.chain_tables),
            bootstrapping=info.bootstrapping)

    # --- lease (primary election) ---

    async def try_acquire_lease(self) -> bool:
        now = time.time()

        async def txn_fn(txn):
            raw = await txn.get(KeyPrefix.LEASE.key())
            lease = serde.loads(raw) if raw else LeaseInfo()
            if lease.holder_node not in (0, self.node_id) and lease.expires_at > now:
                return False
            txn.set(KeyPrefix.LEASE.key(), serde.dumps(LeaseInfo(
                self.node_id, self.address, now + self.cfg.lease_ttl_s)))
            return True

        return await with_transaction(self.kv, txn_fn)

    async def is_primary(self) -> bool:
        txn = self.kv.transaction()
        raw = await txn.get(KeyPrefix.LEASE.key(), snapshot=True)
        if not raw:
            return False
        lease = serde.loads(raw)
        return lease.holder_node == self.node_id and lease.expires_at > time.time()

    async def lease_info(self) -> LeaseInfo:
        txn = self.kv.transaction()
        raw = await txn.get(KeyPrefix.LEASE.key(), snapshot=True)
        return serde.loads(raw) if raw else LeaseInfo()

    # --- persistent records ---

    async def load_routing(self) -> RoutingInfo:
        txn = self.kv.transaction()
        info = RoutingInfo()
        raw = await txn.get(KeyPrefix.ROUTING_VER.key(), snapshot=True)
        info.version = int(raw) if raw else 1
        for k, v in await txn.get_range(KeyPrefix.NODE.value, KeyPrefix.NODE.value + b"\xff",
                                  snapshot=True):
            n: NodeInfo = serde.loads(v)
            info.nodes[n.node_id] = n
        for k, v in await txn.get_range(KeyPrefix.CHAIN.value, KeyPrefix.CHAIN.value + b"\xff",
                                  snapshot=True):
            c: ChainInfo = serde.loads(v)
            info.chains[c.chain_id] = c
        for k, v in await txn.get_range(KeyPrefix.CHAIN_TABLE.value,
                                  KeyPrefix.CHAIN_TABLE.value + b"\xff", snapshot=True):
            t: ChainTable = serde.loads(v)
            info.chain_tables[t.table_id] = t
        if not self.local_states:
            # fresh/failed-over mgmtd: seed target info from the persisted
            # blob (heartbeats overwrite it live)
            raw = await txn.get(KeyPrefix.TARGET_INFO.key(), snapshot=True)
            if raw:
                blob: "TargetInfoBlob" = serde.loads(raw)
                self.local_states = {int(k2): LocalTargetState(v2)
                                     for k2, v2 in blob.states.items()}
        self._routing_cache = info
        return info

    async def persist_target_info(self) -> None:
        """Persist the current per-target local states (one blob)."""
        states = dict(self.local_states)

        async def txn_fn(txn):
            txn.set(KeyPrefix.TARGET_INFO.key(),
                    serde.dumps(TargetInfoBlob(states=states)))
        await with_transaction(self.kv, txn_fn)
        self._persisted_states = states

    def routing(self) -> RoutingInfo:
        return self._routing_cache or RoutingInfo()

    @staticmethod
    async def _merge_node_write(txn, node: NodeInfo,
                                admin: bool) -> NodeInfo:
        """In-txn merge for node-record writes.  status (when DISABLED) and
        tags are mgmtd-admin-owned: liveness/heartbeat writers must never
        stomp them, and reading the current record inside the transaction
        makes a racing admin op an SSI conflict instead of a lost update."""
        key = KeyPrefix.NODE.key(str(node.node_id).encode())
        if not admin:
            raw = await txn.get(key)
            if raw is not None:
                cur: NodeInfo = serde.loads(raw)
                merged = NodeInfo(**{**node.__dict__})
                merged.tags = list(cur.tags)
                if cur.status == NodeStatusEnum.DISABLED:
                    merged.status = cur.status
                node = merged
        txn.set(key, serde.dumps(node))
        return node

    async def save_node(self, node: NodeInfo) -> None:
        async def txn_fn(txn):
            await self._merge_node_write(txn, node, admin=False)
        await with_transaction(self.kv, txn_fn)

    async def save_chains(self, chains: list[ChainInfo],
                          tables: list[ChainTable] = (),
                          nodes: list[NodeInfo] = (),
                          guard_versions: bool = True) -> list[int]:
        """Persist chains (+tables, +node records) in ONE transaction — the
        nodes ride along so e.g. a restart-demotion and the node's new
        generation become durable together.

        Each chain write is CAS-guarded inside the transaction: a chain is
        only stored if the persisted version is exactly new_ver - 1.  The
        chains updater and the admin chain-surgery ops both read-modify-write
        from the in-memory routing cache, so without the guard whichever
        transaction commits second would silently revert the first (both
        also touch ROUTING_VER, so SSI aborts one — but with_transaction
        re-runs the closure with the same stale pre-computed value; the
        in-txn version check is what makes the retry correct).  Returns the
        chain ids actually written; skipped chains signal a lost race —
        callers recompute from fresh routing.  guard_versions=False is for
        installing chains wholesale (admin set_chains)."""
        written: list[int] = []

        async def txn_fn(txn):
            written.clear()
            any_write = False
            skipped = False
            for c in chains:
                key = KeyPrefix.CHAIN.key(str(c.chain_id).encode())
                if guard_versions:
                    raw = await txn.get(key)
                    cur_ver = serde.loads(raw).chain_ver if raw else 0
                    if cur_ver != c.chain_ver - 1:
                        skipped = True
                        continue  # someone else advanced this chain: skip
                txn.set(key, serde.dumps(c))
                written.append(c.chain_id)
                any_write = True
            for t in tables or ():
                # table_ver advances monotonically on every re-install
                # read the persisted predecessor inside the
                # txn so with_transaction retries recompute it
                key = KeyPrefix.CHAIN_TABLE.key(str(t.table_id).encode())
                raw = await txn.get(key)
                prev = serde.loads(raw) if raw else None
                prev_ver = getattr(prev, "table_ver", 0) if prev else 0
                stamped = ChainTable(
                    table_id=t.table_id, chain_ids=list(t.chain_ids),
                    table_ver=max(prev_ver + 1, t.table_ver),
                    table_type=t.table_type,
                    # desired replication is sticky: a re-install that
                    # leaves it unset (0) must not erase the persisted
                    # value the solver depends on
                    replicas=getattr(t, "replicas", 0)
                    or (getattr(prev, "replicas", 0) if prev else 0))
                txn.set(key, serde.dumps(stamped))
                any_write = True
            if not skipped:
                # node-generation records ride ONLY when every guarded chain
                # landed: persisting a restarted node's generation without
                # its demotions would lose restart detection on a failover
                for n in nodes or ():
                    await self._merge_node_write(txn, n, admin=False)
                    any_write = True
            if any_write:
                raw = await txn.get(KeyPrefix.ROUTING_VER.key())
                txn.set(KeyPrefix.ROUTING_VER.key(),
                        str(int(raw or 1) + 1).encode())
            return any_write
        bumped = await with_transaction(self.kv, txn_fn)
        await self.load_routing()
        if bumped:
            # attribute the changed chains to (at least) the version the
            # reload observed — attributing too high is safe (a caller at
            # that version already holds the change), and a racing writer
            # colliding on the same version merges via _log_change
            self._log_change(self._routing_cache.version, written)
        return written

    def node_alive(self, node_id: int) -> bool:
        now = time.time()
        hb = self.last_heartbeat.get(node_id)
        if hb is None:
            return now - self.started_at < self.cfg.heartbeat_timeout_s
        return now - hb < self.cfg.heartbeat_timeout_s

    def node_serviceable(self, node_id: int) -> bool:
        """Alive AND not administratively disabled: the chains updater
        drains a DISABLED node's targets exactly like a dead node's
        (reference disableNode semantics, MgmtdServiceDef.h:10)."""
        if not self.node_alive(node_id):
            return False
        n = self.routing().nodes.get(node_id)
        return n is None or n.status != NodeStatusEnum.DISABLED


def next_chain_state(chain: ChainInfo,
                     alive: dict[int, bool],
                     local: dict[int, LocalTargetState],
                     restarted: set[int] = frozenset(),
                     fresh: set[int] = frozenset()) -> ChainInfo | None:
    """One step of the chain state machine (generateNewChain analog,
    mgmtd/service/updateChain.h:38; table at docs/design_notes.md:201-231).
    Returns a NEW ChainInfo with bumped version if anything changed."""
    targets = [ChainTargetInfo(t.target_id, t.node_id, t.public_state)
               for t in chain.targets]
    changed = False
    serving_count = sum(1 for t in targets
                        if t.public_state == PublicTargetState.SERVING)
    # survivors a restarted member can be demoted onto: serving, alive,
    # disk intact, and not themselves freshly restarted — demoting onto a
    # dead/dying/restarted "survivor" would leave the chain with no
    # authoritative copy.  Counting a local-OFFLINE (disk-dead) member as
    # healthy let one tick demote EVERY member at once, after which a
    # replaced-EMPTY disk cold-start-seeded the chain and resync erased
    # the real data from everyone (wide craq_sim sweep, seed 400084)
    healthy_serving = sum(
        1 for t in targets
        if t.public_state == PublicTargetState.SERVING
        and alive.get(t.node_id, False) and t.target_id not in restarted
        and local.get(t.target_id, LocalTargetState.INVALID)
        != LocalTargetState.OFFLINE)
    # if EVERY live serving member restarted (e.g. rack power blip), one of
    # them must stay as the survivor the others resync from — exempting the
    # head keeps the chain available; the rest still get demoted so replica
    # divergence from the restarts is repaired
    survivor_exempt: int | None = None
    if healthy_serving == 0:
        for t in targets:
            if t.public_state == PublicTargetState.SERVING \
                    and alive.get(t.node_id, False) \
                    and t.target_id in restarted \
                    and local.get(t.target_id, LocalTargetState.INVALID) \
                    != LocalTargetState.OFFLINE:
                # a disk-dead member cannot be the survivor the others
                # resync from — exempting it wastes the exemption and can
                # end the tick with zero serving and no LASTSRV
                survivor_exempt = t.target_id
                break
    # a LASTSRV target holds the only authoritative copy: while one exists,
    # a returning stale target must NOT be seated as serving (write loss)
    has_lastsrv = any(t.public_state == PublicTargetState.LASTSRV
                      for t in targets)
    # an alive, disk-ok SYNCING member (pass-start view): gates fresh
    # rejoiners out of the cold-start seed so real data wins the chain
    has_live_syncing = any(
        t.public_state == PublicTargetState.SYNCING
        and alive.get(t.node_id, False)
        and local.get(t.target_id, LocalTargetState.INVALID)
        != LocalTargetState.OFFLINE
        for t in targets)
    new_lastsrv = False                 # minted during THIS pass
    for t in targets:
        a = alive.get(t.node_id, False)
        ls = local.get(t.target_id, LocalTargetState.INVALID)
        if t.public_state == PublicTargetState.SERVING and a \
                and t.target_id in restarted \
                and (healthy_serving >= 1 or t.target_id != survivor_exempt):
            # node restarted within the heartbeat window: its data may be
            # stale/lost while it still looks alive — demote to SYNCING so
            # resync re-validates it (sole survivor keeps serving: its copy,
            # whatever remains of it, is the best the chain has)
            t.public_state = PublicTargetState.SYNCING
            serving_count -= 1
            changed = True
        elif t.public_state == PublicTargetState.SERVING \
                and (not a or ls == LocalTargetState.OFFLINE):
            # node dead OR the node itself reports the target's disk failed
            # (CheckWorker/write-error -> heartbeat local OFFLINE, reference
            # StorageOperator.cc:604-606); last serving target holds the
            # authoritative copy: LASTSRV
            if serving_count == 1:
                t.public_state = PublicTargetState.LASTSRV
                # visible to LATER targets in this same pass: without this,
                # an empty just-replaced disk processed after the demotion
                # cold-start-seeded itself as the authority and resync then
                # erased every real copy (wide craq_sim sweep, seed 400908)
                has_lastsrv = True
                new_lastsrv = True
            else:
                t.public_state = PublicTargetState.OFFLINE
            serving_count -= 1
            changed = True
        elif t.public_state == PublicTargetState.SYNCING \
                and (not a or ls == LocalTargetState.OFFLINE):
            t.public_state = PublicTargetState.OFFLINE
            changed = True
        elif t.public_state == PublicTargetState.LASTSRV and a \
                and t.target_id in fresh:
            # the lastsrv came back on a VIRGIN disk (heartbeat fresh
            # flag: wiped/replaced since it held the authority) — it has
            # nothing to serve, and reseating it would make resync ERASE
            # every surviving copy (mega-sweep seed 2802880: a wiped
            # 2-replica lastsrv reseated and removed the syncing
            # member's committed write).  Its lineage is gone: demote;
            # the orphan-promotion below seats the best remaining copy.
            t.public_state = PublicTargetState.OFFLINE
            has_lastsrv = False
            changed = True
        elif t.public_state == PublicTargetState.LASTSRV and a \
                and ls != LocalTargetState.OFFLINE:
            if serving_count > 0 or new_lastsrv:
                # SUPERSEDED lastsrv: while it was down the chain found
                # another authority (an UPTODATE syncing member promoted,
                # or a newer LASTSRV was minted this very pass), so its
                # copy is no longer the lineage — and after a restart it
                # may be wiped entirely.  Reseating it as SERVING forked
                # the authority and the next resync propagated its EMPTY
                # disk to the whole chain (hard-matrix craq sweep, seed
                # 990583: crash+wipe+disk-fail combined — acked-write
                # loss).  Rejoin as SYNCING and resync from the living
                # authority instead.
                t.public_state = PublicTargetState.SYNCING
                # THIS target stops being lastsrv, but one minted earlier
                # in the same pass still holds the authority: clearing
                # the flag here let a later empty rejoiner cold-start
                # seed as SERVING past it
                has_lastsrv = new_lastsrv
            else:
                t.public_state = PublicTargetState.SERVING
                serving_count += 1
                has_lastsrv = False
            changed = True
        elif t.public_state == PublicTargetState.LASTSRV \
                and (not a or ls == LocalTargetState.OFFLINE) \
                and (serving_count > 0 or new_lastsrv):
            # the lastsrv died/lost its disk AFTER other members resynced
            # back to SERVING: its copy is no longer unique, so it must
            # demote like any failed member — otherwise it stays LASTSRV
            # forever, can never be disk-replaced (the operator gate only
            # swaps OFFLINE/WAITING targets), and wedges the chain at
            # less-than-full strength (wide craq_sim sweep, seed 400014).
            # Also fires when a NEWER lastsrv was minted this pass — two
            # coexisting LASTSRVs would both reseat as SERVING on return
            # with no resync between them (review-found divergence)
            t.public_state = PublicTargetState.OFFLINE
            has_lastsrv = False
            changed = True
        elif t.public_state in (PublicTargetState.OFFLINE, PublicTargetState.WAITING) \
                and a and ls in (LocalTargetState.ONLINE, LocalTargetState.UPTODATE):
            if serving_count > 0:
                t.public_state = PublicTargetState.SYNCING   # rejoin at tail
                changed = True
            elif not has_lastsrv and not (
                    t.target_id in fresh and has_live_syncing):
                # true cold start (nobody ever served or everyone wiped):
                # the returning target seeds the chain.  A FRESH (virgin
                # disk) rejoiner must not seed past an alive SYNCING
                # member holding real data — the orphan promotion below
                # seats that copy instead (the seed branch was a
                # second door to the 2802880 loss)
                t.public_state = PublicTargetState.SERVING
                serving_count += 1
                changed = True
            # else: wait for the LASTSRV holder — it has the newest data
        elif t.public_state == PublicTargetState.SYNCING and a \
                and ls == LocalTargetState.UPTODATE:
            t.public_state = PublicTargetState.SERVING       # promoted to tail
            serving_count += 1
            changed = True
    # orphan promotion: zero serving members and no authoritative
    # lastsrv left (e.g. the lastsrv returned on a virgin disk), but an
    # alive disk-ok SYNCING member exists — its copy, pre-join gap and
    # all, is the BEST the chain still has; seat it so the survivors
    # resync from real data instead of an empty disk.  Prefer a
    # non-fresh member (one that completed a resync or joined with
    # data) over a fresh one.
    if serving_count == 0 and not has_lastsrv:
        candidates = [t for t in targets
                      if t.public_state == PublicTargetState.SYNCING
                      and alive.get(t.node_id, False)
                      and local.get(t.target_id, LocalTargetState.INVALID)
                      != LocalTargetState.OFFLINE]
        candidates.sort(key=lambda t: t.target_id in fresh)
        if candidates:
            candidates[0].public_state = PublicTargetState.SERVING
            serving_count += 1
            changed = True
    if not changed:
        return None
    # canonical order: serving (original order), then syncing, then the rest —
    # offline targets move to the chain tail (design_notes.md:226)
    order = {PublicTargetState.SERVING: 0, PublicTargetState.SYNCING: 1,
             PublicTargetState.LASTSRV: 2, PublicTargetState.WAITING: 3,
             PublicTargetState.OFFLINE: 4}
    targets.sort(key=lambda t: order[t.public_state])
    return ChainInfo(chain.chain_id, chain.chain_ver + 1, targets,
                     list(chain.preferred_target_order))


def rotate_last_srv(targets: list[ChainTargetInfo]) -> list[ChainTargetInfo]:
    """Operator chain surgery when the LASTSRV holder is gone for good
    (updateChain.cc:143-163): move the LASTSRV head to the tail, designate
    the next target as the new authoritative LASTSRV, everything else
    OFFLINE.  No-op unless the head is LASTSRV and the chain has >= 2."""
    if len(targets) < 2 or targets[0].public_state != PublicTargetState.LASTSRV:
        return targets
    new = [ChainTargetInfo(t.target_id, t.node_id, t.public_state)
           for t in targets[1:]]
    moved = targets[0]
    new.append(ChainTargetInfo(moved.target_id, moved.node_id,
                               PublicTargetState.OFFLINE))
    new[0].public_state = PublicTargetState.LASTSRV
    for t in new[1:]:
        t.public_state = PublicTargetState.OFFLINE
    return new


def rotate_as_preferred_order(targets: list[ChainTargetInfo],
                              preferred: list[int]) -> list[ChainTargetInfo]:
    """One step toward the operator-preferred order (updateChain.cc:106-141):
    find the first position whose current target differs from the preferred
    one; if that target is SERVING, rotate it to the tail as OFFLINE (it will
    resync back in at the tail).  Repeated invocations converge the chain to
    the preferred order one resync cycle at a time."""
    pos = {t.target_id: i for i, t in enumerate(targets)}
    for i, want in enumerate(preferred):
        if want not in pos:
            continue
        if pos[want] == i:
            continue
        cur = targets[i]
        if cur.public_state != PublicTargetState.SERVING:
            break
        new = [ChainTargetInfo(t.target_id, t.node_id, t.public_state)
               for j, t in enumerate(targets) if j != i]
        new.append(ChainTargetInfo(cur.target_id, cur.node_id,
                                   PublicTargetState.OFFLINE))
        return new
    return targets


@serde_struct
@dataclass
class ChainOpReq:
    chain_id: int = 0
    target_id: int = 0           # update_chain only
    node_id: int = 0             # update_chain ADD only
    mode: str = ""               # update_chain: "add" | "remove"
    order: list[int] = field(default_factory=list)  # set_preferred_target_order


@serde_struct
@dataclass
class ChainRsp:
    chain: ChainInfo | None = None


@serde_struct
@dataclass
class TargetInfoBlob:
    """Persisted per-target local states (MgmtdTargetInfoPersister analog):
    a restarted/failed-over mgmtd reloads the last known target info instead
    of starting blind until heartbeats repopulate it."""
    states: dict[int, LocalTargetState] = field(default_factory=dict)


@serde_struct
@dataclass
class ClientSessionReq:
    session: ClientSession | None = None


@serde_struct
@dataclass
class ListClientSessionsRsp:
    sessions: list[ClientSession] = field(default_factory=list)


@serde_struct
@dataclass
class NodeOpReq:
    """enableNode/disableNode/unregisterNode/setNodeTags carrier."""
    node_id: int = 0
    tags: list[str] = field(default_factory=list)


@serde_struct
@dataclass
class NodeRsp:
    node: NodeInfo | None = None


@serde_struct
@dataclass
class GetClientSessionReq:
    client_id: str = ""


@serde_struct
@dataclass
class GetClientSessionRsp:
    session: ClientSession | None = None
    found: bool = False


@serde_struct
@dataclass
class UniversalTagsReq:
    tags: list[str] = field(default_factory=list)


@serde_struct
@dataclass
class UniversalTagsRsp:
    tags: list[str] = field(default_factory=list)


@serde_struct
@dataclass
class ConfigVersionsRsp:
    """Per-node-type template fingerprints (crc32c of the TOML): the
    reference's getConfigVersions surface with content hashes as the
    version — equal hash == identical distributed config."""
    versions: dict[str, int] = field(default_factory=dict)


@serde_struct
@dataclass
class OrphanTarget:
    target_id: int = 0
    node_id: int = 0                 # reporter (0 if unknown)
    local_state: LocalTargetState = LocalTargetState.OFFLINE


@serde_struct
@dataclass
class ListOrphanTargetsRsp:
    targets: list[OrphanTarget] = field(default_factory=list)


@serde_struct
@dataclass
class RepairStatus:
    """One scrub scheduler's health report (`admin repair-status` row).

    Scrub runs cluster-side (storage/scrub_scheduler.py), so its health
    reaches mgmtd by PUSH: the scheduler's owner posts status() after
    each tick via report_repair_status; mgmtd keeps the latest row per
    source in memory (liveness-style — re-learned after a restart, same
    contract as last_heartbeat).  Append-only for serde compat."""
    source: str = ""
    ts: float = 0.0                 # mgmtd receive time (server-stamped)
    repair_mode: str = ""
    budget_mbps: float = 0.0
    targets: int = 0
    ticks: int = 0
    stripes_scanned: int = 0
    shards_probed: int = 0
    shards_lost: int = 0
    shards_corrupt: int = 0
    flagged_enqueued: int = 0
    flagged_unresolved: int = 0
    flagged_pending: int = 0
    repaired_stripes: int = 0
    repaired_shards: int = 0
    stripes_failed: int = 0
    bytes_read: int = 0
    bytes_repaired: int = 0
    reduced_shards: int = 0
    fallback_shards: int = 0
    paced_waits: int = 0
    paced_wait_s: float = 0.0

    @classmethod
    def from_status(cls, source: str, status: dict) -> "RepairStatus":
        """Build a row from ScrubScheduler.status(); unknown keys are
        dropped so scheduler and mgmtd can rev independently."""
        row = cls(source=source)
        for k, v in status.items():
            if k not in ("source", "ts") and hasattr(row, k):
                setattr(row, k, v)
        return row


@serde_struct
@dataclass
class ReportRepairStatusReq:
    status: RepairStatus = field(default_factory=RepairStatus)


@serde_struct
@dataclass
class RepairStatusRsp:
    rows: list[RepairStatus] = field(default_factory=list)


@service("Mgmtd")
class MgmtdService:
    """RPC surface (fbs/mgmtd/MgmtdServiceDef.h:3-26 subset)."""

    def __init__(self, state: MgmtdState):
        self.state = state

    async def _require_primary(self):
        if not await self.state.is_primary():
            raise make_error(StatusCode.MGMTD_NOT_PRIMARY,
                             f"mgmtd {self.state.node_id} lost the lease")

    @rpc_method
    async def heartbeat(self, req: HeartbeatReq, payload, conn):
        await self._require_primary()
        st = self.state
        known = st.routing().nodes.get(req.node.node_id)
        if known is not None and known.node_type != req.node.node_type:
            # node ids are cluster-global: a meta server configured with a
            # storage node's id would otherwise flip the record's generation
            # every other heartbeat and demote that node's targets forever
            raise make_error(
                StatusCode.INVALID_ARG,
                f"node id {req.node.node_id} already registered as "
                f"{known.node_type!r}, refusing {req.node.node_type!r}")
        st.last_heartbeat[req.node.node_id] = time.time()
        # generation is PERSISTED with the node record, so restart
        # detection survives an mgmtd restart/failover coinciding with
        # the storage node's restart
        prev_gen = known.generation if known is not None else None
        restarted = (req.node.generation and prev_gen
                     and prev_gen != req.node.generation)
        # status + tags are MGMTD-owned fields: a node's self-report must
        # never stomp an admin disable-node or set-node-tags (the node
        # always reports defaults for them)
        reported = req.node
        if known is not None:
            reported = NodeInfo(**{**req.node.__dict__})
            reported.status = known.status
            reported.tags = list(known.tags)
        if restarted:
            # fast restart (within the heartbeat window): every target
            # this node serves must fall back to SYNCING and resync.
            # The new generation is NOT persisted here — the chains
            # updater saves it atomically with the demotions, so a
            # primary failover can't observe the generation without them.
            for chain in st.routing().chains.values():
                for t in chain.targets:
                    if t.node_id == req.node.node_id:
                        st.restarted_targets.add(t.target_id)
            st.pending_node_saves[req.node.node_id] = reported
        for tid, ls in req.target_states.items():
            st.local_states[int(tid)] = LocalTargetState(ls)
            st.target_reporter[int(tid)] = req.node.node_id
            st.fresh_targets.discard(int(tid))
        st.fresh_targets.update(int(t) for t in req.fresh_targets)
        if not restarted and (known is None
                              or known.address != req.node.address
                              or known.generation != req.node.generation):
            await st.save_node(reported)
            await st.load_routing()
        return HeartbeatRsp(routing_version=st.routing().version,
                            lease_s=st.cfg.heartbeat_timeout_s), b""

    @rpc_method
    async def get_routing_info(self, req: GetRoutingInfoReq, payload, conn):
        info = self.state.routing()
        rsp = GetRoutingInfoRsp()
        if req.known_version < info.version:
            # delta-capable callers get only the changed chains
            # when the change log covers their version; everyone else
            # (and any log gap) gets the full map
            delta = self.state.build_delta(req.known_version) \
                if getattr(req, "want_delta", False) else None
            if delta is not None:
                rsp.delta = delta
            else:
                rsp.info = info
        # scorecard piggyback rides even when routing is unchanged —
        # health moves on its own clock (the monitor pull period)
        st = self.state
        if st.health is not None \
                and req.known_health_version < st.health_version:
            rsp.health = st.health
            rsp.health_version = st.health_version
        return rsp, b""

    @rpc_method
    async def cluster_health(self, req: ClusterHealthReq, payload, conn):
        """Admin op: the scorecard the primary last pulled from the
        monitor (what GetRoutingInfoRsp piggybacks)."""
        return ClusterHealthRsp(health=self.state.health,
                                health_version=self.state.health_version), b""

    @rpc_method
    async def set_chains(self, req: SetChainsReq, payload, conn):
        """Admin op: install chains/chain tables (UploadChainTable analog)."""
        await self._require_primary()
        await self.state.save_chains(req.chains, req.tables,
                                     guard_versions=False)
        return OkRsp(), b""

    @rpc_method
    async def list_nodes(self, req, payload, conn):
        """Admin op (ListNodes analog): registered nodes + liveness."""
        st = self.state
        now = time.time()
        rows = []
        for node in st.routing().nodes.values():
            hb = st.last_heartbeat.get(node.node_id, 0.0)
            rows.append(NodeStatus(
                node=node, last_heartbeat_age_s=(now - hb) if hb else -1.0,
                alive=st.node_alive(node.node_id)))
        return ListNodesRsp(rows), b""

    @rpc_method
    async def get_lease(self, req, payload, conn):
        """Who is primary (MgmtdLeaseInfo analog)."""
        lease = await self.state.lease_info()
        return lease, b""

    @rpc_method
    async def report_repair_status(self, req: ReportRepairStatusReq,
                                   payload, conn):
        """Scrub scheduler health push: keep the latest row
        per source; ts is server-stamped so skewed client clocks can't
        make a live scrubber look stale."""
        await self._require_primary()
        row = req.status
        row.source = row.source or "scrub"
        row.ts = time.time()
        self.state.repair_statuses[row.source] = row
        return OkRsp(), b""

    @rpc_method
    async def repair_status(self, req, payload, conn):
        """Admin op: latest scrub/repair health rows, one per source."""
        rows = sorted(self.state.repair_statuses.values(),
                      key=lambda r: r.source)
        return RepairStatusRsp(rows=rows), b""

    # ---- chain surgery (admin ops) ----

    async def _load_chain(self, chain_id: int) -> ChainInfo:
        chain = self.state.routing().chain(chain_id)
        if chain is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND, f"chain {chain_id}")
        return chain

    async def _save_chain_checked(self, chain: ChainInfo) -> None:
        """CAS-persist one admin-modified chain; a lost race with the
        background chains updater surfaces as a retryable conflict instead
        of the op silently being reverted."""
        written = await self.state.save_chains([chain])
        if chain.chain_id not in written:
            raise make_error(
                StatusCode.CHAIN_VERSION_MISMATCH,
                f"chain {chain.chain_id} changed concurrently; retry")

    @rpc_method
    async def rotate_last_srv(self, req: ChainOpReq, payload, conn):
        """RotateLastSrvOperation analog (mgmtd/ops/RotateLastSrvOperation.cc)."""
        await self._require_primary()
        chain = await self._load_chain(req.chain_id)
        new_targets = rotate_last_srv(chain.targets)
        if new_targets is chain.targets:
            return ChainRsp(chain=chain), b""
        nxt = ChainInfo(chain.chain_id, chain.chain_ver + 1, new_targets,
                        chain.preferred_target_order)
        await self._save_chain_checked(nxt)
        return ChainRsp(chain=nxt), b""

    @rpc_method
    async def update_chain(self, req: ChainOpReq, payload, conn):
        """Add/remove a target (UpdateChainOperation.cc): add appends as
        OFFLINE (it joins via resync); remove requires the target OFFLINE."""
        await self._require_primary()
        chain = await self._load_chain(req.chain_id)
        if not req.target_id:
            raise make_error(StatusCode.INVALID_ARG, "empty target id")
        targets = [ChainTargetInfo(t.target_id, t.node_id, t.public_state)
                   for t in chain.targets]
        preferred = list(chain.preferred_target_order)
        if req.mode == "add":
            for c in self.state.routing().chains.values():
                if any(t.target_id == req.target_id for t in c.targets):
                    raise make_error(StatusCode.INVALID_ARG,
                                     f"target {req.target_id} already in chain "
                                     f"{c.chain_id}")
            targets.append(ChainTargetInfo(req.target_id, req.node_id,
                                           PublicTargetState.OFFLINE))
            if len(preferred) == len(targets) - 1:
                preferred.append(req.target_id)
        elif req.mode == "remove":
            hit = [t for t in targets if t.target_id == req.target_id]
            if not hit:
                raise make_error(StatusCode.TARGET_NOT_FOUND,
                                 f"target {req.target_id} not in chain")
            if hit[0].public_state != PublicTargetState.OFFLINE:
                raise make_error(
                    StatusCode.INVALID_ARG,
                    f"target {req.target_id} is {hit[0].public_state.name}, "
                    "only OFFLINE targets can be removed")
            targets = [t for t in targets if t.target_id != req.target_id]
            preferred = [t for t in preferred if t != req.target_id]
        else:
            raise make_error(StatusCode.INVALID_ARG, f"mode {req.mode!r}")
        nxt = ChainInfo(chain.chain_id, chain.chain_ver + 1, targets, preferred)
        await self._save_chain_checked(nxt)
        return ChainRsp(chain=nxt), b""

    @rpc_method
    async def set_preferred_target_order(self, req: ChainOpReq, payload, conn):
        """SetPreferredTargetOrderOperation analog: record the operator's
        desired order; rotate_as_preferred_order walks the chain toward it."""
        await self._require_primary()
        chain = await self._load_chain(req.chain_id)
        have = {t.target_id for t in chain.targets}
        if set(req.order) != have:
            raise make_error(StatusCode.INVALID_ARG,
                             f"order {req.order} != chain targets {sorted(have)}")
        nxt = ChainInfo(chain.chain_id, chain.chain_ver + 1,
                        chain.targets, list(req.order))
        await self._save_chain_checked(nxt)
        return ChainRsp(chain=nxt), b""

    @rpc_method
    async def rotate_as_preferred_order(self, req: ChainOpReq, payload, conn):
        """One rotation step toward the preferred order
        (RotateAsPreferredOrderOperation.cc analog)."""
        await self._require_primary()
        chain = await self._load_chain(req.chain_id)
        if not chain.preferred_target_order:
            return ChainRsp(chain=chain), b""
        new_targets = rotate_as_preferred_order(
            chain.targets, chain.preferred_target_order)
        if new_targets is chain.targets:
            return ChainRsp(chain=chain), b""
        nxt = ChainInfo(chain.chain_id, chain.chain_ver + 1, new_targets,
                        chain.preferred_target_order)
        await self._save_chain_checked(nxt)
        return ChainRsp(chain=nxt), b""

    # ---- client sessions ----

    @rpc_method
    async def extend_client_session(self, req: ClientSessionReq, payload, conn):
        """Register/extend a client session (ExtendClientSessionOperation
        analog); sessions are persisted so a mgmtd failover keeps them."""
        await self._require_primary()
        s = req.session
        if s is None or not s.client_id:
            raise make_error(StatusCode.INVALID_ARG, "empty session")
        now = time.time()
        s.last_extend = now

        async def op(txn):
            key = KeyPrefix.CLIENT_SESSION.key(s.client_id.encode())
            raw = await txn.get(key)
            if raw is not None:
                prev: ClientSession = serde.loads(raw)
                s.start = prev.start or now
            else:
                s.start = s.start or now
            txn.set(key, serde.dumps(s))
        await with_transaction(self.state.kv, op)
        return OkRsp(), b""

    @rpc_method
    async def list_client_sessions(self, req, payload, conn):
        async def op(txn):
            return await txn.get_range(
                KeyPrefix.CLIENT_SESSION.value,
                KeyPrefix.CLIENT_SESSION.value + b"\xff", snapshot=True)
        rows = await with_transaction(self.state.kv, op)
        return ListClientSessionsRsp(
            sessions=[serde.loads(v) for _, v in rows]), b""

    # --- node admin ops (MgmtdServiceDef.h:9-16 parity) ---

    async def _node_op(self, node_id: int, mutate) -> NodeInfo:
        """In-txn read-modify-write of a node record + routing version bump.
        Reading the CURRENT record inside the transaction (not the routing
        cache) means a concurrent heartbeat's address/generation save can't
        be reverted — the admin op rebases on whatever committed last."""
        await self._require_primary()
        st = self.state
        key = KeyPrefix.NODE.key(str(node_id).encode())
        out: list[NodeInfo] = []

        async def txn_fn(txn):
            raw = await txn.get(key)
            if raw is None:
                raise make_error(StatusCode.TARGET_NOT_FOUND,
                                 f"node {node_id}")
            updated: NodeInfo = serde.loads(raw)
            mutate(updated)
            txn.set(key, serde.dumps(updated))
            ver = await txn.get(KeyPrefix.ROUTING_VER.key())
            txn.set(KeyPrefix.ROUTING_VER.key(),
                    str(int(ver or 1) + 1).encode())
            out[:] = [updated]
        await with_transaction(st.kv, txn_fn)
        await st.load_routing()
        st._log_change(st.routing().version, ())   # node-only bump
        # rebase any pending restart-save on the admin result: the updater
        # flush would otherwise re-persist the PRE-admin status/tags it
        # captured at heartbeat time (keep its generation — that's the
        # restart-detection payload it exists to deliver).  AFTER
        # load_routing: a heartbeat landing during the reload reads the
        # stale cache and re-captures the pre-admin status; rebasing last
        # covers that window too.
        pend = st.pending_node_saves.get(node_id)
        if pend is not None:
            pend.status = out[0].status
            pend.tags = list(out[0].tags)
        return out[0]

    @rpc_method
    async def enable_node(self, req: NodeOpReq, payload, conn):
        def mutate(n):
            n.status = NodeStatusEnum.ACTIVE
        return NodeRsp(node=await self._node_op(req.node_id, mutate)), b""

    @rpc_method
    async def disable_node(self, req: NodeOpReq, payload, conn):
        """Administrative drain: the chains updater treats the node's
        targets like a dead node's (they walk to chain tail), but the node
        keeps heartbeating — re-enable restores it without a restart."""
        def mutate(n):
            n.status = NodeStatusEnum.DISABLED
        return NodeRsp(node=await self._node_op(req.node_id, mutate)), b""

    @rpc_method
    async def set_node_tags(self, req: NodeOpReq, payload, conn):
        def mutate(n):
            n.tags = list(req.tags)
        return NodeRsp(node=await self._node_op(req.node_id, mutate)), b""

    @rpc_method
    async def unregister_node(self, req: NodeOpReq, payload, conn):
        """Retire a node record.  Refused while any chain still references
        the node — silently dropping a referenced node would strand its
        targets in the chain state machine."""
        await self._require_primary()
        st = self.state
        routing = st.routing()
        if routing.nodes.get(req.node_id) is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND,
                             f"node {req.node_id}")
        for chain in routing.chains.values():
            if any(t.node_id == req.node_id for t in chain.targets):
                raise make_error(
                    StatusCode.INVALID_ARG,
                    f"node {req.node_id} still on chain {chain.chain_id}; "
                    f"update-chain it away first")
        if st.last_heartbeat.get(req.node_id) is not None \
                and st.node_alive(req.node_id):
            # a live node would simply re-register on its next heartbeat,
            # silently undoing this op seconds later
            raise make_error(
                StatusCode.INVALID_ARG,
                f"node {req.node_id} is still heartbeating; stop it (or "
                f"disable-node) first")

        async def op(txn):
            txn.clear(KeyPrefix.NODE.key(str(req.node_id).encode()))
            raw = await txn.get(KeyPrefix.ROUTING_VER.key())
            txn.set(KeyPrefix.ROUTING_VER.key(),
                    str(int(raw or 1) + 1).encode())
        await with_transaction(st.kv, op)
        st.last_heartbeat.pop(req.node_id, None)
        # a pending restart-save would re-create the record on the next
        # updater tick
        st.pending_node_saves.pop(req.node_id, None)
        # reap the retired node's reported-target bookkeeping, or its
        # targets linger in list_orphan_targets forever
        for tid in [t for t, n in st.target_reporter.items()
                    if n == req.node_id]:
            st.target_reporter.pop(tid, None)
            st.local_states.pop(tid, None)
        await st.load_routing()
        st._log_change(st.routing().version, ())   # node-only bump
        return OkRsp(), b""

    @rpc_method
    async def get_client_session(self, req: GetClientSessionReq, payload,
                                 conn):
        async def op(txn):
            return await txn.get(
                KeyPrefix.CLIENT_SESSION.key(req.client_id.encode()),
                snapshot=True)
        raw = await with_transaction(self.state.kv, op)
        return GetClientSessionRsp(
            session=serde.loads(raw) if raw is not None else None,
            found=raw is not None), b""

    @rpc_method
    async def set_universal_tags(self, req: UniversalTagsReq, payload, conn):
        await self._require_primary()

        async def op(txn):
            txn.set(KeyPrefix.UNIVERSAL_TAGS.key(),
                    serde.dumps(list(req.tags)))
        await with_transaction(self.state.kv, op)
        return OkRsp(), b""

    @rpc_method
    async def get_universal_tags(self, req, payload, conn):
        async def op(txn):
            return await txn.get(KeyPrefix.UNIVERSAL_TAGS.key(),
                                 snapshot=True)
        raw = await with_transaction(self.state.kv, op)
        return UniversalTagsRsp(
            tags=serde.loads(raw) if raw is not None else []), b""

    @rpc_method
    async def get_config_versions(self, req, payload, conn):
        from t3fs_torch.ops.codec import crc32c

        async def op(txn):
            return await txn.get_range(KeyPrefix.CONFIG.value,
                                       KeyPrefix.CONFIG.value + b"\xff",
                                       snapshot=True)
        rows = await with_transaction(self.state.kv, op)
        plen = len(KeyPrefix.CONFIG.value)
        return ConfigVersionsRsp(versions={
            k[plen:].decode(): crc32c(v) for k, v in rows}), b""

    @rpc_method
    async def list_orphan_targets(self, req, payload, conn):
        """Targets reported in heartbeats that no chain references
        (ListOrphanTargetsOperation analog) — leftovers of chain surgery /
        aborted migrations an operator should reap."""
        st = self.state
        chained = {t.target_id
                   for c in st.routing().chains.values()
                   for t in c.targets}
        out = [OrphanTarget(target_id=tid,
                            node_id=st.target_reporter.get(tid, 0),
                            local_state=ls)
               for tid, ls in sorted(st.local_states.items())
               if tid not in chained]
        return ListOrphanTargetsRsp(targets=out), b""

    @rpc_method
    async def set_config_template(self, req: SetConfigTemplateReq, payload, conn):
        """Store a per-node-type config template in the KV — the config-
        distribution half of the two-phase bootstrap (reference:
        TwoPhaseApplication.h:42-46, core/app/MgmtdClientFetcher.h)."""
        await self._require_primary()

        async def op(txn):
            txn.set(KeyPrefix.CONFIG.key(req.node_type.encode()),
                    req.toml.encode())
        await with_transaction(self.state.kv, op)
        return OkRsp(), b""

    @rpc_method
    async def get_config_template(self, req: GetConfigTemplateReq, payload, conn):
        async def op(txn):
            return await txn.get(KeyPrefix.CONFIG.key(req.node_type.encode()))
        raw = await with_transaction(self.state.kv, op)
        return GetConfigTemplateRsp(
            toml=raw.decode() if raw is not None else "",
            found=raw is not None), b""


class MgmtdServer:
    """State + service + background loops (chains updater, lease extender,
    sessions checker)."""

    def __init__(self, kv: KVEngine, node_id: int = 1, address: str = "",
                 cfg: MgmtdConfig | None = None, admin_token: str = ""):
        self.cfg = cfg or MgmtdConfig()
        self.state = MgmtdState(kv, node_id, address, self.cfg)
        self.service = MgmtdService(self.state)
        from t3fs_torch.core.service import AppInfo, CoreService
        self.core = CoreService(AppInfo(node_id, "mgmtd", address),
                                config=self.cfg, kv=kv, admin_token=admin_token)
        self._tasks: list[asyncio.Task] = []
        self._stopped = asyncio.Event()

    @property
    def services(self):
        """Everything to register on the net server (reference registers
        MgmtdService + CoreService, MgmtdServer.cc:33-34)."""
        return [self.service, self.core]

    async def start(self) -> None:
        if self.cfg.monitor_address:
            # the reference's health puller needs the monitor service,
            # which is not ported: refuse rather than run without it
            raise NotImplementedError(
                "MgmtdConfig.monitor_address is set, but the health puller "
                "needs t3fs_torch.monitor.service, which is not ported yet")
        acquired = await self.state.try_acquire_lease()
        if acquired:
            log.info("mgmtd %d acquired primary lease", self.state.node_id)
        await self.state.load_routing()
        self._tasks = [
            asyncio.create_task(self._chains_updater(), name="mgmtd-chains"),
            asyncio.create_task(self._lease_extender(), name="mgmtd-lease"),
            asyncio.create_task(self._sessions_checker(),
                                name="mgmtd-sessions"),
        ]

    async def stop(self) -> None:
        self._stopped.set()
        for t in self._tasks:
            t.cancel()
        for t in self._tasks:
            await reap_task(t, log, t.get_name())

    async def _lease_extender(self) -> None:
        while not self._stopped.is_set():
            await asyncio.sleep(self.cfg.lease_extend_period_s)
            try:
                await self.state.try_acquire_lease()
            except Exception:
                log.exception("lease extension failed")

    async def _chains_updater(self) -> None:
        """Primary-only periodic scan applying the chain state machine
        (MgmtdChainsUpdater.cc:72 analog)."""
        while not self._stopped.is_set():
            await asyncio.sleep(self.cfg.chains_update_period_s)
            try:
                if not await self.state.is_primary():
                    continue
                await self.update_chains_once()
            except Exception:
                log.exception("chains updater failed")

    async def _sessions_checker(self) -> None:
        """Prune client sessions whose lease expired
        (MgmtdClientSessionsChecker analog)."""
        while not self._stopped.is_set():
            await asyncio.sleep(self.cfg.sessions_check_period_s)
            try:
                if not await self.state.is_primary():
                    continue
                await self.prune_client_sessions_once()
            except Exception:
                log.exception("sessions checker failed")

    async def prune_client_sessions_once(self) -> int:
        """Remove expired sessions; returns count pruned (test hook)."""
        cutoff = time.time() - self.cfg.client_session_ttl_s
        kv = self.state.kv

        async def op(txn):
            rows = await txn.get_range(
                KeyPrefix.CLIENT_SESSION.value,
                KeyPrefix.CLIENT_SESSION.value + b"\xff")
            dead = []
            for k, v in rows:
                s: ClientSession = serde.loads(v)
                if s.last_extend < cutoff:
                    txn.clear(k)
                    dead.append(s.client_id)
            return dead
        dead = await with_transaction(kv, op)
        if dead:
            log.info("pruned %d expired client sessions: %s",
                     len(dead), dead[:8])
        return len(dead)

    async def update_chains_once(self) -> int:
        """One updater tick; returns number of chains changed (test hook).

        Recomputes and retries when a CAS-guarded save loses a race with an
        admin chain op (save_chains skips chains whose persisted version
        moved; node generations only ride on a fully-clean save)."""
        st = self.state
        for _ in range(3):
            routing = st.routing()
            updated = []
            handled: set[int] = set()
            for chain in routing.chains.values():
                alive = {t.node_id: st.node_serviceable(t.node_id)
                         for t in chain.targets}
                nxt = next_chain_state(chain, alive, st.local_states,
                                       restarted=st.restarted_targets,
                                       fresh=st.fresh_targets)
                handled |= {t.target_id for t in chain.targets} \
                    & st.restarted_targets
                if nxt is not None:
                    updated.append(nxt)
                    log.info("chain %d v%d -> v%d: %s", nxt.chain_id,
                             chain.chain_ver, nxt.chain_ver,
                             [(t.target_id, t.public_state.name)
                              for t in nxt.targets])
            pending_nodes = list(st.pending_node_saves.values())
            # liveness -> NodeStatus for non-storage nodes (meta servers):
            # the Distributor must stop hashing duties onto dead/retired
            # peers, and storage liveness is already expressed via chains
            from t3fs_torch.mgmtd.types import NodeStatus as _NS
            for n in routing.nodes.values():
                if n.node_type == "storage":
                    continue
                if n.status == _NS.DISABLED:
                    continue  # admin disable is sticky; liveness can't flip it
                want = _NS.ACTIVE if st.node_alive(n.node_id) else _NS.FAILED
                if n.status != want \
                        and n.node_id not in st.pending_node_saves:
                    flipped = NodeInfo(**{**n.__dict__})
                    flipped.status = want
                    pending_nodes.append(flipped)
            if updated or pending_nodes:
                # demotions and the new node generations land in ONE txn
                written = await st.save_chains(updated, nodes=pending_nodes)
                if len(written) < len(updated):
                    continue  # admin op won the race: recompute from fresh
            # only forget restart flags once the demotions are durably
            # saved — dropping them before a failed save would leave a
            # stale node serving forever
            st.restarted_targets -= handled
            for n in pending_nodes:
                st.pending_node_saves.pop(n.node_id, None)
            if st.local_states != st._persisted_states:
                # target-info persistence (MgmtdTargetInfoPersister analog)
                await st.persist_target_info()
            return len(updated)
        return 0
