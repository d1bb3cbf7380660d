"""Online rebalancer: drives routing toward the solver's chain table.

Reference analog: the reference re-runs deploy/data_placement offline on
membership change and operators apply the new table by hand.  t3fs closes
the loop: a background planner periodically re-solves every chain table
against the CURRENT healthy node set (t3fs_torch/mgmtd/chain_table.py — HRW, so
the target moves minimally), diffs it against live routing, and executes
the difference as MigrationService jobs (CREATE/JOIN/WAIT/DRAIN/DETACH
chain surgery, each step re-derived from fresh routing).

Safety/pacing:

* moves are throttled by a byte token bucket (``rebalance_budget_mbps``,
  TokenBucketPacer semantics: waits are backpressure, never errors) and a
  max-in-flight cap, so rebalance traffic cannot starve foreground IO;
* the HealthScorecard gates execution: moves ONTO a straggler
  or gone-stale destination are deferred (a node with no scorecard entry
  — e.g. just added — is allowed: absence of history is not sickness),
  and moves whose resync SOURCE (the chain head) is a straggler are
  submitted last, so healthy sources drain first;
* a destination that flaps mid-sync fails its job *resumable*; a later
  plan tick resumes it only if the node is back, healthy, AND the move
  is still compatible with the fresh solve (dst a wanted owner of the
  chain, src not) — otherwise the planner has re-solved (e.g. to a
  different destination) and the stale job stays failed rather than
  executing a move the plan already moved past; over-wide chains such a
  stale job leaves behind (JOIN applied, DETACH never ran) are walked
  back to R by diff_table's shrink moves;
* chains with an in-flight job are excluded from the diff and from
  submission (one surgeon per chain per tick): mid-surgery a chain is
  transiently R+1 wide, and planning against that inflated membership
  would schedule duplicate moves;
* the drain-last-healthy-replica refusal lives in MigrationService, one
  layer down, so no planner bug can walk a chain to zero live copies.

The planner is convergent, not transactional: every tick re-derives the
full want-vs-have diff, and submit is idempotent on (chain, src, dst),
so a crashed/restarted rebalancer (or two ticks racing a slow cluster)
converges on the same end state without double-moving anything.

The port of t3fs/migration/rebalancer.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

from t3fs_torch.client.repair import TokenBucketPacer
from t3fs_torch.migration.service import (
    ACTIVE_STATES, JobState, MigrationService, SubmitMigrationReq,
)
from t3fs_torch.mgmtd.chain_table import diff_table, solve_for_routing
from t3fs_torch.mgmtd.types import NodeStatus as NodeStatusEnum
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusError

log = logging.getLogger("t3fs_torch.rebalancer")


@serde_struct
@dataclass
class RebalanceMove:
    """One planned chain move and where it is in its life."""
    table_id: int = 0
    chain_id: int = 0
    src_target_id: int = 0
    src_node_id: int = 0
    dst_target_id: int = 0
    dst_node_id: int = 0
    # planned | deferred | queued | submitted | done | failed
    state: str = "planned"
    reason: str = ""          # why deferred/failed
    job_id: int = 0
    bytes_est: int = 0


@serde_struct
@dataclass
class RebalanceStatusReq:
    pass


@serde_struct
@dataclass
class RebalanceStatusRsp:
    enabled: bool = False
    budget_mbps: float = 0.0
    ticks: int = 0
    planned: int = 0          # want-vs-have gap as of the last tick
    submitted: int = 0        # moves with an in-flight migration job
    deferred: int = 0         # health-gated this tick
    done: int = 0
    failed: int = 0
    resumed: int = 0          # flapped jobs re-driven after recovery
    bytes_submitted: int = 0
    paced_waits: int = 0
    paced_wait_s: float = 0.0
    moves: list[RebalanceMove] = field(default_factory=list)


@serde_struct
@dataclass
class RebalanceTickReq:
    pass


@serde_struct
@dataclass
class RebalanceTickRsp:
    planned: int = 0
    submitted: int = 0
    deferred: int = 0


@service("Rebalance")
class Rebalancer:
    """Plan ticks against live routing; execution delegated to an
    in-process MigrationService (migration_main hosts both on one
    listener, LocalCluster-based tests wire them directly)."""

    MAX_MOVE_HISTORY = 512

    def __init__(self, migration: MigrationService, *,
                 budget_mbps: float = 0.0, plan_period_s: float = 2.0,
                 max_inflight: int = 2, cap_slack: int = 1,
                 health_gate: bool = True):
        self.migration = migration
        self.client = migration.client
        self.mgmtd_address = migration.mgmtd_address
        self.budget_mbps = budget_mbps
        self.plan_period_s = plan_period_s
        self.max_inflight = max_inflight
        self.cap_slack = cap_slack
        self.health_gate = health_gate
        self.pacer = TokenBucketPacer(budget_mbps)
        self.moves: dict[tuple[int, int, int], RebalanceMove] = {}
        self.ticks = 0
        self.resumed = 0
        self.bytes_submitted = 0
        self._task: asyncio.Task | None = None
        self._stopped = asyncio.Event()

    # ---- lifecycle ----

    async def start(self) -> None:
        self._task = asyncio.create_task(self._loop(), name="rebalance-plan")

    async def stop(self) -> None:
        self._stopped.set()
        if self._task:
            self._task.cancel()
            await reap_task(self._task, log, "rebalance plan loop")

    async def _loop(self) -> None:
        while not self._stopped.is_set():
            try:
                await self.tick()
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # the planner must survive a flapping mgmtd: every tick
                # re-derives everything, so skipping one is always safe
                log.warning("rebalance tick failed: %s", e)
            await asyncio.sleep(self.plan_period_s)

    # ---- cluster views (all best-effort RPCs to mgmtd) ----

    async def _routing(self):
        from t3fs_torch.mgmtd.service import GetRoutingInfoReq
        rsp, _ = await self.client.call(
            self.mgmtd_address, "Mgmtd.get_routing_info",
            GetRoutingInfoReq(known_version=0))
        return rsp.info

    DRAIN_TAG = "drain"

    async def _candidates(self) -> tuple[list, dict[int, bool]]:
        """Solver input: ACTIVE, alive storage nodes minus drain-tagged
        ones.  The ``drain`` tag is the graceful-drain signal: unlike
        disable-node (which demotes the node's targets immediately and
        would strand single-replica EC chains with no SERVING resync
        source), a drain-tagged node KEEPS serving while the solver stops
        assigning it chains — the diff becomes the drain plan, each move
        resyncs from the still-live source, and the node empties without
        an availability dip.  Disable/unregister it once it holds
        nothing."""
        rsp, _ = await self.client.call(
            self.mgmtd_address, "Mgmtd.list_nodes", None)
        alive = {row.node.node_id: row.alive for row in rsp.nodes}
        cands = [row.node for row in rsp.nodes
                 if row.node.node_type == "storage" and row.alive
                 and row.node.status == NodeStatusEnum.ACTIVE
                 and self.DRAIN_TAG not in (row.node.tags or ())]
        return cands, alive

    async def _health_by_node(self) -> dict:
        if not self.health_gate:
            return {}
        from t3fs_torch.mgmtd.service import ClusterHealthReq
        try:
            rsp, _ = await self.client.call(
                self.mgmtd_address, "Mgmtd.cluster_health",
                ClusterHealthReq(), timeout=5.0)
        except StatusError:
            return {}
        if rsp.health is None:
            return {}
        return {n.node_id: n for n in rsp.health.nodes if n.node_id}

    def _sick(self, nh) -> str:
        """Scorecard verdict for a DESTINATION.  A node with samples that
        is flagged straggler, or whose feed went stale (was reporting,
        then stopped — possibly wedged), should not receive new data yet.
        No entry / no samples = a fresh node: allowed."""
        if nh is None or not nh.count:
            return ""
        if nh.straggler:
            return "destination is a straggler"
        if nh.stale:
            return "destination health is stale"
        return ""

    # ---- the planner ----

    async def tick(self) -> RebalanceTickRsp:
        self.ticks += 1
        routing = await self._routing()
        cands, alive = await self._candidates()
        if not cands:
            return RebalanceTickRsp()
        health = await self._health_by_node()

        # reconcile prior bookkeeping with the migration job table FIRST:
        # a chain with an in-flight job is mid-surgery and transiently
        # R+1 wide (dst joined, src not yet detached) — diffing it this
        # tick would pair the same src with a second destination, so the
        # planner leaves busy chains alone until their job settles
        jobs_by_key = {}
        busy_chains: set[int] = set()
        for job in self.migration.jobs.values():
            jobs_by_key[(job.chain_id, job.src_target_id,
                         job.dst_target_id)] = job
            if job.state in ACTIVE_STATES:
                busy_chains.add(job.chain_id)
        inflight = sum(1 for j in self.migration.jobs.values()
                       if j.state in ACTIVE_STATES)

        planned: list[RebalanceMove] = []
        want_by_chain: dict[int, set[int]] = {}
        for table_id in sorted(routing.chain_tables):
            try:
                solved = solve_for_routing(routing, table_id, cands,
                                           cap_slack=self.cap_slack)
            except ValueError as e:
                # e.g. fewer healthy nodes than replicas: nothing to plan
                log.debug("table %d unsolvable this tick: %s", table_id, e)
                continue
            for cid, owners in solved.assignment.items():
                want_by_chain[cid] = set(owners)
            for m in diff_table(routing, solved):
                if m.chain_id in busy_chains:
                    continue
                planned.append(RebalanceMove(
                    table_id=table_id, chain_id=m.chain_id,
                    src_target_id=m.src_target_id,
                    src_node_id=m.src_node_id,
                    dst_target_id=m.dst_target_id,
                    dst_node_id=m.dst_node_id))

        def still_wanted(job) -> bool:
            """A flapped job is only worth re-driving if its move is
            still compatible with THIS tick's solve: the destination is
            a wanted owner of the chain and the source is not.  The key
            cannot be matched against the planned move list instead —
            a job whose JOIN already applied leaves the chain over-wide,
            and the diff for that chain is a shrink, not the original
            swap."""
            want = want_by_chain.get(job.chain_id)
            if not want or job.dst_node_id not in want:
                return False
            chain = routing.chain(job.chain_id)
            src = next((t for t in (chain.targets if chain else ())
                        if t.target_id == job.src_target_id), None)
            return src is None or src.node_id not in want

        # resume flapped jobs whose destination came back healthy AND
        # whose move this tick's solve still wants: a stale flapped job
        # (the planner re-solved to a different destination while the
        # node was gone) stays failed — re-driving it would execute a
        # move the next tick must undo
        for job in list(self.migration.jobs.values()):
            if (job.state == JobState.FAILED.value and job.resumable
                    and job.chain_id not in busy_chains
                    and still_wanted(job)
                    and alive.get(job.dst_node_id, False)
                    and not self._sick(health.get(job.dst_node_id))
                    and inflight < self.max_inflight):
                resumed = self.migration._resume_jobs(
                    only_active=False, job_id=job.job_id)
                if resumed:
                    self.resumed += len(resumed)
                    inflight += len(resumed)
                    busy_chains.add(job.chain_id)
                    log.info("rebalance: resumed flapped job %d "
                             "(chain %d -> n%d)", job.job_id,
                             job.chain_id, job.dst_node_id)

        # execute the gap, healthy resync sources first: the resync reader
        # streams from the chain head, so a straggler head both slows the
        # move and sheds load worst — do those moves last
        def head_straggler(mv: RebalanceMove) -> int:
            chain = routing.chain(mv.chain_id)
            head = chain.head() if chain else None
            nh = health.get(head.node_id) if head else None
            return 1 if (nh is not None and nh.count and nh.straggler) else 0

        submitted = deferred = 0
        seen_keys = set()
        for mv in sorted(planned, key=lambda m: (head_straggler(m),
                                                 m.table_id, m.chain_id)):
            key = (mv.chain_id, mv.src_target_id, mv.dst_target_id)
            seen_keys.add(key)
            rec = self.moves.get(key)
            if rec is None or rec.state in ("done", "failed"):
                # failed-and-still-planned: the solver still wants it
                # (e.g. destination recovered) — plan a fresh attempt
                rec = mv
                self.moves[key] = rec
            job = jobs_by_key.get(key)
            if job is not None and job.state in ACTIVE_STATES:
                rec.state, rec.job_id = "submitted", job.job_id
                continue
            if mv.chain_id in busy_chains:
                # one surgeon per chain per tick: a job resumed or
                # submitted moments ago is already reshaping this chain
                rec.state, rec.reason = "queued", "chain busy"
                continue
            why = self._sick(health.get(mv.dst_node_id))
            if why:
                rec.state, rec.reason = "deferred", why
                deferred += 1
                continue
            if inflight >= self.max_inflight:
                rec.state, rec.reason = "queued", "max_inflight"
                continue
            # pace by the source target's bytes (what resync will stream);
            # unknown sizes still pay a floor so a burst of empty-looking
            # moves cannot bypass the budget entirely
            rec.bytes_est = await self.migration._target_bytes(
                routing, mv.src_node_id, mv.src_target_id)
            await self.pacer.acquire(max(rec.bytes_est, 64 << 10))
            rsp, _ = await self.migration.submit(SubmitMigrationReq(
                chain_id=mv.chain_id, src_target_id=mv.src_target_id,
                dst_target_id=mv.dst_target_id,
                dst_node_id=mv.dst_node_id), b"", None)
            rec.state, rec.job_id, rec.reason = "submitted", rsp.job_id, ""
            self.bytes_submitted += rec.bytes_est
            submitted += 1
            inflight += 1
            busy_chains.add(mv.chain_id)
            log.info("rebalance: chain %d t%d@n%d -> t%d@n%d (job %d, "
                     "~%d bytes)", mv.chain_id, mv.src_target_id,
                     mv.src_node_id, mv.dst_target_id, mv.dst_node_id,
                     rsp.job_id, rec.bytes_est)

        # settle finished jobs; moves the solver no longer wants and that
        # have no live job are converged (done) or abandoned re-plans
        for key, rec in list(self.moves.items()):
            job = jobs_by_key.get(key)
            if job is not None and job.state == JobState.DONE.value:
                rec.state, rec.job_id = "done", job.job_id
            elif job is not None and job.state == JobState.FAILED.value \
                    and not job.resumable:
                rec.state, rec.reason = "failed", job.error
            elif (job is not None and job.state == JobState.FAILED.value
                    and not still_wanted(job)):
                # flapped job the solver no longer wants: superseded by a
                # re-plan, never resumed — settle its record as failed
                rec.state = "failed"
                rec.reason = job.error or "superseded by re-plan"
            elif key not in seen_keys and rec.state in (
                    "planned", "queued", "deferred"):
                rec.state = "done"   # routing caught up before we acted
        self._prune_moves()
        return RebalanceTickRsp(planned=len(planned), submitted=submitted,
                                deferred=deferred)

    def _prune_moves(self) -> None:
        settled = [k for k, r in self.moves.items()
                   if r.state in ("done", "failed")]
        for k in settled[: max(0, len(settled) - self.MAX_MOVE_HISTORY)]:
            self.moves.pop(k, None)

    # ---- RPC surface ----

    @rpc_method
    async def status(self, req, payload, conn):
        by_state: dict[str, int] = {}
        for r in self.moves.values():
            by_state[r.state] = by_state.get(r.state, 0) + 1
        return RebalanceStatusRsp(
            enabled=self._task is not None and not self._stopped.is_set(),
            budget_mbps=self.budget_mbps, ticks=self.ticks,
            planned=by_state.get("planned", 0) + by_state.get("queued", 0),
            submitted=by_state.get("submitted", 0),
            deferred=by_state.get("deferred", 0),
            done=by_state.get("done", 0), failed=by_state.get("failed", 0),
            resumed=self.resumed, bytes_submitted=self.bytes_submitted,
            paced_waits=self.pacer.waits, paced_wait_s=self.pacer.waited_s,
            moves=sorted(self.moves.values(),
                         key=lambda r: (r.table_id, r.chain_id))), b""

    @rpc_method
    async def trigger(self, req, payload, conn):
        """One plan tick now (admin/test hook; the loop keeps its cadence)."""
        return await self.tick(), b""
