"""Migration service: orchestrated target moves between storage nodes.

Reference analog: src/migration/ — the reference ships only a STUB binary
(migration_main, SURVEY.md §1 L6 "migration (stub)").  t3fs implements the
real capability on top of machinery that already exists: chain surgery
(Mgmtd.update_chain, UpdateChainOperation.cc analog), target provisioning
(Storage.create_target), the chain public-state machine, and resync
(full-chunk replace, ResyncWorker.cc:101-389).  A migration job is:

    1. CREATE   — provision the destination target on its node
    2. JOIN     — add it to the chain (enters OFFLINE; the chain state
                  machine walks it OFFLINE -> SYNCING -> SERVING while the
                  predecessor streams chunks via resync)
    3. WAIT     — poll routing until the new target is SERVING
    4. DRAIN    — offline the source target (local state -> heartbeat ->
                  public OFFLINE, moved to chain tail)
    5. DETACH   — remove the source target from the chain

Flap-safety: every step re-derives its progress from FRESH
routing before acting, so a restarted migration service (or an mgmtd
restart under it) re-attaches to in-flight jobs instead of double-
applying chain surgery; the WAIT step is time-bounded against a
destination node that dies or flaps mid-SYNCING (the job fails with a
*resumable* error instead of polling forever); and DRAIN refuses to
offline the chain's last healthy serving replica.  Jobs optionally
persist to a JSON store so a restarted daemon resumes them.

The port of t3fs/migration/service.py, a copy with its imports re-pointed;
its job store's JSON is the reference's, so either package's service
resumes the other's jobs.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from dataclasses import dataclass, field
from enum import Enum

from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.migration")


class JobState(str, Enum):
    PENDING = "pending"
    CREATING = "creating"
    JOINING = "joining"
    WAITING_SYNC = "waiting_sync"
    DRAINING = "draining"
    DETACHING = "detaching"
    DONE = "done"
    FAILED = "failed"


ACTIVE_STATES = (JobState.PENDING.value, JobState.CREATING.value,
                 JobState.JOINING.value, JobState.WAITING_SYNC.value,
                 JobState.DRAINING.value, JobState.DETACHING.value)


@serde_struct
@dataclass
class MigrationJob:
    job_id: int = 0
    chain_id: int = 0
    src_target_id: int = 0
    dst_target_id: int = 0
    dst_node_id: int = 0
    dst_root: str = ""
    state: str = JobState.PENDING.value
    error: str = ""
    # append-only fields: resumable marks a FAILED job whose
    # progress is safely re-derivable from routing (flapped destination,
    # timed-out wait) — `Migration.resume` re-drives it; attempts counts
    # drives (resume included); bytes_est is the planner's source-meta
    # estimate, bytes_moved what the destination reported after sync
    resumable: bool = False
    attempts: int = 0
    bytes_est: int = 0
    bytes_moved: int = 0


class _ResumableError(StatusError):
    """A step failure whose job progress is fully re-derivable from
    routing — safe to resume/re-plan (vs. a config/validation error)."""


def _resumable_error(code: StatusCode, msg: str) -> _ResumableError:
    return _ResumableError(code, msg)


@serde_struct
@dataclass
class SubmitMigrationReq:
    chain_id: int = 0
    src_target_id: int = 0
    dst_target_id: int = 0
    dst_node_id: int = 0
    # empty dst_root asks the destination node to derive the chunk dir
    # under its own data root (Storage.create_target default-root path)
    dst_root: str = ""


@serde_struct
@dataclass
class SubmitMigrationRsp:
    job_id: int = 0


@serde_struct
@dataclass
class ResumeMigrationReq:
    job_id: int = 0      # 0 = resume every unfinished/resumable job


@serde_struct
@dataclass
class ResumeMigrationRsp:
    resumed: list[int] = field(default_factory=list)


@serde_struct
@dataclass
class MigrationStatusRsp:
    implemented: bool = True
    jobs: list[MigrationJob] = field(default_factory=list)


@service("Migration")
class MigrationService:
    """Job queue + driver.  Needs a net client and the mgmtd address; talks
    to mgmtd for routing/chain surgery and to storage nodes for target
    provisioning/offlining."""

    MAX_FINISHED_JOBS = 256   # retained DONE/FAILED history

    def __init__(self, mgmtd_address: str = "", client=None,
                 poll_period_s: float = 0.2, sync_timeout_s: float = 120.0,
                 flap_timeout_s: float = 10.0, store_path: str = ""):
        self.mgmtd_address = mgmtd_address
        self.client = client
        self.poll_period_s = poll_period_s
        self.sync_timeout_s = sync_timeout_s
        # how long WAIT tolerates the awaited target's NODE being dead
        # before failing the job resumable — far shorter than the overall
        # sync timeout, so a permanently-dead destination re-plans fast
        self.flap_timeout_s = flap_timeout_s
        self.store_path = store_path
        self.jobs: dict[int, MigrationJob] = {}
        self._next_id = 1
        self._tasks: dict[int, asyncio.Task] = {}
        if store_path:
            self._load_store()

    # ---- persistent job store ----

    def _load_store(self) -> None:
        try:
            with open(self.store_path) as f:
                blob = json.load(f)
        except FileNotFoundError:
            return
        except (OSError, ValueError) as e:
            log.warning("migration job store %s unreadable (%s); starting "
                        "empty", self.store_path, e)
            return
        self._next_id = int(blob.get("next_id", 1))
        for row in blob.get("jobs", ()):
            job = MigrationJob(**{k: v for k, v in row.items()
                                  if k in MigrationJob.__dataclass_fields__})
            self.jobs[job.job_id] = job

    def _save_store(self) -> None:
        if not self.store_path:
            return
        tmp = self.store_path + ".tmp"
        blob = {"next_id": self._next_id,
                "jobs": [j.__dict__ for j in self.jobs.values()]}
        try:
            with open(tmp, "w") as f:
                json.dump(blob, f)
            os.replace(tmp, self.store_path)
        except OSError as e:
            log.warning("migration job store save failed: %s", e)

    def _set_state(self, job: MigrationJob, state: JobState) -> None:
        job.state = state.value
        self._save_store()

    async def start(self) -> None:
        """Re-drive jobs the store says were in flight: each step re-derives
        from routing, so re-attaching cannot double-apply surgery."""
        resumed = self._resume_jobs(only_active=True)
        if resumed:
            log.info("migration: re-attached to %d in-flight jobs: %s",
                     len(resumed), resumed)

    def _prune_finished(self, job_id: int) -> None:
        """Driver-done callback: drop the task handle and cap the retained
        job history — a long-running daemon must not grow per job forever."""
        self._tasks.pop(job_id, None)
        finished = [j for j in self.jobs.values()
                    if j.state in (JobState.DONE.value, JobState.FAILED.value)]
        for j in sorted(finished, key=lambda j: j.job_id)[
                : max(0, len(finished) - self.MAX_FINISHED_JOBS)]:
            self.jobs.pop(j.job_id, None)

    def _spawn(self, job: MigrationJob) -> None:
        task = asyncio.create_task(self._drive(job),
                                   name=f"migration-{job.job_id}")
        task.add_done_callback(lambda _t: self._prune_finished(job.job_id))
        self._tasks[job.job_id] = task

    def _resume_jobs(self, only_active: bool, job_id: int = 0) -> list[int]:
        out = []
        for job in self.jobs.values():
            if job_id and job.job_id != job_id:
                continue
            if job.job_id in self._tasks:
                continue
            if job.state in ACTIVE_STATES or \
                    (not only_active
                     and job.state == JobState.FAILED.value and job.resumable):
                job.error = ""
                job.resumable = False
                # a resumed job must leave FAILED *now*: observers (the
                # rebalancer's settle pass, status consumers) would read a
                # cleared-but-failed job as a hard failure in the window
                # before the driver's first step transition
                if job.state == JobState.FAILED.value:
                    job.state = JobState.PENDING.value
                self._spawn(job)
                out.append(job.job_id)
        if out:
            self._save_store()
        return out

    # ---- RPC surface ----

    @rpc_method
    async def status(self, req, payload, conn):
        return MigrationStatusRsp(jobs=list(self.jobs.values())), b""

    @rpc_method
    async def submit(self, req: SubmitMigrationReq, payload, conn):
        if self.client is None or not self.mgmtd_address:
            raise make_error(StatusCode.NOT_IMPLEMENTED,
                             "migration service not wired to a cluster")
        if not (req.chain_id and req.src_target_id and req.dst_target_id
                and req.dst_node_id):
            raise make_error(StatusCode.INVALID_ARG,
                             "chain_id, src/dst target ids and dst_node_id "
                             "are all required")
        # idempotent re-submit: the rebalancer re-plans periodically and
        # must converge on (not duplicate) an in-flight move
        for job in self.jobs.values():
            if (job.chain_id, job.src_target_id, job.dst_target_id) == \
                    (req.chain_id, req.src_target_id, req.dst_target_id) \
                    and job.state in ACTIVE_STATES:
                return SubmitMigrationRsp(job_id=job.job_id), b""
        job = MigrationJob(
            job_id=self._next_id, chain_id=req.chain_id,
            src_target_id=req.src_target_id,
            dst_target_id=req.dst_target_id, dst_node_id=req.dst_node_id,
            dst_root=req.dst_root)
        self._next_id += 1
        self.jobs[job.job_id] = job
        self._save_store()
        self._spawn(job)
        return SubmitMigrationRsp(job_id=job.job_id), b""

    @rpc_method
    async def resume(self, req: ResumeMigrationReq, payload, conn):
        """Re-drive FAILED-resumable (and orphaned in-flight) jobs; every
        step re-derives from routing so this is always safe to call."""
        resumed = self._resume_jobs(only_active=False, job_id=req.job_id)
        return ResumeMigrationRsp(resumed=resumed), b""

    async def stop(self) -> None:
        # copy: each task's done-callback pops it from _tasks as it settles
        tasks = list(self._tasks.values())
        for t in tasks:
            t.cancel()
        for t in tasks:
            await reap_task(t, log, t.get_name())

    # ---- driver ----

    async def _routing(self):
        from t3fs_torch.mgmtd.service import GetRoutingInfoReq
        rsp, _ = await self.client.call(
            self.mgmtd_address, "Mgmtd.get_routing_info",
            GetRoutingInfoReq(known_version=0))
        return rsp.info

    async def _alive_nodes(self) -> dict[int, bool]:
        rsp, _ = await self.client.call(
            self.mgmtd_address, "Mgmtd.list_nodes", None)
        return {row.node.node_id: row.alive for row in rsp.nodes}

    async def _drive(self, job: MigrationJob) -> None:
        job.attempts += 1
        try:
            await self._run_steps(job)
            self._set_state(job, JobState.DONE)
            log.info("migration %d done: chain %d target %d -> %d@n%d",
                     job.job_id, job.chain_id, job.src_target_id,
                     job.dst_target_id, job.dst_node_id)
        except asyncio.CancelledError:
            self._save_store()
            raise
        except Exception as e:
            job.error = str(e)
            # transient plumbing failures (mgmtd restarting, a node
            # mid-flap) are re-derivable from routing just like the
            # explicitly-resumable step errors; only semantic failures
            # (bad args, missing chain) need operator eyes
            transient = isinstance(e, StatusError) and e.code in (
                StatusCode.TIMEOUT, StatusCode.BUSY,
                StatusCode.RPC_SEND_FAILED, StatusCode.RPC_TIMEOUT,
                StatusCode.RPC_CONNECT_FAILED)
            job.resumable = isinstance(e, _ResumableError) or transient
            self._set_state(job, JobState.FAILED)
            log.error("migration %d failed%s: %s", job.job_id,
                      " (resumable)" if job.resumable else "", e)

    def _chain_vanished(self, job: MigrationJob, step: str) -> None:
        """A mid-job routing re-fetch found the chain deleted out from
        under the job: there is nothing left to apply surgery to, so the
        job converges as a no-op instead of crashing the driver (log-only
        so the job terminates DONE without an error string)."""
        log.info("migration %d: chain %d no longer in routing at %s; "
                 "nothing left to apply", job.job_id, job.chain_id, step)

    async def _run_steps(self, job: MigrationJob) -> None:
        from t3fs_torch.mgmtd.service import ChainOpReq
        from t3fs_torch.mgmtd.types import PublicTargetState
        from t3fs_torch.storage.types import TargetOpReq

        routing = await self._routing()
        chain = routing.chain(job.chain_id)
        if chain is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND,
                             f"chain {job.chain_id}")
        by_id = {t.target_id: t for t in chain.targets}
        src = by_id.get(job.src_target_id)
        dst = by_id.get(job.dst_target_id)
        if src is None and dst is not None \
                and dst.public_state == PublicTargetState.SERVING:
            return            # re-attach: all five steps already applied
        if src is None and dst is None:
            # stale plan: the chain's membership already moved past this
            # job (a planner tick raced a completed move and re-paired
            # differently).  Nothing was applied and nothing safe CAN be
            # applied — converge as a no-op; the planner's next tick
            # re-diffs fresh routing and plans whatever is still needed.
            # Log-only: the job terminates DONE and must not carry an
            # error string (DONE-with-error is an ambiguous state).
            log.info("migration %d: stale plan — neither src t%d nor dst "
                     "t%d in chain %d; nothing applied", job.job_id,
                     job.src_target_id, job.dst_target_id, job.chain_id)
            return
        dst_addr = routing.node_address(job.dst_node_id)
        if dst_addr is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND,
                             f"node {job.dst_node_id} not registered")

        # 1. CREATE the destination target (create_target is idempotent for
        # the same id+root, so a restarted driver re-attaches cleanly)
        if dst is None or dst.public_state != PublicTargetState.SERVING:
            self._set_state(job, JobState.CREATING)
            await self.client.call(dst_addr, "Storage.create_target",
                                   TargetOpReq(target_id=job.dst_target_id,
                                               root=job.dst_root))

            # bytes estimate for status/pacing: the source side's chunk
            # metas are what resync will diff-stream (best-effort)
            if not job.bytes_est and src is not None:
                job.bytes_est = await self._target_bytes(
                    routing, src.node_id, job.src_target_id)

            # 2. JOIN the chain — membership re-checked on FRESH routing
            # (the CREATE round-trip may have raced another driver), so a
            # re-attached job never double-adds
            self._set_state(job, JobState.JOINING)
            routing = await self._routing()
            chain = routing.chain(job.chain_id)
            if chain is None:
                self._chain_vanished(job, "join")
                return
            if not any(t.target_id == job.dst_target_id
                       for t in chain.targets):
                await self.client.call(
                    self.mgmtd_address, "Mgmtd.update_chain",
                    ChainOpReq(chain_id=job.chain_id,
                               target_id=job.dst_target_id,
                               node_id=job.dst_node_id, mode="add"))

            # 3. WAIT for resync to bring it SERVING (time-bounded, and
            # fast-failed when the destination node itself dies)
            self._set_state(job, JobState.WAITING_SYNC)
            await self._wait_state(job, job.dst_target_id,
                                   {PublicTargetState.SERVING},
                                   watch_node=job.dst_node_id)
            job.bytes_moved = await self._target_bytes(
                await self._routing(), job.dst_node_id, job.dst_target_id)

        if src is None:
            return            # source already detached by a prior attempt

        # 4. DRAIN the source: offline it on its node; the chain state
        # machine demotes it publicly and moves it to the tail.  Routing is
        # re-fetched: the WAIT step may have taken minutes, during which
        # the source node could have re-registered at a new address.
        # Refuse to drain the chain's LAST healthy serving replica — a
        # flapped destination plus an eager drain must never walk the
        # chain down to zero live copies.
        self._set_state(job, JobState.DRAINING)
        routing = await self._routing()
        chain = routing.chain(job.chain_id)
        if chain is None:
            self._chain_vanished(job, "drain")
            return
        alive = await self._alive_nodes()
        survivors = [t for t in chain.serving()
                     if t.target_id != job.src_target_id
                     and alive.get(t.node_id, False)]
        if not survivors:
            raise _resumable_error(
                StatusCode.INVALID_ARG,
                f"refusing to drain target {job.src_target_id}: it is the "
                f"last healthy serving replica of chain {job.chain_id}")
        src_node = src.node_id
        src_addr = routing.node_address(src_node)
        src_now = next((t for t in chain.targets
                        if t.target_id == job.src_target_id), None)
        if src_now is None:
            return            # detached concurrently: nothing left to do
        if src_now.public_state != PublicTargetState.OFFLINE \
                and src_addr is not None:
            try:
                await self.client.call(
                    src_addr, "Storage.offline_target",
                    TargetOpReq(target_id=job.src_target_id))
            except StatusError:
                pass   # node itself may be dead — mgmtd will notice
        await self._wait_state(job, job.src_target_id,
                               {PublicTargetState.OFFLINE})

        # 5. DETACH the source from the chain (skipped if a concurrent
        # driver already removed it — remove is not idempotent on mgmtd)
        self._set_state(job, JobState.DETACHING)
        routing = await self._routing()
        chain = routing.chain(job.chain_id)
        if chain is None:
            self._chain_vanished(job, "detach")
            return
        if any(t.target_id == job.src_target_id for t in chain.targets):
            await self.client.call(
                self.mgmtd_address, "Mgmtd.update_chain",
                ChainOpReq(chain_id=job.chain_id,
                           target_id=job.src_target_id, mode="remove"))

    async def _target_bytes(self, routing, node_id: int,
                            target_id: int) -> int:
        """Best-effort sum of a target's chunk bytes (status/pacing)."""
        from t3fs_torch.storage.types import TargetOpReq
        addr = routing.node_address(node_id)
        if addr is None:
            return 0
        try:
            rsp, _ = await self.client.call(
                addr, "Storage.get_all_chunk_metadata",
                TargetOpReq(target_id=target_id), timeout=10.0)
            return sum(m.length for m in rsp.metas)
        except StatusError:
            return 0

    async def _wait_state(self, job: MigrationJob, target_id: int,
                          wanted, watch_node: int = 0) -> None:
        """Poll routing until `target_id` reaches a wanted state.

        Two separate bounds: the overall
        sync_timeout_s covers a resync that never finishes, and — when
        watch_node is given — flap_timeout_s covers the node hosting the
        awaited target being continuously dead, so a destination that
        crashed mid-SYNCING fails the job (resumable) in seconds instead
        of wedging it for the full sync timeout."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + self.sync_timeout_s
        node_dead_since: float | None = None
        while True:
            routing = await self._routing()
            chain = routing.chain(job.chain_id)
            hit = [t for t in chain.targets if t.target_id == target_id] \
                if chain else []
            if hit and hit[0].public_state in wanted:
                return
            if watch_node:
                node_alive = True   # RPC failure = liveness unknown:
                try:                # don't run the flap clock on a guess
                    alive = await self._alive_nodes()
                    # absent from a SUCCESSFUL listing = unregistered =
                    # dead for our purposes — it must trip flap_timeout_s,
                    # not wedge the wait for the full sync timeout
                    node_alive = alive.get(watch_node, False)
                except StatusError:
                    pass
                if node_alive:
                    node_dead_since = None
                else:
                    node_dead_since = node_dead_since or loop.time()
                    if loop.time() - node_dead_since > self.flap_timeout_s:
                        raise _resumable_error(
                            StatusCode.TIMEOUT,
                            f"node {watch_node} dead for "
                            f"{self.flap_timeout_s:.0f}s while target "
                            f"{target_id} syncing; re-plan the move")
            if loop.time() > deadline:
                state = hit[0].public_state.name if hit else "GONE"
                raise _resumable_error(
                    StatusCode.TIMEOUT,
                    f"target {target_id} stuck in {state}, wanted "
                    f"{[s.name for s in wanted]}")
            await asyncio.sleep(self.poll_period_s)
