"""The port's elastic membership (t3fs_torch.migration.{service,rebalancer}
over t3fs_torch.mgmtd.chain_table) against the JAX package's: every case
of tests/test_rebalancer.py and tests/test_migration.py on the port's
LocalCluster, then one seeded add + drain run through each package's
cluster with the same chain memberships, the same (chain, src, dst) jobs
and the same stored bytes and ChunkMeta per chunk, and a job store written
by either package's MigrationService and resumed by the other's.

The port's admin CLI (t3fs_torch.cli.admin) reads the port's Migration
and Rebalance services over the wire, as a subprocess.  Each cluster runs
its nodes' CRCs on the host and is steadied for test load: a heartbeat
timeout the load cannot reach, and a killed node declared dead in mgmtd
until it starts again (as tests/test_torch_recovery_benches.py does);
neither package changes for it.

Elastic membership: online rebalancer + flap-safe jobs.

Covers the acceptance cases: node add rebalances onto the new node with
byte-identical data; graceful drain (the ``drain`` tag) empties a node
that keeps serving throughout; drain of a chain's last healthy replica
is refused; and mid-migration kills (mgmtd, the migration service, the
destination node) converge on a consistent chain table after restart
without double-applying chain surgery.
"""

import asyncio
import json
import os
import subprocess
import sys

import numpy as np

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.mgmtd.chain_table import diff_table, solve_for_routing
from t3fs_torch.mgmtd.service import NodeOpReq
from t3fs_torch.mgmtd.types import PublicTargetState
from t3fs_torch.migration.rebalancer import Rebalancer
from t3fs_torch.migration.service import (
    ACTIVE_STATES, MigrationService, ResumeMigrationReq, SubmitMigrationReq,
)
from t3fs_torch.net.server import Server
from t3fs_torch.testing.cluster import LocalCluster as PortCluster
from t3fs_torch.utils.status import StatusCode


def steady(cluster_cls, **defaults):
    """cluster_cls on the host CRC, with a heartbeat timeout test load
    cannot reach; a killed node is dead to mgmtd until it starts again."""
    class Steady(cluster_cls):
        def __init__(self, *args, **kw):
            kw["heartbeat_timeout_s"] = 30.0
            super().__init__(*args, **{**defaults, **kw})
            self.declared_dead: set[int] = set()

        async def start(self):
            await super().start()
            self._steady_mgmtd()

        def _steady_mgmtd(self):
            alive = self.mgmtd.state.node_alive
            self.mgmtd.state.node_alive = (
                lambda n: n not in self.declared_dead and alive(n))

        async def restart_mgmtd(self):
            await super().restart_mgmtd()
            self._steady_mgmtd()

        async def kill_storage_node(self, node_id):
            await super().kill_storage_node(node_id)
            self.declared_dead.add(node_id)

        async def start_storage_node(self, node_id, with_targets=True):
            self.declared_dead.discard(node_id)
            return await super().start_storage_node(node_id, with_targets)

    return Steady


LocalCluster = steady(PortCluster, checksum_backend="cpu")

CR_LAYOUT = FileLayout(chunk_size=4096, chains=[1])
CR_DATA = b"cr-before-rebalance" * 800
EC_DATA = b"ec-before-rebalance" * 500


def make_services(cluster, **kw):
    mig = MigrationService(cluster.mgmtd_rpc.address, client=cluster.admin,
                           poll_period_s=0.05, sync_timeout_s=30.0,
                           flap_timeout_s=kw.pop("flap_timeout_s", 5.0),
                           store_path=kw.pop("store_path", ""))
    reb = Rebalancer(mig, max_inflight=kw.pop("max_inflight", 4), **kw)
    return mig, reb


async def write_seed(cluster, ec_chain=0):
    res = await cluster.sc.write_file_range(CR_LAYOUT, 9, 0, CR_DATA)
    assert all(r.status.code == int(StatusCode.OK) for r in res)
    if ec_chain:
        lay = FileLayout(chunk_size=4096, chains=[ec_chain])
        res = await cluster.sc.write_file_range(lay, 11, 0, EC_DATA)
        assert all(r.status.code == int(StatusCode.OK) for r in res)


async def check_seed(cluster, ec_chain=0):
    await cluster.mgmtd_client.refresh()
    got, _ = await cluster.sc.read_file_range(CR_LAYOUT, 9, 0, len(CR_DATA))
    assert got == CR_DATA, "wrong bytes after rebalance (CR)"
    if ec_chain:
        lay = FileLayout(chunk_size=4096, chains=[ec_chain])
        got, _ = await cluster.sc.read_file_range(lay, 11, 0, len(EC_DATA))
        assert got == EC_DATA, "wrong bytes after rebalance (EC)"


async def converge(reb, mig, timeout_s=90.0):
    """Tick the planner until the solver wants nothing and no job runs.
    A non-resumable failure is a test failure, not something to retry."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        rsp = await reb.tick()
        bad = [j for j in mig.jobs.values()
               if j.state == "failed" and not j.resumable]
        assert not bad, [(j.job_id, j.error) for j in bad]
        active = [j for j in mig.jobs.values() if j.state in ACTIVE_STATES]
        if rsp.planned == 0 and not active:
            return
        await asyncio.sleep(0.2)
    raise AssertionError("rebalance never converged")


async def converge_settled(reb, mig, timeout_s=90.0):
    """converge, each tick taken only once no job is active: every plan is
    then read from a routing that no move is changing, so the moves made
    follow the solver and not the host's load (a tick amid a move's steps
    can plan a move the next routing undoes, in either package)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        rsp = await reb.tick()
        while any(j.state in ACTIVE_STATES for j in mig.jobs.values()) \
                and loop.time() < deadline:
            await asyncio.sleep(0.05)
        bad = [j for j in mig.jobs.values()
               if j.state == "failed" and not j.resumable]
        assert not bad, [(j.job_id, j.error) for j in bad]
        if rsp.planned == 0 and not any(j.state in ACTIVE_STATES
                                        for j in mig.jobs.values()):
            return
        await asyncio.sleep(0.2)
    raise AssertionError("rebalance never converged")


def node_targets(routing, node_id):
    return [(c.chain_id, t.target_id) for c in routing.chains.values()
            for t in c.targets if t.node_id == node_id]


async def resume_until_done(mig, job_id, timeout_s=60.0):
    """Re-drive a resumable job until it completes — the same loop the
    rebalancer's plan tick runs in production.  A single resume can
    legitimately fail transient again (e.g. routing still carries the
    restarted node's old address for one chains-updater period)."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout_s
    while loop.time() < deadline:
        await mig.resume(ResumeMigrationReq(job_id=job_id), b"", None)
        job = await wait_job(mig, job_id)
        if job.state == "done":
            return job
        assert job.resumable, job.error
        await asyncio.sleep(0.3)
    raise AssertionError(
        f"job {job_id} never completed: {mig.jobs[job_id].error}")


async def wait_job(mig, job_id, states=("done", "failed"), timeout_s=30.0):
    for _ in range(int(timeout_s / 0.1)):
        job = mig.jobs.get(job_id)
        if job is not None and job.state in states:
            return job
        await asyncio.sleep(0.1)
    raise AssertionError(
        f"job {job_id} never reached {states}: "
        f"{mig.jobs.get(job_id) and mig.jobs[job_id].state}")


def _run_cli(args_list):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "t3fs_torch.cli.admin", *args_list],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, [repo, os.environ.get("PYTHONPATH", "")]))})
    assert out.returncode == 0, out.stderr
    return out.stdout


# ---- node add: rebalance onto a fresh empty node ----

def test_node_add_rebalances_onto_new_node():
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=2, num_chains=6,
                               ec_chains=4)
        await cluster.start()
        try:
            await write_seed(cluster, ec_chain=7)
            ss = await cluster.add_storage_node()
            assert ss.node_id == 4
            # wait until mgmtd registered the empty node
            for _ in range(100):
                if 4 in cluster.mgmtd.state.routing().nodes:
                    break
                await asyncio.sleep(0.05)

            mig, reb = make_services(cluster)
            srv = Server()
            srv.add_service(mig)
            srv.add_service(reb)
            await srv.start()
            await converge(reb, mig)

            routing = cluster.mgmtd.state.routing()
            # the new node received a fair share of chains
            assert len(node_targets(routing, 4)) >= 2
            # every chain is back at full strength, all targets SERVING,
            # and no chain holds two replicas on one node
            for c in routing.chains.values():
                want = 2 if c.chain_id <= 6 else 1
                assert len(c.targets) == want, (c.chain_id, c.targets)
                assert all(t.public_state == PublicTargetState.SERVING
                           for t in c.targets)
                nodes = [t.node_id for t in c.targets]
                assert len(set(nodes)) == len(nodes)
            # converged = the solver's own diff is empty for both tables
            cands, _ = await reb._candidates()
            for table_id in sorted(routing.chain_tables):
                solved = solve_for_routing(routing, table_id, cands)
                assert diff_table(routing, solved) == []

            await check_seed(cluster, ec_chain=7)
            # routing churn reached clients as deltas, not full re-fetches
            assert cluster.mgmtd_client.delta_refreshes > 0

            # operator surface: the admin CLI renders the move ledger
            out = await asyncio.to_thread(
                _run_cli, ["--migration", srv.address, "rebalance-status"])
            assert "moves:" in out and "done=" in out
            assert "pacing:" in out

            await reb.stop()
            await mig.stop()
            await srv.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


# ---- graceful drain: the node keeps serving while it empties ----

def test_drain_tag_empties_node_while_it_serves():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=2, num_chains=6,
                               ec_chains=4)
        await cluster.start()
        try:
            await write_seed(cluster, ec_chain=7)
            mig, reb = make_services(cluster)
            # settle the installed round-robin table to the solver target
            # first, so the drain diff is the only remaining gap
            await converge(reb, mig)

            routing = cluster.mgmtd.state.routing()
            victim = next(n for n in (1, 2, 3, 4)
                          if node_targets(routing, n))
            await cluster.admin.call(
                cluster.mgmtd_rpc.address, "Mgmtd.set_node_tags",
                NodeOpReq(node_id=victim, tags=["drain"]))
            await converge(reb, mig)

            routing = cluster.mgmtd.state.routing()
            assert node_targets(routing, victim) == []
            # graceful: the node is still registered, alive and ACTIVE —
            # it served as a resync source for its own exodus (unlike
            # disable-node, which would have demoted its targets and
            # stranded the single-replica EC chains)
            rsp, _ = await cluster.admin.call(
                cluster.mgmtd_rpc.address, "Mgmtd.list_nodes", None)
            row = next(r for r in rsp.nodes if r.node.node_id == victim)
            assert row.alive
            assert "drain" in row.node.tags
            for c in routing.chains.values():
                assert all(t.public_state == PublicTargetState.SERVING
                           for t in c.targets)
            await check_seed(cluster, ec_chain=7)

            await reb.stop()
            await mig.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


# ---- drain-of-last-healthy-replica refused ----

def test_drain_last_healthy_replica_refused():
    async def body():
        cluster = LocalCluster(num_nodes=2, replicas=1, num_chains=1)
        await cluster.start()
        try:
            await write_seed(cluster)
            mig = MigrationService(cluster.mgmtd_rpc.address,
                                   client=cluster.admin,
                                   poll_period_s=0.05, sync_timeout_s=30.0)
            # every node reported dead: after the destination syncs, the
            # DRAIN step sees no healthy survivor besides the source and
            # must refuse rather than walk the chain to zero live copies
            real_alive = mig._alive_nodes

            async def all_dead():
                return {}
            mig._alive_nodes = all_dead

            src = cluster.target_id(1, 0)
            rsp, _ = await mig.submit(SubmitMigrationReq(
                chain_id=1, src_target_id=src, dst_target_id=9400,
                dst_node_id=2), b"", None)
            job = await wait_job(mig, rsp.job_id)
            assert job.state == "failed" and job.resumable, job.error
            assert "last healthy serving replica" in job.error
            # nothing was drained: both targets still serve
            chain = cluster.chain()
            assert {t.target_id for t in chain.targets} == {src, 9400}
            assert all(t.public_state == PublicTargetState.SERVING
                       for t in chain.targets)

            # with liveness back, resume completes the move
            mig._alive_nodes = real_alive
            await mig.resume(ResumeMigrationReq(job_id=rsp.job_id), b"", None)
            job = await wait_job(mig, rsp.job_id)
            assert job.state == "done", job.error
            chain = cluster.chain()
            assert [t.target_id for t in chain.targets] == [9400]
            await check_seed(cluster)
            await mig.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


# ---- mid-migration kills: re-attach without double-applying surgery ----

async def _park_in_waiting_sync(cluster, mig):
    """Submit the node3 -> node4 move of chain 1 and hold it in
    WAITING_SYNC by pausing the resync pusher (the chain's tail, node 3,
    is both the move's source and the resync source)."""
    await cluster.storage[3].resync.stop()
    rsp, _ = await mig.submit(SubmitMigrationReq(
        chain_id=1, src_target_id=cluster.target_id(3, 0),
        dst_target_id=9400, dst_node_id=4), b"", None)
    job = await wait_job(mig, rsp.job_id, states=("waiting_sync",))
    return rsp.job_id, job


async def _assert_chain_converged(cluster, src_target):
    chain = cluster.chain()
    ids = [t.target_id for t in chain.targets]
    assert sorted(ids) == sorted(set(ids)), f"duplicate targets: {ids}"
    assert 9400 in ids and src_target not in ids
    assert len(ids) == 3
    for _ in range(100):
        chain = cluster.chain()
        if all(t.public_state == PublicTargetState.SERVING
               for t in chain.targets):
            break
        await asyncio.sleep(0.1)
    assert all(t.public_state == PublicTargetState.SERVING
               for t in chain.targets)


def test_mgmtd_restart_mid_job_reattaches():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1)
        await cluster.start()
        try:
            await write_seed(cluster)
            mig = MigrationService(cluster.mgmtd_rpc.address,
                                   client=cluster.admin,
                                   poll_period_s=0.05, sync_timeout_s=30.0)
            job_id, _ = await _park_in_waiting_sync(cluster, mig)

            # fail-stop mgmtd with the JOIN already applied: the driver's
            # next routing poll hits a dead listener -> transient failure,
            # marked resumable (progress is re-derivable from routing)
            await cluster.kill_mgmtd()
            job = await wait_job(mig, job_id)
            assert job.state == "failed" and job.resumable, job.error

            await cluster.restart_mgmtd()
            # restarted state comes from the shared KV: the chain still
            # holds the joined destination exactly once
            ids = [t.target_id for t in cluster.chain().targets]
            assert ids.count(9400) == 1
            await cluster.storage[3].resync.start()
            # probe until the admin client reconnected to the new listener
            from t3fs_torch.mgmtd.service import GetRoutingInfoReq
            for _ in range(100):
                try:
                    await cluster.admin.call(
                        cluster.mgmtd_rpc.address, "Mgmtd.get_routing_info",
                        GetRoutingInfoReq(known_version=0))
                    break
                except Exception:
                    await asyncio.sleep(0.1)

            job = await resume_until_done(mig, job_id)
            assert job.attempts >= 2
            await _assert_chain_converged(cluster, cluster.target_id(3, 0))
            await check_seed(cluster)
            await mig.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_migration_service_restart_mid_job_reattaches():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1)
        await cluster.start()
        try:
            await write_seed(cluster)
            store = os.path.join(cluster._tmp.name, "migration-jobs.json")
            mig = MigrationService(cluster.mgmtd_rpc.address,
                                   client=cluster.admin,
                                   poll_period_s=0.05, sync_timeout_s=30.0,
                                   store_path=store)
            job_id, _ = await _park_in_waiting_sync(cluster, mig)
            # daemon dies mid-WAIT; the job store remembers the in-flight
            # job in its last persisted state
            await mig.stop()

            mig2 = MigrationService(cluster.mgmtd_rpc.address,
                                    client=cluster.admin,
                                    poll_period_s=0.05, sync_timeout_s=30.0,
                                    store_path=store)
            assert mig2.jobs[job_id].state == "waiting_sync"
            await cluster.storage[3].resync.start()
            await mig2.start()          # re-attach re-drives active jobs
            job = await wait_job(mig2, job_id)
            if job.state != "done":     # a transient re-fail is resumable
                assert job.resumable, job.error
                job = await resume_until_done(mig2, job_id)
            await _assert_chain_converged(cluster, cluster.target_id(3, 0))
            await check_seed(cluster)
            await mig2.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_unregistered_destination_fast_fails_wait():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1)
        await cluster.start()
        try:
            await write_seed(cluster)
            mig = MigrationService(cluster.mgmtd_rpc.address,
                                   client=cluster.admin,
                                   poll_period_s=0.05, sync_timeout_s=60.0,
                                   flap_timeout_s=1.0)
            job_id, _ = await _park_in_waiting_sync(cluster, mig)

            # destination vanishes from list_nodes ENTIRELY (unregistered,
            # not merely dead): absent-from-a-successful-listing must count
            # as dead so the flap timeout trips, instead of wedging the
            # WAIT for the full sync timeout
            real = mig._alive_nodes

            async def without_dst():
                alive = await real()
                alive.pop(4, None)
                return alive
            mig._alive_nodes = without_dst
            job = await wait_job(mig, job_id, timeout_s=10.0)
            assert job.state == "failed" and job.resumable, job.error
            assert "re-plan the move" in job.error

            # with the node visible again, resume completes the surgery
            mig._alive_nodes = real
            await cluster.storage[3].resync.start()
            job = await resume_until_done(mig, job_id)
            await _assert_chain_converged(cluster, cluster.target_id(3, 0))
            await check_seed(cluster)
            await mig.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_planner_skips_chain_with_inflight_job():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1)
        await cluster.start()
        try:
            await write_seed(cluster)
            mig, reb = make_services(cluster)
            # park a move mid-surgery: chain 1 is now transiently R+1
            # wide (dst 9400 joined, src not yet detached)
            job_id, _ = await _park_in_waiting_sync(cluster, mig)
            assert len(cluster.chain().targets) == 4

            # the planner must leave the busy chain alone: no duplicate
            # move may be planned or submitted against its inflated
            # membership, tick after tick
            for _ in range(3):
                rsp = await reb.tick()
                assert rsp.planned == 0, vars(rsp)
                assert set(mig.jobs) == {job_id}

            # let the parked move finish and the cluster converge; the
            # solver may keep reshaping the chain, so assert consistency
            # (R targets, distinct nodes, all SERVING), not membership
            await cluster.storage[3].resync.start()
            await converge(reb, mig)
            for _ in range(100):
                chain = cluster.chain()
                if all(t.public_state == PublicTargetState.SERVING
                       for t in chain.targets):
                    break
                await asyncio.sleep(0.1)
            ids = [t.target_id for t in chain.targets]
            assert sorted(ids) == sorted(set(ids)), f"duplicates: {ids}"
            assert len(ids) == 3, ids
            nodes = [t.node_id for t in chain.targets]
            assert len(set(nodes)) == len(nodes), nodes
            assert all(t.public_state == PublicTargetState.SERVING
                       for t in chain.targets)
            await check_seed(cluster)
            await reb.stop()
            await mig.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_destination_flap_mid_sync_resumable():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1)
        await cluster.start()
        try:
            await write_seed(cluster)
            mig = MigrationService(cluster.mgmtd_rpc.address,
                                   client=cluster.admin,
                                   poll_period_s=0.05, sync_timeout_s=60.0,
                                   flap_timeout_s=1.0)
            job_id, _ = await _park_in_waiting_sync(cluster, mig)

            # destination dies mid-SYNCING: the WAIT step must fail the
            # job (resumable) after flap_timeout_s, not poll out the full
            # sync timeout
            await cluster.kill_storage_node(4)
            job = await wait_job(mig, job_id, timeout_s=20.0)
            assert job.state == "failed" and job.resumable, job.error
            assert "re-plan the move" in job.error

            # node comes back on the same disk: _discover_targets
            # re-adopts the half-created destination target, resync
            # finishes the copy, and resume completes the surgery
            await cluster.restart_storage_node(4)
            rsp, _ = await cluster.admin.call(
                cluster.mgmtd_rpc.address, "Mgmtd.list_nodes", None)
            for _ in range(100):
                rsp, _ = await cluster.admin.call(
                    cluster.mgmtd_rpc.address, "Mgmtd.list_nodes", None)
                row = next(r for r in rsp.nodes if r.node.node_id == 4)
                if row.alive:
                    break
                await asyncio.sleep(0.1)
            await cluster.storage[3].resync.start()
            job = await resume_until_done(mig, job_id)
            await _assert_chain_converged(cluster, cluster.target_id(3, 0))
            await check_seed(cluster)
            await mig.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


# ---- tests/test_migration.py: a live target move through chain surgery ----

def _run_cli_migrate_status(migration_address: str) -> str:
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run(
        [sys.executable, "-m", "t3fs_torch.cli.admin",
         "--migration", migration_address, "migrate-status"],
        capture_output=True, text=True, timeout=60,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, [repo, os.environ.get("PYTHONPATH", "")]))})
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_live_target_migration():
    async def body():
        # 4 nodes, chain on nodes 1-3; node 4 is the migration destination
        cluster = LocalCluster(num_nodes=4, replicas=3,
                               heartbeat_timeout_s=0.6)
        await cluster.start()
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data = b"pre-migration" * 400
            res = await cluster.sc.write_file_range(lay, 9, 0, data)
            assert all(r.status.code == int(StatusCode.OK) for r in res)

            src_target = cluster.target_id(3, 0)     # node 3's replica
            dst_target = 9400
            mig = MigrationService(cluster.mgmtd_rpc.address,
                                   client=cluster.admin,
                                   poll_period_s=0.1, sync_timeout_s=30.0)
            srv = Server()
            srv.add_service(mig)
            await srv.start()
            rsp, _ = await cluster.admin.call(
                srv.address, "Migration.submit",
                SubmitMigrationReq(chain_id=1, src_target_id=src_target,
                                   dst_target_id=dst_target, dst_node_id=4,
                                   dst_root=cluster.node_root(4) + "/mig"))
            job_id = rsp.job_id

            for _ in range(300):
                st, _ = await cluster.admin.call(srv.address,
                                                 "Migration.status", None)
                job = next(j for j in st.jobs if j.job_id == job_id)
                if job.state in ("done", "failed"):
                    break
                await asyncio.sleep(0.1)
            assert job.state == "done", f"{job.state}: {job.error}"

            # chain now holds dst, not src, and dst serves
            chain = cluster.chain()
            ids = [t.target_id for t in chain.targets]
            assert dst_target in ids and src_target not in ids
            dst = next(t for t in chain.targets if t.target_id == dst_target)
            assert dst.public_state == PublicTargetState.SERVING

            # data survived the move and reads fine (any serving target)
            got, _ = await cluster.sc.read_file_range(lay, 9, 0, len(data))
            assert got == data
            # the migrated replica physically holds the chunks
            eng = cluster.storage[4].node.targets[dst_target].engine
            assert len(eng.all_metas()) > 0

            # operator surface: admin CLI lists the finished job
            out = await asyncio.to_thread(_run_cli_migrate_status,
                                          srv.address)
            assert f"job {job_id}" in out and "state=done" in out

            await mig.stop()
            await srv.stop()
        finally:
            await cluster.stop()
    asyncio.run(body())


# ---- the port against the reference ----

import importlib                                   # noqa: E402
from types import SimpleNamespace                  # noqa: E402

import pytest                                      # noqa: E402


def _package(name: str) -> SimpleNamespace:
    def mod(path):
        return importlib.import_module(f"{name}.{path}")
    backend = {"checksum_backend": "cpu"} if name == "t3fs_torch" else {}
    return SimpleNamespace(
        name=name, cluster=steady(mod("testing.cluster").LocalCluster,
                                  **backend),
        layout=mod("client.layout").FileLayout, client=mod("net.client").Client,
        migration=mod("migration.service"), rebalancer=mod("migration.rebalancer"),
        NodeOpReq=mod("mgmtd.service").NodeOpReq,
        OK=int(mod("utils.status").StatusCode.OK))


REF, PORT = _package("t3fs"), _package("t3fs_torch")


def _seeded(seed: int, n: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


async def _add_and_drain(P) -> tuple:
    """3 nodes, 6 chains of 2 and 4 one-replica EC chains, seeded files on
    both; a node added and the rebalancer converged, then node 1 tagged
    drain and converged again.  Returns the chain memberships, the jobs and
    every stored chunk of every chain target, read from its engine."""
    c = P.cluster(num_nodes=3, replicas=2, num_chains=6, ec_chains=4)
    await c.start()
    mig = reb = None
    try:
        cr = P.layout(chunk_size=4096, chains=list(range(1, 7)))
        files = [(cr, 9, _seeded(1, 23 * 4096 + 100))]
        files += [(P.layout(chunk_size=4096, chains=[cid]), 20 + cid,
                   _seeded(cid, 5 * 4096 + cid)) for cid in range(7, 11)]
        for lay, inode, data in files:
            res = await c.sc.write_file_range(lay, inode, 0, data)
            assert all(r.status.code == P.OK for r in res)
        await c.add_storage_node()
        for _ in range(100):
            if 4 in c.mgmtd.state.routing().nodes:
                break
            await asyncio.sleep(0.05)
        mig = P.migration.MigrationService(
            c.mgmtd_rpc.address, client=c.admin, poll_period_s=0.05,
            sync_timeout_s=30.0, flap_timeout_s=5.0)
        reb = P.rebalancer.Rebalancer(mig, max_inflight=4)
        await converge_settled(reb, mig)
        await c.admin.call(c.mgmtd_rpc.address, "Mgmtd.set_node_tags",
                           P.NodeOpReq(node_id=1, tags=["drain"]))
        await converge_settled(reb, mig)
        await c.mgmtd_client.refresh()
        for lay, inode, data in files:
            got, _ = await c.sc.read_file_range(lay, inode, 0, len(data))
            assert got == data, (P.name, inode)
        routing = c.mgmtd.state.routing()
        members = {cid: sorted((t.target_id, t.node_id) for t in ch.targets)
                   for cid, ch in sorted(routing.chains.items())}
        jobs = sorted({(j.chain_id, j.src_target_id, j.dst_target_id, j.state)
                       for j in mig.jobs.values()})
        stored = {}
        for cid, ch in sorted(routing.chains.items()):
            for t in ch.targets:
                eng = c.storage[t.node_id].node.targets[t.target_id].engine
                # chain_ver is the chain's version when the chunk was
                # written or REPLACEd: it follows the chains updater's
                # timing, not the plan, so it is left out
                stored[(cid, t.target_id)] = sorted(
                    (m.chunk_id.inode, m.chunk_id.index, m.length,
                     m.update_ver, m.commit_ver, m.checksum, int(m.state),
                     eng.read(m.chunk_id)) for m in eng.all_metas())
        return members, jobs, stored
    finally:
        if reb is not None:
            await reb.stop()
        if mig is not None:
            await mig.stop()
        await c.stop()


def test_add_and_drain_equal_across_packages():
    ref = asyncio.run(_add_and_drain(REF))
    port = asyncio.run(_add_and_drain(PORT))
    assert ref[0] == port[0]
    assert ref[1] == port[1] and all(j[3] == "done" for j in port[1])
    assert ref[2] == port[2]
    assert not any(n == 1 for ts in port[0].values() for _, n in ts)
    assert any(n == 4 for ts in port[0].values() for _, n in ts)


@pytest.mark.parametrize("writer,reader", [(REF, PORT), (PORT, REF)],
                         ids=["ref-to-port", "port-to-ref"])
def test_job_store_resumed_across_packages(writer, reader, tmp_path):
    """A job parked mid-WAIT by one package's MigrationService, its store
    left behind when that service stops, is re-attached and finished by
    the other package's service on the same (port's) cluster."""
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1)
        await cluster.start()
        clients = [writer.client(), reader.client()]
        try:
            await write_seed(cluster)
            store = str(tmp_path / "migration-jobs.json")
            mig = writer.migration.MigrationService(
                cluster.mgmtd_rpc.address, client=clients[0],
                poll_period_s=0.05, sync_timeout_s=30.0, store_path=store)
            job_id, _ = await _park_in_waiting_sync(cluster, mig)
            await mig.stop()
            with open(store) as f:
                blob = json.load(f)
            row = next(r for r in blob["jobs"] if r["job_id"] == job_id)
            assert row["state"] == "waiting_sync" and row["dst_node_id"] == 4

            mig2 = reader.migration.MigrationService(
                cluster.mgmtd_rpc.address, client=clients[1],
                poll_period_s=0.05, sync_timeout_s=30.0, store_path=store)
            assert mig2.jobs[job_id].state == "waiting_sync"
            assert mig2._next_id == blob["next_id"]
            await cluster.storage[3].resync.start()
            await mig2.start()
            job = await wait_job(mig2, job_id)
            if job.state != "done":
                assert job.resumable, job.error
                job = await resume_until_done(mig2, job_id)
            await _assert_chain_converged(cluster, cluster.target_id(3, 0))
            await check_seed(cluster)
            await mig2.stop()
        finally:
            for cli in clients:
                await cli.close()
            await cluster.stop()
    asyncio.run(body())

