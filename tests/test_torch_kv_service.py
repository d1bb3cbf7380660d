"""The port's replicated transactional KV (t3fs_torch.kv.{service,remote})
against the JAX package's (t3fs.kv): every case of tests/test_kv_service.py
and tests/test_kv_pipeline.py run on the port (remote transactions, sync
replication, snapshot catch-up, promotion and failover, the commit
pipeline and its cascade abort), then one seeded history through each
package's primary, follower and client with equal reads, outcomes, seqs
and WAL bytes, and each package's client and follower against the other's
group over the wire.  time.time, the 2PC txn ids and the load sampler's
random stream are pinned in both packages with monkeypatch
(tests/torch_kv_diff.py); nothing in either package changes for it."""

import asyncio
import os
import tempfile

import numpy as np
import pytest

import torch_kv_diff as D
from t3fs_torch.kv.engine import MemKVEngine, with_transaction
from t3fs_torch.kv.remote import RemoteKVEngine
from t3fs_torch.kv.service import KvReplicateReq, KvService
from t3fs_torch.kv.wal_engine import WalKVEngine
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.status import StatusCode, StatusError


def run(coro):
    return asyncio.run(coro)


async def _mk_cluster(n_followers: int = 1, engine=MemKVEngine):
    servers, services, addrs = [], [], []
    ship = Client()
    for i in range(1 + n_followers):
        svc = KvService(engine(), primary=(i == 0), client=ship)
        srv = Server()
        srv.add_service(svc)
        await srv.start()
        servers.append(srv)
        services.append(svc)
        addrs.append(srv.address)
    services[0].followers = addrs[1:]

    async def cleanup():
        for svc in services:
            svc.stop_decision_gc()
        await ship.close()
        for s in servers:
            await s.stop()
    return servers, services, addrs, cleanup


def test_concurrent_disjoint_commits_all_land():
    """N disjoint commits in flight at once: all succeed, versions are
    contiguous, follower state equals primary state."""
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            async def put(i):
                async def w(txn):
                    txn.set(b"k%03d" % i, b"v%d" % i)
                await with_transaction(kv, w)
            await asyncio.gather(*(put(i) for i in range(40)))
            prim, fol = services[0].engine, services[1].engine
            for eng in (prim, fol):
                ver = eng.current_version()
                for i in range(40):
                    assert eng.read_at(b"k%03d" % i, ver) == b"v%d" % i
            assert services[1].seq == services[0].seq == 40
            assert fol._version == prim._version
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_wal_group_commit_overlaps_fsyncs():
    """The point of the pipeline: N concurrent commits on a sync=always
    WAL engine share group-commit barriers instead of paying N serial
    fsyncs (the engine-level group commit finally sees company).  fsync
    is slowed to disk-realistic latency — on a fast /tmp each barrier
    wins the race to cover only its own frame and no groups can form."""
    from unittest import mock
    import time as _t
    real_fsync = os.fsync

    def slow_fsync(fd):
        _t.sleep(0.004)
        real_fsync(fd)

    async def body(root):
        _, services, addrs, cleanup = await _mk_cluster(
            0, engine=lambda: WalKVEngine(root, sync="always"))
        kv = RemoteKVEngine(addrs)
        try:
            eng = services[0].engine
            base = eng.fsyncs

            async def put(i):
                async def w(txn):
                    txn.set(b"g%03d" % i, os.urandom(64))
                await with_transaction(kv, w)
            await asyncio.gather(*(put(i) for i in range(60)))
            spent = eng.fsyncs - base
            ver = eng.current_version()
            assert all(eng.read_at(b"g%03d" % i, ver) is not None
                       for i in range(60))
            # serialized commits would pay ~60; grouped must be well under
            assert spent < 40, f"fsyncs not grouped: {spent} for 60 commits"
        finally:
            await kv.close()
            await cleanup()
    with tempfile.TemporaryDirectory() as d, \
            mock.patch("os.fsync", slow_fsync):
        run(body(d))


def test_inflight_read_overlap_conflicts_and_retries():
    """A commit whose READS overlap an in-flight (admitted, unapplied)
    commit's writes is refused TXN_CONFLICT at admission — the engine's
    check can't see unapplied writes — and with_transaction converges."""
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            async def seed(txn):
                txn.set(b"ctr", b"0")
            await with_transaction(kv, seed)

            async def incr(txn):
                v = int(await txn.get(b"ctr"))
                txn.set(b"ctr", b"%d" % (v + 1))
            await asyncio.gather(*(with_transaction(kv, incr)
                                   for _ in range(10)))
            txn = kv.transaction()
            assert await txn.get(b"ctr") == b"10"
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_follower_reorders_out_of_order_batches():
    """Direct protocol check: seq 2 arriving before seq 1 parks and
    applies once 1 lands; a stale seq answers KV_REPLICA_GAP."""
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(1)
        ship = Client()
        try:
            fol_addr = addrs[1]

            def batch(seq, key, version):
                return KvReplicateReq(
                    seq=seq, version=version, floor=0,
                    write_keys=[key], write_values=[b"x"],
                    write_deletes=[False])
            t2 = asyncio.create_task(ship.call(
                fol_addr, "Kv.apply_replica", batch(2, b"b", 2)))
            await asyncio.sleep(0.2)
            assert not t2.done()        # parked on missing seq 1
            await ship.call(fol_addr, "Kv.apply_replica", batch(1, b"a", 1))
            await t2                    # unparked and applied in order
            fol = services[1]
            assert fol.seq == 2
            ver = fol.engine.current_version()
            assert fol.engine.read_at(b"a", ver) == b"x"
            assert fol.engine.read_at(b"b", ver) == b"x"
            with pytest.raises(StatusError) as ei:
                await ship.call(fol_addr, "Kv.apply_replica",
                                batch(2, b"c", 3))
            assert ei.value.code == StatusCode.KV_REPLICA_GAP
        finally:
            await ship.close()
            await cleanup()
    run(body())


def test_floor_fails_fast_for_lost_predecessors():
    """A follower missing batches at or below the primary's applied floor
    must GAP immediately (they were acked cluster-wide and will never be
    re-shipped), not park out the timeout."""
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(1)
        ship = Client()
        try:
            t0 = asyncio.get_running_loop().time()
            with pytest.raises(StatusError) as ei:
                await ship.call(addrs[1], "Kv.apply_replica",
                                KvReplicateReq(
                                    seq=5, version=5, floor=4,
                                    write_keys=[b"k"], write_values=[b"v"],
                                    write_deletes=[False]))
            assert ei.value.code == StatusCode.KV_REPLICA_GAP
            assert asyncio.get_running_loop().time() - t0 < 2.0
        finally:
            await ship.close()
            await cleanup()
    run(body())


def test_replication_failure_cascades_and_heals():
    """Kill the follower mid-burst: in-flight commits fail (ambiguous),
    seq rolls back, and once a follower is back the next commit heals it
    via the GAP + snapshot path — primary and follower converge."""
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            async def put(i):
                async def w(txn):
                    txn.set(b"h%03d" % i, b"v")
                await with_transaction(kv, w)
            await put(0)
            await servers[1].stop()      # follower goes dark

            results = await asyncio.gather(
                *(put(i) for i in range(1, 9)), return_exceptions=True)
            assert all(isinstance(r, BaseException) for r in results), \
                "no commit may ack while a follower is unreachable"

            # follower returns EMPTY (restart-from-wipe) on the same addr
            fol2 = KvService(MemKVEngine(), primary=False,
                             client=services[0].client)
            port = int(addrs[1].rsplit(":", 1)[1])
            srv2 = Server(port=port)
            srv2.add_service(fol2)
            await srv2.start()
            services[0].followers = [srv2.address]
            try:
                await put(100)
                prim = services[0].engine
                ver_p = prim.current_version()
                assert prim.read_at(b"h100", ver_p) == b"v"
                # none of the failed burst survived on the primary
                for i in range(1, 9):
                    assert prim.read_at(b"h%03d" % i, ver_p) is None
                ver_f = fol2.engine.current_version()
                assert fol2.engine.read_at(b"h000", ver_f) == b"v"
                assert fol2.engine.read_at(b"h100", ver_f) == b"v"
                assert fol2.seq == services[0].seq
            finally:
                fol2.stop_decision_gc()
                await srv2.stop()
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_primary_death_mid_pipeline_leaves_gapless_follower():
    """Failover soundness: whatever prefix of the pipeline reached the
    follower is contiguous (no gap, no reorder), every ACKED commit is
    in it, and the promoted follower serves."""
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            acked: set[int] = set()

            async def put(i):
                async def w(txn):
                    txn.set(b"p%03d" % i, b"v")
                try:
                    await with_transaction(kv, w, max_retries=0)
                    acked.add(i)
                except StatusError:
                    pass
            burst = [asyncio.create_task(put(i)) for i in range(30)]
            await asyncio.sleep(0)        # let admissions start
            await servers[0].stop()       # primary dies mid-pipeline
            await asyncio.gather(*burst, return_exceptions=True)

            fol = services[1]
            ver = fol.engine.current_version()
            present = {i for i in range(30)
                       if fol.engine.read_at(b"p%03d" % i, ver) is not None}
            assert acked <= present, "acked write missing on the follower"
            assert fol.seq == len(present), \
                f"follower seq {fol.seq} != applied batches {len(present)}"

            # promote and serve
            await services[0].client.call(addrs[1], "Kv.promote", None)
            kv2 = RemoteKVEngine([addrs[1]])
            try:
                async def w(txn):
                    txn.set(b"after", b"promo")
                await with_transaction(kv2, w)
                txn = kv2.transaction()
                assert await txn.get(b"after") == b"promo"
                for i in sorted(acked):
                    assert await txn.get(b"p%03d" % i) == b"v"
            finally:
                await kv2.close()
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_parked_batch_refused_after_promotion():
    """A replica batch parked in the reorder buffer must NOT apply after
    the node is promoted — it came from the deposed primary's pipeline
    and would write phantom state / collide seqs."""
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(1)
        ship = Client()
        try:
            parked = asyncio.create_task(ship.call(
                addrs[1], "Kv.apply_replica",
                KvReplicateReq(seq=3, version=3, floor=0,
                               write_keys=[b"phantom"],
                               write_values=[b"x"],
                               write_deletes=[False])))
            await asyncio.sleep(0.2)
            assert not parked.done()
            await ship.call(addrs[1], "Kv.promote", None)
            with pytest.raises(StatusError) as ei:
                await parked
            assert ei.value.code == StatusCode.INVALID_ARG
            fol = services[1]
            assert fol.seq == 0
            assert fol.engine.read_at(
                b"phantom", fol.engine.current_version()) is None
        finally:
            await ship.close()
            await cleanup()
    run(body())


def test_durable_primary_crash_mid_burst_keeps_acked_writes():
    """WAL-backed primary stops mid-pipelined-burst; a fresh engine on
    the same dir must hold EVERY acked write (group commit + phase-B
    barrier ordering), with clean prefix replay."""
    async def body(root):
        servers, services, addrs, cleanup = await _mk_cluster(
            0, engine=lambda: WalKVEngine(root, sync="always"))
        kv = RemoteKVEngine(addrs)
        acked: set[int] = set()
        try:
            async def put(i):
                async def w(txn):
                    txn.set(b"d%03d" % i, b"v%d" % i)
                try:
                    await with_transaction(kv, w, max_retries=0)
                    acked.add(i)
                except StatusError:
                    pass
            burst = [asyncio.create_task(put(i)) for i in range(40)]
            # event-driven: stop only once the first ack lands (a fixed
            # sleep here would flake under load)
            while not acked and not all(t.done() for t in burst):
                await asyncio.sleep(0.005)
            await servers[0].stop()           # "crash": server vanishes
            await asyncio.gather(*burst, return_exceptions=True)
            services[0].stop_decision_gc()
            services[0].engine.close()
        finally:
            await kv.close()
            await cleanup()
        assert acked, "burst produced no acks (timing too tight)"
        eng2 = WalKVEngine(root, sync="always")
        try:
            ver = eng2.current_version()
            for i in sorted(acked):
                assert eng2.read_at(b"d%03d" % i, ver) == b"v%d" % i, i
        finally:
            eng2.close()
    with tempfile.TemporaryDirectory() as d:
        run(body(d))


def test_pipeline_respects_prepared_2pc_footprints():
    """A pipelined commit whose mutations land on a prepared (phase-1)
    2PC slice is refused TXN_CONFLICT until the verdict applies."""
    async def body():
        from t3fs_torch.kv.service import KvPrepareReq
        _, services, addrs, cleanup = await _mk_cluster(0)
        kv = RemoteKVEngine(addrs)
        ship = Client()
        try:
            async def seed(txn):
                txn.set(b"slice", b"0")
            await with_transaction(kv, seed)

            txn = kv.transaction()
            assert await txn.get(b"slice") == b"0"
            txn.set(b"slice", b"1")
            await ship.call(addrs[0], "Kv.prepare", KvPrepareReq(
                txn_id="t-fp", body=txn.to_commit_req(),
                decider=[addrs[0]], is_decider=True))

            other = kv.transaction()
            other.set(b"slice", b"clobber")
            with pytest.raises(StatusError) as ei:
                await other.commit()
            assert ei.value.code == StatusCode.TXN_CONFLICT

            from t3fs_torch.kv.service import KvFinishReq
            await ship.call(addrs[0], "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-fp"))
            check = kv.transaction()
            assert await check.get(b"slice") == b"1"
        finally:
            await ship.close()
            await kv.close()
            await cleanup()
    run(body())


def test_remote_txn_roundtrip_and_conflicts():
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(0)
        kv = RemoteKVEngine(addrs)
        try:
            async def w(txn):
                txn.set(b"a", b"1")
                txn.set(b"b", b"2")
            await with_transaction(kv, w)

            txn = kv.transaction()
            assert await txn.get(b"a") == b"1"
            assert await txn.get(b"missing") is None
            rows = await txn.get_range(b"a", b"z")
            assert rows == [(b"a", b"1"), (b"b", b"2")]

            # SSI conflict: two txns read-modify-write the same key
            t1, t2 = kv.transaction(), kv.transaction()
            v1 = await t1.get(b"a")
            v2 = await t2.get(b"a")
            t1.set(b"a", v1 + b"x")
            t2.set(b"a", v2 + b"y")
            await t1.commit()
            with pytest.raises(StatusError) as ei:
                await t2.commit()
            assert ei.value.code == StatusCode.TXN_CONFLICT

            # read-your-writes + range overlay
            t3 = kv.transaction()
            t3.set(b"c", b"3")
            t3.clear(b"b")
            assert await t3.get(b"c") == b"3"
            rows = await t3.get_range(b"a", b"z")
            assert rows == [(b"a", b"1x"), (b"c", b"3")]
            await t3.commit()
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_sync_replication_and_promote_failover():
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            for i in range(5):
                async def w(txn, i=i):
                    txn.set(f"k{i}".encode(), f"v{i}".encode())
                await with_transaction(kv, w)
            # every commit is on the follower BEFORE the client was acked
            assert services[1].seq == 5
            assert services[1].engine.read_at(
                b"k4", services[1].engine.current_version()) == b"v4"

            # primary dies; follower promoted; client fails over
            await servers[0].stop()
            await Client().call(addrs[1], "Kv.promote", None)
            services[1].followers = []
            txn = kv.transaction()
            assert await txn.get(b"k2") == b"v2"   # acked data survived
            txn.set(b"after", b"failover")
            await txn.commit()
            assert services[1].engine.read_at(
                b"after", services[1].engine.current_version()) == b"failover"
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_replica_gap_triggers_snapshot_catchup():
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            async def w(txn):
                txn.set(b"x", b"1")
            await with_transaction(kv, w)
            # follower "restarts" empty and behind
            services[1].engine.clear_all()
            services[1].seq = 0

            async def w2(txn):
                txn.set(b"y", b"2")
            await with_transaction(kv, w2)
            # gap detected -> snapshot pushed -> follower has BOTH keys
            assert services[0].snapshots_pushed == 1
            eng = services[1].engine
            ver = eng.current_version()
            assert eng.read_at(b"x", ver) == b"1"
            assert eng.read_at(b"y", ver) == b"2"
            assert services[1].seq == services[0].seq
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_unreachable_follower_fails_commit():
    """Sync replication: no acked write may exist only on the primary."""
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine([addrs[0]])
        try:
            await servers[1].stop()   # follower gone
            txn = kv.transaction()
            txn.set(b"k", b"v")
            with pytest.raises(StatusError) as ei:
                await txn.commit()
            # surfaced as MAYBE_COMMITTED: with multiple followers, another
            # follower may already hold the batch and resurrect it after a
            # failover — the client must not blind-retry
            assert ei.value.code == StatusCode.TXN_MAYBE_COMMITTED
            assert "KV_REPLICATION_FAILED" in str(ei.value) or \
                   "unreachable" in str(ei.value)
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_meta_store_over_remote_kv():
    """The real consumer: MetaStore runs unmodified on the remote engine."""
    async def body():
        _, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        try:
            from t3fs_torch.meta.store import ChainAllocator, MetaStore
            from t3fs_torch.mgmtd.types import (
                ChainInfo, ChainTable, ChainTargetInfo, PublicTargetState,
                RoutingInfo,
            )
            routing = RoutingInfo(version=1)
            routing.chains[1] = ChainInfo(1, 1, [
                ChainTargetInfo(101, 1, PublicTargetState.SERVING)])
            routing.chain_tables[1] = ChainTable(1, [1])
            st = MetaStore(kv, ChainAllocator(lambda: routing))
            await st.mkdirs("/proj")
            ino, _ = await st.create("/proj/data.bin", chunk_size=4096)
            got = await st.stat("/proj/data.bin")
            assert got.inode_id == ino.inode_id
            await st.rename("/proj/data.bin", "/proj/renamed.bin")
            names = [e.name for e in await st.readdir("/proj")]
            assert names == ["renamed.bin"]
            # and the follower holds every meta record (promotable)
            eng = services[1].engine
            rows = eng.range_at(b"", b"\xff" * 8, eng.current_version())
            assert len(rows) > 3
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_failed_replication_leaves_primary_unchanged():
    """Commit order is check -> replicate -> apply: a KV_REPLICATION_FAILED
    commit must leave NO trace on the primary (no phantom reads, and a
    retried with_transaction re-executes against pristine state)."""
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine([addrs[0]])
        try:
            await servers[1].stop()
            txn = kv.transaction()
            txn.set(b"ghost", b"v")
            with pytest.raises(StatusError):
                await txn.commit()
            # the primary's engine must not contain the failed write
            eng = services[0].engine
            assert eng.read_at(b"ghost", eng.current_version()) is None
            assert services[0].seq == 0      # seq allocation rolled back
        finally:
            await kv.close()
            await cleanup()
    run(body())


def test_version_clock_survives_failover():
    """Followers track the primary's MVCC clock (batch + snapshot carry it),
    so post-promotion version numbers stay comparable: a conflict against a
    pre-failover read_version is still detected."""
    async def body():
        servers, services, addrs, cleanup = await _mk_cluster(1)
        kv = RemoteKVEngine(addrs)
        cli = Client()
        try:
            for i in range(3):                   # advance the primary clock
                txn = kv.transaction()
                txn.set(f"k{i}".encode(), b"v")
                await txn.commit()
            primary_ver = services[0].engine.current_version()
            assert services[1].engine.current_version() == primary_ver

            # a client pins a read_version on the OLD primary
            txn = kv.transaction()
            assert await txn.get(b"k0") == b"v"
            pinned = txn.read_version

            # failover: old primary dies, follower promoted
            await servers[0].stop()
            await cli.call(addrs[1], "Kv.promote", None)

            # another writer updates k0 on the NEW primary (version above
            # the old clock, not re-counted from 1)
            txn2 = kv.transaction()
            txn2.set(b"k0", b"v2")
            await txn2.commit()
            assert services[1].engine.current_version() > primary_ver

            # the pinned transaction now conflicts -- NOT silently commits
            txn.set(b"other", b"x")
            with pytest.raises(StatusError) as ei:
                await txn.commit()
            assert ei.value.code in (StatusCode.TXN_CONFLICT,
                                     StatusCode.TXN_RETRYABLE,
                                     StatusCode.TXN_MAYBE_COMMITTED)
            assert pinned <= primary_ver
        finally:
            await cli.close()
            await kv.close()
            await cleanup()
    run(body())


def test_commit_timeout_is_maybe_committed():
    """A mutating commit whose RPC times out must surface
    TXN_MAYBE_COMMITTED, not blind-retry (double-apply hazard)."""
    async def body():
        from t3fs_torch.net.server import rpc_method, service

        @service("Kv")
        class BlackholeKv:
            @rpc_method
            async def get_version(self, req, payload, conn):
                from t3fs_torch.kv.service import KvCommitRsp
                return KvCommitRsp(version=1), b""

            @rpc_method
            async def commit(self, req, payload, conn):
                await asyncio.sleep(30)          # never answers in time

        srv = Server()
        srv.add_service(BlackholeKv())
        await srv.start()
        kv = RemoteKVEngine([srv.address], timeout_s=0.3)
        try:
            txn = kv.transaction()
            txn.set(b"k", b"v")
            with pytest.raises(StatusError) as ei:
                await txn.commit()
            assert ei.value.code == StatusCode.TXN_MAYBE_COMMITTED
        finally:
            await kv.close()
            await srv.stop()
    run(body())


def test_maybe_committed_retry_opt_in():
    """with_transaction retries TXN_MAYBE_COMMITTED only for replay-safe
    callers (meta idempotent ops opt in; everyone else sees the ambiguity)."""
    async def body():
        from t3fs_torch.kv.engine import MemKVEngine, with_transaction
        from t3fs_torch.utils.status import make_error

        class FlakyCommitEngine(MemKVEngine):
            def __init__(self):
                super().__init__()
                self.failures = 1

            async def commit_async(self, txn):
                if self.failures > 0:
                    self.failures -= 1
                    raise make_error(StatusCode.TXN_MAYBE_COMMITTED, "rpc timeout")
                self._commit(txn)

        async def put(txn):
            txn.set(b"k", b"v")

        eng = FlakyCommitEngine()
        with pytest.raises(StatusError) as ei:
            await with_transaction(eng, put)
        assert ei.value.code == StatusCode.TXN_MAYBE_COMMITTED

        eng2 = FlakyCommitEngine()
        await with_transaction(eng2, put, retry_maybe_committed=True)
        ver = eng2.current_version()
        assert eng2.read_at(b"k", ver) == b"v"
    run(body())


# ------------------------------------------------ against the reference

KEYS = [b"k%02d" % i for i in range(24)]


def make_steps(seed: int, n: int) -> list[tuple]:
    """n steps over a small key space: transactions that read, set, clear
    and clear ranges; read-modify-write races whose second commit must
    conflict; range reads with and without a limit; and commits sent
    straight to a follower, which must refuse them."""
    rng = np.random.default_rng(seed)

    def key():
        return KEYS[int(rng.integers(0, len(KEYS)))]

    steps = []
    for _ in range(n):
        r = rng.random()
        if r < 0.55:
            reads = [key() for _ in range(int(rng.integers(0, 3)))]
            sets = [(key(), rng.bytes(int(rng.integers(0, 200))))
                    for _ in range(int(rng.integers(1, 4)))]
            clears = [key()] if rng.random() < 0.2 else []
            crange = None
            if rng.random() < 0.1:
                lo = int(rng.integers(0, len(KEYS) - 1))
                crange = (KEYS[lo], KEYS[min(len(KEYS) - 1,
                                             lo + int(rng.integers(1, 5)))])
            steps.append(("txn", reads, sets, clears, crange))
        elif r < 0.75:
            steps.append(("race", key(), rng.bytes(8), rng.bytes(8)))
        elif r < 0.9:
            lo = int(rng.integers(0, len(KEYS) - 1))
            steps.append(("range", KEYS[lo], b"k99", int(rng.integers(0, 4))))
        else:
            steps.append(("follower_commit", key(), rng.bytes(4)))
    return steps


async def drive(c, kv, follower: str, steps) -> list:
    """Run steps through RemoteKVEngine kv of package c; every read and
    every commit's outcome (0 or its StatusCode) in order."""
    log = []
    for st in steps:
        kind = st[0]
        if kind == "txn":
            _, reads, sets, clears, crange = st
            txn = kv.transaction()
            got = [await txn.get(k) for k in reads]
            for k, v in sets:
                txn.set(k, v)
            for k in clears:
                txn.clear(k)
            if crange:
                txn.clear_range(*crange)
            try:
                await txn.commit()
                out = 0
            except c.status.StatusError as e:
                out = D.code_of(e)
            log.append((kind, got, out))
        elif kind == "race":
            _, k, a, b = st
            t1, t2 = kv.transaction(), kv.transaction()
            v1, v2 = await t1.get(k), await t2.get(k)
            t1.set(k, (v1 or b"") + a)
            t2.set(k, (v2 or b"") + b)
            outs = []
            for t in (t1, t2):
                try:
                    await t.commit()
                    outs.append(0)
                except c.status.StatusError as e:
                    outs.append(D.code_of(e))
            log.append((kind, v1, outs))
        elif kind == "range":
            _, lo, hi, limit = st
            txn = kv.transaction()
            log.append((kind, await txn.get_range(lo, hi, limit=limit)))
        else:
            _, k, v = st
            try:
                await kv.client.call(follower, "Kv.commit",
                                     c.service.KvCommitReq(
                                         write_keys=[k], write_values=[v],
                                         write_deletes=[False]))
                log.append((kind, 0))
            except c.status.StatusError as e:
                log.append((kind, D.code_of(e)))
    return log


async def replicated_run(primary: str, follower: str, client: str,
                         root) -> tuple[list, dict]:
    """One seeded history on a primary of package `primary` shipping to a
    follower of package `follower`, driven by package `client`'s
    RemoteKVEngine: the steps, then a fresh empty follower that the
    primary catches up by snapshot (KV_REPLICA_GAP), more steps, then the
    primary stopped, the follower promoted and the client failed over.
    -> (log, each node's WAL files)."""
    P, F, C = D.PKGS[primary], D.PKGS[follower], D.PKGS[client]
    steps = make_steps(D.SEED, 60)
    log = []
    p = await D.Node(P, D.wal_engine(P, f"{root}/p")).start()
    f = await D.Node(F, D.wal_engine(F, f"{root}/f"), primary=False).start()
    p.svc.followers = [f.address]
    kv = C.remote.RemoteKVEngine([p.address, f.address])
    f2 = None
    try:
        log += await drive(C, kv, f.address, steps[:40])
        log.append(("seqs", p.svc.seq, f.svc.seq,
                    p.engine.current_version(), f.engine.current_version()))
        assert D.dump_engine(p.engine) == D.dump_engine(f.engine)
        # the follower is replaced by an empty one: the next batch finds a
        # gap and the primary pushes a snapshot
        await f.stop()
        f.engine.close()
        f2 = await D.Node(F, D.wal_engine(F, f"{root}/f2"),
                          primary=False).start()
        p.svc.followers = [f2.address]
        await kv.close()
        kv = C.remote.RemoteKVEngine([p.address, f2.address])
        log += await drive(C, kv, f2.address, steps[40:50])
        log.append(("caught_up", f2.svc.seq, D.dump_engine(f2.engine)
                    == D.dump_engine(p.engine)))
        # failover: the primary goes, the follower is promoted
        await p.srv.stop()
        await kv.client.call(f2.address, "Kv.promote", None)
        f2.svc.followers = []
        log += await drive(C, kv, f2.address, steps[50:])
        log.append(("promoted", f2.svc.seq, f2.svc.primary,
                    D.dump_engine(f2.engine)))
    finally:
        await kv.close()
        await p.stop()
        if f2 is not None:
            await f2.stop()
        p.engine.close()
        if f2 is not None:
            f2.engine.close()
    return log, {d: D.files(f"{root}/{d}") for d in ("p", "f", "f2")}


def test_replicated_history_matches_reference(tmp_path, monkeypatch):
    """The same seeded history through each package's primary, follower
    and client: equal reads, commit outcomes (TXN_CONFLICT, KV_NOT_PRIMARY),
    seqs and versions, an equal snapshot catch-up and failover, and WAL
    files byte for byte on every node."""
    out = {}
    for name in ("ref", "port"):
        D.pin(monkeypatch)
        out[name] = run(replicated_run(name, name, name, tmp_path / name))
    log, wal = out["ref"]
    codes = [e[-1] for e in log if e[0] in ("txn", "follower_commit")]
    assert int(StatusCode.KV_NOT_PRIMARY) in codes
    assert any(e[0] == "race" and e[2][1] == int(StatusCode.TXN_CONFLICT)
               for e in log)
    caught = next(e for e in log if e[0] == "caught_up")
    assert caught[1] > 0 and caught[2] is True
    assert out["port"][0] == log
    assert out["port"][1] == wal


@pytest.mark.parametrize("primary,follower,client", [
    ("port", "ref", "ref"), ("ref", "port", "port"),
    ("ref", "ref", "port"), ("port", "port", "ref")])
def test_kv_wire_across_packages(tmp_path, monkeypatch, primary, follower,
                                 client):
    """Each package's RemoteKVEngine against the other's KvService group,
    and a primary of one package shipping batches and a snapshot to a
    follower of the other: the history's log equals the reference's own."""
    D.pin(monkeypatch)
    want, _ = run(replicated_run("ref", "ref", "ref", tmp_path / "ref"))
    D.pin(monkeypatch)
    got, _ = run(replicated_run(primary, follower, client, tmp_path / "mix"))
    assert got == want
