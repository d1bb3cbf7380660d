"""The port's range-sharded KV (t3fs_torch.kv.shard: ShardMap,
ShardedKVEngine and its 2PC coordinator, over the service's 2PC
participant) against the JAX package's: every case of
tests/test_kv_shard.py that runs in one process, on the port; then one
seeded cross-shard history on each package's replicated groups with equal
reads, outcomes (TXN_CONFLICT, KV_WRONG_SHARD), seqs, decision records,
rows and WAL bytes; each package's ShardedKVEngine against the other's
groups; MetaStore over each package's sharded KV with the same rows in
each shard; and a durable 2PC that a restart recovers, written and
recovered by either package.  time.time, the txn ids, the meta store's
ids and the samplers' random streams are pinned in both packages with
monkeypatch (tests/torch_kv_diff.py); nothing in either package changes
for it.  The multi-process deployment (DevCluster(kv_shards=2)) is in
tests/test_torch_app_cluster.py."""

import asyncio

import numpy as np
import pytest

import torch_kv_diff as D
from t3fs_torch.kv.engine import MemKVEngine, with_transaction
from t3fs_torch.kv.service import KvService
from t3fs_torch.kv.shard import (
    KEY_MAX, ShardMap, ShardRange, ShardedKVEngine,
)
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.status import StatusCode, StatusError


def run(coro):
    return asyncio.run(coro)


async def _mk_sharded(split: bytes, replicas_per_shard: int = 1,
                      prepare_timeout_s: float = 30.0):
    """Two shard groups split at `split`; each group optionally replicated."""
    servers, services = [], []
    ship = Client()
    shard_addrs: list[list[str]] = []
    for _shard in range(2):
        addrs = []
        group = []
        for i in range(replicas_per_shard):
            svc = KvService(MemKVEngine(), primary=(i == 0), client=ship,
                            prepare_timeout_s=prepare_timeout_s)
            srv = Server()
            srv.add_service(svc)
            await srv.start()
            servers.append(srv)
            group.append(svc)
            addrs.append(srv.address)
        group[0].followers = addrs[1:]
        services.append(group)
        shard_addrs.append(addrs)
    smap = ShardMap(ranges=[
        ShardRange(begin=b"", end=split, addresses=shard_addrs[0]),
        ShardRange(begin=split, end=KEY_MAX, addresses=shard_addrs[1]),
    ])
    kv = ShardedKVEngine(smap)

    async def cleanup():
        await kv.close()
        await ship.close()
        for s in servers:
            await s.stop()
    return kv, services, cleanup


def test_shard_map_validation():
    with pytest.raises(StatusError):
        ShardMap(ranges=[]).validate()
    with pytest.raises(StatusError):   # gap
        ShardMap(ranges=[
            ShardRange(b"", b"m", ["a:1"]),
            ShardRange(b"n", KEY_MAX, ["a:2"])]).validate()
    with pytest.raises(StatusError):   # doesn't reach KEY_MAX
        ShardMap(ranges=[ShardRange(b"", b"m", ["a:1"])]).validate()
    ok = ShardMap(ranges=[ShardRange(b"", b"m", ["a:1"]),
                          ShardRange(b"m", KEY_MAX, ["a:2"])]).validate()
    assert ok.shard_of(b"a") == 0 and ok.shard_of(b"m") == 1
    assert ok.shards_overlapping(b"a", b"z") == [(0, b"a", b"m"),
                                                 (1, b"m", b"z")]


def test_single_shard_and_cross_shard_commits():
    async def body():
        kv, _, cleanup = await _mk_sharded(b"m")
        try:
            # single-shard txns use the one-shot path
            async def one(txn):
                txn.set(b"alpha", b"1")
            await with_transaction(kv, one)

            # cross-shard txn: both sides land atomically
            async def both(txn):
                txn.set(b"beta", b"B")       # shard 0
                txn.set(b"omega", b"O")      # shard 1
            await with_transaction(kv, both)

            t = kv.transaction()
            assert await t.get(b"alpha") == b"1"
            assert await t.get(b"beta") == b"B"
            assert await t.get(b"omega") == b"O"
            # cross-shard range read merges in key order
            rows = await t.get_range(b"a", b"z")
            assert rows == [(b"alpha", b"1"), (b"beta", b"B"),
                            (b"omega", b"O")]
        finally:
            await cleanup()
    run(body())


def test_cross_shard_conflict_aborts_whole_txn():
    """A write racing ANY shard's reads aborts the whole cross-shard txn
    (per-shard SSI revalidated inside the locked prepare cut)."""
    async def body():
        kv, _, cleanup = await _mk_sharded(b"m")
        try:
            async def seed(txn):
                txn.set(b"acct-a", b"100")   # shard 0
                txn.set(b"zcct-b", b"100")   # shard 1
            await with_transaction(kv, seed)

            t1 = kv.transaction()            # transfer a -> b
            a = int(await t1.get(b"acct-a"))
            b = int(await t1.get(b"zcct-b"))
            # concurrent writer bumps acct-a before t1 commits
            t2 = kv.transaction()
            t2.set(b"acct-a", b"999")
            await t2.commit()

            t1.set(b"acct-a", str(a - 10).encode())
            t1.set(b"zcct-b", str(b + 10).encode())
            with pytest.raises(StatusError) as ei:
                await t1.commit()
            assert ei.value.code == StatusCode.TXN_CONFLICT
            # NOTHING from t1 leaked into either shard
            t3 = kv.transaction()
            assert await t3.get(b"acct-a") == b"999"
            assert await t3.get(b"zcct-b") == b"100"
        finally:
            await cleanup()
    run(body())


def test_prepare_expiry_releases_shard():
    """A crashed coordinator's prepare expires and the shard accepts new
    commits (the lock is not leaked)."""
    async def body():
        kv, services, cleanup = await _mk_sharded(
            b"m", prepare_timeout_s=0.3)
        try:
            from t3fs_torch.kv.service import KvPrepareReq, KvCommitReq
            # manually prepare on shard 0 and "crash" (never finish)
            group0 = kv.groups[0]
            await group0._call("Kv.prepare", KvPrepareReq(
                txn_id="dead-coordinator",
                body=KvCommitReq(write_keys=[b"k"], write_values=[b"v"],
                                 write_deletes=[False])))
            # a new commit must get through once the prepare expires
            async def w(txn):
                txn.set(b"after", b"1")
            await asyncio.wait_for(with_transaction(kv, w), timeout=5.0)
            t = kv.transaction()
            assert await t.get(b"after") == b"1"
            # the expired txn's write was aborted, never applied
            assert await t.get(b"k") is None
        finally:
            await cleanup()
    run(body())


def test_cross_shard_with_replicated_groups():
    """2PC over shard groups that are themselves sync-replicated; follower
    state matches the primary after a cross-shard commit."""
    async def body():
        kv, services, cleanup = await _mk_sharded(b"m",
                                                  replicas_per_shard=2)
        try:
            async def both(txn):
                txn.set(b"left", b"L")
                txn.set(b"zright", b"R")
            await with_transaction(kv, both)
            for group, key, val in ((services[0], b"left", b"L"),
                                    (services[1], b"zright", b"R")):
                for svc in group:        # primary AND follower hold it
                    got = svc.engine.read_at(key,
                                             svc.engine.current_version())
                    assert got == val, (key, svc.primary)
        finally:
            await cleanup()
    run(body())


def test_meta_store_over_sharded_kv():
    """The meta store runs unchanged over two shard groups — inode and
    dirent prefixes land on different shards, so ordinary meta ops are
    cross-shard transactions."""
    async def body():
        # split between DENT and INOD prefixes: creates touch both shards
        kv, _, cleanup = await _mk_sharded(b"G")
        try:
            from t3fs_torch.meta.store import ChainAllocator, MetaStore
            from t3fs_torch.mgmtd.types import (
                ChainInfo, ChainTable, ChainTargetInfo, PublicTargetState,
                RoutingInfo)
            routing = RoutingInfo()
            for c in range(1, 4):
                routing.chains[c] = ChainInfo(c, 1, [ChainTargetInfo(
                    c * 100, 1, PublicTargetState.SERVING)])
            routing.chain_tables[1] = ChainTable(1, list(routing.chains))
            store = MetaStore(kv, ChainAllocator(lambda: routing,
                                                 default_chunk_size=4096))
            await store.mkdirs("/a/b")
            inode, _ = await store.create("/a/b/f", session_client="c1")
            got = await store.stat("/a/b/f")
            assert got.inode_id == inode.inode_id
            await store.rename("/a/b/f", "/a/g")
            assert (await store.stat("/a/g")).inode_id == inode.inode_id
            entries = await store.readdir("/a")
            assert sorted(e.name for e in entries) == ["b", "g"]
            await store.remove("/a", recursive=True)
            with pytest.raises(StatusError):
                await store.stat("/a")
        finally:
            await cleanup()
    run(body())


def test_open_kv_engine_shards_spec():
    from t3fs_torch.kv.wal_engine import open_kv_engine
    eng = open_kv_engine("shards:h1:1,h2:1;494e4f44;h3:1")
    assert len(eng.groups) == 2
    assert eng.map.ranges[0].end == b"INOD"
    assert eng.map.shard_of(b"DENT") == 0      # DENT < INOD
    assert eng.map.shard_of(b"INOD\x00") == 1
    import pytest as _p
    with _p.raises(ValueError):
        open_kv_engine("shards:h1:1;zz")       # bad alternation/hex


def test_durable_2pc_laggard_shard_heals_to_commit():
    """Coordinator dies between phase-2 calls: the decider committed, the
    laggard shard's resolver asks the decider and APPLIES its slice — no
    torn transaction."""
    async def body():
        kv, services, cleanup = await _mk_sharded(b"m",
                                                  prepare_timeout_s=0.3)
        try:
            from t3fs_torch.kv.service import KvFinishReq, KvPrepareReq, KvCommitReq
            dec_addrs = kv.map.ranges[0].addresses
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            await kv.groups[0]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-heal", body=mk(b"a", b"1"),
                decider=dec_addrs, is_decider=True))
            await kv.groups[1]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-heal", body=mk(b"z", b"2"),
                decider=dec_addrs, is_decider=False))
            # phase 2 reaches ONLY the decider; coordinator "dies"
            await kv.groups[0]._call("Kv.commit_prepared",
                                     KvFinishReq(txn_id="t-heal"))
            # shard 1 must self-heal to COMMIT via the decision record
            async def committed():
                t = kv.transaction()
                return (await t.get(b"a"), await t.get(b"z"))
            for _ in range(100):
                a, z = await committed()
                if a == b"1" and z == b"2":
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError(f"laggard never healed: {a!r} {z!r}")
        finally:
            await cleanup()
    run(body())


def test_durable_2pc_presumed_abort_when_undecided():
    """Coordinator dies after phase 1: the decider tombstone-aborts on
    expiry, the other shard follows, and a LATE commit_prepared cannot
    resurrect the transaction."""
    async def body():
        kv, services, cleanup = await _mk_sharded(b"m",
                                                  prepare_timeout_s=0.3)
        try:
            from t3fs_torch.kv.service import KvFinishReq, KvPrepareReq, KvCommitReq
            dec_addrs = kv.map.ranges[0].addresses
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            await kv.groups[0]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-dead", body=mk(b"a", b"1"),
                decider=dec_addrs, is_decider=True))
            await kv.groups[1]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-dead", body=mk(b"z", b"2"),
                decider=dec_addrs, is_decider=False))
            # footprint locks: an UNRELATED commit flows immediately,
            # while the prepared txn is still live — it no longer waits
            # out the expiry behind a shard-wide commit lock
            assert "t-dead" in services[0][0]._prepared
            async def w(txn):
                txn.set(b"after", b"y")
                txn.set(b"zafter", b"y")
            await asyncio.wait_for(with_transaction(kv, w), timeout=8.0)
            # both must resolve to ABORT on expiry (presumed abort)
            from t3fs_torch.kv.service import KvDecisionReq
            for _ in range(200):
                rsp = await kv.groups[0]._call(
                    "Kv.get_decision", KvDecisionReq(txn_id="t-dead"))
                if rsp.decision == "A":
                    break
                await asyncio.sleep(0.05)
            assert rsp.decision == "A", rsp
            t = kv.transaction()
            assert await t.get(b"a") is None
            assert await t.get(b"z") is None
            # a late phase-2 on the decider is refused (tombstone)
            with pytest.raises(StatusError) as ei:
                await kv.groups[0]._call("Kv.commit_prepared",
                                         KvFinishReq(txn_id="t-dead"))
            assert ei.value.code == StatusCode.KV_TXN_NOT_FOUND
        finally:
            await cleanup()
    run(body())


def test_durable_2pc_shard_restart_recovers_prepared():
    """A shard primary restarts holding a durable prepared record; the
    recovered service finishes the txn per the decider's verdict."""
    async def body():
        from t3fs_torch.kv.service import (
            KvFinishReq, KvPrepareReq, KvCommitReq, KvService,
        )
        from t3fs_torch.kv.engine import MemKVEngine
        from t3fs_torch.net.client import Client
        from t3fs_torch.net.server import Server

        ship = Client()
        # decider shard (group 0)
        dec_engine = MemKVEngine()
        dec_svc = KvService(dec_engine, client=ship, prepare_timeout_s=0.3)
        dec_srv = Server(); dec_srv.add_service(dec_svc)
        await dec_srv.start()
        # crashing shard (group 1): engine survives, service restarts
        eng = MemKVEngine()
        svc1 = KvService(eng, client=ship, prepare_timeout_s=600.0)
        srv1 = Server(); srv1.add_service(svc1)
        await srv1.start()
        try:
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            dec = [dec_srv.address]
            await ship.call(dec_srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-rec", body=mk(b"a", b"1"),
                decider=dec, is_decider=True))
            await ship.call(srv1.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-rec", body=mk(b"z", b"2"),
                decider=dec, is_decider=False))
            await ship.call(dec_srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-rec"))
            # "crash" shard 1's service (prepared entry lost, engine kept)
            await srv1.stop()
            for _t in list(svc1._prepared.values()):
                _t[1].cancel()
            # restart over the same engine state
            svc1b = KvService(eng, client=ship, prepare_timeout_s=0.2)
            srv1b = Server(); srv1b.add_service(svc1b)
            await srv1b.start()
            assert await svc1b.recover_prepared() == 1
            for _ in range(100):
                if eng.read_at(b"z", eng.current_version()) == b"2":
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError("recovered prepare never applied")
            await srv1b.stop()
        finally:
            await dec_srv.stop()
            try:
                await srv1.stop()
            except Exception:
                pass
            await ship.close()
    run(body())


def test_2pc_stale_follower_u_does_not_tear_committed_txn():
    """A stale/re-seeded decider FOLLOWER answering
    decision='U' (authoritative=False) must NOT make a participant
    presume abort when the decider's PRIMARY durably COMMITTED.  The
    resolver must skip non-authoritative 'U' and keep asking."""
    async def body():
        from t3fs_torch.kv.service import (
            KvFinishReq, KvPrepareReq, KvCommitReq, KvService,
        )
        ship = Client()
        # decider primary: will durably COMMIT the txn
        dec_svc = KvService(MemKVEngine(), client=ship,
                            prepare_timeout_s=600.0)
        dec_srv = Server(); dec_srv.add_service(dec_svc)
        await dec_srv.start()
        # stale follower of the decider group: restarted EMPTY (no DEC /
        # PREP records), answers 'U' non-authoritatively
        stale_svc = KvService(MemKVEngine(), primary=False, client=ship)
        stale_srv = Server(); stale_srv.add_service(stale_svc)
        await stale_srv.start()
        # participant shard with a short expiry so its resolver runs
        part_eng = MemKVEngine()
        part_svc = KvService(part_eng, client=ship, prepare_timeout_s=0.3)
        part_srv = Server(); part_srv.add_service(part_svc)
        await part_srv.start()
        try:
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            # the STALE follower is listed FIRST: pre-fix, its 'U' was
            # taken at face value and the participant tore the txn
            dec = [stale_srv.address, dec_srv.address]
            await ship.call(dec_srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-stale", body=mk(b"a", b"1"),
                decider=dec, is_decider=True))
            await ship.call(part_srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-stale", body=mk(b"z", b"2"),
                decider=dec, is_decider=False))
            # decider COMMITS durably; coordinator "dies" before phase 2
            # reaches the participant (we just don't send it)
            await ship.call(dec_srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-stale"))
            # participant's expiry resolver must land on COMMIT
            for _ in range(100):
                if part_eng.read_at(b"z",
                                    part_eng.current_version()) == b"2":
                    break
                await asyncio.sleep(0.1)
            else:
                raise AssertionError(
                    "participant tore a decider-committed txn "
                    "(or never resolved)")
        finally:
            for s in (dec_srv, stale_srv, part_srv):
                await s.stop()
            await ship.close()
    run(body())


def test_2pc_late_prepare_after_abort_tombstoned():
    """A prepare landing AFTER abort_prepared already
    answered OK (no entry yet) must be refused immediately instead of
    registering and holding the shard-wide commit lock until expiry."""
    async def body():
        from t3fs_torch.kv.service import (
            KvCommitReq, KvFinishReq, KvPrepareReq, KvService,
        )
        ship = Client()
        svc = KvService(MemKVEngine(), client=ship,
                        prepare_timeout_s=600.0)
        srv = Server(); srv.add_service(svc)
        await srv.start()
        try:
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            # coordinator timed out and aborted BEFORE the prepare landed
            await ship.call(srv.address, "Kv.abort_prepared",
                            KvFinishReq(txn_id="t-late"))
            with pytest.raises(StatusError) as ei:
                await ship.call(srv.address, "Kv.prepare", KvPrepareReq(
                    txn_id="t-late", body=mk(b"a", b"1"),
                    decider=[srv.address], is_decider=False))
            assert ei.value.code == StatusCode.KV_TXN_NOT_FOUND
            # the shard's commit lock is FREE: an unrelated commit
            # completes promptly (pre-fix: stalled prepare_timeout_s)
            await asyncio.wait_for(
                ship.call(srv.address, "Kv.commit", mk(b"k", b"v")),
                timeout=2.0)
        finally:
            await srv.stop()
            await ship.close()
    run(body())


def test_2pc_duplicate_prepare_idempotent():
    """Duplicate delivery of a prepare must ack
    idempotently — not re-register (leaking the first timer) nor
    deadlock on the commit lock the first prepare holds."""
    async def body():
        from t3fs_torch.kv.service import (
            KvCommitReq, KvFinishReq, KvPrepareReq, KvService,
        )
        ship = Client()
        eng = MemKVEngine()
        svc = KvService(eng, client=ship, prepare_timeout_s=600.0)
        srv = Server(); srv.add_service(svc)
        await srv.start()
        try:
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            preq = KvPrepareReq(txn_id="t-dup", body=mk(b"a", b"1"),
                                decider=[srv.address], is_decider=True)
            await ship.call(srv.address, "Kv.prepare", preq)
            # duplicate: must return (not deadlock) and keep ONE entry
            await asyncio.wait_for(
                ship.call(srv.address, "Kv.prepare", preq), timeout=2.0)
            assert list(svc._prepared) == ["t-dup"]
            await ship.call(srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-dup"))
            assert eng.read_at(b"a", eng.current_version()) == b"1"
            # lock released exactly once: a follow-up commit flows
            await asyncio.wait_for(
                ship.call(srv.address, "Kv.commit", mk(b"k", b"v")),
                timeout=2.0)
        finally:
            await srv.stop()
            await ship.close()
    run(body())


def test_decision_record_gc():
    """ABORT tombstones expire by TTL (losing one degrades to the same
    abort verdict); COMMIT records expire only when every embedded
    participant group confirms resolution — a down/unconfirmed
    participant keeps the verdict alive (no TTL-induced torn txns)."""
    async def body():
        import struct
        import time as _time
        from t3fs_torch.kv.engine import MemKVEngine, Transaction
        from t3fs_torch.kv.service import DEC_PREFIX, KvService
        from t3fs_torch.utils import serde as _serde

        svc = KvService(MemKVEngine(), client=Client())
        # a live, authoritative, fully-resolved participant group
        peer = KvService(MemKVEngine())
        peer_srv = Server(); peer_srv.add_service(peer)
        await peer_srv.start()
        eng = svc.engine
        drop = Transaction(eng, read_version=eng.current_version())
        old_ts = struct.pack("<d", _time.time() - 7200)
        new_ts = struct.pack("<d", _time.time())
        # old C with NO participant info (legacy): must be kept forever
        drop._writes[DEC_PREFIX + b"old-c"] = b"C" + old_ts
        # old C whose only participant group is UNREACHABLE: kept
        drop._writes[DEC_PREFIX + b"down-c"] = \
            b"C" + old_ts + _serde.dumps([["127.0.0.1:1"]])
        # old C with an EMPTY participant list: indistinguishable from an
        # unpopulated field -> kept forever like legacy
        drop._writes[DEC_PREFIX + b"empty-c"] = \
            b"C" + old_ts + _serde.dumps([])
        # old C whose participant (a live PRIMARY) confirms resolution: gc
        drop._writes[DEC_PREFIX + b"done-c"] = \
            b"C" + old_ts + _serde.dumps([[peer_srv.address]])
        drop._writes[DEC_PREFIX + b"old-a"] = b"A" + old_ts
        drop._writes[DEC_PREFIX + b"legacy"] = b"A"       # pre-ts format
        drop._writes[DEC_PREFIX + b"new"] = b"C" + new_ts
        await eng.commit_async(drop)

        assert await svc.gc_decisions(ttl_s=3600.0) == 3  # done-c, old-a, legacy
        ver = eng.current_version()
        assert eng.read_at(DEC_PREFIX + b"old-c", ver) is not None
        assert eng.read_at(DEC_PREFIX + b"down-c", ver) is not None
        assert eng.read_at(DEC_PREFIX + b"empty-c", ver) is not None
        assert eng.read_at(DEC_PREFIX + b"done-c", ver) is None
        await peer_srv.stop()
        assert eng.read_at(DEC_PREFIX + b"old-a", ver) is None
        assert eng.read_at(DEC_PREFIX + b"legacy", ver) is None
        assert eng.read_at(DEC_PREFIX + b"new", ver) is not None
        # decision still readable through the RPC after format change
        from t3fs_torch.kv.service import KvDecisionReq
        rsp, _ = await svc.get_decision(KvDecisionReq(txn_id="new"), b"", None)
        assert rsp.decision == "C"
    run(body())


def test_durable_2pc_push_resolution_beats_poll():
    """Decider-side push: when the coordinator dies
    after phase 2 reached only the decider, the decider PUSHES its
    verdict to the other participants immediately.  Poll timers are set
    far too long to matter, so fast convergence proves the push path —
    for both the COMMIT verdict and the expiry-ABORT verdict."""
    async def body():
        from t3fs_torch.kv.service import KvFinishReq, KvPrepareReq, KvCommitReq
        import time as _t

        # --- COMMIT push: poll timer 60s, must converge in ~2s ---
        kv, services, cleanup = await _mk_sharded(b"m",
                                                  prepare_timeout_s=60.0)
        try:
            dec_addrs = kv.map.ranges[0].addresses
            parts = [list(kv.map.ranges[0].addresses),
                     list(kv.map.ranges[1].addresses)]
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            await kv.groups[0]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-push", body=mk(b"a", b"1"), decider=dec_addrs,
                is_decider=True, participants=parts))
            await kv.groups[1]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-push", body=mk(b"z", b"2"), decider=dec_addrs,
                is_decider=False, participants=parts))
            await kv.groups[0]._call("Kv.commit_prepared",
                                     KvFinishReq(txn_id="t-push"))
            t0 = _t.perf_counter()
            while True:
                t = kv.transaction()
                a, z = await t.get(b"a"), await t.get(b"z")
                if a == b"1" and z == b"2":
                    break
                assert _t.perf_counter() - t0 < 5.0, \
                    f"push did not converge ({a!r} {z!r}); poll is 60s"
                await asyncio.sleep(0.05)
        finally:
            await cleanup()

        # --- ABORT push: decider expires fast, laggard polls slow ---
        from t3fs_torch.kv.engine import MemKVEngine
        from t3fs_torch.kv.service import KvService
        from t3fs_torch.net.client import Client
        from t3fs_torch.net.server import Server
        ship = Client()
        dec_svc = KvService(MemKVEngine(), client=ship,
                            prepare_timeout_s=0.3)
        lag_svc = KvService(MemKVEngine(), client=ship,
                            prepare_timeout_s=60.0)
        srv_d, srv_l = Server(), Server()
        srv_d.add_service(dec_svc); srv_l.add_service(lag_svc)
        await srv_d.start(); await srv_l.start()
        try:
            parts = [[srv_d.address], [srv_l.address]]
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            await ship.call(srv_d.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-ab", body=mk(b"a", b"1"),
                decider=[srv_d.address], is_decider=True,
                participants=parts))
            await ship.call(srv_l.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-ab", body=mk(b"z", b"2"),
                decider=[srv_d.address], is_decider=False,
                participants=parts))
            # coordinator vanishes entirely; decider expires -> ABORT,
            # pushes abort_prepared -> laggard frees its lock quickly
            t0 = _t.perf_counter()
            while lag_svc._prepared:
                assert _t.perf_counter() - t0 < 5.0, \
                    "abort push did not release the laggard; poll is 60s"
                await asyncio.sleep(0.05)
            ver = lag_svc.engine.current_version()
            assert lag_svc.engine.read_at(b"z", ver) is None
        finally:
            await srv_d.stop(); await srv_l.stop()
            await ship.close()
            dec_svc.stop_decision_gc(); lag_svc.stop_decision_gc()
    run(body())


def test_2pc_slow_coordinator_races_prepare_expiry():
    """A SLOW-but-alive coordinator whose phase 2
    lands after server-side prepare expiry.  Expiry aborts the (still
    committable) txn by design — what must hold is that the coordinator
    LEARNS the abort (definitive error, not a silent tear), no shard
    applied its slice, and both shards converge with free locks."""
    async def body():
        kv, services, cleanup = await _mk_sharded(b"m",
                                                  prepare_timeout_s=0.3)
        try:
            from t3fs_torch.kv.service import KvCommitReq, KvFinishReq, KvPrepareReq
            dec_addrs = kv.map.ranges[0].addresses
            mk = lambda k, v: KvCommitReq(write_keys=[k], write_values=[v],
                                          write_deletes=[False])
            # phase 1 on both shards (decider first, like the coordinator)
            await kv.groups[0]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-slow", body=mk(b"a", b"1"),
                decider=dec_addrs, is_decider=True,
                participants=[list(kv.map.ranges[i].addresses)
                              for i in range(2)]))
            await kv.groups[1]._call("Kv.prepare", KvPrepareReq(
                txn_id="t-slow", body=mk(b"z", b"2"),
                decider=dec_addrs, is_decider=False))
            # the coordinator stalls PAST the server-side expiry
            await asyncio.sleep(1.0)
            # late phase 2: the decider already tombstone-aborted — the
            # coordinator must get a DEFINITIVE refusal
            with pytest.raises(StatusError) as ei:
                await kv.groups[0]._call("Kv.commit_prepared",
                                         KvFinishReq(txn_id="t-slow"))
            assert ei.value.code == StatusCode.KV_TXN_NOT_FOUND
            # decider verdict is a durable ABORT tombstone
            from t3fs_torch.kv.service import KvDecisionReq
            rsp = await kv.groups[0]._call(
                "Kv.get_decision", KvDecisionReq(txn_id="t-slow"))
            assert rsp.decision == "A"
            # nothing applied anywhere; locks free; new txns flow
            async def wait_clean():
                while True:
                    t = kv.transaction()
                    if await t.get(b"a") is None and await t.get(b"z") is None:
                        return
                    await asyncio.sleep(0.05)
            await asyncio.wait_for(wait_clean(), timeout=5.0)

            async def w(txn):
                txn.set(b"after", b"1")
                txn.set(b"zafter", b"2")
            await asyncio.wait_for(with_transaction(kv, w), timeout=5.0)
            t = kv.transaction()
            assert await t.get(b"after") == b"1"
            assert await t.get(b"zafter") == b"2"
        finally:
            await cleanup()
    run(body())


# ---- footprint locks ----

async def _mk_single_kv(prepare_timeout_s: float = 600.0):
    """One KvService group + a second group to act as decider."""
    from t3fs_torch.kv.service import KvService
    ship = Client()
    dec_svc = KvService(MemKVEngine(), client=ship,
                        prepare_timeout_s=prepare_timeout_s)
    dec_srv = Server(); dec_srv.add_service(dec_svc)
    await dec_srv.start()
    svc = KvService(MemKVEngine(), client=ship,
                    prepare_timeout_s=prepare_timeout_s)
    srv = Server(); srv.add_service(svc)
    await srv.start()

    async def cleanup():
        for s in list(svc._prepared.values()) + list(dec_svc._prepared.values()):
            s[1].cancel()
        await srv.stop(); await dec_srv.stop(); await ship.close()
    return ship, svc, srv, dec_svc, dec_srv, cleanup


def test_footprint_admits_unrelated_commits_during_2pc():
    """Without footprint locks ONE prepared cross-shard txn would
    serialize every commit on the shard until phase 2.  With footprint locks, commits
    off the footprint flow freely across the inter-phase window."""
    async def body():
        from t3fs_torch.kv.service import KvCommitReq, KvFinishReq, KvPrepareReq
        ship, svc, srv, dec_svc, dec_srv, cleanup = await _mk_single_kv()
        try:
            await ship.call(srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-fp", body=KvCommitReq(
                    write_keys=[b"locked"], write_values=[b"1"],
                    write_deletes=[False], read_keys=[b"watched"]),
                decider=[dec_srv.address]))
            assert "t-fp" in svc._footprints
            # unrelated commits land immediately, no expiry wait
            for i in range(5):
                rsp, _ = await asyncio.wait_for(ship.call(
                    srv.address, "Kv.commit", KvCommitReq(
                        write_keys=[b"free%d" % i], write_values=[b"v"],
                        write_deletes=[False])), timeout=2.0)
            ver = svc.engine.current_version()
            assert svc.engine.read_at(b"free4", ver) == b"v"
            assert svc.engine.read_at(b"locked", ver) is None  # not yet
            # phase 2 applies the slice unconditionally afterwards
            await ship.call(srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-fp"))
            ver = svc.engine.current_version()
            assert svc.engine.read_at(b"locked", ver) == b"1"
            assert "t-fp" not in svc._footprints
        finally:
            await cleanup()
    run(body())


def test_footprint_blocks_conflicting_commit_and_prepare():
    """Writes/clears landing on a prepared txn's reads OR writes get
    TXN_CONFLICT (retryable) until the verdict applies; so does a second
    prepare whose slice overlaps the footprint."""
    async def body():
        from t3fs_torch.kv.service import KvCommitReq, KvFinishReq, KvPrepareReq
        ship, svc, srv, dec_svc, dec_srv, cleanup = await _mk_single_kv()
        try:
            await ship.call(srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-a", body=KvCommitReq(
                    write_keys=[b"wkey"], write_values=[b"1"],
                    write_deletes=[False], read_keys=[b"rkey"],
                    range_begins=[b"rga"], range_ends=[b"rgz"]),
                decider=[dec_srv.address]))
            # write to the prepared WRITE key
            for bad in (
                KvCommitReq(write_keys=[b"wkey"], write_values=[b"x"],
                            write_deletes=[False]),
                # write to the prepared READ key
                KvCommitReq(write_keys=[b"rkey"], write_values=[b"x"],
                            write_deletes=[False]),
                # write INTO the prepared read range
                KvCommitReq(write_keys=[b"rgm"], write_values=[b"x"],
                            write_deletes=[False]),
                # clear COVERING the prepared write key
                KvCommitReq(clear_begins=[b"w"], clear_ends=[b"x"]),
            ):
                with pytest.raises(StatusError) as ei:
                    await ship.call(srv.address, "Kv.commit", bad)
                assert ei.value.code == StatusCode.TXN_CONFLICT, bad
            # second prepare overlapping the footprint: refused too
            with pytest.raises(StatusError) as ei:
                await ship.call(srv.address, "Kv.prepare", KvPrepareReq(
                    txn_id="t-b", body=KvCommitReq(
                        write_keys=[b"rkey"], write_values=[b"y"],
                        write_deletes=[False]),
                    decider=[dec_srv.address]))
            assert ei.value.code == StatusCode.TXN_CONFLICT
            assert "t-b" not in svc._footprints
            # resolution releases the footprint: same commit now lands
            await ship.call(srv.address, "Kv.abort_prepared",
                            KvFinishReq(txn_id="t-a"))
            assert "t-a" not in svc._footprints
            await ship.call(srv.address, "Kv.commit", KvCommitReq(
                write_keys=[b"wkey"], write_values=[b"x"],
                write_deletes=[False]))
            ver = svc.engine.current_version()
            assert svc.engine.read_at(b"wkey", ver) == b"x"
        finally:
            await cleanup()
    run(body())


def test_footprint_disjoint_prepares_coexist():
    """Two cross-shard txns with disjoint slices prepare concurrently on
    one shard — the old protocol deadlocked/serialized them on the
    commit lock."""
    async def body():
        from t3fs_torch.kv.service import KvCommitReq, KvFinishReq, KvPrepareReq
        ship, svc, srv, dec_svc, dec_srv, cleanup = await _mk_single_kv()
        try:
            for name, key in (("t-1", b"one"), ("t-2", b"two")):
                await asyncio.wait_for(ship.call(
                    srv.address, "Kv.prepare", KvPrepareReq(
                        txn_id=name, body=KvCommitReq(
                            write_keys=[key], write_values=[b"v"],
                            write_deletes=[False]),
                        decider=[dec_srv.address])), timeout=2.0)
            assert set(svc._footprints) == {"t-1", "t-2"}
            for name in ("t-1", "t-2"):
                await ship.call(srv.address, "Kv.commit_prepared",
                                KvFinishReq(txn_id=name))
            ver = svc.engine.current_version()
            assert svc.engine.read_at(b"one", ver) == b"v"
            assert svc.engine.read_at(b"two", ver) == b"v"
        finally:
            await cleanup()
    run(body())


def test_footprint_reregistered_on_restart_and_promotion():
    """recover_prepared (restart AND failover promotion) re-registers
    footprints from durable PREP records BEFORE the first post-recovery
    commit can land on a prepared slice."""
    async def body():
        from t3fs_torch.kv.engine import MemKVEngine
        from t3fs_torch.kv.service import (
            KvCommitReq, KvFinishReq, KvPrepareReq, KvService,
        )
        ship = Client()
        dec_svc = KvService(MemKVEngine(), client=ship,
                            prepare_timeout_s=600.0)
        dec_srv = Server(); dec_srv.add_service(dec_svc)
        await dec_srv.start()
        eng = MemKVEngine()
        svc = KvService(eng, client=ship, prepare_timeout_s=600.0)
        srv = Server(); srv.add_service(svc)
        await srv.start()
        try:
            await ship.call(srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-rst", body=KvCommitReq(
                    write_keys=[b"held"], write_values=[b"1"],
                    write_deletes=[False]),
                decider=[dec_srv.address], is_decider=False))
            # "crash": service state lost, engine (durable PREP) kept
            await srv.stop()
            for e in list(svc._prepared.values()):
                e[1].cancel()
            svc2 = KvService(eng, client=ship, prepare_timeout_s=600.0)
            srv2 = Server(); srv2.add_service(svc2)
            await srv2.start()
            assert await svc2.recover_prepared() == 1
            assert "t-rst" in svc2._footprints    # registered synchronously
            with pytest.raises(StatusError) as ei:
                await ship.call(srv2.address, "Kv.commit", KvCommitReq(
                    write_keys=[b"held"], write_values=[b"x"],
                    write_deletes=[False]))
            assert ei.value.code == StatusCode.TXN_CONFLICT
            # decider commits -> resolution applies the slice + releases
            await ship.call(dec_srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-rst", body=KvCommitReq(
                    write_keys=[b"dec"], write_values=[b"1"],
                    write_deletes=[False]),
                decider=[dec_srv.address], is_decider=True))
            await ship.call(dec_srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-rst"))
            await ship.call(srv2.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-rst"))
            ver = eng.read_at(b"held", eng.current_version())
            assert ver == b"1"
            assert "t-rst" not in svc2._footprints
            await ship.call(srv2.address, "Kv.commit", KvCommitReq(
                write_keys=[b"held"], write_values=[b"x"],
                write_deletes=[False]))
            assert eng.read_at(b"held", eng.current_version()) == b"x"
            await srv2.stop()
            for e in list(svc2._prepared.values()):
                e[1].cancel()
        finally:
            await dec_srv.stop()
            try:
                await srv.stop()
            except Exception:
                pass
            for e in list(dec_svc._prepared.values()):
                e[1].cancel()
            await ship.close()
    run(body())


def test_get_many_pays_per_shard_not_per_key_rpcs():
    """A batched point-read of N keys
    against a sharded KV must cost O(touched shards) RPCs — one read per
    shard with the snapshot pin FOLDED into it — not O(N) version+read
    pairs."""
    async def body():
        kv, services, cleanup = await _mk_sharded(b"m")
        try:
            async def seed(txn):
                for i in range(10):
                    txn.set(b"a%02d" % i, b"L%d" % i)   # shard 0
                    txn.set(b"z%02d" % i, b"R%d" % i)   # shard 1
            await with_transaction(kv, seed)

            from t3fs_torch.kv.remote import RemoteKVEngine
            calls: list[str] = []
            orig = RemoteKVEngine._call

            async def counting(self, method, req, **kw):
                calls.append(method)
                return await orig(self, method, req, **kw)

            RemoteKVEngine._call = counting
            try:
                t = kv.transaction()
                keys = [b"a%02d" % i for i in range(10)] + \
                       [b"z%02d" % i for i in range(10)] + [b"missing"]
                vals = await t.get_many(keys)
            finally:
                RemoteKVEngine._call = orig
            assert vals[:10] == [b"L%d" % i for i in range(10)]
            assert vals[10:20] == [b"R%d" % i for i in range(10)]
            assert vals[20] is None
            # 2 shards touched -> exactly 2 RPCs, all Kv.read (the pin
            # rode along via version=-1; no Kv.get_version round trips)
            assert calls == ["Kv.read", "Kv.read"], calls
            # read-your-writes + clear overlay still hold through the batch
            t2 = kv.transaction()
            t2.set(b"a00", b"new")
            t2.clear_range(b"z00", b"z05")
            vals = await t2.get_many([b"a00", b"z03", b"z07"])
            assert vals == [b"new", None, b"R7"]
        finally:
            await cleanup()
    run(body())


def test_first_read_folds_version_pin():
    """A transaction's FIRST read costs one round trip, not a
    get_version + read pair; concurrent first reads share one pin."""
    async def body():
        kv, services, cleanup = await _mk_sharded(b"m")
        try:
            async def seed(txn):
                txn.set(b"k1", b"v1")
                txn.set(b"k2", b"v2")
            await with_transaction(kv, seed)

            from t3fs_torch.kv.remote import RemoteKVEngine
            calls: list[str] = []
            orig = RemoteKVEngine._call

            async def counting(self, method, req, **kw):
                calls.append(method)
                return await orig(self, method, req, **kw)

            RemoteKVEngine._call = counting
            try:
                t = kv.transaction()
                # concurrent first reads: both must see ONE consistent pin
                v1, v2 = await asyncio.gather(t.get(b"k1"), t.get(b"k2"))
            finally:
                RemoteKVEngine._call = orig
            assert (v1, v2) == (b"v1", b"v2")
            assert "Kv.get_version" not in calls, calls
            assert calls.count("Kv.read") == 2
            sub = t._subs[0]
            assert sub.read_version is not None
        finally:
            await cleanup()
    run(body())


def test_footprint_survives_failover_promotion():
    """A FOLLOWER promoted mid-2PC re-registers the prepared txn's
    footprint from the replicated PREP record: commits landing on the
    slice between promotion and the verdict get TXN_CONFLICT, and the
    verdict then applies cleanly on the new primary."""
    async def body():
        from t3fs_torch.kv.engine import MemKVEngine
        from t3fs_torch.kv.service import (
            KvCommitReq, KvFinishReq, KvPrepareReq, KvService,
        )
        ship = Client()
        # decider group (single member, stays up)
        dec_svc = KvService(MemKVEngine(), client=ship,
                            prepare_timeout_s=600.0)
        dec_srv = Server(); dec_srv.add_service(dec_svc)
        await dec_srv.start()
        # participant group: primary + follower
        p_svc = KvService(MemKVEngine(), client=ship,
                          prepare_timeout_s=600.0)
        p_srv = Server(); p_srv.add_service(p_svc)
        await p_srv.start()
        f_svc = KvService(MemKVEngine(), primary=False, client=ship,
                          prepare_timeout_s=600.0)
        f_srv = Server(); f_srv.add_service(f_svc)
        await f_srv.start()
        p_svc.followers = [f_srv.address]
        try:
            await ship.call(p_srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-fo", body=KvCommitReq(
                    write_keys=[b"slice"], write_values=[b"1"],
                    write_deletes=[False], read_keys=[b"guard"]),
                decider=[dec_srv.address], is_decider=False))
            # primary dies mid-window; follower promoted
            await p_srv.stop()
            for e in list(p_svc._prepared.values()):
                e[1].cancel()
            await ship.call(f_srv.address, "Kv.promote", None)
            assert "t-fo" in f_svc._footprints     # re-armed from PREP
            # the slice is shielded on the NEW primary
            for bad_key in (b"slice", b"guard"):
                with pytest.raises(StatusError) as ei:
                    await ship.call(f_srv.address, "Kv.commit", KvCommitReq(
                        write_keys=[bad_key], write_values=[b"x"],
                        write_deletes=[False]))
                assert ei.value.code == StatusCode.TXN_CONFLICT, bad_key
            # unrelated commits flow on the new primary meanwhile
            await ship.call(f_srv.address, "Kv.commit", KvCommitReq(
                write_keys=[b"free"], write_values=[b"y"],
                write_deletes=[False]))
            # decider decides COMMIT; new primary applies per verdict
            await ship.call(dec_srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-fo", body=KvCommitReq(
                    write_keys=[b"dec"], write_values=[b"1"],
                    write_deletes=[False]),
                decider=[dec_srv.address], is_decider=True))
            await ship.call(dec_srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-fo"))
            await ship.call(f_srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-fo"))
            eng = f_svc.engine
            assert eng.read_at(b"slice", eng.current_version()) == b"1"
            assert "t-fo" not in f_svc._footprints
            # the shield is gone: the previously-refused commit lands
            await ship.call(f_srv.address, "Kv.commit", KvCommitReq(
                write_keys=[b"slice"], write_values=[b"x"],
                write_deletes=[False]))
            assert eng.read_at(b"slice", eng.current_version()) == b"x"
        finally:
            for svc in (dec_svc, p_svc, f_svc):
                for e in list(svc._prepared.values()):
                    e[1].cancel()
            await f_srv.stop(); await dec_srv.stop()
            try:
                await p_srv.stop()
            except Exception:
                pass
            await ship.close()
    run(body())


def test_footprint_blocks_torn_cross_shard_read():
    """After phase 2 applied on shard A but NOT yet on
    shard B, a transaction reading T1's write on A and validating a read
    of pre-T1 state on B must NOT commit (it observed T1 half-applied —
    a serializability cycle).  The footprint read-check is what refuses
    it: a candidate's READS conflict with a registered footprint's
    WRITES."""
    async def body():
        from t3fs_torch.kv.service import KvCommitReq, KvFinishReq, KvPrepareReq
        ship, svc, srv, dec_svc, dec_srv, cleanup = await _mk_single_kv()
        try:
            # T1's slice on this shard writes Y (cross-shard txn; the
            # other slice is elsewhere).  Prepared, verdict not yet in.
            await ship.call(srv.address, "Kv.prepare", KvPrepareReq(
                txn_id="t-torn", body=KvCommitReq(
                    write_keys=[b"Y"], write_values=[b"new"],
                    write_deletes=[False]),
                decider=[dec_srv.address]))
            ver_rsp, _ = await ship.call(srv.address, "Kv.get_version",
                                         None)
            # T2 read pre-T1 Y here (and, in the torn scenario, T1's
            # already-applied X on another shard): its validation /
            # commit carrying that read must be refused until T1's
            # verdict applies
            for req in (
                # writer that read Y
                KvCommitReq(read_version=ver_rsp.version,
                            read_keys=[b"Y"], write_keys=[b"Z"],
                            write_values=[b"z"], write_deletes=[False]),
                # read-only validation (validate_reads wire shape)
                KvCommitReq(read_version=ver_rsp.version,
                            read_keys=[b"Y"]),
                # range read covering the prepared write
                KvCommitReq(read_version=ver_rsp.version,
                            range_begins=[b"A"], range_ends=[b"c"]),
            ):
                with pytest.raises(StatusError) as ei:
                    await ship.call(srv.address, "Kv.commit", req)
                assert ei.value.code == StatusCode.TXN_CONFLICT, req
            # verdict applies -> the same reads validate fine (they now
            # see T1 fully applied and re-pin a fresh version on retry)
            await ship.call(srv.address, "Kv.commit_prepared",
                            KvFinishReq(txn_id="t-torn"))
            ver2, _ = await ship.call(srv.address, "Kv.get_version", None)
            await ship.call(srv.address, "Kv.commit", KvCommitReq(
                read_version=ver2.version, read_keys=[b"Y"],
                write_keys=[b"Z"], write_values=[b"z"],
                write_deletes=[False]))
        finally:
            await cleanup()
    run(body())


# ------------------------------------------------ against the reference

SPLIT = b"m"
SKEYS = [bytes([c]) + b"%02d" % i for c in b"cgkqtx" for i in range(4)]


def make_shard_steps(seed: int, n: int) -> list[tuple]:
    """n steps over keys on both sides of SPLIT: transactions that write
    one or both shards (the latter commit by 2PC), cross-shard
    read-modify-write races whose second commit must conflict, batched
    point reads and cross-shard range reads, and commits sent straight to
    the group that does not own the key (KV_WRONG_SHARD)."""
    rng = np.random.default_rng(seed)

    def key():
        return SKEYS[int(rng.integers(0, len(SKEYS)))]

    steps = []
    for _ in range(n):
        r = rng.random()
        if r < 0.5:
            sets = [(key(), rng.bytes(int(rng.integers(0, 64))))
                    for _ in range(int(rng.integers(1, 4)))]
            reads = [key() for _ in range(int(rng.integers(0, 3)))]
            clears = [key()] if rng.random() < 0.2 else []
            steps.append(("txn", reads, sets, clears))
        elif r < 0.7:
            steps.append(("race", SKEYS[int(rng.integers(0, 12))],
                          SKEYS[12 + int(rng.integers(0, 12))],
                          rng.bytes(6), rng.bytes(6)))
        elif r < 0.8:
            steps.append(("get_many", [key() for _ in range(5)]))
        elif r < 0.9:
            steps.append(("range", b"a", b"z", int(rng.integers(0, 10))))
        else:
            steps.append(("wrong_shard", key(), rng.bytes(4)))
    return steps


async def drive_sharded(e, kv, groups: list[str], steps, settled) -> list:
    """Run steps through ShardedKVEngine kv of package e; groups are the
    two groups' primaries for the direct commits.  settled() is awaited
    after each step, so no phase-2 push of one step races the next."""
    log = []

    async def commit(t):
        try:
            await t.commit()
            return 0
        except e.status.StatusError as err:
            return D.code_of(err)

    for st in steps:
        kind = st[0]
        if kind == "txn":
            _, reads, sets, clears = st
            txn = kv.transaction()
            got = [await txn.get(k) for k in reads]
            for k, v in sets:
                txn.set(k, v)
            for k in clears:
                txn.clear(k)
            log.append((kind, got, await commit(txn)))
        elif kind == "race":
            _, a, b, va, vb = st
            t1, t2 = kv.transaction(), kv.transaction()
            got = [await t.get(k) for t in (t1, t2) for k in (a, b)]
            t1.set(a, va)
            t1.set(b, va)
            t2.set(a, vb)
            t2.set(b, vb)
            log.append((kind, got, [await commit(t1), await commit(t2)]))
        elif kind == "get_many":
            txn = kv.transaction()
            log.append((kind, await txn.get_many(st[1])))
        elif kind == "range":
            txn = kv.transaction()
            log.append((kind, await txn.get_range(st[1], st[2],
                                                  limit=st[3])))
        else:
            _, k, v = st
            other = groups[0] if k >= SPLIT else groups[1]
            try:
                await kv.client.call(other, "Kv.commit", e.service.KvCommitReq(
                    write_keys=[k], write_values=[v], write_deletes=[False]))
                log.append((kind, 0))
            except e.status.StatusError as err:
                log.append((kind, D.code_of(err)))
        await settled()
    return log


async def settle(nodes) -> None:
    """Wait out the 2PC work a commit leaves behind (the decider's push of
    phase 2 to the other participants): until no primary holds a prepared
    txn and every follower holds its primary's rows."""
    for _ in range(400):
        if all(not prim.svc._prepared and not prim.svc._resolving
               and not prim.svc._push_tasks
               and D.dump_engine(prim.engine) == D.dump_engine(fol.engine)
               for prim, fol in nodes):
            return
        await asyncio.sleep(0.025)
    raise AssertionError("2PC never settled")


async def sharded_run(groups_pkg: str, engine_pkg: str, root) -> tuple:
    """Two groups of package groups_pkg split at SPLIT, each a WAL primary
    shipping to a WAL follower, each told its owned range; a
    ShardedKVEngine of package engine_pkg drives the seeded steps.
    -> (log, state, WAL files), addresses named g0/g1/f0/f1."""
    G, E = D.PKGS[groups_pkg], D.PKGS[engine_pkg]
    names = D.Names()
    nodes = []
    for g in range(2):
        prim = await D.Node(G, D.wal_engine(G, f"{root}/g{g}"),
                            prepare_timeout_s=30.0).start()
        fol = await D.Node(G, D.wal_engine(G, f"{root}/f{g}"),
                           primary=False).start()
        prim.svc.followers = [fol.address]
        names.add(prim.address, f"g{g}")
        names.add(fol.address, f"f{g}")
        nodes.append((prim, fol))
    bounds = [(b"", SPLIT), (SPLIT, E.shard.KEY_MAX)]
    ship = E.client.Client()
    for (prim, fol), (b, e) in zip(nodes, bounds):
        await ship.call(prim.address, "Kv.shard_set_owned",
                        E.service.KvShardOwnedReq(begins=[b], ends=[e]))
    smap = E.shard.ShardMap(ranges=[
        E.shard.ShardRange(b, e, [prim.address, fol.address])
        for (prim, fol), (b, e) in zip(nodes, bounds)])
    kv = E.shard.ShardedKVEngine(smap, client=ship)
    try:
        log = await drive_sharded(E, kv, [n[0].address for n in nodes],
                                  make_shard_steps(D.SEED, 48),
                                  lambda: settle(nodes))
        state = []
        for prim, fol in nodes:
            rows = D.dump_engine(prim.engine)
            decisions = [(k, v[:1]) for k, v in rows
                         if k.startswith(G.service.DEC_PREFIX)]
            state.append((prim.svc.seq, fol.svc.seq,
                          prim.engine.current_version(), decisions,
                          names(rows)))
    finally:
        await kv.close()
        for prim, fol in nodes:
            await prim.stop()
            await fol.stop()
            prim.engine.close()
            fol.engine.close()
    wal = {d: names(D.wal_frames(f"{root}/{d}"))
           for d in ("g0", "f0", "g1", "f1")}
    return log, state, wal


def test_sharded_history_matches_reference(tmp_path, monkeypatch):
    """The same seeded cross-shard history on each package's two
    replicated groups through its own ShardedKVEngine: equal reads,
    outcomes (TXN_CONFLICT, KV_WRONG_SHARD), seqs, versions, decision
    records and rows on every node, and WAL frames byte for byte (with the
    run's addresses named)."""
    out = {}
    for name in ("ref", "port"):
        D.pin(monkeypatch)
        out[name] = run(sharded_run(name, name, tmp_path / name))
    log, state, wal = out["ref"]
    kinds = [e[-1] for e in log if e[0] == "wrong_shard"]
    assert kinds and set(kinds) == {int(StatusCode.KV_WRONG_SHARD)}
    assert any(e[0] == "race" and e[2] == [0, int(StatusCode.TXN_CONFLICT)]
               for e in log)
    assert all(s[3] for s in state) or state[0][3]   # 2PC decided somewhere
    assert out["port"][0] == log
    assert out["port"][1] == state
    assert out["port"][2] == wal


@pytest.mark.parametrize("groups,engine", [("ref", "port"), ("port", "ref")])
def test_sharded_wire_across_packages(tmp_path, monkeypatch, groups, engine):
    """Each package's ShardedKVEngine (2PC coordinator included) against
    the other's replicated groups: the log, seqs, decision records and
    rows equal the reference's own run."""
    D.pin(monkeypatch)
    want = run(sharded_run("ref", "ref", tmp_path / "ref"))[:2]
    D.pin(monkeypatch)
    got = run(sharded_run(groups, engine, tmp_path / "mix"))[:2]
    assert got == want


def _meta_pins(monkeypatch, clock):
    """The meta store's own clocks, ids and layout seeds, as
    tests/test_torch_meta.py pins them."""
    import t3fs.meta.store
    import t3fs_torch.meta.store
    ids = D.Uuids()
    for mod in (t3fs.meta.store, t3fs_torch.meta.store):
        monkeypatch.setattr(mod, "time", clock)
        monkeypatch.setattr(mod, "uuidlib", ids)
        monkeypatch.setattr(mod, "random", __import__("random").Random(7))


async def meta_over_shards(pkg: str) -> tuple[list, list]:
    """MetaStore of pkg over pkg's two single-node groups split between the
    DENT and INOD prefixes, so creates, renames and removes are
    cross-shard 2PC.  -> (each op's outcome, each group's rows)."""
    import importlib
    P = D.PKGS[pkg]
    store_mod = importlib.import_module(f"{P.name}.meta.store")
    mg = importlib.import_module(f"{P.name}.mgmtd.types")
    names = D.Names()
    nodes = []
    for g in range(2):
        node = await D.Node(P, P.engine.MemKVEngine()).start()
        names.add(node.address, f"g{g}")
        nodes.append(node)
    smap = P.shard.ShardMap(ranges=[
        P.shard.ShardRange(b"", b"G", [nodes[0].address]),
        P.shard.ShardRange(b"G", P.shard.KEY_MAX, [nodes[1].address])])
    kv = P.shard.ShardedKVEngine(smap)
    routing = mg.RoutingInfo()
    for c in range(1, 4):
        routing.chains[c] = mg.ChainInfo(c, 1, [mg.ChainTargetInfo(
            c * 100, 1, mg.PublicTargetState.SERVING)])
    routing.chain_tables[1] = mg.ChainTable(1, list(routing.chains))
    store = store_mod.MetaStore(kv, store_mod.ChainAllocator(
        lambda: routing, default_chunk_size=4096))
    out = []

    async def op(coro):
        try:
            res = await coro
        except P.status.StatusError as e:
            out.append(D.code_of(e))
            return
        if isinstance(res, tuple):
            res = list(res)
        out.append(P.serde.dumps(res))

    try:
        await op(store.mkdirs("/a/b"))
        for i in range(6):
            await op(store.create(f"/a/b/f{i}", session_client="c1"))
        await op(store.stat("/a/b/f3"))
        await op(store.rename("/a/b/f3", "/a/g"))
        await op(store.rename("/a/b/f4", "/a/b/f5"))
        await op(store.readdir("/a"))
        await op(store.readdir("/a/b"))
        await op(store.create("/a/b/f0", session_client="c1"))  # EXISTS
        await op(store.remove("/a/b/f1"))
        await op(store.stat("/a/b/f1"))                          # NOT_FOUND
        rows = [names(D.dump_engine(n.engine)) for n in nodes]
    finally:
        await kv.close()
        for n in nodes:
            await n.stop()
    return out, rows


def test_meta_store_over_sharded_kv_matches_reference(monkeypatch):
    """MetaStore over each package's own sharded KV: the same outcomes and
    the same rows in each shard, every prefix on the shard the split puts
    it on."""
    out = {}
    for name in ("ref", "port"):
        _meta_pins(monkeypatch, D.pin(monkeypatch))
        out[name] = run(meta_over_shards(name))
    (ops, rows) = out["ref"]
    assert all(rows) and any(isinstance(o, int) for o in ops)
    assert {k[:4] for k, _ in rows[1] if not k.startswith(b"\x00")} \
        >= {b"INOD"}
    assert out["port"] == out["ref"]


@pytest.mark.parametrize("writer,recoverer", [
    ("ref", "ref"), ("port", "port"), ("ref", "port"), ("port", "ref")])
def test_durable_2pc_restart_recovers_like_reference(
        tmp_path, monkeypatch, writer, recoverer):
    """Both groups on WAL engines: the coordinator prepares on both and
    commits the decider, then the participant's process dies before phase
    2.  A participant restarted over its WAL by `recoverer` re-arms the
    prepared record and resolves it to COMMIT through the decider; the
    prepare written by either package is recovered by either.  The rows,
    decision records and WAL files equal the reference's own run."""
    async def body(w: str, r: str, root) -> tuple:
        W, R = D.PKGS[w], D.PKGS[r]
        names = D.Names()
        dec = await D.Node(W, D.wal_engine(W, f"{root}/dec"),
                           prepare_timeout_s=0.3).start()
        part = await D.Node(W, D.wal_engine(W, f"{root}/part"),
                            prepare_timeout_s=600.0).start()
        names.add(dec.address, "dec")
        names.add(part.address, "part")
        ship = W.client.Client()
        mk = lambda k, v: W.service.KvCommitReq(   # noqa: E731
            write_keys=[k], write_values=[v], write_deletes=[False])
        await ship.call(dec.address, "Kv.prepare", W.service.KvPrepareReq(
            txn_id="t-rec", body=mk(b"a", b"1"), decider=[dec.address],
            is_decider=True, participants=[[dec.address], [part.address]]))
        await ship.call(part.address, "Kv.prepare", W.service.KvPrepareReq(
            txn_id="t-rec", body=mk(b"z", b"2"), decider=[dec.address],
            is_decider=False))
        await ship.call(dec.address, "Kv.commit_prepared",
                        W.service.KvFinishReq(txn_id="t-rec"))
        await ship.close()
        await part.stop()                       # the process dies ...
        part.engine.close()
        prepared_wal = names(D.wal_frames(f"{root}/part"))
        # ... and comes back over its WAL, in the recovering package
        back = D.Node(R, D.wal_engine(R, f"{root}/part"),
                      prepare_timeout_s=0.2)
        recovered = await back.svc.recover_prepared()
        await back.start()
        try:
            for _ in range(200):
                if back.engine.read_at(
                        b"z", back.engine.current_version()) == b"2":
                    break
                await asyncio.sleep(0.05)
            else:
                raise AssertionError("recovered prepare never applied")
            rows = [names(D.dump_engine(n.engine)) for n in (dec, back)]
        finally:
            await back.stop()
            await dec.stop()
            back.engine.close()
            dec.engine.close()
        return recovered, prepared_wal, rows

    D.pin(monkeypatch)
    want = run(body("ref", "ref", tmp_path / "want"))
    D.pin(monkeypatch)
    got = run(body(writer, recoverer, tmp_path / "got"))
    assert want[0] == 1
    assert any(k.startswith(D.PKGS["ref"].service.DEC_PREFIX)
               for k, _ in want[2][0])
    assert got == want


def test_restarted_participant_resolves_decided_before_listening(tmp_path):
    """The decider COMMITTED, the participant died prepared.  Restarted
    over its WAL, the reference's participant re-arms the txn and leaves it
    to a timer 0.5 s on: until then its slice reads as absent, though the
    txn may already be acknowledged (meta's idempotent retry reads the
    decider's side).  The port's kv_main resolves it through the decider
    before it listens (app/kv_main.resolve_decided): the slice reads at
    once, and the reference's own timer lands the same rows later."""
    from t3fs_torch.app.kv_main import resolve_decided

    async def body(pkg: str, root) -> tuple:
        P = D.PKGS[pkg]
        dec = await D.Node(P, D.wal_engine(P, f"{root}/dec"),
                           prepare_timeout_s=600.0).start()
        part = await D.Node(P, D.wal_engine(P, f"{root}/part"),
                            prepare_timeout_s=600.0).start()
        ship = P.client.Client()
        mk = lambda k, v: P.service.KvCommitReq(   # noqa: E731
            write_keys=[k], write_values=[v], write_deletes=[False])
        for addr, key, is_dec in ((dec.address, b"a", True),
                                  (part.address, b"z", False)):
            await ship.call(addr, "Kv.prepare", P.service.KvPrepareReq(
                txn_id="t-ack", body=mk(key, b"1"), decider=[dec.address],
                is_decider=is_dec))
        await ship.call(dec.address, "Kv.commit_prepared",
                        P.service.KvFinishReq(txn_id="t-ack"))
        await ship.close()
        await part.stop()
        part.engine.close()
        back = D.Node(P, D.wal_engine(P, f"{root}/part"),
                      prepare_timeout_s=600.0)
        try:
            recovered = await back.svc.recover_prepared()
            resolved = (await resolve_decided(back.svc)
                        if pkg == "port" else 0)
            ver = back.engine.current_version()
            seen = back.engine.read_at(b"z", ver)
            for _ in range(200):            # the reference's timer
                if back.engine.read_at(
                        b"z", back.engine.current_version()) == b"1":
                    break
                await asyncio.sleep(0.025)
            rows = D.dump_engine(back.engine)
        finally:
            await back.stop()
            await dec.stop()
            back.engine.close()
            dec.engine.close()
        return recovered, resolved, seen, rows

    ref = run(body("ref", tmp_path / "ref"))
    port = run(body("port", tmp_path / "port"))
    assert ref[:3] == (1, 0, None)           # the window
    assert port[:3] == (1, 1, b"1")          # closed before listening
    assert port[3] == ref[3]
