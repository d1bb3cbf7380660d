"""The port's KV data distributor (t3fs_torch.kv.distributor: the
range-load accounting it reads, its split, move and merge planner, its
orphan healing) against the JAX package's: every case of
tests/test_kv_distributor.py on the port, LocalCluster(kv_shards=2)'s
orphan healing included; then one seeded load on each package's groups
with the same range_stats bytes and two KVDistributor ticks that take the
same actions to the same map and rows.  time.time and the load sampler's
random stream are pinned in both packages with monkeypatch
(tests/torch_kv_diff.py); nothing in either package changes for it."""

import asyncio

import numpy as np
import pytest

import torch_kv_diff as D
from t3fs_torch.kv.distributor import KVDistributor
from t3fs_torch.kv.engine import MemKVEngine, with_transaction
from t3fs_torch.kv.service import KvRangeStatsReq, KvService
from t3fs_torch.kv.shard import KEY_MAX, ShardMap, ShardRange, ShardedKVEngine
from t3fs_torch.kv.surgery import MoveIntent, ShardAdmin
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.status import StatusCode, StatusError


def run(coro):
    return asyncio.run(coro)


async def _mk_groups(n_groups: int = 2):
    """n groups up, the WHOLE user keyspace on group 0 (the map home);
    later groups start empty — the distributor's move targets."""
    ship = Client()
    servers, services, addrs = [], [], []
    for _ in range(n_groups):
        svc = KvService(MemKVEngine(), client=ship, prepare_timeout_s=5.0)
        srv = Server()
        srv.add_service(svc)
        await srv.start()
        servers.append(srv)
        services.append(svc)
        addrs.append([srv.address])
    m = ShardMap(ranges=[ShardRange(b"", KEY_MAX, addrs[0])], version=1)
    admin = ShardAdmin(addrs[0], client=ship)
    await admin.publish_map(m)
    kv = ShardedKVEngine(m, client=ship, map_home=addrs[0])

    async def cleanup():
        await kv.close()
        for s in servers:
            await s.stop()
    return kv, admin, services, addrs, cleanup


async def _storm(kv, n: int = 200, prefix: bytes = b"hot/") -> None:
    """Concentrated write traffic: n keys under one prefix."""
    for base in range(0, n, 40):
        async def w(txn, base=base):
            for i in range(base, min(base + 40, n)):
                txn.set(prefix + b"%04d" % i, b"v%d" % i)
        await with_transaction(kv, w)


def _dist(addrs, admin, **kw):
    kw.setdefault("tick_period_s", 999.0)     # ticks driven by the test
    kw.setdefault("split_ops_threshold", 2.0)
    kw.setdefault("merge_ops_threshold", 0.01)
    kw.setdefault("cooldown_s", 60.0)
    return KVDistributor(admin.map_home, client=admin.client,
                         known_groups=[list(a) for a in addrs], **kw)


# ---------------------------------------------------------------- accounting

def test_range_stats_accounting_and_split_suggestion():
    """Layer 1: write traffic shows up as decayed rates; the split
    suggestion is the sampled traffic median (inside the hot prefix),
    not the byte midpoint."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(1)
        try:
            await _storm(kv, 200)
            # a key far from the traffic: the median must ignore it
            async def w(txn):
                txn.set(b"zzzz/lonely", b"x")
            await with_transaction(kv, w)
            rsp = await admin._group(addrs[0])._call(
                "Kv.range_stats", KvRangeStatsReq())
            assert rsp.begins == [b""] and rsp.ends == [KEY_MAX]
            assert rsp.write_ops_s[0] > 1.0
            assert rsp.write_bytes_s[0] > 0.0
            assert rsp.rows[0] == 201
            assert rsp.approx_bytes[0] > 0
            sk = rsp.split_keys[0]
            assert sk.startswith(b"hot/"), sk
            # reads are tracked separately
            async def r(txn):
                for i in range(50):
                    await txn.get(b"hot/%04d" % i)
            await with_transaction(kv, r)
            rsp = await admin._group(addrs[0])._call(
                "Kv.range_stats", KvRangeStatsReq())
            assert rsp.read_ops_s[0] > 0.5
        finally:
            await cleanup()
    run(body())


def test_range_stats_rebucket_follows_map():
    """The caller's bounds re-bucket the tracker: after a split the
    counters divide between the halves (proportionally to the sampled
    keys), they don't vanish or double."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(1)
        try:
            await _storm(kv, 200)
            whole = await admin._group(addrs[0])._call(
                "Kv.range_stats", KvRangeStatsReq())
            total = whole.write_ops_s[0]
            split = b"hot/0100"
            halves = await admin._group(addrs[0])._call(
                "Kv.range_stats",
                KvRangeStatsReq(begins=[b"", split], ends=[split, KEY_MAX]))
            part = halves.write_ops_s[0] + halves.write_ops_s[1]
            # decay between the two pulls only shrinks the sum
            assert 0.5 * total <= part <= total * 1.01
            # a ~uniform storm splits ~evenly at its median
            assert halves.write_ops_s[0] > 0.2 * total
            assert halves.write_ops_s[1] > 0.2 * total
        finally:
            await cleanup()
    run(body())


# ------------------------------------------------------------------- merge

def test_merge_same_group_map_only():
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(1)
        try:
            await _storm(kv, 60)
            m = await admin.split(b"hot/0030")
            assert len(m.ranges) == 2
            m = await admin.merge(b"", KEY_MAX)
            assert len(m.ranges) == 1 and m.version == 3
            assert await admin._load_intent() is None
            # merge again: idempotent no-op
            m2 = await admin.merge(b"", KEY_MAX)
            assert m2.version == 3
            async def r(txn):
                assert await txn.get(b"hot/0042") == b"v42"
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
        finally:
            await cleanup()
    run(body())


def test_merge_cross_group_refuses_then_move_first():
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(2)
        try:
            await _storm(kv, 60)
            await admin.split(b"hot/0030")
            await admin.move(b"hot/0030", KEY_MAX, addrs[1])
            with pytest.raises(StatusError) as ei:
                await admin.merge(b"", KEY_MAX)
            assert ei.value.code == StatusCode.INVALID_ARG
            # move_first pulls the right half home, then merges
            m = await admin.merge(b"", KEY_MAX, move_first=True)
            assert len(m.ranges) == 1
            assert sorted(m.ranges[0].addresses) == sorted(addrs[0])
            assert await admin._load_intent() is None
            # every row readable, none duplicated on the old group
            async def r(txn):
                for i in range(60):
                    assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
            g1 = services[1].engine
            assert g1.read_at(b"hot/0045", g1.current_version()) is None
        finally:
            await cleanup()
    run(body())


def test_merge_crash_resume_at_each_step_boundary():
    """Mirror of the move kill-point tests: a merge dying (a) after the
    intent but before the map publish, and (b) after the publish but
    before the owned re-assert, finishes via resume() with the same
    final map either way."""
    async def body():
        for kill_at in ("publish", "owned"):
            kv, admin, services, addrs, cleanup = await _mk_groups(1)
            try:
                await _storm(kv, 40)
                await admin.split(b"hot/0020")

                real_publish = ShardAdmin.publish_map
                import t3fs_torch.kv.remote as remote_mod
                real_call = remote_mod.RemoteKVEngine._call

                async def dying_publish(self_, m, base_version=None):
                    raise RuntimeError("killed before publish")

                async def dying_owned(self_, method, req, **kw):
                    if method == "Kv.shard_set_owned":
                        raise RuntimeError("killed before owned re-assert")
                    return await real_call(self_, method, req, **kw)

                if kill_at == "publish":
                    ShardAdmin.publish_map = dying_publish
                else:
                    remote_mod.RemoteKVEngine._call = dying_owned
                try:
                    with pytest.raises(RuntimeError):
                        await admin.merge(b"", KEY_MAX)
                finally:
                    ShardAdmin.publish_map = real_publish
                    remote_mod.RemoteKVEngine._call = real_call

                # the durable intent survived the crash...
                intent = await admin._load_intent()
                assert intent is not None and intent.kind == "merge"
                # ...and resume finishes the merge idempotently
                m = await admin.resume()
                assert m is not None and len(m.ranges) == 1
                assert await admin._load_intent() is None
                # the group's owned record collapsed to the merged bounds
                async def r(txn):
                    for i in range(40):
                        assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
                    txn.set(b"hot/9999", b"post-merge")
                await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
            finally:
                await cleanup()
    run(body())


# ----------------------------------------------------------------- planner

def test_distributor_auto_splits_hot_range():
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(1)
        dist = _dist(addrs, admin)
        try:
            await _storm(kv, 200)
            rsp = await dist.tick()
            assert any(a.startswith("split") for a in rsp.actions), \
                rsp.actions
            m = await admin.load_map()
            assert len(m.ranges) == 2 and m.version == 2
            # the cut landed inside the hot prefix (traffic median)
            assert m.ranges[0].end.startswith(b"hot/")
            # zero wrong/lost rows across the split
            async def r(txn):
                for i in range(200):
                    assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
        finally:
            await dist.close()
            await cleanup()
    run(body())


def test_distributor_moves_hot_range_to_idle_group():
    """known_groups makes an empty group a move target: the map alone
    never names it, the deployment registry must.  The map starts with
    two ranges on g0 — the planner refuses to relocate a range holding
    a group's entire load (no spread improvement), so a lone
    whole-keyspace range would split, not move."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(2)
        dist = _dist(addrs, admin, split_ops_threshold=10_000.0,
                     merge_ops_threshold=0.01, imbalance_ratio=1.5)
        try:
            await _storm(kv, 120)
            await admin.split(b"hot/0060")
            rsp = await dist.tick()
            assert any(a.startswith("move") for a in rsp.actions), rsp.actions
            m = await admin.load_map()
            moved = [r for r in m.ranges
                     if sorted(r.addresses) == sorted(addrs[1])]
            assert len(moved) == 1, m.ranges
            async def r(txn):
                for i in range(120):
                    assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
            # the source group really dropped the moved rows (no dups)
            probe = b"hot/0007" if moved[0].begin == b"" else b"hot/0071"
            g0 = services[0].engine
            assert g0.read_at(probe, g0.current_version()) is None
        finally:
            await dist.close()
            await cleanup()
    run(body())


def test_cooldown_prevents_split_merge_oscillation():
    """Synthetic on/off hot spot: the split's cooldown (armed on BOTH
    halves) blocks the immediate merge-back, and after the merge the
    merged range's cooldown blocks the immediate re-split — each
    direction must wait out the window, so the map can't flap."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(1)
        dist = _dist(addrs, admin, split_ops_threshold=1.0,
                     merge_ops_threshold=0.99, cooldown_s=0.8)
        try:
            await _storm(kv, 200)
            rsp = await dist.tick()
            assert dist.splits == 1, rsp.actions
            # hot spot switches OFF; immediate ticks must NOT merge back
            before = dist.skipped_cooldown
            for _ in range(3):
                rsp = await dist.tick()
                assert rsp.actions == []
            assert dist.merges == 0
            assert dist.skipped_cooldown > before
            # wait out the cooldown; load decays below the merge
            # threshold only slowly (30 s half-life), so force the cold
            # read the planner would eventually see
            await asyncio.sleep(0.9)
            for svc in services:
                for b in svc.load.buckets:
                    b.read_ops = b.write_ops = 0.0
            rsp = await dist.tick()
            assert dist.merges == 1, rsp.actions
            m = await admin.load_map()
            assert len(m.ranges) == 1
            # and the merge armed its own cooldown: no instant re-split
            await _storm(kv, 200, prefix=b"hot2/")
            rsp = await dist.tick()
            assert dist.splits == 1 and rsp.actions == []
            assert await admin.load_map() is not None
        finally:
            await dist.close()
            await cleanup()
    run(body())


def test_distributor_skips_manual_intent_then_heals_orphan():
    """Mutual exclusion: a live intent (an operator's surgery) means the
    tick submits NOTHING; once the intent outlives resume_after_s it is
    an orphan and the distributor finishes it."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(2)
        dist = _dist(addrs, admin, resume_after_s=0.5)
        try:
            await _storm(kv, 200)
            # an operator wrote a move intent and died before driving it
            intent = MoveIntent(begin=b"", end=KEY_MAX,
                                src=list(addrs[0]), dst=list(addrs[1]))
            await admin._put_intent(intent)
            rsp = await dist.tick()
            assert rsp.actions == [] and dist.skipped_intent == 1
            assert dist.splits == dist.moves == 0
            # aged past resume_after_s -> healed, not planned around
            await asyncio.sleep(0.6)
            rsp = await dist.tick()
            assert dist.resumed == 1, rsp.actions
            assert await admin._load_intent() is None
            m = await admin.load_map()
            assert sorted(m.ranges[0].addresses) == sorted(addrs[1])
            async def r(txn):
                assert await txn.get(b"hot/0101") == b"v101"
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
        finally:
            await dist.close()
            await cleanup()
    run(body())


# ------------------------------------------------- crash/restart convergence

def test_distributor_killed_mid_copy_restart_converges():
    """Acceptance kill-point 1: the distributor dies DURING the snapshot
    copy of a move its tick launched; a fresh distributor's start()
    heals the orphan and the map converges with no lost/duplicate rows."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(2)
        d1 = _dist(addrs, admin, split_ops_threshold=10_000.0,
                   imbalance_ratio=1.5)
        d1.admin.page_rows = 32
        d1.admin.freeze_ttl_s = 0.5
        try:
            await _storm(kv, 120)
            # two ranges on g0: a range holding ALL of a group's load
            # never moves (no spread improvement), so the planner needs
            # a split in place before its tick can launch the move
            await admin.split(b"hot/0060")
            import t3fs_torch.kv.remote as remote_mod
            real_call = remote_mod.RemoteKVEngine._call
            calls = {"n": 0}

            async def dying_call(self_, method, req, **kw):
                if method == "Kv.shard_load":
                    calls["n"] += 1
                    if calls["n"] == 2:
                        raise RuntimeError("distributor killed mid-copy")
                return await real_call(self_, method, req, **kw)

            remote_mod.RemoteKVEngine._call = dying_call
            try:
                with pytest.raises(RuntimeError):
                    await d1.tick()
            finally:
                remote_mod.RemoteKVEngine._call = real_call
            intent = await admin._load_intent()
            assert intent is not None and intent.kind == "move"

            # freeze lapses; a write lands between the attempts
            await asyncio.sleep(0.6)
            async def w(txn):
                txn.set(b"hot/9999", b"between-attempts")
            await asyncio.wait_for(with_transaction(kv, w), timeout=5.0)

            # the restarted distributor heals on start()
            d2 = _dist(addrs, admin)
            await d2.start()
            try:
                assert d2.resumed == 1
                assert await admin._load_intent() is None
                m = await admin.load_map()
                moved = [r for r in m.ranges
                         if (r.begin, r.end) == (intent.begin, intent.end)]
                assert len(moved) == 1, m.ranges
                assert sorted(moved[0].addresses) == sorted(addrs[1])
                async def r(txn):
                    for i in range(120):
                        assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
                    assert await txn.get(b"hot/9999") == b"between-attempts"
                await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
                # the moved half really changed hands engine-to-engine
                probe, want = ((b"hot/0007", b"v7") if intent.begin == b""
                               else (b"hot/0071", b"v71"))
                g0, g1 = services[0].engine, services[1].engine
                assert g0.read_at(probe, g0.current_version()) is None
                assert g1.read_at(probe, g1.current_version()) == want
            finally:
                await d2.close()
        finally:
            await d1.close()
            await cleanup()
    run(body())


def test_distributor_killed_after_ownership_drop_restart_converges():
    """Acceptance kill-point 2: death AFTER the source dropped ownership
    but BEFORE the map publish — the harshest window (stale clients
    bounce off KV_WRONG_SHARD until healed)."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(2)
        try:
            await _storm(kv, 60)

            async def dying_publish(m, base_version=None):
                raise RuntimeError("killed after ownership drop")
            real_publish = admin.publish_map
            admin.publish_map = dying_publish
            try:
                with pytest.raises(RuntimeError):
                    await admin.move(b"", KEY_MAX, addrs[1])
            finally:
                admin.publish_map = real_publish
            assert await admin._load_intent() is not None
            # the source refuses the range NOW (ownership dropped):
            # an acked write can no longer land where cleanup erases it
            with pytest.raises(StatusError) as ei:
                stale = ShardedKVEngine(
                    ShardMap(ranges=[ShardRange(b"", KEY_MAX, addrs[0])],
                             version=1),
                    client=admin.client)
                txn = stale.transaction()
                txn.set(b"hot/0001", b"stale-write")
                await txn.commit()
            assert ei.value.code in (StatusCode.KV_WRONG_SHARD,
                                     StatusCode.TXN_CONFLICT,
                                     StatusCode.KV_SHARD_FROZEN)

            d2 = _dist(addrs, admin)
            await d2.start()
            try:
                assert d2.resumed == 1
                m = await admin.load_map()
                assert sorted(m.ranges[0].addresses) == sorted(addrs[1])
                async def r(txn):
                    for i in range(60):
                        assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
                    txn.set(b"hot/0001", b"post-heal")
                await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
            finally:
                await d2.close()
        finally:
            await cleanup()
    run(body())


# ------------------------------------------------------------------ pacing

def test_move_copy_pacing_waits_are_backpressure():
    """A tight byte budget slows the copy (pacer.waits climbs) but never
    errors, and the freeze is re-extended across the waits so no write
    can sneak into an already-copied page."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_groups(2)
        try:
            await _storm(kv, 120)
            from t3fs_torch.client.repair import TokenBucketPacer
            admin.pacer = TokenBucketPacer(0.02, floor_bytes=1)  # 20 kB/s
            admin.pacer.tokens = 0.0       # no initial burst
            admin.page_rows = 32
            admin.freeze_ttl_s = 1.0
            m = await admin.move(b"", KEY_MAX, addrs[1])
            assert sorted(m.ranges[0].addresses) == sorted(addrs[1])
            assert admin.pacer.waits > 0
            assert admin.pacer.waited_s > 0.0
            async def r(txn):
                for i in range(120):
                    assert await txn.get(b"hot/%04d" % i) == b"v%d" % i
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
        finally:
            await cleanup()
    run(body())


# -------------------------------------------------------- LocalCluster wiring

def test_localcluster_heals_orphan_intent_on_restart():
    """A mover killed mid-copy leaves a durable intent; the
    meta-plane restart (LocalCluster bring-up path) heals it without
    operator action and every file survives."""
    async def body():
        from t3fs_torch.testing.cluster import LocalCluster
        c = LocalCluster(num_nodes=3, with_meta=True, kv_shards=2,
                         checksum_backend="cpu", heartbeat_timeout_s=60.0)
        await c.start()
        try:
            await c.mc.mkdirs("/d")
            for i in range(12):
                await c.mc.create(f"/d/f{i}")
            # split the user keyspace and kill a move of the upper half
            await c.kv_admin.split(b"I")
            c.kv_admin.page_rows = 4
            c.kv_admin.freeze_ttl_s = 0.5
            dst = [c.kv_groups[1][1].address]
            import t3fs_torch.kv.remote as remote_mod
            real_call = remote_mod.RemoteKVEngine._call
            calls = {"n": 0}

            async def dying_call(self_, method, req, **kw):
                if method == "Kv.shard_load":
                    calls["n"] += 1
                    if calls["n"] == 2:
                        raise RuntimeError("mover killed mid-copy")
                return await real_call(self_, method, req, **kw)

            remote_mod.RemoteKVEngine._call = dying_call
            try:
                with pytest.raises(RuntimeError):
                    await c.kv_admin.move(b"I", KEY_MAX, dst)
            finally:
                remote_mod.RemoteKVEngine._call = real_call
            assert await c.kv_admin._load_intent() is not None

            await asyncio.sleep(0.6)          # freeze lapses
            await c.restart_meta_plane()
            # bring-up finished the surgery: intent gone, map flipped
            assert await c.kv_admin._load_intent() is None
            m = await c.kv_admin.load_map()
            moved = [r for r in m.ranges if r.begin == b"I"]
            assert moved and sorted(moved[0].addresses) == sorted(dst)
            # no duplicate/dropped metadata rows: everything stats
            for i in range(12):
                assert await c.mc.stat(f"/d/f{i}") is not None
            ents = await c.mc.readdir("/d")
            assert len(ents) == 12
        finally:
            await c.stop()
    run(body())


# ------------------------------------------------ against the reference

async def tick_run(pkg: str) -> dict:
    """Two groups of package pkg, the whole keyspace on g0; a seeded write
    and read load, skewed onto a hot prefix; then the range_stats g0
    answers, and two KVDistributor ticks (a split at the sampled median,
    then a move of the hotter half to the idle group).  -> the stats,
    each tick's actions and map version, the counters, and each group's
    rows, with the addresses named."""
    P = D.PKGS[pkg]
    rng = np.random.default_rng(D.SEED)
    names = D.Names()
    nodes = []
    for g in range(2):
        node = await D.Node(P, P.engine.MemKVEngine(),
                            prepare_timeout_s=5.0).start()
        names.add(node.address, f"g{g}")
        nodes.append(node)
    addrs = [[n.address] for n in nodes]
    ship = P.client.Client()
    m = P.shard.ShardMap(ranges=[P.shard.ShardRange(
        b"", P.shard.KEY_MAX, addrs[0])], version=1)
    admin = P.surgery.ShardAdmin(addrs[0], client=ship)
    await admin.publish_map(m)
    kv = P.shard.ShardedKVEngine(m, client=ship, map_home=addrs[0])
    out = {}
    try:
        hot = rng.zipf(1.3, 400) % 200
        cold = rng.integers(0, 50, 40)
        for base in range(0, len(hot), 25):
            async def w(txn, base=base):
                for i in hot[base:base + 25]:
                    txn.set(b"hot/%04d" % i, rng.bytes(int(rng.integers(1, 64))))
            await P.engine.with_transaction(kv, w)
        for i in cold:
            async def r(txn, i=i):
                await txn.get(b"cold/%04d" % i)
                txn.set(b"cold/%04d" % i, b"c")
            await P.engine.with_transaction(kv, r)
        rsp = await admin._group(addrs[0])._call(
            "Kv.range_stats", P.service.KvRangeStatsReq())
        out["stats"] = P.serde.dumps(rsp)
        dist = P.dist.KVDistributor(
            admin.map_home, client=ship, tick_period_s=999.0,
            split_ops_threshold=2.0, merge_ops_threshold=0.01,
            cooldown_s=0.0, known_groups=[list(a) for a in addrs])
        for t in range(2):
            tick = await dist.tick()
            out[f"tick{t}"] = names((tick.actions, tick.map_version))
        out["counters"] = (dist.splits, dist.moves, dist.merges,
                           dist.errors, dist.skipped_cooldown)
        out["map"] = names(P.serde.dumps(await admin.load_map()))
        out["rows"] = names([D.dump_engine(n.engine) for n in nodes])
        await dist.close()
    finally:
        await kv.close()
        for n in nodes:
            await n.stop()
    return out


def test_distributor_tick_matches_reference(monkeypatch):
    """One seeded load: the same range_stats bytes (rates, sizes, sampled
    split key), and the same two ticks in both packages: a split at the
    sampled median, then a move to the idle group, to the same map and
    rows."""
    out = {}
    for name in ("ref", "port"):
        D.pin(monkeypatch)
        out[name] = run(tick_run(name))
    ref = out["ref"]
    assert ref["tick0"][0] and ref["tick0"][0][0].startswith("split")
    assert ref["tick1"][0] and ref["tick1"][0][0].startswith("move")
    assert ref["counters"][:2] == (1, 1)
    assert out["port"] == ref
