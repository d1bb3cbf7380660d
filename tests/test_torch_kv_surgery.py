"""The port's online shard surgery (t3fs_torch.kv.surgery: ShardAdmin's
split, move, merge and resume over the service's shard gates) against the
JAX package's: every case of tests/test_kv_surgery.py on the port, then a
whole move with the same RPCs in the same order, the same map and rows, a
move killed at each of its RPCs and resumed by a new driver, with the
intent, map and rows after the kill and after the resume equal to the
reference's, and the admin CLI's kv-* commands: one operator sequence
through the reference's CLI and through the port's, each over port KV
groups of its own, with equal outputs.  time.time is pinned in both
packages with monkeypatch (tests/torch_kv_diff.py); nothing in either
package changes for it."""

import asyncio

import pytest

import torch_kv_diff as D
from t3fs_torch.kv.engine import MemKVEngine, with_transaction
from t3fs_torch.kv.service import KvService
from t3fs_torch.kv.shard import (
    KEY_MAX, MAP_KEY, ShardMap, ShardRange, ShardedKVEngine,
)
from t3fs_torch.kv.surgery import ShardAdmin
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.status import StatusCode, StatusError


def run(coro):
    return asyncio.run(coro)


async def _mk_cluster(n_groups: int = 3, split: bytes = b"m"):
    """Groups 0..n-1 running; group 0 serves [b'', split), group 1 serves
    [split, MAX); later groups start EMPTY (move targets).  Group 0 is
    also the map home."""
    ship = Client()
    servers, services, addrs = [], [], []
    for i in range(n_groups):
        svc = KvService(MemKVEngine(), client=ship, prepare_timeout_s=5.0)
        srv = Server(); srv.add_service(svc)
        await srv.start()
        servers.append(srv); services.append(svc)
        addrs.append([srv.address])
    m = ShardMap(ranges=[ShardRange(b"", split, addrs[0]),
                         ShardRange(split, KEY_MAX, addrs[1])],
                 version=1)
    admin = ShardAdmin(addrs[0], client=ship)
    await admin.publish_map(m)
    kv = ShardedKVEngine(m, client=ship, map_home=addrs[0])

    async def cleanup():
        await kv.close()
        for s in servers:
            await s.stop()
    return kv, admin, services, addrs, cleanup


def test_split_then_move_live_range():
    """Split [m,MAX) at 's' and move [s,MAX) to an empty group while a
    client keeps reading/writing — no lost or stale data."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_cluster()
        try:
            # seed data across the keyspace
            async def seed(txn):
                for i in range(40):
                    txn.set(b"k%02d" % i, b"v%d" % i)
                    txn.set(b"z%02d" % i, b"zv%d" % i)
            await with_transaction(kv, seed)

            m = await admin.split(b"s")
            assert [r.begin for r in m.ranges] == [b"", b"m", b"s"]
            m = await admin.move(b"s", KEY_MAX, addrs[2])
            assert [list(r.addresses) for r in m.ranges] == \
                [addrs[0], addrs[1], addrs[2]]

            # the CLIENT still holds the old map: its next touch of the
            # moved range must transparently converge via refresh+retry
            async def rw(txn):
                assert await txn.get(b"z07") == b"zv7"
                txn.set(b"z99", b"new")
            await with_transaction(kv, rw)
            assert kv.map.version == m.version

            # the moved rows live on group 2 and are GONE from group 1
            g2 = services[2].engine
            assert g2.read_at(b"z07", g2.current_version()) == b"zv7"
            assert g2.read_at(b"z99", g2.current_version()) == b"new"
            g1 = services[1].engine
            assert g1.read_at(b"z07", g1.current_version()) is None
            # unmoved halves untouched
            t = kv.transaction()
            assert await t.get(b"k03") == b"v3"
            # a stale DIRECT write to the old group is refused
            with pytest.raises(StatusError) as ei:
                txn = kv.groups[1].transaction()   # group 1 = [m,s) now
                txn.set(b"z50", b"stale")
                await txn.commit()
            assert ei.value.code in (StatusCode.KV_WRONG_SHARD,
                                     StatusCode.TXN_CONFLICT)
        finally:
            await cleanup()
    run(body())


def test_move_killed_mid_copy_converges():
    """Kill the mover BEFORE the flip: the freeze expires, the source
    keeps serving, resume() re-copies fresh (including writes that landed
    between the attempts) and completes."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_cluster()
        try:
            async def seed(txn):
                for i in range(30):
                    txn.set(b"z%02d" % i, b"zv%d" % i)
            await with_transaction(kv, seed)

            # sabotage: the target's load_range dies after the first page
            admin.page_rows = 8
            admin.freeze_ttl_s = 0.5
            orig_drive = admin._drive
            calls = {"n": 0}
            real_call = type(kv.groups[0])._call

            async def dying_call(self_, method, req, **kw):
                if method == "Kv.shard_load":
                    calls["n"] += 1
                    if calls["n"] == 2:
                        raise RuntimeError("mover killed mid-copy")
                return await real_call(self_, method, req, **kw)

            import t3fs_torch.kv.remote as remote_mod
            remote_mod.RemoteKVEngine._call = dying_call
            try:
                with pytest.raises(RuntimeError):
                    await admin.move(b"m", KEY_MAX, addrs[2])
            finally:
                remote_mod.RemoteKVEngine._call = real_call

            # the durable intent SURVIVES the failure (it clears only
            # after full success) — that is what resume() keys on
            assert await admin._load_intent() is not None

            # freeze expires -> source serves again; a write lands
            await asyncio.sleep(0.6)
            async def w(txn):
                txn.set(b"z50", b"landed-between-attempts")
            await asyncio.wait_for(with_transaction(kv, w), timeout=5.0)

            # resume completes the move and the late write survived
            m = await admin.resume()
            assert m is not None
            g2 = services[2].engine
            assert g2.read_at(b"z50",
                              g2.current_version()) == b"landed-between-attempts"
            assert g2.read_at(b"z07", g2.current_version()) == b"zv7"
            # client converges
            async def r(txn):
                assert await txn.get(b"z50") == b"landed-between-attempts"
            await asyncio.wait_for(with_transaction(kv, r), timeout=5.0)
            assert await admin._load_intent() is None
        finally:
            await cleanup()
    run(body())


def test_move_killed_after_flip_freeze_lapse_no_acked_write_loss():
    """Kill the mover AFTER the map
    flip, let freeze_ttl_s lapse while it stays dead, and have a
    stale-map client write to the source.  The source dropped ownership
    at flip time, so the write must get KV_WRONG_SHARD — with the old
    order (ownership drop in post-flip cleanup) the lapsed freeze let
    the source ACK it and resume()'s delete_range then erased it."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_cluster()
        try:
            async def seed(txn):
                for i in range(10):
                    txn.set(b"z%02d" % i, b"zv%d" % i)
            await with_transaction(kv, seed)

            admin.freeze_ttl_s = 0.3
            real_call = type(kv.groups[0])._call

            async def dying_call(self_, method, req, **kw):
                # first POST-flip touch of the source is its cleanup
                # delete_range — dying here leaves map flipped, source
                # drained of ownership, freeze ticking to expiry
                if method == "Kv.shard_delete_range" and \
                        self_.addresses == addrs[1]:
                    raise RuntimeError("mover killed after flip")
                return await real_call(self_, method, req, **kw)

            import t3fs_torch.kv.remote as remote_mod
            remote_mod.RemoteKVEngine._call = dying_call
            try:
                with pytest.raises(RuntimeError):
                    await admin.move(b"m", KEY_MAX, addrs[2])
            finally:
                remote_mod.RemoteKVEngine._call = real_call
            # the intent survived the crash (clears only on full success)
            assert await admin._load_intent() is not None

            # mover stays dead past the freeze TTL
            await asyncio.sleep(0.5)

            # stale-map client writes to the SOURCE: must be refused
            # even though the freeze lapsed
            stale = ShardedKVEngine(
                ShardMap(ranges=[ShardRange(b"", b"m", addrs[0]),
                                 ShardRange(b"m", KEY_MAX, addrs[1])],
                         version=1),
                client=admin.client)
            with pytest.raises(StatusError) as ei:
                txn = stale.transaction()
                txn.set(b"z03", b"stale-client-write")
                await txn.commit()
            assert ei.value.code in (StatusCode.KV_WRONG_SHARD,
                                     StatusCode.TXN_CONFLICT)

            # fresh-map clients already route to the target and get acks
            async def w(txn):
                assert await txn.get(b"z03") == b"zv3"
                txn.set(b"z98", b"acked-mid-window")
            await asyncio.wait_for(with_transaction(kv, w), timeout=5.0)

            m = await admin.resume()
            assert m is not None
            assert await admin._load_intent() is None
            # NO acked row was deleted: every seed + the mid-window ack
            # survive on the target; the source dropped its copies
            g2 = services[2].engine
            for i in range(10):
                assert g2.read_at(b"z%02d" % i,
                                  g2.current_version()) == b"zv%d" % i
            assert g2.read_at(b"z98",
                              g2.current_version()) == b"acked-mid-window"
            g1 = services[1].engine
            assert g1.read_at(b"z03", g1.current_version()) is None
        finally:
            await cleanup()
    run(body())


def test_move_killed_between_ownership_drop_and_publish():
    """The bounded-unavailability half of the reorder: mover dies after
    the source dropped ownership but BEFORE the map publish.  Stale
    clients bounce off KV_WRONG_SHARD (no acks, no loss); resume()
    re-copies and publishes, after which clients converge."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_cluster()
        try:
            async def seed(txn):
                for i in range(10):
                    txn.set(b"z%02d" % i, b"zv%d" % i)
            await with_transaction(kv, seed)

            admin.freeze_ttl_s = 0.3
            real_publish = admin.publish_map
            boom = {"armed": True}

            async def dying_publish(m, base_version=None):
                if boom["armed"]:
                    boom["armed"] = False
                    raise RuntimeError("mover killed before publish")
                return await real_publish(m, base_version=base_version)

            admin.publish_map = dying_publish
            with pytest.raises(RuntimeError):
                await admin.move(b"m", KEY_MAX, addrs[2])
            assert await admin._load_intent() is not None

            # freeze lapses; the source STILL refuses (ownership gone)
            await asyncio.sleep(0.5)
            txn = kv.groups[1].transaction()
            txn.set(b"z03", b"window-write")
            with pytest.raises(StatusError) as ei:
                await txn.commit()
            assert ei.value.code in (StatusCode.KV_WRONG_SHARD,
                                     StatusCode.TXN_CONFLICT)

            m = await admin.resume()
            assert m is not None
            g2 = services[2].engine
            for i in range(10):
                assert g2.read_at(b"z%02d" % i,
                                  g2.current_version()) == b"zv%d" % i
            # converged client round-trip through the new map
            async def rw(txn):
                assert await txn.get(b"z07") == b"zv7"
                txn.set(b"z99", b"post-resume")
            await asyncio.wait_for(with_transaction(kv, rw), timeout=5.0)
            assert g2.read_at(b"z99", g2.current_version()) == b"post-resume"
        finally:
            await cleanup()
    run(body())


def test_publish_map_cas_and_pending_intent_guard():
    """Concurrent surgery must not lose updates (CAS on
    the map record) and a pending move intent blocks a DIFFERENT move."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_cluster()
        try:
            m = await admin.load_map()
            # CAS: publishing against a stale base version conflicts
            stale = ShardMap(ranges=list(m.ranges), version=m.version + 1)
            await admin.publish_map(stale, base_version=m.version)
            with pytest.raises(StatusError) as ei:
                await admin.publish_map(
                    ShardMap(ranges=list(m.ranges), version=m.version + 1),
                    base_version=m.version)   # stale base
            assert ei.value.code == StatusCode.TXN_CONFLICT

            # pending-intent guard
            from t3fs_torch.kv.surgery import MoveIntent
            await admin._put_intent(MoveIntent(
                begin=b"m", end=KEY_MAX, src=addrs[1], dst=addrs[2]))
            with pytest.raises(StatusError) as ei:
                await admin.move(b"", b"m", addrs[2])   # DIFFERENT range
            assert ei.value.code == StatusCode.BUSY
            await admin._put_intent(None)
        finally:
            await cleanup()
    run(body())


def test_clear_range_gated_against_frozen_and_unowned():
    """A clear_range must be FULLY owned and must not
    overlap a frozen range (begin-only checking let wide clears
    half-apply or delete already-copied rows)."""
    async def body():
        kv, admin, services, addrs, cleanup = await _mk_cluster()
        try:
            from t3fs_torch.kv.service import KvShardOwnedReq, KvShardRangeReq
            g1 = kv.groups[1]
            # group 1 owns [m, s) only
            await g1._call("Kv.shard_set_owned", KvShardOwnedReq(
                begins=[b"m"], ends=[b"s"]))
            txn = g1.transaction()
            txn.clear_range(b"n", b"z")       # extends past owned end
            with pytest.raises(StatusError) as ei:
                await txn.commit()
            assert ei.value.code == StatusCode.KV_WRONG_SHARD

            # frozen overlap: clear starting BEFORE the frozen begin
            await g1._call("Kv.shard_set_owned", KvShardOwnedReq(
                begins=[b"m"], ends=[b"z"]))
            await g1._call("Kv.shard_freeze", KvShardRangeReq(
                begin=b"p", end=b"q", ttl_s=30.0))
            txn = g1.transaction()
            txn.clear_range(b"m", b"r")
            with pytest.raises(StatusError) as ei:
                await txn.commit()
            assert ei.value.code == StatusCode.KV_SHARD_FROZEN
            await g1._call("Kv.shard_unfreeze", KvShardRangeReq())
        finally:
            await cleanup()
    run(body())


# ------------------------------------------------ against the reference

async def move_run(pkg: str, kill_at: int | None, monkeypatch) -> dict:
    """Three single-node groups of package pkg, the map [b'', m) on g0 and
    [m, MAX) on g1 (g0 the map home), rows seeded on both sides; then
    ShardAdmin.move([m, MAX) -> g2) with the kill_at-th RPC of the mover
    raising (None: no kill), and a fresh ShardAdmin's resume().  -> every
    RPC the mover made, and the intent, map, and each group's rows after
    the kill and after the resume, with the addresses named."""
    P = D.PKGS[pkg]
    names = D.Names()
    nodes = []
    for g in range(3):
        node = await D.Node(P, P.engine.MemKVEngine(),
                            prepare_timeout_s=5.0).start()
        names.add(node.address, f"g{g}")
        nodes.append(node)
    addrs = [[n.address] for n in nodes]
    ship = P.client.Client()
    m = P.shard.ShardMap(ranges=[
        P.shard.ShardRange(b"", b"m", addrs[0]),
        P.shard.ShardRange(b"m", P.shard.KEY_MAX, addrs[1])], version=1)
    admin = P.surgery.ShardAdmin(addrs[0], client=ship, page_rows=8)
    await admin.publish_map(m)
    kv = P.shard.ShardedKVEngine(m, client=ship, map_home=addrs[0])

    async def seed(txn):
        for i in range(10):
            txn.set(b"a%02d" % i, b"av%d" % i)
        for i in range(30):
            txn.set(b"z%02d" % i, b"zv%d" % i)
    await P.engine.with_transaction(kv, seed)

    async def state():
        intent = await admin._load_intent()
        return names({
            "intent": P.serde.dumps(intent) if intent else None,
            "map": P.serde.dumps(await admin.load_map()),
            "rows": [D.dump_engine(n.engine) for n in nodes]})

    calls = []
    real_call = P.remote.RemoteKVEngine._call

    async def counted(self_, method, req, **kw):
        calls.append(method)
        if len(calls) == kill_at:
            raise RuntimeError("mover killed")
        return await real_call(self_, method, req, **kw)

    out = {}
    try:
        monkeypatch.setattr(P.remote.RemoteKVEngine, "_call", counted)
        try:
            await admin.move(b"m", P.shard.KEY_MAX, addrs[2])
            out["killed"] = False
        except RuntimeError:
            out["killed"] = True
        finally:
            monkeypatch.setattr(P.remote.RemoteKVEngine, "_call", real_call)
        out["calls"] = calls
        out["after_kill"] = await state()
        # a new driver process picks the intent up
        admin2 = P.surgery.ShardAdmin(addrs[0], client=ship, page_rows=8)
        healed = await admin2.resume()
        out["resumed"] = healed is not None
        out["after_resume"] = await state()

        async def read(txn):
            return await txn.get_range(b"a", b"\xff")
        fresh = P.shard.ShardedKVEngine(await admin2.load_map(),
                                        client=ship, map_home=addrs[0])
        out["read_back"] = await P.engine.with_transaction(fresh, read)
    finally:
        await kv.close()
        for n in nodes:
            await n.stop()
    return out


# the mover's RPCs in a whole move of 30 rows at 8 rows a page
MOVE_CALLS = 27


def test_move_rpcs_match_reference(monkeypatch):
    """A whole move makes the same RPCs, in the same order, in both
    packages, and ends in the same map and rows; MoveIntent's bytes are
    the reference's."""
    out = {}
    for name in ("ref", "port"):
        D.pin(monkeypatch)
        out[name] = run(move_run(name, None, monkeypatch))
    assert len(out["ref"]["calls"]) == MOVE_CALLS
    assert out["port"] == out["ref"]
    intent = dict(begin=b"m", end=b"\xff", src=["a:1"], dst=["b:2"],
                  kind="merge")
    assert D.PKGS["port"].serde.dumps(
        D.PKGS["port"].surgery.MoveIntent(**intent)) == \
        D.PKGS["ref"].serde.dumps(D.PKGS["ref"].surgery.MoveIntent(**intent))


@pytest.mark.parametrize("kill_at", range(1, MOVE_CALLS + 1))
def test_move_killed_then_resumed_like_reference(monkeypatch, kill_at):
    """The mover dies at its kill_at-th RPC: the intent, map and rows left
    behind, and the resume() that finishes the move, equal the
    reference's; every seeded row reads back through the final map."""
    out = {}
    for name in ("ref", "port"):
        D.pin(monkeypatch)
        out[name] = run(move_run(name, kill_at, monkeypatch))
    assert out["ref"]["killed"]
    assert out["port"] == out["ref"]
    rows = out["ref"]["read_back"]
    assert len(rows) == 40 and out["ref"]["after_resume"]["intent"] is None


# ------------------------------------------------ the admin CLI's kv-*

async def kv_cli_run(admin) -> list:
    """Three single-node port groups with no map yet and one package's
    CLI: publish the map, split, move, resume, merge, each shown with
    kv-map and kv-status.  -> each command's (rc, stdout, stderr) with the
    groups' addresses named g0..g2."""
    from test_torch_admin_cli import Session
    P = D.PKGS["port"]
    names = D.Names()
    nodes = []
    for g in range(3):
        node = await D.Node(P, P.engine.MemKVEngine(),
                            prepare_timeout_s=5.0).start()
        names.add(node.address, f"g{g}")
        nodes.append(node)
    g0, g1, g2 = (n.address for n in nodes)
    sess = Session(admin)
    out = []

    async def cli(*argv):
        out.append(names(await sess.run(*argv)))
        return out[-1]

    try:
        await cli("kv-status", g0, g1, g2, "127.0.0.1:1")
        await cli("kv-map", g0)                     # no map yet
        await cli("kv-publish-map", f"{g0};6d;{g1}")
        await cli("kv-publish-map", f"{g0};6d;{g1}")  # already published
        await cli("kv-publish-map", f"{g0};6d")       # malformed spec
        m = await P.surgery.ShardAdmin([g0], client=sess.ctx.cli).load_map()
        kv = P.shard.ShardedKVEngine(m, client=nodes[0].ship, map_home=[g0])

        async def seed(txn):
            for i in range(10):
                txn.set(b"a%02d" % i, b"av%d" % i)
            for i in range(30):
                txn.set(b"z%02d" % i, b"zv%d" % i)
        await P.engine.with_transaction(kv, seed)
        await kv.close()
        await cli("kv-map", g0, "--no-load")
        await cli("kv-split", "s", g0)
        await cli("kv-move", "s", "MAX", g2, "--map-home", g0)
        await cli("kv-move-resume", g0)
        await cli("kv-map", g0, "--no-load")
        await cli("kv-merge", "m", "MAX", "--map-home", g0)  # across groups
        await cli("kv-merge", "m", "MAX", "--map-home", g0, "--move-first")
        await cli("kv-map", g0, "--no-load")
        await cli("kv-status", g0, g1, g2)
        out.append(names([D.dump_engine(n.engine) for n in nodes]))
    finally:
        await sess.close()
        for n in nodes:
            await n.stop()
    return out


def test_kv_cli_commands_equal_across_packages(monkeypatch):
    """The kv-* commands (tests/test_kv_surgery.py's CLI case) through both
    packages' build_parser and dispatch, each over port groups of its own:
    equal outputs, equal rows after."""
    import t3fs.cli.admin as ref_admin
    import t3fs_torch.cli.admin as port_admin
    from test_torch_admin_cli import cases_of
    out = {}
    for name, admin in (("ref", ref_admin), ("port", port_admin)):
        D.pin(monkeypatch)
        out[name] = run(kv_cli_run(admin))
    assert out["port"] == out["ref"]
    port = out["port"]
    assert port[0][1] == ("g0: primary seq=0\ng1: primary seq=0\n"
                          "g2: primary seq=0\n"
                          "127.0.0.1:1: unreachable (RPC_CONNECT_FAILED)\n")
    assert "published shard map v1: 2 ranges" in port[2][1]
    assert port[3][0] == "exit map already published (v1); surgery " \
        "commands evolve it from here"
    assert port[6][1] == "map v2: 3 ranges\n"
    assert port[7][1] == "moved; map v3\n"
    assert port[8][1] == "no pending move intent\n"
    assert "merged; map v" in port[11][1]
    rows = port[-1]
    assert sum(len(r) for r in rows) >= 40
    assert {"kv-status", "kv-publish-map", "kv-map", "kv-split", "kv-move",
            "kv-merge", "kv-move-resume"} == cases_of(
        "tests/test_torch_kv_surgery.py::"
        "test_kv_cli_commands_equal_across_packages")
