"""The port's cluster control plane (t3fs_torch.{kv,mgmtd,client,storage})
against the JAX package's (t3fs): the chain state machine over a seeded
sweep, the transactional KV over seeded schedules, heartbeats and routing
across the two packages on the wire, and a resync between a reference node
and a port node in each direction.  Everything runs on the CPU."""

import asyncio

import numpy as np
import pytest

from t3fs.client.layout import FileLayout as RefLayout
from t3fs.kv import engine as ref_kv
from t3fs.mgmtd import service as ref_mgmtd
from t3fs.mgmtd import types as ref_types
from t3fs.utils import serde as ref_serde
from t3fs_torch.client.layout import FileLayout as PortLayout
from t3fs_torch.kv import engine as port_kv
from t3fs_torch.mgmtd import service as port_mgmtd
from t3fs_torch.mgmtd import types as port_types
from t3fs_torch.utils import serde as port_serde

PACKAGES = {"ref": (ref_mgmtd, ref_types, ref_serde),
            "port": (port_mgmtd, port_types, port_serde)}
LAYOUTS = {"ref": RefLayout, "port": PortLayout}
SWEEP_CASES = 2400


# ---------------------------------------------------------------- chain state

def make_case(rng: np.random.Generator) -> dict:
    """One chain of 1-4 targets in any public state, with an alive map, a
    local map over every LocalTargetState (or none), and the restarted and
    fresh sets; node ids may repeat so that a node carries two targets."""
    n = int(rng.integers(1, 5))
    pub = [int(s) for s in ref_types.PublicTargetState]
    loc = [int(s) for s in ref_types.LocalTargetState]
    targets = []
    for i in range(n):
        tid = 100 * (i + 1) + int(rng.integers(0, 3))
        node = int(rng.integers(1, n + 2))
        targets.append((tid, node, int(rng.choice(pub))))
    nodes = sorted({t[1] for t in targets})
    alive = {nd: bool(rng.integers(0, 2)) for nd in nodes
             if rng.random() < 0.9}
    local = {t[0]: int(rng.choice(loc)) for t in targets if rng.random() < 0.85}
    restarted = {t[0] for t in targets if rng.random() < 0.25}
    fresh = {t[0] for t in targets if rng.random() < 0.25}
    ids = [t[0] for t in targets]
    preferred = [int(x) for x in rng.permutation(ids)]
    if rng.random() < 0.2:
        preferred.append(999)          # an id the chain does not hold
    if rng.random() < 0.2 and preferred:
        preferred.pop(int(rng.integers(0, len(preferred))))
    return dict(targets=targets, ver=int(rng.integers(1, 9)), alive=alive,
                local=local, restarted=restarted, fresh=fresh,
                preferred=preferred)


def run_case(pkg: str, case: dict) -> list:
    """Each function of the state machine on one case, recorded as serde
    bytes (None when it reports no change, the exception's type name when
    it raises, and whether the rotations returned their input unchanged)."""
    svc, types, serde = PACKAGES[pkg]

    def chain():
        return types.ChainInfo(7, case["ver"], [
            types.ChainTargetInfo(t, nd, types.PublicTargetState(s))
            for t, nd, s in case["targets"]], list(case["preferred"]))

    out = []
    try:
        nxt = svc.next_chain_state(
            chain(), dict(case["alive"]),
            {t: types.LocalTargetState(s) for t, s in case["local"].items()},
            restarted=set(case["restarted"]), fresh=set(case["fresh"]))
        out.append(None if nxt is None else serde.dumps(nxt))
    except Exception as e:            # both packages must fail alike
        out.append(type(e).__name__)
    for fn, args in ((svc.rotate_last_srv, ()),
                     (svc.rotate_as_preferred_order, (case["preferred"],))):
        c = chain()
        got = fn(c.targets, *args)
        out.append((got is c.targets, serde.dumps(
            types.ChainInfo(7, case["ver"], got, []))))
    return out


@pytest.mark.parametrize("part", range(4))
def test_chain_state_machine_matches_reference(part):
    rng = np.random.default_rng(9000 + part)
    changed = raised = 0
    for i in range(SWEEP_CASES // 4):
        case = make_case(rng)
        ref, port = run_case("ref", case), run_case("port", case)
        assert port == ref, (i, case)
        changed += isinstance(ref[0], bytes)
        raised += isinstance(ref[0], str)
    # the sweep reaches both outcomes and the INVALID state's KeyError
    assert changed > SWEEP_CASES // 20 and raised > 0, (changed, raised)


# ---------------------------------------------------------------- KV engine

def kv_schedule(seed: int, n_txns: int = 6, n_steps: int = 80) -> list[tuple]:
    """Interleaved steps over up to n_txns open transactions on 12 keys:
    (txn, op, args); 'commit' closes a transaction, which a later 'open'
    reuses."""
    rng = np.random.default_rng(seed)
    keys = [b"k%02d" % i for i in range(12)]
    steps = []
    for _ in range(n_steps):
        t = int(rng.integers(0, n_txns))
        op = str(rng.choice(["get", "sget", "range", "many", "set", "clear",
                             "clear_range", "commit"],
                            p=[.2, .08, .1, .07, .25, .07, .05, .18]))
        a, b = sorted(int(x) for x in rng.integers(0, 12, 2))
        val = bytes(rng.integers(0, 256, int(rng.integers(0, 6)), dtype=np.uint8))
        steps.append((t, op, keys[a], keys[b], val))
    return steps


async def run_kv_schedule(kv_mod, steps) -> tuple[list, list]:
    eng = kv_mod.MemKVEngine()
    open_: dict[int, object] = {}
    log = []
    for t, op, ka, kb, val in steps:
        txn = open_.get(t)
        if txn is None:
            txn = open_[t] = eng.transaction()
        if op == "get":
            log.append(await txn.get(ka))
        elif op == "sget":
            log.append(await txn.get(ka, snapshot=True))
        elif op == "range":
            log.append(await txn.get_range(ka, kb + b"\xff"))
        elif op == "many":
            log.append(await txn.get_many([ka, kb]))
        elif op == "set":
            txn.set(ka, val)
        elif op == "clear":
            txn.clear(ka)
        elif op == "clear_range":
            txn.clear_range(ka, kb)
        else:
            try:
                await txn.commit()
                log.append(("commit", t))
            except Exception as e:
                log.append(("abort", t, int(getattr(e, "code", -1))))
            del open_[t]
    return log, eng.snapshot_rows()


async def run_kv_contention(kv_mod, seed: int) -> tuple[list, list, int]:
    """Concurrent read-modify-write transactions through with_transaction:
    each increments two counters and appends to a log key; conflicts
    retry at once (backoff 0), so the interleaving is the same in both
    packages."""
    eng = kv_mod.MemKVEngine()
    rng = np.random.default_rng(seed)
    plan = [(int(a), int(b)) for a, b in rng.integers(0, 4, (24, 2))]
    attempts = 0

    async def bump(i: int, a: int, b: int):
        async def fn(txn):
            nonlocal attempts
            attempts += 1
            va = int(await txn.get(b"c%d" % a) or b"0")
            await asyncio.sleep(0)            # let a rival commit in between
            vb = int(await txn.get(b"c%d" % b) or b"0")
            txn.set(b"c%d" % a, b"%d" % (va + 1))
            txn.set(b"c%d" % b, b"%d" % (vb + 1))
            got = await txn.get_range(b"log/", b"log0")
            txn.set(b"log/%03d" % i, b"%d" % len(got))
            return va, vb
        return await kv_mod.with_transaction(eng, fn, max_retries=50,
                                             backoff_s=0.0)

    results = await asyncio.gather(*(bump(i, a, b) for i, (a, b) in enumerate(plan)))
    return list(results), eng.snapshot_rows(), attempts


@pytest.mark.parametrize("seed", range(6))
def test_kv_engine_schedules_match_reference(seed):
    steps = kv_schedule(seed)
    ref = asyncio.run(run_kv_schedule(ref_kv, steps))
    port = asyncio.run(run_kv_schedule(port_kv, steps))
    assert port == ref
    assert any(isinstance(e, tuple) and e[0] == "commit" for e in ref[0])


def test_kv_schedules_include_conflicts():
    """The seeded schedules above do reach SSI aborts (TXN_CONFLICT)."""
    aborts = sum(isinstance(e, tuple) and e[0] == "abort"
                 for seed in range(6)
                 for e in asyncio.run(run_kv_schedule(ref_kv, kv_schedule(seed)))[0])
    assert aborts >= 3, aborts


@pytest.mark.parametrize("seed", range(3))
def test_with_transaction_retries_match_reference(seed):
    ref = asyncio.run(run_kv_contention(ref_kv, seed))
    port = asyncio.run(run_kv_contention(port_kv, seed))
    assert port == ref
    assert ref[2] > 24                         # conflicts forced retries
    counts = {k: int(v) for k, v in ref[1] if k.startswith(b"c")}
    plan = np.random.default_rng(seed).integers(0, 4, (24, 2))
    # every increment landed once (a transaction naming one counter twice
    # bumps it once)
    assert sum(counts.values()) == sum(len({int(a), int(b)}) for a, b in plan)


# ---------------------------------------------------------------- on the wire

def mixed_cluster(mgmtd_pkg: str, node_pkg: dict[int, str], **kw):
    """A LocalCluster of `mgmtd_pkg` (its mgmtd, KV and clients) whose
    storage node i is a StorageServer of package node_pkg[i], on the host
    checksum backend, at the LocalCluster's knobs."""
    from t3fs.storage.server import StorageServer as RefServer
    from t3fs.testing.cluster import LocalCluster as RefCluster
    from t3fs_torch.storage.server import StorageServer as PortServer
    from t3fs_torch.testing.cluster import LocalCluster as PortCluster

    base = RefCluster if mgmtd_pkg == "ref" else PortCluster
    if mgmtd_pkg == "port":
        kw.setdefault("checksum_backend", "cpu")

    class Mixed(base):
        async def start_storage_node(self, node_id, with_targets=True):
            cls = RefServer if node_pkg[node_id] == "ref" else PortServer
            ss = cls(node_id, self.mgmtd_rpc.address,
                     heartbeat_period_s=min(
                         0.15, self.mgmtd_cfg.heartbeat_timeout_s / 6),
                     resync_period_s=0.1, checksum_backend="cpu",
                     default_root=self.node_root(node_id),
                     discover_targets=True)
            for c in range(self.num_chains) if with_targets else ():
                tid = self.target_id(node_id, c)
                ss.add_target(tid, f"{self.node_root(node_id)}/t{tid}")
            await ss.start()
            self.storage[node_id] = ss
            return ss

    return Mixed(num_nodes=len(node_pkg), replicas=len(node_pkg), **kw)


async def wait_for(pred, timeout=15.0, what="condition"):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        assert loop.time() < deadline, f"timeout waiting for {what}"
        await asyncio.sleep(0.02)


@pytest.mark.parametrize("mgmtd_pkg", ["ref", "port"])
def test_heartbeats_and_routing_across_packages(mgmtd_pkg):
    """Port and reference StorageServers heartbeat to one mgmtd of either
    package: both register, both hold the routing mgmtd publishes (equal
    serde bytes under either package), and a node kill reshapes the chain
    for both."""
    async def body():
        c = mixed_cluster(mgmtd_pkg, {1: "ref", 2: "port", 3: "port"})
        await c.start()
        try:
            want = c.mgmtd.state.routing()
            await wait_for(lambda: all(ss.mgmtd.routing().version >= want.version
                                       for ss in c.storage.values()), what="routing")
            own = PACKAGES[mgmtd_pkg][2].dumps(c.mgmtd.state.routing())
            for nid, ss in c.storage.items():
                pkg = "ref" if type(ss).__module__.startswith("t3fs.") else "port"
                assert PACKAGES[pkg][2].dumps(ss.mgmtd.routing()) == own, nid
            assert sorted(c.mgmtd.state.routing().nodes) == [1, 2, 3]
            assert all(c.mgmtd.state.node_alive(n) for n in (1, 2, 3))
            await c.kill_storage_node(3)
            await wait_for(lambda: len(c.chain().serving()) == 2, what="reshape")
            v = c.chain().chain_ver
            await wait_for(lambda: all(ss.mgmtd.routing().chains[1].chain_ver == v
                                       for ss in c.storage.values()),
                           what="reshaped routing on both packages' nodes")
        finally:
            await c.stop()
    asyncio.run(body())


@pytest.mark.parametrize("source,successor", [("ref", "port"), ("port", "ref")])
def test_resync_between_packages(source, successor):
    """A chain of two: node 1 (`source`'s StorageServer) keeps serving while
    node 2 (`successor`'s) is down; writes land; node 2 returns on its old
    disk and is resynced by node 1.  Both replicas then hold the same bytes
    and equal ChunkMeta, chunk for chunk, and a chunk removed during the
    outage is gone from node 2.

    The heartbeat timeout is one test load cannot reach, so a stalled loop
    never fences node 1 or reshapes the chain on its own; node 2's death is
    declared by aging its last heartbeat in mgmtd once it is killed."""
    async def body():
        pkgs = {1: source, 2: successor}
        c = mixed_cluster(successor, pkgs, heartbeat_timeout_s=30.0)
        await c.start()
        lay = LAYOUTS[successor](chunk_size=96 << 10, chains=[1])
        rng = np.random.default_rng(77)
        try:
            first = rng.integers(0, 256, 5 * (96 << 10) + 1234, dtype=np.uint8).tobytes()
            for r in await c.sc.write_file_range(lay, 1, 0, first):
                assert r.status.code == 0
            for r in await c.sc.write_file_range(lay, 3, 0, b"doomed" * 100):
                assert r.status.code == 0
            await c.kill_storage_node(2)

            def node2_dead() -> bool:
                # its last heartbeat, long past: mgmtd's liveness check fails
                c.mgmtd.state.last_heartbeat[2] = 0.0
                return len(c.chain().serving()) == 1

            await wait_for(node2_dead, what="reshape")
            later = rng.integers(0, 256, 3 * (96 << 10), dtype=np.uint8).tobytes()
            for r in await c.sc.write_file_range(lay, 1, 50_000, later):
                assert r.status.code == 0
            for r in await c.sc.write_file_range(lay, 2, 0, later[:70_000]):
                assert r.status.code == 0
            await c.sc.remove_file_chunks(lay, 3)
            await c.restart_storage_node(2)
            await wait_for(lambda: len(c.chain().serving()) == 2, timeout=20.0,
                           what="resync back to serving")
            assert c.storage[1].resync.completed >= 1
            src = c.storage[1].node.targets[c.target_id(1)].engine
            dst = c.storage[2].node.targets[c.target_id(2)].engine
            s_metas = {(m.chunk_id.inode, m.chunk_id.index): m for m in src.all_metas()}
            d_metas = {(m.chunk_id.inode, m.chunk_id.index): m for m in dst.all_metas()}
            assert sorted(s_metas) == sorted(d_metas) and (3, 0) not in d_metas
            assert len(s_metas) == 6 + 1
            s_ser, d_ser = PACKAGES[source][2], PACKAGES[successor][2]
            ver = c.chain().chain_ver
            for key, m in s_metas.items():
                d = d_metas[key]
                # a resync REPLACE stamps the chain version it was sent at
                # (the successor's SYNCING seat); every other field, and
                # the bytes, are the source's
                if d.chain_ver != m.chain_ver:
                    assert m.chain_ver < d.chain_ver < ver, (key, m, d)
                    d = type(d)(**{**d.__dict__, "chain_ver": m.chain_ver})
                assert s_ser.dumps(m) == d_ser.dumps(d), (key, m, d)
                assert src.read(m.chunk_id) == dst.read(d.chunk_id), key
            want = bytearray(first)
            want[50_000:50_000 + len(later)] = later
            got, _ = await c.sc.read_file_range(lay, 1, 0, len(want))
            assert got == bytes(want)
        finally:
            await c.stop()
    asyncio.run(body())


def test_mgmtd_refuses_the_unported_health_puller():
    """With a monitor address the reference starts a health puller over
    the monitor service, which the port does not have: start() refuses."""
    async def body():
        cfg = port_mgmtd.MgmtdConfig(monitor_address="127.0.0.1:1")
        srv = port_mgmtd.MgmtdServer(port_kv.MemKVEngine(), 1, "", cfg)
        with pytest.raises(NotImplementedError, match="monitor"):
            await srv.start()
        await srv.stop()
    asyncio.run(body())


@pytest.mark.parametrize("knob", [{"with_meta": True}, {"with_monitor": True},
                                  {"kv_shards": 2},
                                  {"with_kv_distributor": True}])
def test_local_cluster_refuses_unported_branches(knob):
    """The monitor and the sharded KV are not ported: asking for them
    raises.  The meta service is: with_meta starts a MetaServer on its own
    RPC server, and the cluster's MetaClient reaches it."""
    from t3fs_torch.meta.service import MetaServer
    from t3fs_torch.testing.cluster import LocalCluster

    if "with_meta" not in knob:
        with pytest.raises(NotImplementedError, match="A12g"):
            LocalCluster(**knob)
        return

    async def body():
        c = LocalCluster(num_nodes=1, replicas=1, checksum_backend="cpu",
                         **knob)
        await c.start()
        try:
            assert isinstance(c.meta, MetaServer)
            assert c.mc.addresses == [c.meta_rpc.address]
            assert (await c.mc.mkdirs("/d")).inode_id > 1
            assert [e.name for e in await c.mc.readdir("/")] == ["d"]
        finally:
            await c.stop()
    asyncio.run(body())
