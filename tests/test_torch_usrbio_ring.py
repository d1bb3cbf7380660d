"""The port's ring data plane (t3fs_torch/usrbio/ring_client.py, the storage
service's Storage.ring_*, StorageClientConfig(data_plane="ring")): every
case of tests/test_usrbio_ring.py run on the port's fabric, then held
against the JAX package bit for bit.

The port's fabrics checksum on the CUDA backend run on its plain versions
(device="cpu").  Against the reference: the ring structs' serde bytes and
packed SQEs, each package's ring client over the other package's fabric,
one seeded ring write and read sequence through both packages' fabrics
(the same CQE fields, stored bytes and ChunkMeta, and the port's rpc plane
the same again), and the bounds check that keeps a ring read inside the
client's arena.  The reference's arena names (os.getpid,
random.getrandbits), client ids and ring ids are pinned by monkeypatch in
both packages for the sequence; neither package changes for it."""

import asyncio
import functools
import itertools
import time
import types as pytypes

import numpy as np
import pytest

import benchmarks.kvcache_fleet_bench
import t3fs.client.storage_client
import t3fs.net.client
import t3fs.net.rdma
import t3fs.storage.types
import t3fs.testing.fabric
import t3fs.usrbio.ring_client
import t3fs.utils.serde
import t3fs_torch.benchmarks.kvcache_fleet_bench
import t3fs_torch.client.storage_client
import t3fs_torch.net.client
import t3fs_torch.net.rdma
import t3fs_torch.storage.types
import t3fs_torch.testing.fabric
import t3fs_torch.usrbio.ring_client
import t3fs_torch.utils.serde
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.storage.types import ChunkId, IOResult, ReadIO
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.usrbio import SlotAllocator
from t3fs_torch.usrbio.ring_client import RingClient
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _port_fabric_on_the_cpu(monkeypatch):
    """Every port StorageFabric of this file checksums on the CUDA backend
    run on its plain versions (device="cpu")."""
    monkeypatch.setattr(StorageFabric, "default_checksum_backend",
                        functools.partial(CudaChecksumBackend, device="cpu"))


# ---------------- SlotAllocator ----------------

def test_slot_allocator_rejects_bad_params():
    for count, size in ((0, 1), (-1, 1), (1, 0), (1, -4)):
        with pytest.raises(ValueError):
            SlotAllocator(count, size)


def test_slot_allocator_acquire_release_books():
    a = SlotAllocator(2, 512)
    assert (a.available, a.in_flight) == (2, 0)
    s1, s2 = a.acquire(), a.acquire()
    assert {a.offset(s1), a.offset(s2)} == {0, 512}
    assert (a.available, a.in_flight) == (0, 2)
    assert a.try_acquire() is None
    with pytest.raises(RuntimeError):
        a.acquire()
    a.release(s1)
    assert (a.available, a.in_flight) == (1, 1)
    assert a.acquire() == s1
    a.release(s1)
    a.release(s2)
    assert (a.available, a.in_flight) == (2, 0)


def test_slot_allocator_release_discipline():
    a = SlotAllocator(2)
    s = a.acquire()
    a.release(s)
    with pytest.raises(ValueError):
        a.release(s)
    with pytest.raises(ValueError):
        a.release(1 if s == 0 else 0)
    with pytest.raises(ValueError):
        a.offset(2)


def test_slot_allocator_key_binding():
    a = SlotAllocator(2, 64)
    s = a.acquire()
    with pytest.raises(ValueError):
        a.bind("k", (s + 1) % 2)
    a.bind("k", s)
    with pytest.raises(ValueError):
        a.bind("k", s)
    with pytest.raises(KeyError):
        a.release_key("other")
    assert a.release_key("k") == s
    assert a.available == 2
    with pytest.raises(KeyError):
        a.release_key("k")


def test_slot_allocator_discard_quarantines_until_deadline():
    a = SlotAllocator(1, 64, quarantine_s=0.05)
    s = a.acquire()
    a.release(s, discard=True)
    assert a.discarded == 1 and a.quarantined == 1
    assert a.try_acquire() is None
    time.sleep(0.08)
    got = a.try_acquire()
    assert got == s and a.quarantined == 0
    b = SlotAllocator(1, 64)
    sb = b.acquire()
    b.release(sb, discard=True)
    assert b.try_acquire() == sb


# ---------------- shm ring: batched pop/complete ----------------

def test_ioring_batched_pop_and_complete_waves():
    """pop_sqes/complete_many move whole submission waves, and the
    doorbell re-arms across waves."""
    from t3fs_torch.lib import usrbio
    iov = usrbio.IoVec("t3fs-torch-test-ringbatch-iov", 16 * 4096)
    ring = usrbio.IoRing("t3fs-torch-test-ringbatch", entries=32, iov=iov)
    try:
        for wave in range(2):
            for i in range(8):
                ring.prep_io(True, 7, i * 4096, 4096, i * 4096,
                             userdata=wave * 100 + i)
            ring.submit_ios()
            sqes = ring.pop_sqes(max_n=32, timeout_ms=2000)
            assert [s.userdata for s in sqes] == \
                [wave * 100 + i for i in range(8)]
            ring.complete_many([(s.userdata, s.len, 0) for s in sqes])
            done = ring.wait_for_ios(max_n=32, min_n=8, timeout_ms=2000)
            assert sorted(c.userdata for c in done) == \
                [wave * 100 + i for i in range(8)]
            assert all(c.result == 4096 and c.status == 0 for c in done)
        assert ring.pop_sqes(max_n=4, timeout_ms=50) == []
    finally:
        ring.close()
        iov.close()


def test_ioring_partial_pop_leaves_rest_poppable():
    """A consumer that pops fewer sqes than were submitted must not strand
    the remainder behind a consumed doorbell (the baton-pass)."""
    from t3fs_torch.lib import usrbio
    iov = usrbio.IoVec("t3fs-torch-test-ringbaton-iov", 8 * 4096)
    ring = usrbio.IoRing("t3fs-torch-test-ringbaton", entries=16, iov=iov)
    try:
        for i in range(6):
            ring.prep_io(True, 7, 0, 4096, 0, userdata=i)
        ring.submit_ios()
        first = ring.pop_sqes(max_n=2, timeout_ms=2000)
        assert [s.userdata for s in first] == [0, 1]
        rest = ring.pop_sqes(max_n=16, timeout_ms=2000)
        assert [s.userdata for s in rest] == [2, 3, 4, 5]
    finally:
        ring.close()
        iov.close()


# ---------------- fabric helpers ----------------

async def _write_chunks(sc, chain_id, n, size, seed=0):
    """n chunks of `size` bytes via write_chunk; returns {ChunkId: bytes}."""
    import random
    rng = random.Random(seed)
    data = {}
    for i in range(n):
        cid = ChunkId(1000 + seed, i)
        blob = bytes(rng.getrandbits(8) for _ in range(size))
        r = await sc.write_chunk(chain_id, cid, 0, blob, size)
        assert r.status.code == int(StatusCode.OK), r.status.message
        data[cid] = blob
    return data


def _read_ios(data, chain_id, length=0):
    return [ReadIO(chunk_id=cid, chain_id=chain_id, offset=0,
                   length=length or len(blob))
            for cid, blob in data.items()]


# ---------------- smoke ----------------

def test_ring_smoke_write_and_read_batch():
    """One write batch + one read batch on data_plane=ring over real TCP:
    bytes round-trip, the arena session attached, and the CQEs carry the
    engine's CRCs; every IO an SQE on a node, none spilled."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        sc.cfg.data_plane = "ring"
        try:
            data = await _write_chunks(sc, fab.chain_id, 8, 4096)
            ring = sc._ring_state["ring"]
            assert ring is not None and ring._sessions, \
                "writes never attached a ring session"
            results, payloads = await sc.batch_read(
                _read_ios(data, fab.chain_id))
            from t3fs_torch.ops.codec import crc32c
            for (cid, blob), r, p in zip(data.items(), results, payloads):
                assert r.status.code == int(StatusCode.OK), r.status.message
                assert p == blob, f"{cid}: wrong bytes on the ring plane"
                assert r.length == len(blob)
                assert r.checksum == crc32c(blob)
            nodes = fab.nodes
            assert ring.sqes == {"read": 8, "write": 8} and ring.spills == 0
            assert (sum(n.ring_reads for n in nodes),
                    sum(n.ring_writes for n in nodes)) == (8, 8)
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_ring_smoke_results_field_identical_to_rpc():
    """Every CQE field a caller can see matches the rpc plane's result for
    the same reads, a short read and a miss included."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc_rpc = StorageClient(lambda: fab.routing, client=fab.client)
        sc_ring = StorageClient(lambda: fab.routing, client=fab.client)
        sc_ring.cfg.data_plane = "ring"
        try:
            data = await _write_chunks(sc_rpc, fab.chain_id, 6, 8192,
                                       seed=1)
            ios = _read_ios(data, fab.chain_id)
            some = next(iter(data))
            ios.append(ReadIO(chunk_id=some, chain_id=fab.chain_id,
                              offset=4096, length=512))
            ios.append(ReadIO(chunk_id=ChunkId(4242, 0),
                              chain_id=fab.chain_id, offset=0, length=64))
            r_rpc, p_rpc = await sc_rpc.batch_read(
                [io.clone() for io in ios])
            r_ring, p_ring = await sc_ring.batch_read(
                [io.clone() for io in ios])
            assert sc_ring._ring_state["ring"]._sessions
            for a, b, pa, pb in zip(r_rpc, r_ring, p_rpc, p_ring):
                assert (a.status.code, a.length, a.update_ver,
                        a.commit_ver, a.commit_chain_ver, a.checksum) == \
                       (b.status.code, b.length, b.update_ver,
                        b.commit_ver, b.commit_chain_ver, b.checksum)
                assert pa == pb
            assert r_ring[-1].status.code == int(StatusCode.CHUNK_NOT_FOUND)
        finally:
            await sc_rpc.close()
            await sc_ring.close()
            await fab.stop()
    run(body())


def test_ring_smoke_crosshost_batched_transport_engaged():
    """ring_no_shm withholds the shm alias so every ring payload rides the
    batched one-sided plane: bytes round-trip and the Buf.batch counters
    show the batched transport engaged, with no per-op fallback."""
    async def body():
        from t3fs_torch.net.rdma import BATCH_STATS
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        sc.cfg.data_plane = "ring"
        sc.cfg.ring_no_shm = True
        try:
            before = BATCH_STATS.snapshot()
            data = await _write_chunks(sc, fab.chain_id, 8, 4096, seed=6)
            results, payloads = await sc.batch_read(
                _read_ios(data, fab.chain_id))
            after = BATCH_STATS.snapshot()
            ring = sc._ring_state["ring"]
            assert ring is not None and ring._sessions
            assert all(not aliased
                       for _, _, aliased in ring._sessions.values())
            for (cid, blob), r, p in zip(data.items(), results, payloads):
                assert r.status.code == int(StatusCode.OK), r.status.message
                assert p == blob, f"{cid}: wrong bytes on cross-host plane"
            d_doorbells = after["doorbells"] - before["doorbells"]
            d_ops = after["batched_ops"] - before["batched_ops"]
            assert d_doorbells > 0, "batched transport never engaged"
            assert d_ops > d_doorbells, "no coalescing: 1 op per doorbell"
            assert after["fallback_ops"] == before["fallback_ops"]
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- zero per-IO serde ----------------

def _count_plan_encodes(classes, counts):
    originals = {}
    for cls in classes:
        plan = serde._plan_of(cls)
        originals[cls] = plan.enc

        def wrapper(w, obj, _orig=plan.enc, _name=cls.__name__):
            counts[_name] += 1
            _orig(w, obj)
        plan.enc = wrapper
    return originals


def test_ring_read_batch_encodes_zero_per_io_structs():
    """A ring read batch crosses the wire with zero ReadIO/IOResult serde
    encodes in the whole process; the same batch on the rpc plane encodes
    per-IO structs (the counter's sanity check)."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2)
        await fab.start()
        sc_ring = StorageClient(lambda: fab.routing, client=fab.client)
        sc_ring.cfg.data_plane = "ring"
        sc_rpc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            data = await _write_chunks(sc_ring, fab.chain_id, 16, 4096,
                                       seed=2)
            ios = _read_ios(data, fab.chain_id)
            counts = {"ReadIO": 0, "IOResult": 0}
            originals = _count_plan_encodes((ReadIO, IOResult), counts)
            try:
                results, payloads = await sc_ring.batch_read(
                    [io.clone() for io in ios])
                assert all(r.status.code == int(StatusCode.OK)
                           for r in results)
                assert counts == {"ReadIO": 0, "IOResult": 0}, \
                    f"per-IO serde on the ring plane: {counts}"
                await sc_rpc.batch_read([io.clone() for io in ios])
                assert counts["ReadIO"] >= len(ios)
            finally:
                for cls, enc in originals.items():
                    serde._plan_of(cls).enc = enc
            for (cid, blob), p in zip(data.items(), payloads):
                assert p == blob
        finally:
            await sc_ring.close()
            await sc_rpc.close()
            await fab.stop()
    run(body())


# ---------------- fallback paths ----------------

def test_ring_falls_back_to_rpc_on_pre_ring_server():
    """Strip the ring methods from every server: writes and reads on
    data_plane=ring still complete on the rpc path, the address memoized
    as ringless after one probe, and the spills counted."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2)
        await fab.start()
        for srv in fab.servers:
            for m in [m for m in srv.dispatcher
                      if m.startswith("Storage.ring_")]:
                del srv.dispatcher[m]
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        sc.cfg.data_plane = "ring"
        try:
            data = await _write_chunks(sc, fab.chain_id, 4, 4096, seed=3)
            results, payloads = await sc.batch_read(
                _read_ios(data, fab.chain_id))
            for (cid, blob), r, p in zip(data.items(), results, payloads):
                assert r.status.code == int(StatusCode.OK)
                assert p == blob
            ring = sc._ring_state["ring"]
            assert ring is not None
            assert ring._no_ring, "pre-ring servers were not memoized"
            assert not ring._sessions
            assert ring.spills == 8 and ring.sqes == {"read": 0, "write": 0}
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_ring_read_group_hands_back_oversize_and_ineligible():
    """read_group's leftover contract: an IO larger than a slot never goes
    on the wire, a whole-chunk read whose result outgrew its slot comes
    back for an rpc re-read, eligible IOs still complete, every slot
    released afterwards."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            data = await _write_chunks(sc, fab.chain_id, 1, 4096, seed=4)
            (cid, blob), = data.items()
            ring = RingClient(sc, slot_size=1024, slots=4)
            try:
                ios = [
                    ReadIO(chunk_id=cid, chain_id=fab.chain_id,
                           offset=0, length=0),
                    ReadIO(chunk_id=cid, chain_id=fab.chain_id,
                           offset=0, length=4096),
                    ReadIO(chunk_id=cid, chain_id=fab.chain_id,
                           offset=512, length=512),
                ]
                installed = {}

                def install(i, r, p, src):
                    installed[i] = (r, bytes(p))

                leftover = await ring.read_group(
                    fab.head_address(), [0, 1, 2], ios, install, "primary")
                assert sorted(leftover) == [0, 1]
                assert list(installed) == [2]
                r, p = installed[2]
                assert r.status.code == int(StatusCode.OK)
                assert p == blob[512:1024]
                assert ring.alloc.available == 4, "slot leak"
                assert ring.spills == 2
            finally:
                await ring.close()
            sc.cfg.data_plane = "ring"
            sc.cfg.ring_slot_size = 1024
            results, payloads = await sc.batch_read(
                [ReadIO(chunk_id=cid, chain_id=fab.chain_id,
                        offset=0, length=0)])
            assert results[0].status.code == int(StatusCode.OK)
            assert payloads[0] == blob
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_ring_arena_pressure_spills_to_rpc():
    """More in-group IOs than arena slots: the overflow rides rpc, the rest
    complete on the ring, nothing dropped or reordered."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            data = await _write_chunks(sc, fab.chain_id, 6, 2048, seed=5)
            ios = _read_ios(data, fab.chain_id)
            ring = RingClient(sc, slot_size=2048, slots=2)
            try:
                installed = {}

                def install(i, r, p, src):
                    installed[i] = bytes(p)

                leftover = await ring.read_group(
                    fab.head_address(), list(range(6)), ios, install,
                    "primary")
                assert len(leftover) == 4
                assert len(installed) == 2
                blobs = list(data.values())
                for i, p in installed.items():
                    assert p == blobs[i]
                assert ring.alloc.available == 2
            finally:
                await ring.close()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- riders: kvcache + checkpoint ----------------

def test_kvcache_get_many_byte_identical_on_ring():
    """The serving tier on data_plane=ring: get_many after a flush returns
    exactly the bytes put, and the reads went through the ring plane."""
    from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig

    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=4)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        sc.cfg.data_plane = "ring"
        try:
            tier = KVCacheTier(
                sc, fab.chain_ids, namespace="ringns",
                config=KVCacheTierConfig(lanes=4, hit_sample=1,
                                         flush_interval_s=0.005,
                                         ledger_flush_interval_s=0.05),
                writer_id=1)
            await tier.start()
            expected = {f"key-{i}".encode():
                        (f"val-{i}-".encode() * 200)[:1024 + 37 * i]
                        for i in range(24)}
            for k, v in expected.items():
                await tier.put(k, v)
            await tier.flush()
            ring = sc._ring_plane()
            assert ring is not None
            calls = {"n": 0}
            orig = ring.read_group

            async def counting(*a, **kw):
                calls["n"] += 1
                return await orig(*a, **kw)
            ring.read_group = counting
            keys = sorted(expected)
            got = await tier.get_many(keys)
            for k, v in zip(keys, got):
                assert v == expected[k], f"{k!r}: wrong bytes on ring"
            assert calls["n"] > 0, "get_many never used the ring plane"
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_kvcache_get_many_rides_batched_crosshost_plane():
    """With the shm alias withheld the tier's get_many rides the batched
    one-sided transport: bytes identical, Buf.batch doorbells rung."""
    from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig
    from t3fs_torch.net.rdma import BATCH_STATS

    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=4)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        sc.cfg.data_plane = "ring"
        sc.cfg.ring_no_shm = True
        try:
            tier = KVCacheTier(
                sc, fab.chain_ids, namespace="xhostns",
                config=KVCacheTierConfig(lanes=4, hit_sample=1,
                                         flush_interval_s=0.005,
                                         ledger_flush_interval_s=0.05),
                writer_id=1)
            await tier.start()
            expected = {f"xh-{i}".encode():
                        (f"val-{i}-".encode() * 150)[:768 + 29 * i]
                        for i in range(16)}
            for k, v in expected.items():
                await tier.put(k, v)
            await tier.flush()
            before = BATCH_STATS.snapshot()
            keys = sorted(expected)
            got = await tier.get_many(keys)
            after = BATCH_STATS.snapshot()
            for k, v in zip(keys, got):
                assert v == expected[k]
            assert after["doorbells"] > before["doorbells"]
            ring = sc._ring_plane()
            assert all(not aliased
                       for _, _, aliased in ring._sessions.values())
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_ckpt_restore_on_ring_healthy_and_degraded():
    """Checkpoint save and restore with the whole stack on data_plane=ring
    (the port's LocalCluster, TorchECCodec on the CPU): the healthy restore
    and the degraded decode after killing a data and a parity chain are
    bit-identical."""
    from t3fs_torch.ckpt import CheckpointReader, CheckpointWriter
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.fuse.vfs import FileSystem
    from t3fs_torch.testing.cluster import LocalCluster
    from tests.test_torch_ckpt import make_tree, trees_equal

    async def body():
        cluster = LocalCluster(num_nodes=8, replicas=1, num_chains=8,
                               with_meta=True, heartbeat_timeout_s=0.6,
                               checksum_backend="cpu")
        await cluster.start()
        try:
            cluster.sc.cfg.data_plane = "ring"
            lay = ECLayout.create(k=4, m=2, chunk_size=2048,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ECStorageClient(cluster.sc, codec=TorchECCodec(device="cpu"))
            fs = FileSystem(cluster.mc, cluster.sc)
            tree = make_tree(np.random.default_rng(9))
            w = CheckpointWriter(ec, fs, lay, "/ckpt/ring")
            stats = await w.save(5, tree)
            ring = cluster.sc._ring_state["ring"]
            assert ring is not None and ring._sessions

            r = CheckpointReader(ec, fs, "/ckpt/ring")
            trees_equal(tree, await r.restore())

            ino = await fs.stat(stats.manifest_path)
            used = set(ino.layout.chains)
            data_chain = next(c for c in (2, 3, 4) if c not in used)
            parity_chain = next(c for c in (5, 6) if c not in used)
            for chain in (data_chain, parity_chain):
                await cluster.kill_storage_node(chain)
            for _ in range(100):
                if all(c.chain_ver >= 2 for c in
                       cluster.mgmtd.state.routing().chains.values()
                       if any(t.node_id in (data_chain, parity_chain)
                              for t in c.targets)):
                    break
                await asyncio.sleep(0.1)
            await cluster.mgmtd_client.refresh()

            trees_equal(tree, await r.restore())
            assert ec.codec.codec_counts.get("cuda-decode-words", 0) >= 1
            assert ring.spills == 0
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


# ---------------- the port against the JAX package ----------------

def _pkg(root, fleet) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, sc=root.client.storage_client,
        fabric=root.testing.fabric, net=root.net.client, rdma=root.net.rdma,
        types=root.storage.types, ring=root.usrbio.ring_client,
        serde=root.utils.serde, thaw=fleet.thaw_routing,
        freeze=fleet.freeze_routing)


REF = _pkg(t3fs, benchmarks.kvcache_fleet_bench)
PORT = _pkg(t3fs_torch, t3fs_torch.benchmarks.kvcache_fleet_bench)


def ring_structs(p, rng) -> list:
    """Every ring request and response of package p, fields from rng."""
    t = p.types
    n = lambda: int(rng.integers(0, 1 << 62))  # noqa: E731
    buf = p.rdma.RemoteBuf(n(), n(), n(), n())
    results = [t.IOResult(p.types.WireStatus(int(rng.integers(0, 3000)),
                                             "msg" * int(rng.integers(0, 3))),
                          n(), n(), n(), n(), int(rng.integers(0, 1 << 32)))
               for _ in range(3)]
    return [t.RingAttachReq(client_id=f"c{n()}", shm_name=f"arena-{n()}",
                            shm_size=n(), buf=buf, proto_ver=1),
            t.RingAttachReq(),
            t.RingAttachRsp(ring_id=n(), aliased=True),
            t.RingAttachRsp(),
            t.RingDetachReq(ring_id=n()), t.RingDetachRsp(ok=False),
            t.RingRWReq(ring_id=n(), sqes=rng.bytes(90 * 3), client_id="sc-1"),
            t.RingRWRsp(cqes=rng.bytes(64), results=results),
            t.RingRWRsp()]


def test_ring_serde_bytes_match_reference():
    """Each Ring*Req/Rsp's serde bytes equal the reference's, and each
    package decodes the other's bytes to the same fields."""
    ref_objs = ring_structs(REF, np.random.default_rng(21))
    port_objs = ring_structs(PORT, np.random.default_rng(21))
    for a, b in zip(ref_objs, port_objs):
        ba, bb = REF.serde.dumps(a), PORT.serde.dumps(b)
        assert ba == bb, type(a).__name__
        assert PORT.serde.dumps(PORT.serde.loads(ba)) == ba
        assert REF.serde.dumps(REF.serde.loads(bb)) == bb


def test_pack_ring_sqes_matches_reference():
    """pack_ring_sqes over seeded SQE tuples: the same bytes (90 a SQE,
    "<2Q9q2B"), the same unpacked tuples, None for an out-of-range field in
    both; the op and flag constants the same."""
    rng = np.random.default_rng(8)
    recs = [tuple(int(x) for x in (
        *rng.integers(0, 1 << 63, 2, dtype=np.uint64),
        *rng.integers(-(1 << 62), 1 << 62, 9, dtype=np.int64),
        *rng.integers(0, 256, 2))) for _ in range(64)]
    a, b = PORT.types.pack_ring_sqes(recs), REF.types.pack_ring_sqes(recs)
    assert a == b and len(a) == 90 * len(recs)
    assert list(PORT.types.unpack_ring_sqes(a)) == \
        list(REF.types.unpack_ring_sqes(b)) == recs
    for bad in ((1 << 64, *recs[0][1:]), (*recs[0][:11], 256, 0),
                (*recs[0][:3], 1 << 63, *recs[0][4:])):
        assert PORT.types.pack_ring_sqes([bad]) is None
        assert REF.types.pack_ring_sqes([bad]) is None
    for name in ("RING_OP_READ", "RING_OP_WRITE", "RING_F_VERIFY",
                 "RING_F_UNCOMMITTED", "RING_F_NO_PAYLOAD"):
        assert getattr(PORT.types, name) == getattr(REF.types, name)
    assert PORT.types._RING_SQE_FMT.format == REF.types._RING_SQE_FMT.format


def foreign_client(p, fabric, **kw):
    """Package p's StorageClient over the wire to another package's fabric."""
    routing = p.thaw(p.freeze(fabric.routing))
    cli = p.net.Client()
    cli.add_service(p.rdma.BufferRegistry())
    return p.sc.StorageClient(lambda: routing, client=cli, **kw)


def fabric_of(p, **kw):
    if p is PORT:
        return PORT.fabric.StorageFabric(
            checksum_backend=functools.partial(CudaChecksumBackend, device="cpu"), **kw)
    return REF.fabric.StorageFabric(**kw)


@pytest.mark.parametrize("no_shm", [False, True])
@pytest.mark.parametrize("client_pkg", ["ref", "port"])
def test_ring_client_against_other_package_fabric(client_pkg, no_shm):
    """Each package's ring client over the other package's fabric, with
    and without the shm alias: its ring writes and reads give the bytes,
    CQE fields and stored chunks that the fabric's own ring client gives
    for the same IOs, and the server opened the client's arena by name
    where it may."""
    cp = REF if client_pkg == "ref" else PORT
    fp = PORT if cp is REF else REF

    async def body():
        fab = fabric_of(fp, num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        own = fp.sc.StorageClient(lambda: fab.routing, client=fab.client)
        own.cfg.data_plane = "ring"
        own.cfg.ring_no_shm = no_shm
        other = foreign_client(cp, fab)
        other.cfg.data_plane = "ring"
        other.cfg.ring_no_shm = no_shm
        try:
            rng = np.random.default_rng(31)
            out = {}
            for who, sc, p, inode in ((cp.name, other, cp, 50), (fp.name, own, fp, 60)):
                cids, blobs, results = [], [], []
                for i, n in enumerate((1, 4000, 65536, 100_000, 256 << 10)):
                    blob = np.random.default_rng(i).bytes(n)
                    cid = p.types.ChunkId(inode, i)
                    r = await sc.write_chunk(fab.chain_ids[i % 2], cid, 0, blob,
                                             256 << 10)
                    results.append((r.status.code, r.length, r.update_ver,
                                    r.commit_ver, r.checksum))
                    cids.append(cid)
                    blobs.append(blob)
                ios = [p.types.ReadIO(chunk_id=c, chain_id=fab.chain_ids[i % 2],
                                      offset=0, length=len(b))
                       for i, (c, b) in enumerate(zip(cids, blobs))]
                got, payloads = await sc.batch_read(ios)
                assert payloads == blobs
                ring = sc._ring_state["ring"]
                assert ring._sessions and not ring._no_ring
                assert all(a is (not no_shm) for _, _, a in ring._sessions.values())
                out[who] = (results, [(g.status.code, g.length, g.update_ver,
                                       g.commit_ver, g.commit_chain_ver, g.checksum)
                                      for g in got])
            assert out[cp.name] == out[fp.name]
            # both inodes' chunks: the same ChunkMeta (less the inode) and bytes
            for node in fab.nodes:
                for t in node.targets.values():
                    metas = {(m.chunk_id.inode, m.chunk_id.index): m
                             for m in t.engine.all_metas()}
                    for i in range(5):
                        a, b = metas.get((50, i)), metas.get((60, i))
                        assert (a is None) == (b is None)
                        if a is not None:
                            assert (a.length, a.update_ver, a.commit_ver,
                                    a.checksum, a.state) == \
                                   (b.length, b.update_ver, b.commit_ver,
                                    b.checksum, b.state)
                            assert t.engine.read(a.chunk_id) == t.engine.read(b.chunk_id)
            if fp is PORT:
                assert sum(n.ring_writes for n in fab.nodes) == 10
                assert sum(n.ring_reads for n in fab.nodes) == 10
        finally:
            await other.close()
            await own.close()
            await fab.stop()
    run(body())


SEQ_CHUNK = 160 << 10
SEQ_SIZES = (1, 4000, 65535, 65536, 65537, 100_000, SEQ_CHUNK)


def make_ring_ops(seed: int, n: int = 40) -> list[tuple]:
    """Seeded writes (whole chunks, partial and appending writes, sizes
    around the nodes' 64 KiB device cutoff) and batched reads (whole,
    partial, length 0, misses) over 4 chunks of 2 chains."""
    rng = np.random.default_rng(seed)
    lengths: dict[int, int] = {}
    ops = []
    while len(ops) < n:
        idx = int(rng.integers(0, 4))
        if rng.random() < 0.35 and lengths:
            picks = [int(i) for i in rng.choice(6, 4)]
            reads = []
            for i in picks:
                ln = lengths.get(i % 4 if i < 4 else i, 0)
                off = int(rng.integers(0, max(ln, 1)))
                reads.append((i, off, int(rng.choice([0, 1, 512, ln - off or 1]))))
            ops.append(("read", reads))
            continue
        cur = lengths.get(idx)
        n_bytes = int(rng.choice(SEQ_SIZES))
        off = 0 if cur is None else int(rng.choice([0, min(cur, SEQ_CHUNK - 1)]))
        n_bytes = max(1, min(n_bytes, SEQ_CHUNK - off))
        ops.append(("write", idx, off, rng.integers(0, 256, n_bytes,
                                                    dtype=np.uint8).tobytes()))
        lengths[idx] = max(cur or 0, off + n_bytes)
    return ops


def dump_replicas(p, fabric) -> dict:
    out = {}
    for node in fabric.nodes:
        for tid, target in sorted(node.targets.items()):
            metas = sorted(target.engine.all_metas(),
                           key=lambda m: (m.chunk_id.inode, m.chunk_id.index))
            out[(node.node_id, tid)] = [
                (p.serde.dumps(m), bytes(target.engine.read(m.chunk_id)))
                for m in metas]
    return out


@pytest.fixture
def pinned(monkeypatch):
    """The arena names (os.getpid, random.getrandbits in ring_client) pinned
    in both packages; the client ids and ring ids are set by the run."""
    for p in (REF, PORT):
        monkeypatch.setattr(p.ring, "os", pytypes.SimpleNamespace(getpid=lambda: 4242))
        monkeypatch.setattr(p.ring, "random",
                            pytypes.SimpleNamespace(getrandbits=lambda n: 0x5EED))


async def ring_seq_run(p, plane: str, ops) -> dict:
    """ops through package p's own fabric (3 nodes, 2 chains of 2) by p's
    StorageClient on `plane` (client id and the nodes' ring ids pinned):
    every IOResult and payload, then every replica."""
    fab = fabric_of(p, num_nodes=3, replicas=2, num_chains=2)
    await fab.start()
    for node in fab.nodes:
        node._ring_ids = itertools.count(100)
    sc = p.sc.StorageClient(lambda: fab.routing, client=fab.client,
                            client_id="ring-diff-client")
    sc.cfg.data_plane = plane
    res = lambda r: (r.status.code, r.length, r.update_ver, r.commit_ver,  # noqa: E731
                     r.commit_chain_ver, r.checksum)
    try:
        out = []
        cid = lambda i: p.types.ChunkId(77, i)  # noqa: E731
        for op in ops:
            if op[0] == "write":
                _, idx, off, data = op
                r = await sc.write_chunk(fab.chain_ids[idx % 2], cid(idx), off, data,
                                         SEQ_CHUNK)
                out.append(("write", res(r)))
            else:
                ios = [p.types.ReadIO(chunk_id=cid(i), chain_id=fab.chain_ids[i % 2],
                                      offset=off, length=ln)
                       for i, off, ln in op[1]]
                got, payloads = await sc.batch_read(ios)
                out.append(("read", [res(r) for r in got], [bytes(x) for x in payloads]))
        ring = sc._ring_state["ring"]
        facts = None if ring is None else (
            sorted(rid for rid, _, _ in ring._sessions.values()),
            getattr(ring, "spills", 0))
        return {"ops": out, "replicas": dump_replicas(p, fab), "ring": facts}
    finally:
        await sc.close()
        await fab.stop()


@pytest.mark.parametrize("seed", [4, 19])
def test_ring_sequence_matches_reference_and_rpc_plane(seed, pinned):
    """One seeded ring write and read sequence through each package's
    fabric: every CQE field and payload, and every replica's stored bytes
    and ChunkMeta, are equal; the port's rpc plane gives them all again."""
    ops = make_ring_ops(seed)
    ref = run(ring_seq_run(REF, "ring", ops))
    port = run(ring_seq_run(PORT, "ring", ops))
    rpc = run(ring_seq_run(PORT, "rpc", ops))
    assert len(port["ops"]) == len(ops)
    for i, (a, b, c) in enumerate(zip(ref["ops"], port["ops"], rpc["ops"])):
        assert a == b == c, (i, ops[i][0])
    assert port["replicas"] == ref["replicas"] == rpc["replicas"]
    assert sum(len(v) for v in ref["replicas"].values()) >= 8
    assert ref["ring"] == port["ring"] and port["ring"][0][0] == 100
    assert port["ring"][1] == 0 and rpc["ring"] is None
    kinds = [o[0] for o in ops]
    assert "read" in kinds and "write" in kinds
    codes = {r[0] for o in port["ops"] if o[0] == "read" for r in o[1]}
    assert int(StatusCode.OK) in codes and int(StatusCode.CHUNK_NOT_FOUND) in codes


async def bounds_run(p, no_shm: bool) -> list:
    """A raw ring_rw of READ SQEs against a 4 KiB arena (package p's
    client and fabric): one running past the arena's end, one ending on
    it, one starting at its last byte, one filling it; returns each call's
    CQE (status, length) or RPC error code, and whether any arena byte
    changed after the out-of-range calls."""
    fab = fabric_of(p, num_nodes=1, replicas=1)
    await fab.start()
    sc = p.sc.StorageClient(lambda: fab.routing, client=fab.client)
    sc.cfg.ring_no_shm = no_shm
    try:
        cid = p.types.ChunkId(5, 0)
        await sc.write_chunk(fab.chain_id, cid, 0, bytes(range(256)) * 16, 4096)
        ring = p.ring.RingClient(sc, slot_size=1024, slots=4)
        ring.arena.write_at(0, b"\xa5" * 4096)
        out = []
        for iov_off, length in ((2048, 4096), (4095, 2), (3072, 1024), (0, 4096)):
            blob = p.types.pack_ring_sqes([(5, 0, fab.chain_id, 0, length, iov_off,
                                            length, 0, 0, 0, 0,
                                            p.types.RING_OP_READ, 0)])
            try:
                r = (await ring._ring_call(fab.head_address(), "read", blob, 1))[0]
                out.append(("cqe", r.status.code, r.length))
            except Exception as e:
                out.append(("rpc-error", int(e.code)))
            if length != 1024 and iov_off + length > 4096:
                out.append(ring.arena.read_at(0, 4096) == b"\xa5" * 4096)
        out.append(ring.arena.read_at(3072, 1024) == (bytes(range(256)) * 4))
        out.append([a for _, _, a in ring._sessions.values()])
        await ring.close()
        return out
    finally:
        await sc.close()
        await fab.stop()


@pytest.mark.parametrize("no_shm", [False, True])
def test_ring_read_stays_inside_the_arena(no_shm):
    """_ring_read_fast preads straight to the arena's address only when
    iov_off + length fits it.  An SQE running past the arena never writes
    a byte of it: aliased, the general path's copy refuses and the whole
    frame fails with INTERNAL (the reference's behavior, kept); one-sided,
    the slice check answers an INVALID_ARG CQE.  In-range SQEs land their
    bytes.  Both packages alike."""
    ref = run(bounds_run(REF, no_shm))
    port = run(bounds_run(PORT, no_shm))
    assert ref == port
    err = (("rpc-error", int(StatusCode.INTERNAL)) if not no_shm
           else ("cqe", int(StatusCode.INVALID_ARG), 0))
    assert port == [err, True, err, True, ("cqe", 0, 1024), ("cqe", 0, 4096),
                    True, [not no_shm]]


def test_phase26_paths_on_the_cpu(monkeypatch):
    """chip_smoke.py phase 26's ring write path and its riders at a small
    size on the CPU: the populate and app OP_WRITEs through the ring with
    every stored chunk's ChunkMeta against the native host CRC and plain
    B1, and the checkpoint (save, restore, degraded restore) and KVCache
    riders on data_plane="ring" with no spill and every SQE counted."""
    import torch

    import chip_smoke as cs

    cpu = torch.device("cpu")
    monkeypatch.setattr(cs, "USRBIO_ARGS", [
        "0.5" if a == "5" else a for a in cs.USRBIO_ARGS])
    cs.phase_usrbio_big(cpu, block=128 << 10, file_size=2 << 20, app_writes=4)
    run(cs.phase_ring_riders(cpu, leaf_bytes=1 << 20, leaves=2,
                             chunk_bytes=64 << 10, kv_blocks=32, kv_value=4096))


def test_stopped_node_unmaps_its_ring_sessions():
    """A node stopped under an attached ring client (killed: no detach)
    unmaps the client's arena, which the client has unlinked, so tmpfs can
    free its pages: the port's StorageServer and StorageFabric close their
    ring sessions on stop (the reference's keep them mapped).  After the
    client closes too, no usrbio segment stays mapped in this process."""
    import chip_smoke as cs
    from t3fs_torch.testing.cluster import LocalCluster

    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=2, num_chains=2,
                               checksum_backend="cpu")
        await cluster.start()
        try:
            cluster.sc.cfg.data_plane = "ring"
            data = await _write_chunks(cluster.sc, 1, 4, 4096, seed=9)
            assert data
            ring = cluster.sc._ring_state["ring"]
            name = ring.arena.shm_name
            node = cluster.storage[cluster.chain(1).targets[0].node_id].node
            sessions = list(node.ring_sessions.values())
            assert sessions and all(s.shm is not None for s in sessions)
            await cluster.kill_storage_node(node.node_id)
            assert not node.ring_sessions
            assert all(s.shm._base is None for s in sessions)
            assert any(name in m for m in cs.shm_mapped())   # the client's own
        finally:
            await cluster.stop()
        assert not [m for m in cs.shm_mapped() if name in m]
    run(body())
