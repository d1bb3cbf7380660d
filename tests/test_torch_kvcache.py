"""The port's KVCache store (t3fs_torch/lib/kvcache.py): every case of
tests/test_kvcache.py run on the port's fabric, then the store held against
the JAX package's bit for bit."""

import asyncio
import functools
import types as pytypes

import numpy as np
import pytest

import benchmarks.kvcache_fleet_bench
import t3fs.client.storage_client
import t3fs.lib.kvcache
import t3fs.net.client
import t3fs.net.rdma
import t3fs.testing.fabric
import t3fs.utils.serde
import t3fs_torch.benchmarks.kvcache_fleet_bench
import t3fs_torch.client.storage_client
import t3fs_torch.lib.kvcache
import t3fs_torch.net.client
import t3fs_torch.net.rdma
import t3fs_torch.testing.fabric
import t3fs_torch.utils.serde
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.lib.kvcache import KVCacheStore, _pack_block, _unpack_block
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.utils.status import StatusError


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _port_fabric_on_the_cpu(monkeypatch):
    """Every port StorageFabric of this file checksums on the CUDA backend
    run on its plain versions (device="cpu"): the card's code path without
    the card."""
    monkeypatch.setattr(StorageFabric, "default_checksum_backend",
                        functools.partial(CudaChecksumBackend, device="cpu"))


def test_block_codec_self_describing():
    blob = _pack_block(b"key", b"value")
    assert _unpack_block(blob, b"key") == b"value"
    assert _unpack_block(blob, b"other") is None          # collision -> miss
    assert _unpack_block(blob[:-1], b"key") is None       # torn -> miss
    assert _unpack_block(b"", b"key") is None
    # trailing garbage from a longer previous block is ignored
    assert _unpack_block(blob + b"\xff" * 16, b"key") == b"value"


def test_placement_stable_and_namespaced():
    sc = object.__new__(StorageClient)  # placement only; no I/O
    a = KVCacheStore(sc, chains=[1, 2, 3], namespace="a")
    b = KVCacheStore(sc, chains=[1, 2, 3], namespace="b")
    ch1, cid1 = a.locate(b"k")
    ch2, cid2 = a.locate(b"k")
    assert (ch1, cid1) == (ch2, cid2)          # deterministic across calls
    assert a.inode != b.inode                  # namespaces are disjoint
    assert a.inode >> 63 == 1                  # clear of meta inode space


def test_put_get_remove_roundtrip():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            kv = KVCacheStore(sc, chains=[fab.chain_id], namespace="t")
            keys = [f"blk-{i}".encode() for i in range(24)]
            vals = [bytes([i]) * (512 + 64 * i) for i in range(24)]
            await asyncio.gather(*(kv.put(k, v) for k, v in zip(keys, vals)))

            got = await kv.get_many(keys)
            assert got == vals
            assert await kv.get(b"absent") is None

            # overwrite with a SHORTER value must not leak old bytes
            await kv.put(keys[0], b"short")
            assert await kv.get(keys[0]) == b"short"

            n = await kv.remove_many(keys[:10])
            assert n == 10
            got = await kv.get_many(keys)
            assert got[:10] == [None] * 10 and got[10:] == vals[10:]
            # idempotent GC: re-removing acks
            assert await kv.remove_many(keys[:10]) == 10
        finally:
            await fab.stop()
    run(body())


def test_put_superseded_by_newer_update_is_not_an_error():
    """A put whose (retried) update lost to a NEWER committed update on
    the same chunk — a hot key hammered from many processes — succeeds
    with last-writer-wins semantics instead of raising: the outcome is
    indistinguishable from landing and being overwritten right after."""
    from t3fs_torch.net.wire import WireStatus
    from t3fs_torch.storage.types import IOResult
    from t3fs_torch.utils.status import StatusCode

    class _StaleClient:
        cfg = type("C", (), {"verify_checksums": False})()

        async def write_chunk(self, *a, **kw):
            return IOResult(WireStatus(int(StatusCode.CHUNK_STALE_UPDATE),
                                       "v3 <= committed v7"))

    kv = KVCacheStore(_StaleClient(), chains=[1], namespace="t")
    assert run(kv.put(b"hot", b"v")) == 0      # no fence, but no crash


def test_block_size_enforced():
    async def body():
        fab = StorageFabric(num_nodes=1, replicas=1)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            from t3fs_torch.lib.kvcache import KVCacheConfig
            kv = KVCacheStore(sc, chains=[fab.chain_id],
                              config=KVCacheConfig(block_size=1024))
            with pytest.raises(StatusError):
                await kv.put(b"k", b"x" * 2048)
        finally:
            await fab.stop()
    run(body())


def test_hedging_override_tracks_live_client_config():
    """Regression: the store once kept a construction-time copy.copy of the
    client config for its reads, so flipping client.cfg afterwards silently
    had no effect.  The override is now derived per call."""
    from t3fs_torch.lib.kvcache import KVCacheConfig

    class _Recorder:
        class cfg:
            verify_checksums = False
        async def batch_read(self, ios, *, stats=None, hedging=None):
            self.hedging = hedging
            from t3fs_torch.storage.types import IOResult
            from t3fs_torch.utils.status import Status, StatusCode
            r = IOResult(status=Status(StatusCode.CHUNK_NOT_FOUND, ""))
            return [r] * len(ios), [b""] * len(ios)

    rec = _Recorder()
    kv = KVCacheStore(rec, chains=[1],
                      config=KVCacheConfig(read_hedging="inherit"))
    run(kv.get_many([b"k"]))
    assert rec.hedging is None          # inherit: client setting governs
    kv.cfg.read_hedging = "off"         # flipped AFTER construction...
    run(kv.get_many([b"k"]))
    assert rec.hedging == "off"         # ...and the next call sees it
    kv.cfg.read_hedging = "on"
    run(kv.get_many([b"k"]))
    assert rec.hedging == "on"


def test_fenced_remove_loses_to_concurrent_put():
    """GC probes a victim, then a put of the same key lands before the
    REMOVE: the fence (probed update_ver) must make the remove a no-op so
    the newer block survives."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            kv = KVCacheStore(sc, chains=[fab.chain_id], namespace="fence")
            await kv.put(b"victim", b"old-bytes")
            [(match, fence)] = await kv.probe_many([b"victim"])
            assert match and fence >= 1
            # the race: a fresh put lands between probe and remove
            await kv.put(b"victim", b"new-bytes")
            assert await kv.remove_keys([b"victim"], fences=[fence]) \
                == [False]
            assert await kv.get(b"victim") == b"new-bytes"
            # re-probe picks up the new version; the fenced remove now wins
            [(match, fence2)] = await kv.probe_many([b"victim"])
            assert match and fence2 > fence
            assert await kv.remove_keys([b"victim"], fences=[fence2]) \
                == [True]
            assert await kv.get(b"victim") is None
            # probing an absent key is a clean (False, 0)
            assert await kv.probe_many([b"victim"]) == [(False, 0)]
            # fenced remove of an absent chunk still acks (idempotent GC)
            assert await kv.remove_keys([b"victim"], fences=[fence2]) \
                == [True]
        finally:
            await fab.stop()
    run(body())


def test_prefix_chain_semantics():
    blocks_a = [b"tok0", b"tok1", b"tok2"]
    blocks_b = [b"tok0", b"tok1", b"DIVERGES"]
    ka = KVCacheStore.prefix_keys("model-x", blocks_a)
    kb = KVCacheStore.prefix_keys("model-x", blocks_b)
    assert ka[:2] == kb[:2]            # shared prefix -> shared keys
    assert ka[2] != kb[2]              # divergence changes later keys
    assert KVCacheStore.prefix_keys("model-y", blocks_a)[0] != ka[0]


def test_longest_prefix_batched_probe():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            kv = KVCacheStore(sc, chains=[fab.chain_id], namespace="pfx")
            blocks = [f"tokens-{i}".encode() for i in range(6)]
            keys = kv.prefix_keys("m", blocks)
            # cache the first 4 blocks' KV state
            for i in range(4):
                await kv.put(keys[i], f"kvstate-{i}".encode())
            n, values = await kv.longest_prefix("m", blocks)
            assert n == 4
            assert values == [f"kvstate-{i}".encode() for i in range(4)]
            # a hole breaks the prefix even if later blocks exist
            await kv.remove_many([keys[1]])
            n, values = await kv.longest_prefix("m", blocks)
            assert n == 1 and values == [b"kvstate-0"]
        finally:
            await fab.stop()
    run(body())


# ---------------- the port against the JAX package, bit for bit ----------------

def _pkg(root, fleet) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, kv=root.lib.kvcache, sc=root.client.storage_client,
        fabric=root.testing.fabric, net=root.net.client, rdma=root.net.rdma,
        serde=root.utils.serde, thaw=fleet.thaw_routing,
        freeze=fleet.freeze_routing)


REF = _pkg(t3fs, benchmarks.kvcache_fleet_bench)
PORT = _pkg(t3fs_torch, t3fs_torch.benchmarks.kvcache_fleet_bench)
BLOCK = 256 << 10
# around the nodes' 64 KiB device cutoff (the port's CUDA backend runs its
# plain B1 from there up), and a block that fills its class
VALUE_SIZES = (0, 1, 700, 16 << 10, (64 << 10) - 13, 64 << 10, 100_000,
               BLOCK - 12 - 40)


def make_kv_ops(seed: int, n_ops: int = 90) -> list[tuple]:
    """A seeded op sequence over a small key space: puts (overwrites with
    shorter and longer values too), batched gets with absent keys,
    probes, fenced and unfenced removes, a prefix chain and its lookups."""
    rng = np.random.default_rng(seed)
    keys = [f"k{seed}-{i}".encode() for i in range(24)] + [
        rng.integers(0, 256, 40, dtype=np.uint8).tobytes()]
    chain = [f"tok{i}".encode() * 7 for i in range(6)]
    ops: list[tuple] = []
    while len(ops) < n_ops:
        kind = rng.choice(["put", "put", "put", "get", "probe", "remove",
                           "prefix"])
        some = [keys[int(i)] for i in rng.choice(len(keys), 6)]
        if kind == "put":
            n = int(rng.choice(VALUE_SIZES))
            ops.append(("put", some[0], rng.integers(0, 256, n, dtype=np.uint8)
                        .tobytes()))
        elif kind == "get":
            ops.append(("get_many", some + [b"never-put"]))
        elif kind == "probe":
            ops.append(("probe_many", some))
        elif kind == "remove":
            ops.append(("remove_keys", some[:3], bool(rng.integers(0, 2))))
        else:
            j = int(rng.integers(0, len(chain) + 1))
            ops.append(("prefix", j, chain))
    return ops


async def run_kv_ops(p, store, ops) -> list:
    out = []
    for op in ops:
        if op[0] == "put":
            out.append(("put", await store.put(op[1], op[2])))
        elif op[0] == "get_many":
            out.append(("get_many", await store.get_many(op[1])))
        elif op[0] == "probe_many":
            out.append(("probe_many", await store.probe_many(op[1])))
        elif op[0] == "remove_keys":
            fences = ([v for _, v in await store.probe_many(op[1])]
                      if op[2] else None)
            out.append(("remove_keys", await store.remove_keys(op[1], fences)))
        else:
            _, j, chain = op
            keys = p.kv.KVCacheStore.prefix_keys("model-x", chain)
            for k, blk in zip(keys[:j], chain[:j]):
                await store.put(k, blk * 3)
            out.append(("prefix", keys,
                        await store.longest_prefix("model-x", chain)))
    return out


def dump_replicas(p, fabric) -> dict:
    """Every replica's chunks: (node, target) -> [(ChunkMeta bytes, chunk
    bytes)] in chunk-id order."""
    out = {}
    for node in fabric.nodes:
        for tid, target in sorted(node.targets.items()):
            metas = sorted(target.engine.all_metas(),
                           key=lambda m: (m.chunk_id.inode, m.chunk_id.index))
            out[(node.node_id, tid)] = [
                (p.serde.dumps(m), bytes(target.engine.read(m.chunk_id)))
                for m in metas]
    return out


def foreign_client(p, fabric):
    """Package p's StorageClient over the wire to another package's fabric."""
    routing = p.thaw(p.freeze(fabric.routing))
    cli = p.net.Client()
    cli.add_service(p.rdma.BufferRegistry())
    return p.sc.StorageClient(lambda: routing, client=cli)


async def kv_diff_run(p, ops) -> dict:
    """The op sequence through package p's store on p's own fabric (3 nodes,
    2 chains of 2 replicas); then both packages' stores read every key and
    the prefix chain back, the other package's over the wire."""
    fab = p.fabric.StorageFabric(num_nodes=3, replicas=2, num_chains=2)
    await fab.start()
    sc = p.sc.StorageClient(lambda: fab.routing, client=fab.client)
    cfg = p.kv.KVCacheConfig(block_size=BLOCK)
    store = p.kv.KVCacheStore(sc, fab.chain_ids, namespace="diff", config=cfg)
    try:
        results = await run_kv_ops(p, store, ops)
        keys = sorted({k for op in ops if op[0] == "put" for k in [op[1]]})
        chain = next(op[2] for op in ops if op[0] == "prefix")
        reads = {}
        for q in (REF, PORT):
            qsc = sc if q is p else foreign_client(q, fab)
            qstore = q.kv.KVCacheStore(qsc, fab.chain_ids, namespace="diff",
                                       config=q.kv.KVCacheConfig(block_size=BLOCK))
            reads[q.name] = (await qstore.get_many(keys),
                             await qstore.probe_many(keys),
                             await qstore.longest_prefix("model-x", chain))
            if q is not p:
                await qsc.close()
        return {"results": results, "reads": reads,
                "replicas": dump_replicas(p, fab)}
    finally:
        await sc.close()
        await fab.stop()


@pytest.mark.parametrize("seed", [3, 14])
def test_store_matches_reference_bit_for_bit(seed):
    """One seeded op sequence through each package's KVCacheStore on its
    own fabric: every put, get_many, probe_many, remove_keys and
    longest_prefix result, and every replica's stored chunk bytes and
    ChunkMeta, are equal; each package's store reads the blocks the other
    wrote (over the wire) exactly as the writer's own does."""
    ops = make_kv_ops(seed)
    ref = run(kv_diff_run(REF, ops))
    port = run(kv_diff_run(PORT, ops))
    assert len(port["results"]) == len(ops)
    for i, (a, b) in enumerate(zip(ref["results"], port["results"])):
        assert a == b, (i, ops[i][0])
    assert port["replicas"] == ref["replicas"]
    assert sum(len(v) for v in ref["replicas"].values()) > 20
    for out in (ref, port):
        assert out["reads"]["t3fs"] == out["reads"]["t3fs_torch"]
    assert ref["reads"] == port["reads"]
    # the sequence reached hits, misses, both remove kinds and a prefix
    kinds = {op[0] for op in ops}
    assert kinds >= {"put", "get_many", "probe_many", "remove_keys", "prefix"}
    gets = [v for r in ref["results"] if r[0] == "get_many" for v in r[1]]
    assert any(v is None for v in gets) and any(v for v in gets)


def test_block_codec_and_placement_match_reference():
    """The block codec's bytes, its decode of intact, collided, torn and
    padded blocks, placement, namespace inodes and prefix keys are the
    reference's."""
    rng = np.random.default_rng(5)
    sc = object.__new__(StorageClient)
    ref_sc = object.__new__(REF.sc.StorageClient)
    for n in (0, 1, 5, 300, 70_000):
        key = rng.integers(0, 256, int(rng.integers(0, 80)), dtype=np.uint8).tobytes()
        value = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        blob = PORT.kv._pack_block(key, value)
        assert blob == REF.kv._pack_block(key, value)
        for b, k in ((blob, key), (blob, key + b"x"), (blob[:-1], key),
                     (blob + b"\xff" * 9, key), (b"", key)):
            assert PORT.kv._unpack_block(b, k) == REF.kv._unpack_block(b, k)
    for ns in ("a", "default", "model-x/shard-7"):
        a = KVCacheStore(sc, chains=[1, 2, 3, 4, 5], namespace=ns)
        b = REF.kv.KVCacheStore(ref_sc, chains=[1, 2, 3, 4, 5], namespace=ns)
        assert a.inode == b.inode
        for i in range(50):
            key = f"{ns}-{i}".encode()
            (ca, ida), (cb, idb) = a.locate(key), b.locate(key)
            assert (ca, ida.inode, ida.index) == (cb, idb.inode, idb.index)
    blocks = [rng.integers(0, 256, 64, dtype=np.uint8).tobytes() for _ in range(9)]
    assert (KVCacheStore.prefix_keys("m", blocks)
            == REF.kv.KVCacheStore.prefix_keys("m", blocks))


@pytest.mark.cuda
def test_kvcache_bench_on_the_card():
    """kvcache_bench on the port's defaults on the card, at one DeepSeek-V3
    KV block of 16 tokens (61 layers x (512 + 64) x 2 B): every hop's CRC
    of the 2 MiB-class block on B1, no miss."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from t3fs_torch.benchmarks.kvcache_bench import parse_args, run_bench
    from t3fs_torch.ops import cuda_codec

    cuda_codec.reset_launches()
    out = run(run_bench(parse_args(
        ["--blocks", "32", "--value-size", str(16 * 61 * (512 + 64) * 2),
         "--batch", "8", "--concurrency", "8", "--seconds", "1"])))
    assert out["get_miss"] == 0 and out["get_iops"] > 0
    assert out["gc_removed"] == 32
    assert cuda_codec.launches["crc_words"] > 0
