"""The port's checkpoint engine (t3fs_torch/ckpt) on the port's LocalCluster
with its meta service: every case of tests/test_ckpt.py run on the port,
then held against the JAX package bit for bit.

The port runs its nodes' CRCs on the CPU checksum backend and TorchECCodec
on the CPU (the kernels' plain versions); the reference its ECCodec with
the Pallas kernels in interpret mode (T3FS_FORCE_PALLAS_INTERPRET=1), as
tests/test_ckpt.py runs it.  The same seeded tree saved through each
package's cluster gives the same manifest bytes, shard bytes and ChunkMeta;
a checkpoint written by either package's clients restores through the
other's, over the wire against the other's servers."""

import asyncio
import itertools
import types as pytypes

import numpy as np
import pytest

import t3fs.ckpt
import t3fs.ckpt.writer
import t3fs.client.ec_client
import t3fs.client.meta_client
import t3fs.client.mgmtd_client
import t3fs.client.storage_client
import t3fs.fuse.vfs
import t3fs.storage.types
import t3fs.testing.cluster
import t3fs.utils.serde
import t3fs.utils.status
import t3fs_torch.ckpt
import t3fs_torch.ckpt.writer
import t3fs_torch.client.ec_client
import t3fs_torch.client.meta_client
import t3fs_torch.client.mgmtd_client
import t3fs_torch.client.storage_client
import t3fs_torch.fuse.vfs
import t3fs_torch.storage.types
import t3fs_torch.testing.cluster
import t3fs_torch.utils.serde
import t3fs_torch.utils.status
from t3fs.ops.codec import crc32c as ref_crc32c
from t3fs_torch.ckpt import (CheckpointManifest, CheckpointReader,
                             CheckpointStore, CheckpointWriter, ckpt_inode,
                             flatten_tree, manifest_name, parse_step,
                             unflatten_tree)
from t3fs_torch.client.ec_client import ECLayout, ECStorageClient, PARITY_NS
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.storage.types import UpdateType
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode, StatusError


def _pkg(root) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, ckpt=root.ckpt, writer=root.ckpt.writer,
        ec=root.client.ec_client, mc=root.client.meta_client,
        mgmtd=root.client.mgmtd_client, sc=root.client.storage_client,
        vfs=root.fuse.vfs, st=root.storage.types, cluster=root.testing.cluster,
        serde=root.utils.serde, status=root.utils.status)


REF = _pkg(t3fs)
PORT = _pkg(t3fs_torch)


def run(coro):
    # watchdog wrapper: a wedged await fails loudly with every task's
    # coroutine stack instead of hanging the whole suite
    async def _watch():
        task = asyncio.ensure_future(coro)
        done, _ = await asyncio.wait({task}, timeout=120)
        if not done:
            import sys
            print("\n==== HANG: asyncio task dump ====", file=sys.stderr)
            for t in asyncio.all_tasks():
                t.print_stack(file=sys.stderr)
            task.cancel()
            raise TimeoutError("test hang (see task dump on stderr)")
        return task.result()
    return asyncio.run(_watch())


def make_tree(rng):
    """Multi-leaf pytree: mixed dtypes/shapes, nested containers, a tail
    that doesn't fill a stripe, a tiny leaf, and a None."""
    return {
        "params": {
            "w": rng.standard_normal((64, 33)).astype(np.float32),
            "b": rng.standard_normal(257).astype(np.float64),
        },
        "opt": [rng.integers(0, 1 << 31, 5000, dtype=np.int32),
                np.float32(3.5)],
        "meta": None,
        "step_count": np.int64(12345),
    }


def trees_equal(a, b):
    fa, _ = flatten_tree(a)
    fb, _ = flatten_tree(b)
    assert [p for p, _ in fa] == [p for p, _ in fb]
    for (pa, la), (_pb, lb) in zip(fa, fb):
        xa, xb = np.asarray(la), np.asarray(lb)
        assert xa.dtype == xb.dtype and xa.shape == xb.shape, pa
        assert np.array_equal(xa, xb), pa


def port_cluster(**kw) -> LocalCluster:
    return LocalCluster(with_meta=True, checksum_backend="cpu", **kw)


def port_ec(cluster) -> ECStorageClient:
    return ECStorageClient(cluster.sc, codec=TorchECCodec(device="cpu"))


LAY6 = dict(k=4, m=2, chunk_size=2048, chains=[1, 2, 3, 4, 5, 6])
# for a cluster whose test kills no node: no loop stall under test load
# reaches it, so no chain is reshaped (nodes self-fence at half of it)
NO_KILL_HEARTBEAT_TIMEOUT_S = 60.0


async def wait_chains_bumped(cluster, nodes) -> None:
    for _ in range(100):
        if all(c.chain_ver >= 2 for c in
               cluster.mgmtd.state.routing().chains.values()
               if any(t.node_id in nodes for t in c.targets)):
            break
        await asyncio.sleep(0.1)
    await cluster.mgmtd_client.refresh()


# ---------------- pure-python manifest/treedef units ----------------

def test_tree_flatten_unflatten_roundtrip():
    rng = np.random.default_rng(0)
    tree = make_tree(rng)
    leaves, treedef = flatten_tree(tree)
    paths = [p for p, _ in leaves]
    assert "params/w" in paths and "opt/0" in paths
    rebuilt = unflatten_tree(treedef, {i: leaf for i, (_, leaf) in
                                       enumerate(leaves)})
    assert rebuilt["meta"] is None
    assert isinstance(rebuilt["opt"], list)
    trees_equal(tree, rebuilt)
    sparse = unflatten_tree(treedef, {0: leaves[0][1]})
    assert sparse["step_count"] is None
    with pytest.raises(StatusError):
        flatten_tree({"a/b": np.zeros(1)})
    with pytest.raises(StatusError):
        flatten_tree({1: np.zeros(1)})
    # the reference flattens to the same paths and treedef string
    ref_leaves, ref_def = REF.ckpt.flatten_tree(tree)
    assert ref_def == treedef
    assert [p for p, _ in ref_leaves] == paths


def test_manifest_serde_and_naming():
    lay = ECLayout.create(k=2, m=2, chunk_size=512, chains=[1, 2, 3, 4])
    man = CheckpointManifest(version=1, directory="/ck", step=7,
                             treedef='{"t":"leaf","i":0}', layout=lay,
                             created_at=123.0)
    man2 = serde.loads(serde.dumps(man))
    assert isinstance(man2, CheckpointManifest)
    assert man2.step == 7 and man2.layout.k == 2
    assert man2.layout.chains == [1, 2, 3, 4]
    assert parse_step(manifest_name(7)) == 7
    assert parse_step("step-000000000042.t3ckpt") == 42
    assert parse_step(".tmp-step-000000000042.t3ckpt") is None
    assert parse_step("notes.txt") is None
    a = ckpt_inode("/ck", 7, "params/w")
    assert a == ckpt_inode("/ck", 7, "params/w")
    assert a != ckpt_inode("/ck", 8, "params/w")
    assert a != ckpt_inode("/ck", 7, "params/b")
    assert not a & PARITY_NS and a & (1 << 63)
    # the same bytes and inodes as the reference's
    ref_lay = REF.ec.ECLayout.create(k=2, m=2, chunk_size=512,
                                     chains=[1, 2, 3, 4])
    leaf = dict(path="p/q", dtype="float32", shape=[3, 5], nbytes=60,
                inode=a, num_stripes=1, shard_crcs=[1, 2, 3, 4])
    ref_man = REF.ckpt.CheckpointManifest(
        version=1, directory="/ck", step=7, treedef='{"t":"leaf","i":0}',
        layout=ref_lay, leaves=[REF.ckpt.CkptLeaf(**leaf)], created_at=123.0)
    man.leaves = [t3fs_torch.ckpt.CkptLeaf(**leaf)]
    assert serde.dumps(man) == REF.serde.dumps(ref_man)
    assert REF.serde.dumps(REF.serde.loads(serde.dumps(man))) == \
        serde.dumps(man)
    for step, path in itertools.product((0, 7, 10**11), ("", "a/0", "é")):
        assert ckpt_inode("/d", step, path) == \
            REF.ckpt.ckpt_inode("/d", step, path)
        assert manifest_name(step) == REF.ckpt.manifest_name(step)


# ---------------- cluster e2e (the port) ----------------

def test_ckpt_save_restore_partial_resharded():
    async def body():
        cluster = port_cluster(num_nodes=3, replicas=1, num_chains=6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            tree = make_tree(np.random.default_rng(1))
            w = CheckpointWriter(ec, fs, lay, "/ckpt/run1")
            stats = await w.save(100, tree)
            assert stats.stripes_total > 1
            assert stats.shards_written > 0
            assert stats.manifest_path == \
                f"/ckpt/run1/{manifest_name(100)}"
            # writes went through the fused encode+CRC step
            assert ec.codec.codec_counts.get("cuda-encode-words", 0) >= 1

            r = CheckpointReader(ec, fs, "/ckpt/run1")
            trees_equal(tree, await r.restore())
            trees_equal(tree, await r.restore(step=100))

            part = await r.restore(paths=["params"])
            assert part["opt"] == [None, None]
            assert part["step_count"] is None
            assert np.array_equal(part["params"]["w"], tree["params"]["w"])
            one = await r.restore(paths=["opt/0"])
            assert np.array_equal(one["opt"][0], tree["opt"][0])
            assert one["opt"][1] is None

            shards = [await r.restore_shard(i, 3) for i in range(3)]
            seen = {}
            for sh in shards:
                for path, arr in sh.items():
                    assert path not in seen, "reader shards must be disjoint"
                    seen[path] = arr
            flat, _ = flatten_tree(tree)
            assert set(seen) == {p for p, _ in flat}
            for path, leaf in flat:
                assert np.array_equal(seen[path], np.asarray(leaf)), path
            with pytest.raises(StatusError):
                await r.restore_shard(3, 3)
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_ckpt_resume_skips_committed_stripes():
    async def body():
        cluster = port_cluster(num_nodes=3, replicas=1, num_chains=6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            tree = make_tree(np.random.default_rng(2))
            w = CheckpointWriter(ec, fs, lay, "/ckpt/run2")
            first = await w.save(5, tree)
            again = await w.save(5, tree)
            assert again.stripes_total == first.stripes_total
            assert again.stripes_skipped == again.stripes_total
            assert again.shards_written == 0 and again.bytes_written == 0
            forced = await w.save(5, tree, resume=False)
            assert forced.shards_written > 0
            r = CheckpointReader(ec, fs, "/ckpt/run2")
            trees_equal(tree, await r.restore())
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_ckpt_interrupt_then_resume_rewrites_only_missing():
    async def body():
        cluster = port_cluster(num_nodes=3, replicas=1, num_chains=6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            rng = np.random.default_rng(3)
            tree = {"a": rng.integers(0, 255, 9 * 4 * 2048, dtype=np.uint8)}
            w = CheckpointWriter(ec, fs, lay, "/ckpt/irq", window=1)
            hit = asyncio.Event()

            def on_stripe(done, total):
                if done >= 3:
                    hit.set()

            task = asyncio.create_task(w.save(7, tree, on_stripe=on_stripe))
            await hit.wait()
            task.cancel()
            with pytest.raises(asyncio.CancelledError):
                await task
            store = CheckpointStore(fs, "/ckpt/irq")
            assert await store.list_steps() == []

            stats = await w.save(7, tree)
            assert stats.stripes_total == 9
            assert stats.stripes_skipped >= 3, stats
            assert stats.shards_written <= (9 - 3) * 6, stats
            assert await store.list_steps() == [7]
            r = CheckpointReader(ec, fs, "/ckpt/irq")
            assert np.array_equal((await r.restore())["a"], tree["a"])
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_ckpt_degraded_restore_two_chains_down():
    async def body():
        cluster = port_cluster(num_nodes=8, replicas=1, num_chains=8,
                               heartbeat_timeout_s=0.6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            tree = make_tree(np.random.default_rng(4))
            w = CheckpointWriter(ec, fs, lay, "/ckpt/deg")
            stats = await w.save(11, tree)
            ino = await fs.stat(stats.manifest_path)
            used = set(ino.layout.chains)
            data_chain = next(c for c in (2, 3, 4) if c not in used)
            parity_chain = next(c for c in (5, 6) if c not in used)
            for chain in (data_chain, parity_chain):
                await cluster.kill_storage_node(chain)
            await wait_chains_bumped(cluster, (data_chain, parity_chain))

            r = CheckpointReader(ec, fs, "/ckpt/deg")
            trees_equal(tree, await r.restore())
            assert ec.codec.codec_counts.get("cuda-decode-words", 0) >= 1, \
                ec.codec.codec_counts
            rep = await r.scrub(11, repair=False)
            assert rep.shards_missing > 0
            assert rep.stripes_unrecoverable == 0
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_ckpt_scrub_repairs_stale_and_missing_shards():
    async def body():
        cluster = port_cluster(num_nodes=3, replicas=1, num_chains=6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            rng = np.random.default_rng(5)
            tree = {"a": rng.integers(0, 255, 4 * 4 * 2048, dtype=np.uint8)}
            w = CheckpointWriter(ec, fs, lay, "/ckpt/scrub")
            await w.save(1, tree)
            store = CheckpointStore(fs, "/ckpt/scrub")
            lf = (await store.load(1)).leaves[0]
            await cluster.sc.write_chunk(
                lay.shard_chain(2, 1), lay.data_chunk(lf.inode, 2, 1), 0,
                bytes(2048), chunk_size=2048,
                update_type=UpdateType.REPLACE)
            await cluster.sc.write_chunk(
                lay.shard_chain(3, 4), lay.parity_chunk(lf.inode, 3, 0), 0,
                b"", chunk_size=2048, update_type=UpdateType.REMOVE)
            r = CheckpointReader(ec, fs, "/ckpt/scrub")
            assert np.array_equal((await r.restore())["a"], tree["a"])
            rep = await r.scrub(1)
            assert rep.shards_corrupt >= 1 and rep.shards_missing >= 1
            assert rep.shards_repaired >= 2
            assert rep.stripes_unrecoverable == 0
            rep2 = await r.scrub(1)
            assert rep2.shards_corrupt == 0 and rep2.shards_missing == 0
            assert np.array_equal((await r.restore())["a"], tree["a"])
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_ckpt_gc_keep_last():
    async def body():
        cluster = port_cluster(num_nodes=3, replicas=1, num_chains=6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            w = CheckpointWriter(ec, fs, lay, "/ckpt/gc")
            trees = {}
            for step in (100, 200, 300):
                trees[step] = {"x": np.full(3 * 4 * 2048, step % 251,
                                            dtype=np.uint8)}
                await w.save(step, trees[step])
            store = CheckpointStore(fs, "/ckpt/gc")
            assert await store.list_steps() == [100, 200, 300]
            old_inode = ckpt_inode("/ckpt/gc", 100, "x")
            rep = await store.gc(cluster.sc, keep_last=2)
            assert rep.steps_removed == [100]
            assert rep.steps_kept == [200, 300]
            assert rep.bytes_removed == 3 * 4 * 2048
            assert await store.list_steps() == [200, 300]
            res, _ = await cluster.sc.read_chunk(
                lay.shard_chain(0, 0), lay.data_chunk(old_inode, 0, 0))
            assert res.status.code == int(StatusCode.CHUNK_NOT_FOUND)
            r = CheckpointReader(ec, fs, "/ckpt/gc")
            assert np.array_equal((await r.restore(step=200))["x"],
                                  trees[200]["x"])
            with pytest.raises(StatusError):
                await store.gc(cluster.sc, keep_last=0)
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_write_stripe_reports_per_shard_failures():
    async def body():
        cluster = LocalCluster(num_nodes=6, replicas=1, num_chains=6,
                               with_meta=False, heartbeat_timeout_s=0.6,
                               checksum_backend="cpu")
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            data = bytes(range(256)) * 32
            enc = await ec.encode_stripe(lay, data)
            sub = (1, 4)
            results = await ec.write_encoded(lay, 77, 0, enc, shards=sub)
            assert len(results) == len(sub)
            assert all(r.status.code == int(StatusCode.OK) for r in results)
            res, _ = await cluster.sc.read_chunk(
                lay.shard_chain(0, 0), lay.data_chunk(77, 0, 0))
            assert res.status.code == int(StatusCode.CHUNK_NOT_FOUND)
            dead_chain = lay.shard_chain(0, 2)
            await cluster.kill_storage_node(dead_chain)
            await wait_chains_bumped(cluster, (dead_chain,))
            results = await ec.write_stripe(lay, 88, 0, data)
            assert len(results) == 6
            bad = [s for s, r in enumerate(results)
                   if r.status.code != int(StatusCode.OK)]
            assert bad == [2], [StatusCode(r.status.code).name
                                for r in results]
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


def test_scrub_discovery_lists_every_committed_leaf():
    """checkpoint_scrub_targets / manifest_discovery: one ScrubTarget per
    leaf of every committed step, named <dir>/step-N/<leaf>."""
    from t3fs_torch.ckpt.scrub import manifest_discovery

    async def body():
        cluster = port_cluster(num_nodes=3, replicas=1, num_chains=6)
        await cluster.start()
        try:
            lay = ECLayout.create(**LAY6)
            ec = port_ec(cluster)
            fs = FileSystem(cluster.mc, cluster.sc)
            w = CheckpointWriter(ec, fs, lay, "/ckpt/disc")
            tree = make_tree(np.random.default_rng(6))
            for step in (1, 2):
                await w.save(step, tree)
            targets = await manifest_discovery(fs, ["/ckpt/disc",
                                                    "/ckpt/none"])()
            names = sorted(t.name for t in targets)
            paths = [p for p, _ in flatten_tree(tree)[0]]
            assert names == sorted(f"/ckpt/disc/step-{s}/{p}"
                                   for s in (1, 2) for p in paths)
            for t in targets:
                assert t.layout == lay and t.stripe_lens
            await ec.close()
        finally:
            await cluster.stop()
    run(body())


# ---------------- held against the reference ----------------

class _Clock:
    def time(self) -> float:
        return 1_800_000_000.25


@pytest.fixture
def pinned(monkeypatch):
    """time.time() pinned in both packages' writer modules: the manifest's
    created_at is the one clock reading a checkpoint's bytes hold."""
    monkeypatch.setenv("T3FS_FORCE_PALLAS_INTERPRET", "1")
    for p in (REF, PORT):
        monkeypatch.setattr(p.writer, "time", _Clock())


def cluster_of(p, **kw):
    if p is REF:
        return REF.cluster.LocalCluster(with_meta=True, **kw)
    return port_cluster(**kw)


def ec_of(p, sc):
    if p is REF:
        return REF.ec.ECStorageClient(sc)
    return PORT.ec.ECStorageClient(sc, codec=TorchECCodec(device="cpu"))


def diff_tree():
    rng = np.random.default_rng(11)
    return {"w": rng.standard_normal((40, 50)).astype(np.float32),
            "ids": rng.integers(0, 1 << 40, 1500, dtype=np.int64),
            "blob": rng.integers(0, 256, 3 * 4 * 2048 + 17, dtype=np.uint8),
            "small": [np.uint8(7), rng.integers(0, 9, 3, dtype=np.int16)]}


async def save_and_dump(p) -> dict:
    """Save diff_tree() as step 3 through package p's own cluster, then
    dump the manifest file's bytes and every shard's ChunkMeta and bytes.

    No node is killed here, so the cluster's heartbeat timeout is one that
    test load cannot reach: a loop stalled past the default 0.6 s (the
    reference's Pallas kernels run interpreted in this process) would
    reshape a chain on one side only and stamp its version into that
    side's ChunkMeta.  The dump then runs on the initial routing."""
    cluster = cluster_of(p, num_nodes=3, replicas=1, num_chains=6,
                         heartbeat_timeout_s=NO_KILL_HEARTBEAT_TIMEOUT_S)
    await cluster.start()
    try:
        lay = p.ec.ECLayout.create(**LAY6)
        ec = ec_of(p, cluster.sc)
        fs = p.vfs.FileSystem(cluster.mc, cluster.sc)
        w = p.ckpt.CheckpointWriter(ec, fs, lay, "/ckpt/diff", window=1)
        stats = await w.save(3, diff_tree())
        man_blob = await fs.read_file(stats.manifest_path)
        man = p.serde.loads(man_blob)
        routing = cluster.mgmtd.state.routing()
        assert {c.chain_ver for c in routing.chains.values()} == {1}
        shards = {}
        for lf in man.leaves:
            for s in range(lf.num_stripes):
                for slot in range(lay.k + lay.m):
                    t = routing.chains[lay.shard_chain(s, slot)].head()
                    eng = cluster.storage[t.node_id].node.targets[
                        t.target_id].engine
                    cid = (lay.data_chunk(lf.inode, s, slot) if slot < lay.k
                           else lay.parity_chunk(lf.inode, s, slot - lay.k))
                    meta = eng.get_meta(cid)
                    shards[(lf.path, s, slot)] = None if meta is None else (
                        p.serde.dumps(meta), eng.read(cid))
        r = p.ckpt.CheckpointReader(ec, fs, "/ckpt/diff")
        got = await r.restore()
        flat = p.ckpt.flatten_tree(got)[0]
        restored = [(path, np.asarray(x).dtype.str, np.asarray(x).shape,
                     np.asarray(x).tobytes()) for path, x in flat]
        codec_counts = dict(ec.codec.codec_counts)
        await ec.close()
        return {"stats": stats.__dict__, "manifest": man_blob,
                "shards": shards, "restored": restored,
                "codec": codec_counts}
    finally:
        await cluster.stop()


def test_saved_checkpoint_matches_reference_bit_for_bit(pinned):
    """The same seeded tree saved through each package's cluster: the
    SaveStats, the manifest file's bytes, every shard's stored bytes and
    ChunkMeta (length, versions, CRC, state) are equal, and each restores
    to the tree."""
    out = {p.name: run(save_and_dump(p)) for p in (REF, PORT)}
    ref, port = out["t3fs"], out["t3fs_torch"]
    assert port["codec"].get("cuda-encode-words", 0) >= 1
    assert ref["codec"].get("pallas-encode-words", 0) >= 1
    assert port["stats"] == ref["stats"]
    assert port["manifest"] == ref["manifest"]
    assert port["shards"].keys() == ref["shards"].keys()
    for key in ref["shards"]:
        assert port["shards"][key] == ref["shards"][key], key
    assert sum(v is None for v in ref["shards"].values()) >= 1   # holes
    want = [(path, np.asarray(x).dtype.str, np.asarray(x).shape,
             np.asarray(x).tobytes()) for path, x in flatten_tree(diff_tree())[0]]
    assert port["restored"] == ref["restored"] == want


async def cross_restore(cluster_pkg) -> None:
    """On cluster_pkg's cluster: the other package's clients (over the
    wire to this cluster's mgmtd, meta and storage servers) save step 1,
    which this package's own clients restore; this package's clients save
    step 2, which the other's restore, degraded after a node kill too."""
    other = PORT if cluster_pkg is REF else REF
    cluster = cluster_of(cluster_pkg, num_nodes=7, replicas=1, num_chains=7,
                         heartbeat_timeout_s=0.6)
    await cluster.start()
    mg = other.mgmtd.MgmtdClient(cluster.mgmtd_rpc.address,
                                 refresh_period_s=0.1)
    await mg.start()
    sc = other.sc.StorageClient(mg.routing, config=other.sc.StorageClientConfig(
        retry_backoff_s=0.05, max_retries=12), refresh_routing=mg.refresh)
    mc = other.mc.MetaClient([cluster.meta_rpc.address])
    try:
        rng = np.random.default_rng(21)
        tree1 = {"a": rng.standard_normal(3000).astype(np.float32),
                 "b": [rng.integers(0, 1 << 30, 999, dtype=np.int64)]}
        tree2 = {"c": rng.integers(0, 256, 5 * 4 * 2048 + 5, dtype=np.uint8)}
        chains = [1, 2, 3, 4, 5, 6]
        # foreign clients write, native clients read
        f_ec = ec_of(other, sc)
        f_fs = other.vfs.FileSystem(mc, sc)
        f_lay = other.ec.ECLayout.create(k=4, m=2, chunk_size=2048,
                                         chains=chains)
        await other.ckpt.CheckpointWriter(f_ec, f_fs, f_lay, "/x").save(1, tree1)
        n_ec = ec_of(cluster_pkg, cluster.sc)
        n_fs = cluster_pkg.vfs.FileSystem(cluster.mc, cluster.sc)
        n_lay = cluster_pkg.ec.ECLayout.create(k=4, m=2, chunk_size=2048,
                                               chains=chains)
        got = await cluster_pkg.ckpt.CheckpointReader(n_ec, n_fs, "/x").restore(1)
        assert np.array_equal(got["a"], tree1["a"])
        assert np.array_equal(got["b"][0], tree1["b"][0])
        # native clients write, foreign clients read: healthy, then with
        # the node behind chain 2 down (a data shard of every stripe)
        await cluster_pkg.ckpt.CheckpointWriter(n_ec, n_fs, n_lay, "/x").save(
            2, tree2)
        f_reader = other.ckpt.CheckpointReader(f_ec, f_fs, "/x")
        assert np.array_equal((await f_reader.restore(2))["c"], tree2["c"])
        assert await other.ckpt.CheckpointStore(f_fs, "/x").list_steps() == [1, 2]
        man = await f_reader.store.load(2)
        used = set((await f_fs.stat(f"/x/{other.ckpt.manifest_name(2)}"))
                   .layout.chains)
        victim = next(c for c in (2, 3, 4) if c not in used)
        await cluster.kill_storage_node(victim)
        await wait_chains_bumped(cluster, (victim,))
        await mg.refresh()
        assert np.array_equal((await f_reader.restore(2))["c"], tree2["c"])
        assert man.leaves[0].num_stripes == 6
        await f_ec.close()
        await n_ec.close()
    finally:
        await mc.close_conn()
        await sc.close()
        await mg.stop()
        await cluster.stop()


@pytest.mark.parametrize("cluster_pkg", ["ref", "port"])
def test_checkpoint_restores_across_packages(cluster_pkg, monkeypatch):
    monkeypatch.setenv("T3FS_FORCE_PALLAS_INTERPRET", "1")
    run(cross_restore(REF if cluster_pkg == "ref" else PORT))


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ckpt_on_the_card(cuda_device):
    """The port's defaults on the card: LocalCluster's CUDA checksum
    backend and ECStorageClient's TorchECCodec.  A save at 64 KiB shards
    (every stripe on the fused encode-and-CRC route), a restore, and a
    degraded restore with two chains down; the manifest's CRCs equal the
    reference package's host CRC of each stored shard, and B1, B2 and B3
    were launched."""
    from t3fs_torch.ops import cuda_codec

    async def body():
        cluster = LocalCluster(num_nodes=8, replicas=1, num_chains=8,
                               with_meta=True, heartbeat_timeout_s=0.6)
        await cluster.start()
        ec = ECStorageClient(cluster.sc)
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=64 << 10,
                                  chains=[1, 2, 3, 4, 5, 6])
            fs = FileSystem(cluster.mc, cluster.sc)
            rng = np.random.default_rng(13)
            tree = {"w": rng.standard_normal((300, 257)).astype(np.float32),
                    "b": rng.integers(0, 256, 5 * 4 * (64 << 10), dtype=np.uint8)}
            cuda_codec.reset_launches()
            stats = await CheckpointWriter(ec, fs, lay, "/card").save(1, tree)
            assert set(ec.codec.codec_counts) == {"cuda-encode-words"}
            r = CheckpointReader(ec, fs, "/card")
            trees_equal(tree, await r.restore())
            man = await r.store.load(1)
            for lf in man.leaves:
                for s in range(lf.num_stripes):
                    crcs = lf.stripe_crcs(lay, s)
                    for j in range(lay.k + lay.m):
                        res, data = await cluster.sc.read_chunk(
                            lay.shard_chain(s, j), lay.shard_chunk(lf.inode, s, j))
                        if crcs[j] == 0 and j < lay.k:
                            continue
                        assert crcs[j] == ref_crc32c(data) == int(res.checksum)
            used = set((await fs.stat(stats.manifest_path)).layout.chains)
            down = [next(c for c in (2, 3, 4) if c not in used),
                    next(c for c in (5, 6) if c not in used)]
            for node in down:
                await cluster.kill_storage_node(node)
            await wait_chains_bumped(cluster, down)
            trees_equal(tree, await r.restore())
            assert ec.codec.codec_counts.get("cuda-decode-words", 0) >= 1
            for name in ("crc_words", "rs_raid6_words", "rs_reconstruct_words"):
                assert cuda_codec.launches[name] > 0, name
        finally:
            await ec.close()
            await cluster.stop()
    run(body())
