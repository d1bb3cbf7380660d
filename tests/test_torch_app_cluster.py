"""The port's deployment layer (t3fs_torch.app: the mgmtd, storage, meta
and monitor binaries, ApplicationBase and DevCluster) against the JAX
package's (t3fs.app): both packages' multi-process clusters up at once on
the CPU (the port's storage processes on the host checksum backend), the
same seeded file written through FileSystem in each giving equal stored
bytes and ChunkMeta, each package's clients against the other's cluster,
the TOML each DevCluster writes, the two-phase config fetch, the
placement solver, meta over two kv_main shard processes
(DevCluster(kv_shards=2)), and the refusals: DevCluster past one shard a
KeyPrefix, and a storage process asked for the CUDA backend where no GPU
is present.

Every test that drives the clusters bounds its own wall time
(asyncio.wait_for), and the clusters are started once for the module.
No node is killed here, so the heartbeat timeout is one test load cannot
reach; the reference's own fail-over end to end (tests/test_app_cluster.py)
stays marked slow, and chip_smoke.py's phase 28 kills and restarts a
storage process of the port's cluster on the card."""

import asyncio
import os
import re

import numpy as np
import pytest
import torch

from t3fs.app import dev_cluster as ref_dc
from t3fs.client import meta_client as ref_mc
from t3fs.client import mgmtd_client as ref_mgc
from t3fs.client import storage_client as ref_sc
from t3fs.fuse import vfs as ref_vfs
from t3fs.mgmtd import placement as ref_pl
from t3fs.mgmtd import types as ref_types
from t3fs_torch.app import dev_cluster as port_dc
from t3fs_torch.client import meta_client as port_mc
from t3fs_torch.client import mgmtd_client as port_mgc
from t3fs_torch.client import storage_client as port_sc
from t3fs_torch.fuse import vfs as port_vfs
from t3fs_torch.mgmtd import placement as port_pl
from t3fs_torch.mgmtd import types as port_types
from t3fs_torch.net.client import Client as PortClient

CHUNK = 64 << 10
FILE_BYTES = 5 * CHUNK + 12345          # five whole chunks and a tail
HEARTBEAT_TIMEOUT_S = 60.0
START_TIMEOUT_S = 240.0
CALL_TIMEOUT_S = 120.0

CLIENTS = {
    "ref": (ref_mgc.MgmtdClient, ref_sc.StorageClient,
            ref_sc.StorageClientConfig, ref_mc.MetaClient,
            ref_vfs.FileSystem),
    "port": (port_mgc.MgmtdClient, port_sc.StorageClient,
             port_sc.StorageClientConfig, port_mc.MetaClient,
             port_vfs.FileSystem),
}


def _cluster(pkg: str, run_dir: str):
    kw = dict(num_storage=2, replicas=2, num_chains=2, with_meta=True,
              chunk_size=CHUNK, heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S)
    if pkg == "port":
        return port_dc.DevCluster(run_dir, checksum_backend="cpu", **kw)
    return ref_dc.DevCluster(run_dir, **kw)


@pytest.fixture(scope="module")
def clusters(tmp_path_factory):
    """Both packages' clusters, started together; stopped after the
    module.  Each process's log is under its run dir."""
    base = tmp_path_factory.mktemp("devcluster")
    cs = {pkg: _cluster(pkg, str(base / pkg)) for pkg in ("ref", "port")}

    async def start():
        try:
            await asyncio.wait_for(
                asyncio.gather(*(c.start() for c in cs.values())),
                START_TIMEOUT_S)
        except BaseException:
            await stop()
            raise

    async def stop():
        for c in cs.values():
            c.admin = type(c.admin)()     # the last loop's client is gone
            await c.stop()

    asyncio.run(start())
    yield cs
    asyncio.run(stop())


def _data(seed: int, n: int = FILE_BYTES) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n,
                                                dtype=np.uint8).tobytes()


async def _with_clients(pkg: str, cluster, fn):
    """Run fn(fs, mgmtd client) with pkg's clients against cluster."""
    MgmtdClient, StorageClient, Config, MetaClient, FileSystem = CLIENTS[pkg]
    mgmtd = MgmtdClient(cluster.mgmtd_address, refresh_period_s=0.2)
    await mgmtd.start()
    sc = StorageClient(mgmtd.routing,
                       config=Config(retry_backoff_s=0.1, max_retries=15),
                       refresh_routing=mgmtd.refresh)
    meta = MetaClient([cluster.meta_address])
    try:
        return await fn(FileSystem(meta, sc), mgmtd)
    finally:
        await meta.close_conn()
        await sc.close()
        await mgmtd.stop()


def _run(coro):
    return asyncio.run(asyncio.wait_for(coro, CALL_TIMEOUT_S))


async def _file_chunks(fs, mgmtd, path: str) -> dict:
    """path's chunks on every replica, by chunk index: (ChunkMeta fields
    but the inode, bytes) per target, read over the wire."""
    inode = (await fs.stat(path)).inode_id
    cli = PortClient()
    try:
        reps = await port_dc.read_replicas(cli, mgmtd.routing())
    finally:
        await cli.close()
    by_index: dict[int, list] = {}
    for (chain_id, target_id), chunks in sorted(reps.items()):
        for (ino, idx), (m, data) in chunks.items():
            if ino == inode:
                by_index.setdefault(idx, []).append(
                    (chain_id, m.length, m.update_ver, m.commit_ver,
                     m.chain_ver, m.checksum, int(m.state), data))
    return by_index


def test_port_cluster_file_roundtrip(clusters):
    """The port's clients write and read a seeded file through FileSystem
    on the port's cluster; every replica holds it, its CRC right."""
    from t3fs_torch.ops.codec import crc32c

    c = clusters["port"]
    assert {"monitor"}.isdisjoint(c.procs) and {
        "mgmtd", "storage1", "storage2", "meta"} == set(c.procs)
    assert all(p.poll() is None for p in c.procs.values())
    data = _data(1)

    async def body(fs, mgmtd):
        await fs.mkdirs("/rt")
        await fs.write_file("/rt/blob", data)
        assert await fs.read_file("/rt/blob") == data
        return await _file_chunks(fs, mgmtd, "/rt/blob")

    chunks = _run(_with_clients("port", c, body))
    assert sorted(chunks) == list(range(-(-FILE_BYTES // CHUNK)))
    for idx, reps in chunks.items():
        assert len(reps) == 2 and reps[0] == reps[1]
        piece = data[idx * CHUNK:(idx + 1) * CHUNK]
        assert reps[0][-1] == piece and reps[0][5] == crc32c(piece)


def test_stored_chunks_equal_across_packages(clusters):
    """The same seeded file through each package's clients into its own
    cluster: equal bytes and ChunkMeta on every replica."""
    data = _data(2)

    def write_and_dump(pkg):
        async def body(fs, mgmtd):
            await fs.mkdirs("/same")
            await fs.write_file("/same/file", data)
            return await _file_chunks(fs, mgmtd, "/same/file")
        return _run(_with_clients(pkg, clusters[pkg], body))

    ref, port = write_and_dump("ref"), write_and_dump("port")
    assert len(ref) == -(-FILE_BYTES // CHUNK)
    # chain placement comes from meta's layout; compare what each chunk
    # holds, replica by replica
    strip = {i: [r[1:] for r in reps] for i, reps in ref.items()}
    assert {i: [r[1:] for r in reps] for i, reps in port.items()} == strip


@pytest.mark.parametrize("client,cluster", [("port", "ref"), ("ref", "port")])
def test_clients_against_the_other_packages_cluster(clusters, client,
                                                    cluster):
    """Wire compatibility both ways: one package's mgmtd, storage and meta
    clients write, read and list on the other package's processes."""
    data = _data(3 if client == "port" else 4)
    path = f"/x-{client}/f"

    async def body(fs, mgmtd):
        await fs.mkdirs(f"/x-{client}")
        await fs.write_file(path, data)
        assert await fs.read_file(path) == data
        names = [e.name for e in await fs.readdir(f"/x-{client}")]
        routing = mgmtd.routing()
        return names, sorted(routing.chains), sorted(routing.nodes)

    names, chains, nodes = _run(_with_clients(client, clusters[cluster],
                                                 body))
    assert names == ["f"] and chains == [1, 2]
    assert {1, 2} <= set(nodes)


def _normalized_tomls(c, pkg: str) -> dict:
    """Every TOML the cluster wrote, with its run dir, its mgmtd port and
    its package's module names taken out."""
    out = {}
    mport = c.mgmtd_address.rsplit(":", 1)[1]
    for name in sorted(os.listdir(c.run_dir)):
        if not name.endswith(".toml"):
            continue
        text = open(os.path.join(c.run_dir, name)).read()
        text = text.replace(c.run_dir, "<run_dir>")
        text = re.sub(rf"127\.0\.0\.1:{mport}\b", "<mgmtd>", text)
        out[name] = text.replace(f"{pkg}.", "<pkg>.")
    return out


def test_dev_cluster_configs_equal(clusters):
    ref = _normalized_tomls(clusters["ref"], "t3fs")
    port = _normalized_tomls(clusters["port"], "t3fs_torch")
    assert sorted(ref) == ["meta.toml", "mgmtd.toml", "storage1.toml",
                           "storage2.toml"]
    assert port == ref
    assert 'checksum_backend = "cpu"' in port["storage1.toml"]
    assert "wal:<run_dir>/meta-kv?sync=os" in port["meta.toml"]


def test_two_phase_config_fetch(clusters):
    """Config templates stored in mgmtd are served to booting nodes: the
    port's ApplicationBase against the port's mgmtd and the reference's."""
    from t3fs_torch.app.base import ApplicationBase
    from t3fs_torch.app.storage_main import StorageMainConfig
    from t3fs_torch.mgmtd.service import SetConfigTemplateReq
    from t3fs_torch.utils.config import to_toml

    async def body(c, data_dir):
        cli = PortClient()
        try:
            template = StorageMainConfig(engine_backend="python",
                                         data_dir=data_dir)
            await cli.call(c.mgmtd_address, "Mgmtd.set_config_template",
                           SetConfigTemplateReq(
                               "storage", to_toml(template.to_dict())))
        finally:
            await cli.close()
        app = ApplicationBase("storage", StorageMainConfig)
        # boot() is the binary's synchronous entry: a thread of its own,
        # so its asyncio.run does not nest in this loop
        return await asyncio.to_thread(
            app.boot, ["--fetch-config-from", c.mgmtd_address,
                       "--set", "node_id=7"])

    for pkg in ("port", "ref"):
        cfg = _run(body(clusters[pkg], f"/from-{pkg}-template"))
        assert cfg.engine_backend == "python"             # template
        assert cfg.data_dir == f"/from-{pkg}-template"    # template
        assert cfg.node_id == 7                           # local override
        assert cfg.service.checksum_backend == "cuda"     # port default


def test_storage_process_without_gpu_fails_at_startup(clusters):
    """A storage process asked for the CUDA backend where torch sees no
    GPU dies at startup, and DevCluster raises with its log tail: no
    fallback to the host CRC."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the CUDA backend starts")
    c = clusters["port"]

    async def body():
        c.admin = PortClient()
        c.checksum_backend = "cuda"
        try:
            c.start_storage_node(9)
            with pytest.raises(RuntimeError, match="storage9 died at startup"
                               ) as err:
                await c._wait_port("storage9")
            return str(err.value)
        finally:
            c.checksum_backend = "cpu"
            await c.admin.close()
            c.procs.pop("storage9", None)

    msg = _run(body())
    assert "torch.cuda.is_available() is false" in msg
    toml = open(os.path.join(c.run_dir, "storage9.toml")).read()
    assert 'checksum_backend = "cuda"' in toml


def test_dev_cluster_refuses_kv_shards(tmp_path):
    """More shards than KeyPrefix split points: the reference's
    ValueError, raised before any process is spawned."""
    from t3fs_torch.kv.prefixes import KeyPrefix

    c = port_dc.DevCluster(str(tmp_path), kv_shards=len(KeyPrefix) + 1,
                           checksum_backend="cpu")
    with pytest.raises(ValueError, match="KeyPrefix split points"):
        asyncio.run(c.start())
    assert c.procs == {}


def test_meta_over_sharded_kv_multiprocess(tmp_path):
    """meta_main over TWO standalone kv_main shard processes (a shards:
    spec split at the KeyPrefix boundaries), driven through MetaClient
    over real sockets: mkdirs, create, stat, rename and readdir are
    cross-process cross-shard 2PC, and both kv_main processes hold rows."""
    from t3fs_torch.kv.service import KvRangeReq

    c = port_dc.DevCluster(str(tmp_path / "run"), num_storage=1, replicas=1,
                           num_chains=1, durable=True, kv_shards=2,
                           chunk_size=CHUNK,
                           heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S,
                           checksum_backend="cpu")

    async def body():
        try:
            await asyncio.wait_for(c.start(), START_TIMEOUT_S)
            assert len(c.kv_addresses) == 2
            toml = open(os.path.join(c.run_dir, "meta.toml")).read()
            assert 'kv = "shards:' in toml
            mc = port_mc.MetaClient([c.meta_address])
            try:
                await mc.mkdirs("/shard/deep", recursive=True)
                inode, sess = await mc.create("/shard/deep/f",
                                              chunk_size=CHUNK)
                await mc.close(inode.inode_id, sess, length=0)
                got = await mc.stat("/shard/deep/f")
                assert got.inode_id == inode.inode_id
                await mc.rename("/shard/deep/f", "/shard/g")
                names = [e.name for e in await mc.readdir("/shard")]
                assert sorted(names) == ["deep", "g"]
            finally:
                await mc.close_conn()
            counts = []
            for addr in c.kv_addresses:
                rsp, _ = await c.admin.call(addr, "Kv.read_range", KvRangeReq(
                    begin=b"", end=b"\xff" * 17))
                counts.append(len(rsp.keys))
            assert all(n > 0 for n in counts), counts
        finally:
            await c.stop()

    _run(body())


def test_storage_main_counters_line(tmp_path):
    from t3fs_torch.app.storage_main import CODEC_LOG_TAG, read_codec_counters

    log = tmp_path / "storage1.log"
    log.write_text(
        f"2026 I [storage] t3fs_torch.app: {CODEC_LOG_TAG} "
        '{"node_id": 1, "batches": 1}\n'
        "noise\n"
        f"2026 I [storage] t3fs_torch.app: {CODEC_LOG_TAG} "
        '{"node_id": 1, "batches": 5, "batched_items": 9}\n')
    assert read_codec_counters(str(log)) == {
        "node_id": 1, "batches": 5, "batched_items": 9}


def test_kv_main_recovery_line(tmp_path):
    from t3fs_torch.app.kv_main import RECOVER_LOG_TAG, read_recovered

    log = tmp_path / "kv2.log"
    log.write_text(
        f"2026 I [kv] t3fs_torch.app: {RECOVER_LOG_TAG} "
        '{"recovered": 0, "resolved": 0}\n'
        "noise\n"
        f"2026 I [kv] t3fs_torch.app: {RECOVER_LOG_TAG} "
        '{"recovered": 2, "resolved": 2}\n')
    assert read_recovered(str(log)) == [{"recovered": 0, "resolved": 0},
                                        {"recovered": 2, "resolved": 2}]


# -------------------------------------------------------------- placement

def _routing(types, pairs):
    r = types.RoutingInfo()
    for cid, nodes in pairs:
        r.chains[cid] = types.ChainInfo(cid, 1, [
            types.ChainTargetInfo(cid * 100 + i, n,
                                  types.PublicTargetState.SERVING)
            for i, n in enumerate(nodes)])
    return r


@pytest.mark.parametrize("nodes,chains,replicas", [(5, 10, 1), (6, 12, 3),
                                                   (9, 24, 3), (4, 6, 2)])
def test_placement_matches_reference(nodes, chains, replicas):
    for seed in (0, 3):
        ref = ref_pl.build_chain_table(nodes, chains, replicas, seed=seed)
        port = port_pl.build_chain_table(nodes, chains, replicas, seed=seed)
        assert port == ref
        assert port_pl.pair_counts(port, nodes) == \
            ref_pl.pair_counts(ref, nodes)
        assert port_pl.recovery_imbalance(port, nodes) == \
            ref_pl.recovery_imbalance(ref, nodes)
        for f in range(1, nodes + 1):
            assert port_pl.recovery_load(port, nodes, f) == \
                ref_pl.recovery_load(ref, nodes, f)
    pairs = list(enumerate(ref, start=1))
    rr, pr = _routing(ref_types, pairs), _routing(port_types, pairs)
    for failed in ({1}, {2, 3}, set()):
        assert port_pl.chain_recovery_weights(pr, failed) == \
            ref_pl.chain_recovery_weights(rr, failed)
    for k, m in ((4, 2), (8, 2), (3, 1)):
        try:
            want = ref_pl.select_ec_chains(rr, k, m)
        except ValueError:
            with pytest.raises(ValueError):
                port_pl.select_ec_chains(pr, k, m)
            continue
        assert port_pl.select_ec_chains(pr, k, m) == want
        assert port_pl.validate_ec_chains(pr, want, m)
    assert [port_pl.target_id(n, c) for n in (1, 7) for c in (0, 3)] == \
        [ref_pl.target_id(n, c) for n in (1, 7) for c in (0, 3)]
