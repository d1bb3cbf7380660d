"""End-to-end elastic recovery on the port's LocalCluster (mgmtd, heartbeats,
chain reshape, CRAQ resync): twins of tests/test_recovery.py at the
reference's knobs, parametrised as the reference's are, on the host
checksum backend; one seeded failure-and-resync scenario through both
packages' LocalClusters that must end with the same bytes, ChunkMeta and
chain; and a `cuda`-marked flap and resync on the card.

Reference analogs: tests/storage/service/TestStorageServiceFailStop.cc,
tests/storage/sync/TestSyncStartAndDone.cc / TestSyncForward.cc.
"""

import asyncio

import numpy as np
import pytest
import torch

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.mgmtd.types import PublicTargetState
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusCode


async def wait_for(predicate, timeout=10.0, interval=0.05, desc="condition"):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        if predicate():
            return
        await asyncio.sleep(interval)
    raise AssertionError(f"timeout waiting for {desc}")


# write-pipeline matrix for the tests that push data through the chain:
# streamed runs with a small threshold so these modest payloads fragment
PIPELINE_MODES = [("off", None), ("overlap", None), ("streamed", 2048)]
PIPELINE_IDS = [m for m, _ in PIPELINE_MODES]


@pytest.mark.parametrize("write_pipeline,stream_threshold", PIPELINE_MODES,
                         ids=PIPELINE_IDS)
def test_cluster_write_read(write_pipeline, stream_threshold):
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, checksum_backend="cpu",
                               write_pipeline=write_pipeline,
                               stream_threshold=stream_threshold)
        await cluster.start()
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data = b"mgmtd-backed" * 500
            results = await cluster.sc.write_file_range(lay, 1, 0, data)
            assert all(r.status.code == int(StatusCode.OK) for r in results)
            got, _ = await cluster.sc.read_file_range(lay, 1, 0, len(data))
            assert got == data
        finally:
            await cluster.stop()
    asyncio.run(body())


@pytest.mark.parametrize("write_pipeline,stream_threshold", PIPELINE_MODES,
                         ids=PIPELINE_IDS)
def test_failstop_reshape_write_rejoin_resync(write_pipeline,
                                              stream_threshold):
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, checksum_backend="cpu",
                               heartbeat_timeout_s=0.6,
                               write_pipeline=write_pipeline,
                               stream_threshold=stream_threshold)
        await cluster.start()
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data1 = b"before-failure" * 300
            await cluster.sc.write_file_range(lay, 1, 0, data1)

            # fail-stop the middle chain member (node 2 / target 201)
            victim_target = cluster.target_id(2, 0)
            await cluster.kill_storage_node(2)

            # mgmtd detects silence and reshapes: victim moves to tail OFFLINE
            await wait_for(
                lambda: cluster.chain().chain_ver >= 2 and
                all(t.target_id != victim_target
                    for t in cluster.chain().serving()),
                desc="chain reshape after fail-stop")
            assert len(cluster.chain().serving()) == 2

            # writes continue on the shortened chain
            data2 = b"during-failure" * 300
            results = await cluster.sc.write_file_range(lay, 2, 0, data2)
            assert all(r.status.code == int(StatusCode.OK) for r in results), \
                [r.status for r in results]

            # node 2 returns with its old (stale) disk
            await cluster.start_storage_node(2)
            # mgmtd: OFFLINE+alive -> SYNCING; resync runs; -> SERVING
            await wait_for(
                lambda: any(t.target_id == victim_target
                            for t in cluster.chain().serving()),
                timeout=15.0, desc="victim promoted back to serving")
            assert len(cluster.chain().serving()) == 3

            # the rejoined replica must hold BOTH files' data, byte-exact
            returned = cluster.storage[2].node.targets[victim_target]
            from t3fs_torch.storage.types import ChunkId
            for inode, data in ((1, data1), (2, data2)):
                got = b""
                for idx in range((len(data) + 4095) // 4096):
                    got += returned.engine.read(ChunkId(inode, idx))
                assert got == data, f"inode {inode} diverged on rejoined node"

            # and reads served by the whole cluster still match
            got, _ = await cluster.sc.read_file_range(lay, 2, 0, len(data2))
            assert got == data2
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_rejoining_node_drops_extra_chunks():
    """Chunks deleted while a node was down are removed during resync."""
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, checksum_backend="cpu",
                               heartbeat_timeout_s=0.6)
        await cluster.start()
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data = b"doomed" * 100
            await cluster.sc.write_file_range(lay, 5, 0, data)

            victim_target = cluster.target_id(2, 0)
            await cluster.kill_storage_node(2)
            await wait_for(lambda: len(cluster.chain().serving()) == 2,
                           desc="reshape")
            # remove the file while node 2 is down
            await cluster.sc.remove_file_chunks(lay, 5)

            await cluster.start_storage_node(2)
            await wait_for(
                lambda: any(t.target_id == victim_target
                            for t in cluster.chain().serving()),
                timeout=15.0, desc="rejoin")
            returned = cluster.storage[2].node.targets[victim_target]
            assert returned.engine.query_range(5) == [], \
                "stale chunks must be dropped by resync"
        finally:
            await cluster.stop()
    asyncio.run(body())


@pytest.mark.parametrize("write_pipeline,stream_threshold", PIPELINE_MODES,
                         ids=PIPELINE_IDS)
def test_disk_failure_offline_replace_resync(write_pipeline,
                                             stream_threshold):
    """Disk dies under a LIVE node mid-writes: write error marks the target
    OFFLINE, heartbeats propagate, mgmtd pulls it from the chain with no
    acked-write loss; operator 'replaces the disk' and the target resyncs
    back to serving (StorageOperator.cc:604-606 + worker/CheckWorker
    analogs)."""
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, checksum_backend="cpu",
                               heartbeat_timeout_s=0.6,
                               write_pipeline=write_pipeline,
                               stream_threshold=stream_threshold)
        await cluster.start()
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data1 = b"pre-disk-failure" * 300
            await cluster.sc.write_file_range(lay, 1, 0, data1)

            # node 2's disk dies: engine.put starts raising EIO
            victim_target = cluster.target_id(2, 0)
            node2 = cluster.storage[2].node
            target = node2.targets[victim_target]
            real_put = target.engine.put

            def broken_put(*a, **kw):
                raise OSError(5, "Input/output error")
            target.engine.put = broken_put

            # writes keep succeeding (chain retries through the reshape)
            data2 = b"during-disk-failure" * 300
            results = await cluster.sc.write_file_range(lay, 2, 0, data2)
            assert all(r.status.code == int(StatusCode.OK) for r in results), \
                [str(r.status) for r in results]

            # mgmtd pulled the disk-failed target out of the serving set
            await wait_for(
                lambda: all(t.target_id != victim_target
                            for t in cluster.chain().serving()),
                desc="disk-failed target leaves the serving set")

            # operator replaces the disk: engine works again, target ONLINE
            from t3fs_torch.mgmtd.types import LocalTargetState
            target.engine.put = real_put
            node2.local_states[victim_target] = LocalTargetState.ONLINE

            await wait_for(
                lambda: any(t.target_id == victim_target
                            for t in cluster.chain().serving()),
                timeout=15.0, desc="replaced target promoted to serving")

            # the rejoined replica holds both files byte-exact
            from t3fs_torch.storage.types import ChunkId
            for inode, data in ((1, data1), (2, data2)):
                got = b""
                for idx in range((len(data) + 4095) // 4096):
                    got += target.engine.read(ChunkId(inode, idx))
                assert got == data, f"inode {inode} diverged after disk swap"
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_partitioned_head_self_fences():
    """Reference suicide.cc at lease/2: a storage
    node partitioned from mgmtd stops acking writes BEFORE mgmtd's
    heartbeat timeout can promote a successor — a stale head can never
    keep acknowledging data the reshaped chain won't have."""
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, checksum_backend="cpu",
                               heartbeat_timeout_s=1.2)
        await cluster.start()
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data = b"pre-partition" * 300
            results = await cluster.sc.write_file_range(lay, 1, 0, data)
            assert all(r.status.code == int(StatusCode.OK) for r in results)

            # the head of chain 1 is node 1; partition it from mgmtd by
            # killing its heartbeat loop (the node itself stays up and
            # reachable by clients — the dangerous half-partition)
            head = cluster.storage[1]
            assert head.mgmtd.lease_s > 0          # lease learned via hb
            import time as _t
            t_cut = _t.monotonic()
            head.mgmtd._hb_task.cancel()

            # the node must fence itself BEFORE the failure-detection
            # window (1.2s) elapses — i.e. before mgmtd could possibly
            # have promoted a successor.  Measuring wall time (not just
            # "eventually fenced") is what actually pins the lease/2
            # property: a regression to lease*2 would fence too late and
            # fail here.
            await wait_for(lambda: head.node.fenced(), timeout=5.0,
                           desc="head self-fence")
            fenced_after = _t.monotonic() - t_cut
            assert fenced_after < cluster.mgmtd_cfg.heartbeat_timeout_s, \
                f"fenced after {fenced_after:.2f}s — later than the " \
                f"{cluster.mgmtd_cfg.heartbeat_timeout_s}s promotion window"

            # a write sent straight at the stale head is refused
            from t3fs_torch.storage.types import ChunkId, UpdateIO, UpdateType
            from t3fs_torch.net.client import Client
            probe = Client()
            try:
                from t3fs_torch.storage.service import WriteReq
                io = UpdateIO(chunk_id=ChunkId(9, 0), chain_id=1,
                              chain_ver=1, update_ver=1, offset=0,
                              length=4, chunk_size=4096,
                              update_type=UpdateType.WRITE)
                rsp, _ = await probe.call(head.server.address,
                                          "Storage.write",
                                          WriteReq(io=io), payload=b"dead")
                assert rsp.result.status.code == int(
                    StatusCode.TARGET_OFFLINE), rsp.result.status
                assert "self-fenced" in rsp.result.status.message
            finally:
                await probe.close()

            # the CLUSTER keeps accepting writes: mgmtd times the head
            # out, reshapes chain 1, and the client lands on the new head
            data2 = b"post-partition" * 300
            results2 = await cluster.sc.write_file_range(lay, 2, 0, data2)
            assert all(r.status.code == int(StatusCode.OK)
                       for r in results2)
            got, _ = await cluster.sc.read_file_range(lay, 2, 0, len(data2))
            assert got == data2
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_fresh_flag_survives_lastsrv_routing_view():
    """A wiped target's LASTSRV seat in the routing view always
    predates the wipe (mgmtd never seats a known-fresh target as LASTSRV),
    so the heartbeat provider must keep reporting fresh while the view
    shows LASTSRV — clearing there raced mgmtd's fresh-LASTSRV demotion
    tick and reopened the seed-2802880 acked-write loss.  Only a SERVING
    seat (or sync_done) ends freshness, matching craq_sim's disk_fresh."""
    from t3fs_torch.mgmtd.types import ChainInfo, ChainTargetInfo, RoutingInfo
    from t3fs_torch.storage.server import StorageServer

    class _T:
        def __init__(self):
            self.booted_fresh = True

    class _Node:
        def __init__(self, routing):
            self._r = routing
            self.targets = {101: _T()}

        def routing(self):
            return self._r

    def view(state):
        return RoutingInfo(chains={1: ChainInfo(chain_id=1, targets=[
            ChainTargetInfo(target_id=101, node_id=1, public_state=state)])})

    srv = StorageServer.__new__(StorageServer)   # unit: bypass full init

    # stale LASTSRV view: still fresh, still reported
    srv.node = _Node(view(PublicTargetState.LASTSRV))
    assert srv._fresh_targets() == [101]
    assert srv.node.targets[101].booted_fresh

    # OFFLINE / SYNCING views: same
    for st in (PublicTargetState.OFFLINE, PublicTargetState.SYNCING):
        srv.node = _Node(view(st))
        srv.node.targets[101].booted_fresh = True
        assert srv._fresh_targets() == [101], st

    # a SERVING seat is the lineage — freshness ends, flag clears
    srv.node = _Node(view(PublicTargetState.SERVING))
    assert srv._fresh_targets() == []
    assert not srv.node.targets[101].booted_fresh


# ------------------------------------------- one scenario, both packages

SCENARIO_CHUNK = 128 << 10     # above the batching seam's 64 KiB device cutoff


async def run_scenario(pkg: str, seed: int = 2026) -> dict:
    """Write, kill, write, flap, empty restart on a 3-node LocalCluster with
    one chain of 3; returns each replica's chunks (ChunkMeta fields and
    bytes) and the chain.  The port runs a CudaChecksumBackend on the CPU,
    so every payload of the successors goes through the batching seam."""
    if pkg == "ref":
        from t3fs.client.layout import FileLayout
        from t3fs.testing.cluster import LocalCluster as Cluster
        kw = {}
    else:
        from t3fs_torch.client.layout import FileLayout
        from t3fs_torch.storage.codec_backend import CudaChecksumBackend
        from t3fs_torch.testing.cluster import LocalCluster as Cluster
        kw = {"checksum_backend": lambda: CudaChecksumBackend(device="cpu")}
    rng = np.random.default_rng(seed)

    def blob(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    cluster = Cluster(num_nodes=3, replicas=3, heartbeat_timeout_s=0.6, **kw)
    await cluster.start()
    lay = FileLayout(chunk_size=SCENARIO_CHUNK, chains=[1])
    try:
        async def settle():
            # the client and every node on mgmtd's routing: a write sent on
            # an older view stamps an older chain_ver into its ChunkMeta
            want = cluster.mgmtd.state.routing().version
            await cluster.mgmtd_client.refresh()
            await wait_for(lambda: cluster.mgmtd_client.routing().version == want
                           and all(ss.mgmtd.routing().version == want
                                   for ss in cluster.storage.values()),
                           desc="routing settled")

        async def write(inode, off, data):
            await settle()
            res = await cluster.sc.write_file_range(lay, inode, off, data)
            assert all(r.status.code == 0 for r in res), [r.status for r in res]

        await write(1, 0, blob(6 * SCENARIO_CHUNK + 5000))
        await write(3, 0, blob(2 * SCENARIO_CHUNK))
        await cluster.kill_storage_node(2)
        await wait_for(lambda: len(cluster.chain().serving()) == 2, desc="reshape")
        await write(1, SCENARIO_CHUNK + 777, blob(2 * SCENARIO_CHUNK))
        await write(2, 0, blob(3 * SCENARIO_CHUNK - 100))
        await settle()
        await cluster.sc.remove_file_chunks(lay, 3)
        await cluster.restart_storage_node(2)
        await wait_for(lambda: len(cluster.chain().serving()) == 3, timeout=20.0,
                       desc="flap resynced")
        await write(2, 2 * SCENARIO_CHUNK, blob(SCENARIO_CHUNK))
        await cluster.restart_storage_node_empty(3)
        await wait_for(lambda: len(cluster.chain().serving()) == 3, timeout=20.0,
                       desc="empty disk resynced")
        chain = cluster.chain()
        replicas = {}
        for t in chain.targets:
            engine = cluster.storage[t.node_id].node.targets[t.target_id].engine
            replicas[t.target_id] = {
                (m.chunk_id.inode, m.chunk_id.index): (
                    m.length, m.update_ver, m.commit_ver, m.chain_ver,
                    m.checksum, int(m.state), engine.read(m.chunk_id))
                for m in engine.all_metas()}
        batched = {nid: getattr(ss.node.codec, "batched_items", None)
                   for nid, ss in cluster.storage.items()}
        return {"chain": (chain.chain_ver, [(t.target_id, t.node_id,
                                             int(t.public_state))
                                            for t in chain.targets]),
                "replicas": replicas, "batched": batched}
    finally:
        await cluster.stop()


def test_failure_and_resync_scenario_matches_reference():
    ref = asyncio.run(run_scenario("ref"))
    port = asyncio.run(run_scenario("port"))
    assert port["chain"] == ref["chain"]
    assert sorted(port["replicas"]) == sorted(ref["replicas"])
    for tid, chunks in ref["replicas"].items():
        assert port["replicas"][tid] == chunks, tid
    # every replica holds the same chunks, no removed file is left behind
    sets = [sorted(c) for c in ref["replicas"].values()]
    assert all(s == sets[0] for s in sets) and all(k[0] != 3 for k in sets[0])
    # the resynced successors took the seam's device-size route
    assert port["batched"][2] > 0 and port["batched"][3] > 0, port["batched"]


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA checksum backend)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_flap_and_resync_on_card(cuda_device):
    """A small port LocalCluster on its default CUDA checksum backend: one
    flap (a node killed and restarted on its old disk while writes land)
    and its resync; every replica's stored checksum equals plain B1 of the
    chunk's bytes and the host CRC, and the resync launched B1."""
    from t3fs_torch.ops import cuda_codec
    from t3fs_torch.ops.codec import crc32c
    from t3fs_torch.ops.tables import codec_tables
    from t3fs_torch.ops.torch_codec import i32
    from t3fs_torch.storage.types import ChunkId

    def plain_b1(chunk: bytes) -> int:
        tables = codec_tables(len(chunk) // 512, device=cuda_device)
        words = torch.frombuffer(bytearray(chunk), dtype=torch.int32)
        raw = cuda_codec.crc_words_raw_plain(words.view(1, -1).to(cuda_device),
                                             tables)
        return int((raw ^ i32(tables.chunk_affine)).item()) & 0xFFFFFFFF

    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3)
        await cluster.start()
        lay = FileLayout(chunk_size=SCENARIO_CHUNK, chains=[1])
        rng = np.random.default_rng(5)
        try:
            first = rng.integers(0, 256, 4 * SCENARIO_CHUNK, dtype=np.uint8).tobytes()
            await cluster.sc.write_file_range(lay, 1, 0, first)
            await cluster.kill_storage_node(3)
            await wait_for(lambda: len(cluster.chain().serving()) == 2,
                           desc="reshape")
            later = rng.integers(0, 256, 2 * SCENARIO_CHUNK, dtype=np.uint8).tobytes()
            res = await cluster.sc.write_file_range(lay, 1, SCENARIO_CHUNK, later)
            assert all(r.status.code == 0 for r in res)
            before = cuda_codec.launches["crc_words"]
            await cluster.restart_storage_node(3)
            await wait_for(lambda: len(cluster.chain().serving()) == 3,
                           timeout=20.0, desc="resync back to serving")
            assert cuda_codec.launches["crc_words"] > before
            assert cluster.storage[3].node.codec.batched_items >= 2
            want = first[:SCENARIO_CHUNK] + later + first[3 * SCENARIO_CHUNK:]
            for t in cluster.chain().targets:
                engine = cluster.storage[t.node_id].node.targets[t.target_id].engine
                for idx in range(4):
                    chunk = want[idx * SCENARIO_CHUNK:(idx + 1) * SCENARIO_CHUNK]
                    meta = engine.get_meta(ChunkId(1, idx))
                    assert engine.read(ChunkId(1, idx)) == chunk
                    assert meta.checksum == crc32c(chunk) == plain_b1(chunk)
                    assert meta.update_ver == meta.commit_ver
        finally:
            await cluster.stop()
    asyncio.run(body())
