"""The CRAQ storage service of the port (t3fs_torch.storage.service) over
the port's in-process fabric: the reference's tests/test_storage_service.py
cases whose subject is ported, under the port's two checksum backends on the
CPU (the host CRC, and the CUDA backend's batching path on its plain
version) and the three write pipelines; then a differential run of one
seeded update sequence through the reference fabric and the port's, which
must agree bit for bit; and `cuda`-marked twins on the card.

The fabric's defaults are the reference's: the native chunk engine and
io_uring reads (their own cases are in tests/test_torch_native_engine.py).
Not here: the check worker, whose module is not ported yet.
"""

import asyncio

import numpy as np
import pytest
import torch

from t3fs_torch.mgmtd.types import ChainTargetInfo, PublicTargetState
from t3fs_torch.ops.crc32c import crc32c_ref
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.storage.types import (
    BatchReadReq, ChunkId, ChunkState, QueryLastChunkReq, ReadIO,
    RemoveChunksReq, UpdateIO, UpdateType, WriteReq,
)
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.utils.status import StatusCode

import torch_storage_diff as diff


def run(coro):
    return asyncio.run(coro)


def _device_backend():
    return CudaChecksumBackend(device="cpu", min_device_bytes=0, max_wait_us=200)


# (checksum backend, write pipeline): the pipelined modes run on the
# canonical backend only, as in the reference suite -- the pipeline
# restructures _locked_update's dataflow, orthogonal to the backend
SETUPS = {"cpu-off": ("cpu", "off"), "device-off": ("device", "off"),
          "cpu-overlap": ("cpu", "overlap"), "cpu-streamed": ("cpu", "streamed")}


@pytest.fixture(params=list(SETUPS))
def fabric_setup(request, monkeypatch):
    backend, mode = SETUPS[request.param]
    monkeypatch.setattr(
        StorageFabric, "default_checksum_backend",
        "cpu" if backend == "cpu" else staticmethod(_device_backend))
    monkeypatch.setattr(StorageFabric, "default_write_pipeline", mode)
    if mode == "streamed":
        # small threshold so ordinary test payloads exercise fragmentation
        monkeypatch.setattr(StorageFabric, "default_stream_threshold", 512)


def make_write(fabric, cid, data, *, offset=0, seq=1, channel=7,
               update_ver=0, chunk_size=4096):
    return WriteReq(io=UpdateIO(
        chunk_id=cid, chain_id=fabric.chain_id,
        chain_ver=fabric.chain().chain_ver,
        update_type=UpdateType.WRITE, offset=offset, length=len(data),
        chunk_size=chunk_size, update_ver=update_ver,
        checksum=crc32c_ref(data), channel=channel, channel_seq=seq,
        client_id="test-client", inline=True))


async def write(fabric, cid, data, **kw):
    rsp, _ = await fabric.client.call(
        fabric.head_address(), "Storage.write",
        make_write(fabric, cid, data, **kw), payload=data)
    return rsp.result


async def read(fabric, cid, address=None, offset=0, length=0):
    req = BatchReadReq(ios=[ReadIO(chunk_id=cid, chain_id=fabric.chain_id,
                                   offset=offset, length=length)])
    rsp, payload = await fabric.client.call(
        address or fabric.head_address(), "Storage.batch_read", req)
    return rsp.results[0], payload


@pytest.mark.usefixtures("fabric_setup")
def test_single_replica_write_read():
    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        try:
            cid = ChunkId(10, 0)
            data = b"hello chunk" * 30
            result = await write(fabric, cid, data)
            assert result.status.code == int(StatusCode.OK), result.status
            assert result.update_ver == 1 and result.commit_ver == 1
            assert result.checksum == crc32c_ref(data)
            r, payload = await read(fabric, cid)
            assert payload == data and r.commit_ver == 1
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_three_replica_chain_propagation():
    async def body():
        fabric = StorageFabric(num_nodes=3, replicas=3)
        await fabric.start()
        try:
            cid = ChunkId(11, 0)
            data = b"x" * 1000
            result = await write(fabric, cid, data)
            assert result.status.code == int(StatusCode.OK), result.status
            # every replica holds committed identical content
            for i in range(3):
                target = fabric.nodes[i].targets[fabric.target_id(i)]
                meta = target.engine.get_meta(cid)
                assert meta is not None, f"replica {i} missing chunk"
                assert meta.commit_ver == 1 and meta.checksum == crc32c_ref(data)
                assert target.engine.read(cid) == data
            # CRAQ read-any: read from the tail node's address
            tail = fabric.chain().tail()
            r, payload = await read(fabric, cid,
                                    fabric.address_of_target(tail.target_id))
            assert payload == data
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_appends_and_partial_overwrite():
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            cid = ChunkId(12, 0)
            a = b"A" * 100
            b = b"B" * 50
            r1 = await write(fabric, cid, a, seq=1)
            r2 = await write(fabric, cid, b, offset=100, seq=2)  # append
            assert r2.status.code == int(StatusCode.OK)
            assert r2.length == 150
            assert r2.checksum == crc32c_ref(a + b)   # combine path
            r3 = await write(fabric, cid, b"C" * 10, offset=50, seq=3)  # overwrite
            _, payload = await read(fabric, cid)
            assert payload == a[:50] + b"C" * 10 + a[60:] + b
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_channel_dedupe_exactly_once():
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            cid = ChunkId(13, 0)
            data = b"dedupe me"
            r1 = await write(fabric, cid, data, seq=5)
            # identical retry returns the cached result, does NOT re-apply
            r2 = await write(fabric, cid, data, seq=5)
            assert (r2.update_ver, r2.commit_ver) == (r1.update_ver, r1.commit_ver)
            meta = fabric.nodes[0].targets[fabric.target_id(0)].engine.get_meta(cid)
            assert meta.update_ver == 1
            # older seq rejected
            r3 = await write(fabric, cid, data, seq=4)
            assert r3.status.code == int(StatusCode.CHUNK_STALE_UPDATE)
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_chain_version_mismatch_rejected():
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            cid = ChunkId(14, 0)
            req = make_write(fabric, cid, b"zz")
            req.io.chain_ver = 99
            rsp, _ = await fabric.client.call(fabric.head_address(),
                                              "Storage.write", req, payload=b"zz")
            assert rsp.result.status.code == int(StatusCode.CHAIN_VERSION_MISMATCH)
        finally:
            await fabric.stop()
    run(body())

    # note: non-head write rejection is covered in test_write_to_non_head


@pytest.mark.usefixtures("fabric_setup")
def test_write_to_non_head():
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            cid = ChunkId(15, 0)
            req = make_write(fabric, cid, b"data")
            tail = fabric.chain().tail()
            rsp, _ = await fabric.client.call(
                fabric.address_of_target(tail.target_id),
                "Storage.write", req, payload=b"data")
            assert rsp.result.status.code == int(StatusCode.NOT_HEAD)
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_query_last_chunk_and_remove():
    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        try:
            for idx in range(3):
                await write(fabric, ChunkId(16, idx), bytes([idx]) * (idx + 1),
                            seq=idx + 1)
            rsp, _ = await fabric.client.call(
                fabric.head_address(), "Storage.query_last_chunk",
                QueryLastChunkReq(chain_id=fabric.chain_id, inode=16))
            assert rsp.last_index == 2 and rsp.last_length == 3
            assert rsp.total_chunks == 3 and rsp.total_length == 6
            rsp, _ = await fabric.client.call(
                fabric.head_address(), "Storage.remove_chunks",
                RemoveChunksReq(chain_id=fabric.chain_id, inode=16,
                                begin_index=1))
            assert rsp.result.length == 2  # removed two chunks
            rsp, _ = await fabric.client.call(
                fabric.head_address(), "Storage.query_last_chunk",
                QueryLastChunkReq(chain_id=fabric.chain_id, inode=16))
            assert rsp.last_index == 0 and rsp.total_chunks == 1
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_query_last_chunk_retries_through_stale_head():
    """query_last_chunk must refresh routing and retry when the cached
    head is unreachable — meta's close path calls it moments after a
    failover, when its routing cache can still name the dead node (the
    r5 test_app_cluster regression once the test's waits went
    event-driven)."""
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.mgmtd.types import NodeInfo

    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        try:
            await write(fabric, ChunkId(44, 0), b"x" * 100, seq=1)

            # stale view: head's node address points at a dead port
            import copy
            stale = copy.deepcopy(fabric.routing)
            live_node = fabric.routing.nodes[1]
            stale.nodes[1] = NodeInfo(1, "127.0.0.1:1")
            view = {"r": stale}

            async def refresh():
                view["r"] = fabric.routing   # mgmtd heals the view

            sc = StorageClient(
                lambda: view["r"],
                config=StorageClientConfig(retry_backoff_s=0.005),
                client=fabric.client, refresh_routing=refresh)
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            assert await sc.query_last_chunk(lay, 44) == 100
            assert view["r"] is fabric.routing  # retried via the refresh
            assert live_node is fabric.routing.nodes[1]
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_uncommitted_not_served_and_concurrent_chunks():
    async def body():
        fabric = StorageFabric(num_nodes=3, replicas=3)
        await fabric.start()
        try:
            # concurrent writes to distinct chunks all succeed
            datas = {i: bytes([i]) * 200 for i in range(8)}
            results = await asyncio.gather(*[
                write(fabric, ChunkId(17, i), datas[i], channel=i + 1, seq=1)
                for i in range(8)])
            assert all(r.status.code == int(StatusCode.OK) for r in results)
            for i in range(8):
                _, payload = await read(fabric, ChunkId(17, i))
                assert payload == datas[i]
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_admin_target_rpcs():
    """createTarget/offlineTarget/removeTarget/queryChunk/getAllChunkMetadata
    (fbs/storage/Service.h:8-24)."""
    from t3fs_torch.storage.types import QueryChunkReq, TargetOpReq

    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        try:
            addr = fabric.head_address()
            cid = ChunkId(5, 0)
            data = b"q" * 500
            await write(fabric, cid, data)

            rsp, _ = await fabric.client.call(
                addr, "Storage.query_chunk",
                QueryChunkReq(chain_id=fabric.chain_id, chunk_id=cid))
            assert rsp.found and rsp.meta.length == 500
            rsp, _ = await fabric.client.call(
                addr, "Storage.query_chunk",
                QueryChunkReq(chain_id=fabric.chain_id,
                              chunk_id=ChunkId(5, 99)))
            assert not rsp.found

            tid = fabric.target_id(0)
            rsp, _ = await fabric.client.call(
                addr, "Storage.get_all_chunk_metadata",
                TargetOpReq(target_id=tid))
            assert [str(m.chunk_id) for m in rsp.metas] == ["5.0"]

            # create a second target, offline it, remove it
            import tempfile
            with tempfile.TemporaryDirectory() as d:
                rsp, _ = await fabric.client.call(
                    addr, "Storage.create_target",
                    TargetOpReq(target_id=999, root=d))
                assert rsp.target_id == 999
                node = fabric.nodes[0]
                assert 999 in node.targets
                # remove refuses while not OFFLINE
                from t3fs_torch.utils.status import StatusError
                with pytest.raises(StatusError):
                    await fabric.client.call(addr, "Storage.remove_target",
                                             TargetOpReq(target_id=999))
                await fabric.client.call(addr, "Storage.offline_target",
                                         TargetOpReq(target_id=999))
                await fabric.client.call(addr, "Storage.remove_target",
                                         TargetOpReq(target_id=999))
                assert 999 not in node.targets
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_write_error_offlines_target():
    """Engine I/O failure on a write marks the target locally OFFLINE
    (StorageOperator.cc:604-606 offlineTargets analog)."""
    from t3fs_torch.mgmtd.types import LocalTargetState

    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        try:
            node = fabric.nodes[0]
            tid = fabric.target_id(0)
            target = node.targets[tid]

            def broken_put(*a, **kw):
                raise OSError(5, "Input/output error")
            target.engine.put = broken_put

            result = await write(fabric, ChunkId(6, 0), b"x" * 100)
            assert result.status.code != int(StatusCode.OK)
            assert node.local_states[tid] == LocalTargetState.OFFLINE
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_reliable_update_record_guards():
    """Session-state guards: seq regressions ignored, cached final results
    never clobbered by later failures, cache-echo BUSY never recorded, and
    pre-assignment failures preserve the remembered version."""
    from t3fs_torch.net.wire import WireStatus
    from t3fs_torch.storage.reliable import ReliableUpdate
    from t3fs_torch.storage.types import IOResult

    ru = ReliableUpdate()

    def io(seq, ver=0):
        return UpdateIO(chunk_id=ChunkId(1, 0), chain_id=1, channel=9,
                        channel_seq=seq, client_id="c", update_ver=ver)

    ok = IOResult(WireStatus())
    retryable = IOResult(WireStatus(int(StatusCode.DISK_ERROR), "disk"))
    stale = IOResult(WireStatus(int(StatusCode.CHUNK_STALE_UPDATE), "old"))
    busy_echo = IOResult(WireStatus(int(StatusCode.BUSY), "in flight"))

    # attempt 1: begin, version assigned, retryable failure
    ru.begin(io(4))
    ru.remember_version(io(4, ver=7))
    ru.record(io(4, ver=7), retryable)
    assert ru.assigned_version(io(4)) == 7
    assert ru.check(io(4)) is None      # retry proceeds

    # a pre-assignment failure (update_ver still 0) keeps the version
    ru.record(io(4, ver=0), retryable)
    assert ru.assigned_version(io(4)) == 7

    # success cached; a later same-seq failure cannot clobber it
    ru.record(io(4, ver=7), ok)
    assert ru.check(io(4)).status.code == int(StatusCode.OK)
    ru.record(io(4, ver=7), retryable)
    assert ru.check(io(4)).status.code == int(StatusCode.OK)

    # late duplicate of an OLDER seq must not roll the session backward
    ru.record(io(3, ver=2), stale)
    assert ru.check(io(4)).status.code == int(StatusCode.OK)

    # the BUSY cache-echo is never recorded (in_flight stays true)
    ru.begin(io(5))
    ru.record(io(5), busy_echo)
    assert ru.check(io(5)).status.code == int(StatusCode.BUSY)


@pytest.mark.usefixtures("fabric_setup")
def test_batch_read_no_payload_verify_only():
    """no_payload reads verify server-side and ship only the status."""
    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        try:
            cid = ChunkId(41, 0)
            data = b"v" * 2048
            await write(fabric, cid, data)
            req = BatchReadReq(ios=[ReadIO(chunk_id=cid,
                                           chain_id=fabric.chain_id,
                                           verify_checksum=True,
                                           no_payload=True)])
            rsp, payload = await fabric.client.call(
                fabric.head_address(), "Storage.batch_read", req)
            assert rsp.results[0].status.code == int(StatusCode.OK)
            assert payload == b""   # nothing shipped
            # corrupt the stored checksum: verify-only read must report it
            t = fabric.nodes[0].targets[fabric.target_id(0)]
            meta = t.engine.get_meta(cid)
            meta.checksum ^= 0xDEAD
            t.engine.set_meta(cid, meta)
            rsp, payload = await fabric.client.call(
                fabric.head_address(), "Storage.batch_read", req)
            assert rsp.results[0].status.code == int(
                StatusCode.CHECKSUM_MISMATCH)
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_stale_head_cannot_single_copy_commit():
    """Acked-write-loss regression: a head whose routing jumps mid-update to
    a chain where its successors were demoted must FAIL the write with
    CHAIN_VERSION_MISMATCH — not adopt the new topology, find no successor,
    declare itself tail, and commit a single-copy write that the LASTSRV
    lineage later erases via resync (the reference pins every step to the
    update's chain version, StorageOperator handleUpdate re-check)."""
    async def body():
        from t3fs_torch.mgmtd.types import ChainInfo, ChainTargetInfo, \
            PublicTargetState, RoutingInfo

        fabric = StorageFabric(num_nodes=3, replicas=3)
        await fabric.start()
        try:
            head_node = fabric.nodes[0]
            v1 = fabric.routing
            # the reshape mgmtd applied while this node's view lagged:
            # successors demoted, tail is the authoritative LASTSRV
            v2 = RoutingInfo(version=2)
            v2.nodes = v1.nodes
            v2.chain_tables = v1.chain_tables
            c1 = v1.chains[fabric.chain_id]
            v2.chains[fabric.chain_id] = ChainInfo(
                c1.chain_id, c1.chain_ver + 1,
                [ChainTargetInfo(c1.targets[2].target_id,
                                 c1.targets[2].node_id,
                                 PublicTargetState.LASTSRV),
                 ChainTargetInfo(c1.targets[0].target_id,
                                 c1.targets[0].node_id,
                                 PublicTargetState.OFFLINE),
                 ChainTargetInfo(c1.targets[1].target_id,
                                 c1.targets[1].node_id,
                                 PublicTargetState.OFFLINE)])
            calls = {"n": 0}

            def flipping_provider():
                # entry validation sees the stale v1; every later call
                # (the forward path) sees the reshaped v2
                calls["n"] += 1
                return v1 if calls["n"] <= 1 else v2

            head_node._routing_provider = flipping_provider

            sc = StorageClient(lambda: v1, client=fabric.client,
                               config=StorageClientConfig(
                                   retry_backoff_s=0.01, max_retries=3))
            cid = ChunkId(77, 0)
            result = await sc.write_chunk(fabric.chain_id, cid, 0,
                                          b"x" * 4096, chunk_size=4096)
            assert result.status.code != int(StatusCode.OK), \
                "stale head acked a single-copy write"
            # nothing may be COMMITTED on the stale head
            eng = head_node.targets[fabric.target_id(0)].engine
            meta = eng.get_meta(cid)
            assert meta is None or int(meta.state) != int(ChunkState.COMMIT)
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.usefixtures("fabric_setup")
def test_large_read_thread_pipeline():
    """>64 KiB reads hop to the read pool when io_uring reads are off; a
    256 KiB write takes the device CRC path."""
    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1, aio_read=False)
        await fabric.start()
        try:
            cid = ChunkId(77, 0)
            data = bytes(range(256)) * 1024            # 256 KiB
            result = await write(fabric, cid, data)
            assert result.status.code == int(StatusCode.OK)
            r, payload = await read(fabric, cid)
            assert payload == data
            r, tailp = await read(fabric, cid, offset=100_000, length=70_000)
            assert tailp == data[100_000:170_000]
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.parametrize("engine", ["py", "native"])
@pytest.mark.parametrize("pipeline", ["off", "overlap", "streamed"])
@pytest.mark.parametrize("backend", ["cpu", "device"])
def test_differential_against_reference(backend, pipeline, engine):
    """One seeded sequence of updates (full, partial, append, truncate,
    remove; lengths around the 64 KiB device cutoff) through the reference
    fabric and the port's, on the SQLite engine with thread reads and on
    the native engine with io_uring reads: every IOResult and every
    replica's bytes and ChunkMeta equal, bit for bit."""
    port_backend = "cpu" if backend == "cpu" else (
        lambda: CudaChecksumBackend(device="cpu", max_wait_us=200))
    ref, port = run(diff.run_both(port_backend, pipeline, seed=1234,
                                  engine=engine))
    assert port == ref
    assert len(port["results"]) == diff.NUM_UPDATES
    assert all(r[0] == int(StatusCode.OK) for r in port["results"])
    # every stored checksum is the CRC of the stored bytes
    assert all(c[-1] for rep in port["replicas"] for c in rep if c)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA checksum backend)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("pipeline", ["off", "overlap"])
def test_differential_against_reference_on_card(cuda_device, pipeline):
    ref, port = run(diff.run_both("cuda", pipeline, seed=1234))
    assert port == ref


@pytest.mark.cuda
def test_three_replica_chain_on_card(cuda_device):
    """Every hop's payload CRC of device size runs B1 on the card."""
    from t3fs_torch.ops import cuda_codec

    async def body():
        fabric = StorageFabric(num_nodes=3, replicas=3)
        await fabric.start()
        try:
            before = cuda_codec.launches["crc_words"]
            rng = np.random.default_rng(5)
            for i, n in enumerate((1000, 65535, 65536, 300_000, 1 << 20)):
                cid = ChunkId(90, i)
                data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
                result = await write(fabric, cid, data, chunk_size=1 << 20,
                                     seq=i + 1)
                assert result.status.code == int(StatusCode.OK), result.status
                for j in range(3):
                    meta = fabric.nodes[j].targets[fabric.target_id(j)] \
                        .engine.get_meta(cid)
                    assert meta.checksum == crc32c_ref(data)
                    assert meta.commit_ver == meta.update_ver == 1
            assert all(node.codec.batched_items == 3 for node in fabric.nodes)
            assert cuda_codec.launches["crc_words"] > before
        finally:
            await fabric.stop()
    run(body())
