"""The port's StorageClient (t3fs_torch.client.storage_client) over the
port's fabric: the reference's tests/test_storage_client.py cases in scope
(file-range striping, failover, channels, the packed wires, both transfer
modes), under the port's two checksum backends on the CPU.  The in-memory
fake client (t3fs_torch.client.storage_client_inmem) is held against this
client and against the reference's fake in
tests/test_torch_storage_client_inmem.py.
"""

import asyncio
import socket

import pytest

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.client.storage_client import (
    StorageClient, StorageClientConfig, TargetSelection,
)
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.storage.types import ChunkId
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.utils.status import StatusCode


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True, params=["cpu", "device"])
def _checksum_backend(request, monkeypatch):
    """The host CRC, and the CUDA backend's batching path on its plain
    version (every payload through it: no host cutoff)."""
    monkeypatch.setattr(
        StorageFabric, "default_checksum_backend",
        "cpu" if request.param == "cpu" else staticmethod(
            lambda: CudaChecksumBackend(device="cpu", min_device_bytes=0,
                                        max_wait_us=200)))


def test_layout_spans():
    lay = FileLayout(chunk_size=100, chains=[1, 2, 3])
    assert lay.chunk_span(0, 250) == [(0, 0, 100), (1, 0, 100), (2, 0, 50)]
    assert lay.chunk_span(150, 100) == [(1, 50, 50), (2, 0, 50)]
    assert [lay.chain_of(i) for i in range(5)] == [1, 2, 3, 1, 2]
    shuffled = FileLayout(chunk_size=100, chains=[1, 2, 3, 4, 5], seed=42)
    assert sorted(shuffled.chains) == [1, 2, 3, 4, 5]


def test_file_range_write_read_over_chain():
    async def body():
        fabric = StorageFabric(num_nodes=3, replicas=3)
        await fabric.start()
        try:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client)
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            data = bytes(range(256)) * 40  # 10240B: 3 chunks
            results = await sc.write_file_range(lay, inode=42, offset=0, data=data)
            assert all(r.status.code == int(StatusCode.OK) for r in results)
            got, _ = await sc.read_file_range(lay, 42, 0, len(data))
            assert got == data
            # unaligned read
            got, _ = await sc.read_file_range(lay, 42, 3000, 3000)
            assert got == data[3000:6000]
            # cross-chunk overwrite
            patch = b"P" * 3000
            await sc.write_file_range(lay, 42, 3500, patch)
            got, _ = await sc.read_file_range(lay, 42, 0, len(data))
            assert got == data[:3500] + patch + data[6500:]
            # length via query_last_chunk
            assert await sc.query_last_chunk(lay, 42) == len(data)
        finally:
            await fabric.stop()
    run(body())


def test_read_failover_walks_chain():
    async def body():
        fabric = StorageFabric(num_nodes=3, replicas=3)
        await fabric.start()
        try:
            cfg = StorageClientConfig(read_selection=TargetSelection.HEAD_TARGET,
                                      max_retries=5, retry_backoff_s=0.01)
            sc = StorageClient(lambda: fabric.routing, client=fabric.client,
                               config=cfg)
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            data = b"failover" * 100
            await sc.write_file_range(lay, 43, 0, data)
            # kill the head server; reads must fail over to another replica
            await fabric.servers[0].stop()
            got, results = await sc.read_file_range(lay, 43, 0, len(data))
            assert got == data
        finally:
            await fabric.stop()
    run(body())


def test_truncate_and_remove_file():
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client)
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            data = b"z" * 10000
            await sc.write_file_range(lay, 44, 0, data)
            await sc.truncate_file(lay, 44, 5000)
            assert await sc.query_last_chunk(lay, 44) == 5000
            got, _ = await sc.read_file_range(lay, 44, 0, 5000)
            assert got == data[:5000]
            await sc.remove_file_chunks(lay, 44)
            assert await sc.query_last_chunk(lay, 44) == 0
        finally:
            await fabric.stop()
    run(body())


def test_write_failover_on_chain_version_bump():
    """Client with stale chain_ver retries after routing changes."""
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client,
                               config=StorageClientConfig(retry_backoff_s=0.01))
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            # bump the chain version mid-flight: first attempt reads routing
            # before the bump only if we race; simply bump now — the client
            # must pick up the new version from routing and succeed
            fabric.bump_chain(fabric.chain().targets)
            r = await sc.write_file_range(lay, 45, 0, b"bump")
            assert r[0].status.code == int(StatusCode.OK)
        finally:
            await fabric.stop()
    run(body())


def test_remote_buf_pooled_writes():
    """transfer_mode=remote_buf: payload staged in a pooled registered
    buffer, head pulls it one-sided (doUpdate RDMA READ analog,
    StorageOperator.cc:560-591); pool reuses buffers across writes."""
    from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
    from t3fs_torch.storage.types import ChunkId

    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            sc = StorageClient(
                lambda: fabric.routing, client=fabric.client,
                config=StorageClientConfig(transfer_mode="remote_buf",
                                           remote_buf_threshold=1024))
            data1 = bytes(range(256)) * 16     # 4 KiB: over threshold
            data2 = b"z" * 4096
            r1 = await sc.write_chunk(fabric.chain_id, ChunkId(31, 0), 0,
                                      data1, chunk_size=4096)
            assert r1.status.code == int(StatusCode.OK), str(r1.status)
            r2 = await sc.write_chunk(fabric.chain_id, ChunkId(31, 1), 0,
                                      data2, chunk_size=4096)
            assert r2.status.code == int(StatusCode.OK)
            # second write reused the pooled buffer
            assert sc.buf_pool.misses == 1 and sc.buf_pool.hits == 1
            # small write stays inline (below threshold)
            r3 = await sc.write_chunk(fabric.chain_id, ChunkId(31, 2), 0,
                                      b"tiny", chunk_size=4096)
            assert r3.status.code == int(StatusCode.OK)
            assert sc.buf_pool.misses == 1
            # data round-trips byte-exact
            _, p = await sc.read_chunk(fabric.chain_id, ChunkId(31, 0))
            assert p == data1
        finally:
            await fabric.stop()
    run(body())


def test_batch_read_packed_fast_path_roundtrip():
    """The packed batch encoding must be byte-accurate both ways, fall
    back for RemoteBuf/overflow IOs, and interop with the struct path
    (see docs/perf_multiprocess.md)."""
    from t3fs_torch.storage.types import (
        PACKED_READIO_VER, ChunkId, IOResult, ReadIO, pack_ioresults,
        pack_readios, unpack_ioresults, unpack_readios,
    )
    from t3fs_torch.net.wire import WireStatus

    ios = [ReadIO(ChunkId((1 << 63) | 7, i), 3, i * 512, 16384,
                  verify_checksum=(i % 2 == 0), no_payload=(i == 5),
                  chain_ver=(i % 3))
           for i in range(32)]
    blob = pack_readios(ios)
    assert blob is not None and \
        unpack_readios(blob, PACKED_READIO_VER) == ios
    # a v1 client's legacy-stride blob still decodes (chain_ver -> 0):
    # stride sniffing cannot distinguish 51 v1 entries from 43 v2 ones,
    # so the server keys on BatchReadReq.packed_ver instead
    from t3fs_torch.storage.types import _READIO_FMT_V1
    legacy = b"".join(
        _READIO_FMT_V1.pack(io.chunk_id.inode, io.chunk_id.index,
                            io.chain_id, io.offset, io.length,
                            io.verify_checksum, io.allow_uncommitted,
                            io.no_payload)
        for io in ios)
    got = unpack_readios(legacy, 1)
    assert [(g.chunk_id, g.chain_id, g.offset, g.length, g.chain_ver)
            for g in got] == \
        [(io.chunk_id, io.chain_id, io.offset, io.length, 0)
         for io in ios]

    # RemoteBuf forces the struct path
    from t3fs_torch.net.rdma import RemoteBuf
    ios2 = list(ios)
    ios2[3] = ReadIO(ChunkId(1, 1), 1, 0, 16, buf=RemoteBuf())
    assert pack_readios(ios2) is None

    rs = [IOResult(WireStatus(0), 16384, 2, 2, 1, 0xFFFFFFFF)
          for _ in range(32)]
    blob2 = pack_ioresults(rs)
    assert blob2 is not None and unpack_ioresults(blob2) == rs
    # an error message must survive -> struct path
    rs[9] = IOResult(WireStatus(5001, "chunk not found"))
    assert pack_ioresults(rs) is None


def test_batch_read_uses_packed_wire_path():
    """End-to-end negotiation: the FIRST batch per address rides the
    struct path with want_packed, the server advertises its packed_ver,
    and subsequent batches ship packed_ios at that version; a batch with
    an error message falls back to the struct list transparently."""
    import asyncio as _a

    from t3fs_torch.storage.types import BatchReadRsp, PACKED_READIO_VER
    from t3fs_torch.testing.fabric import StorageFabric
    from t3fs_torch.client.layout import FileLayout

    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        try:
            from t3fs_torch.client.storage_client import StorageClient
            # pin reads to one target: the packed_ver advertisement is
            # learned PER ADDRESS, so round-robin reads would still be on
            # their first (struct) batch against the other replicas
            sc = StorageClient(
                lambda: fab.routing, client=fab.client,
                config=StorageClientConfig(
                    read_selection=TargetSelection.HEAD_TARGET))
            lay = FileLayout(chunk_size=16384, chains=[fab.chain_id])
            data = bytes(range(256)) * 256          # 4 chunks
            await sc.write_file_range(lay, 77, 0, data)

            # spy on the RPC client to assert the wire shape
            seen = []
            orig_call = fab.client.call

            async def spy_call(addr, method, req=None, **kw):
                rsp, payload = await orig_call(addr, method, req, **kw)
                if method == "Storage.batch_read":
                    seen.append((bool(req.packed_ios), bool(
                        isinstance(rsp, BatchReadRsp) and rsp.packed_results)))
                return rsp, payload
            fab.client.call = spy_call

            got, results = await sc.read_file_range(lay, 77, 0, len(data))
            assert got == data
            # first batch: struct request, packed response (advertises)
            assert seen[0] == (False, True), seen
            assert {v for v, _ in sc._packed_ver.values()} == \
                {PACKED_READIO_VER}

            # second batch to the same address: packed request
            got, results = await sc.read_file_range(lay, 77, 0, len(data))
            assert got == data
            assert seen[-1] == (True, True), seen

            # a read of a missing chunk produces an error message ->
            # struct-path response; the client still decodes it fine
            from t3fs_torch.storage.types import ReadIO, ChunkId
            res, _ = await sc.batch_read(
                [ReadIO(ChunkId(9999, 0), fab.chain_id, 0, 4096)])
            assert res[0].status.code != 0
            assert seen[-1][1] is False
        finally:
            await fab.stop()
    _a.run(body())


def test_batch_read_packed_interop_with_old_server():
    """A server that predates the packed encoding drops the unknown
    want_packed/packed_ver fields and answers struct results; since it
    never ADVERTISES a packed_ver, the client must keep every batch on
    the struct path (never a packed blob it could mis-parse)."""
    import asyncio as _a

    async def body():
        from t3fs_torch.testing.fabric import StorageFabric
        from t3fs_torch.client.storage_client import StorageClient
        from t3fs_torch.client.layout import FileLayout
        fab = StorageFabric(num_nodes=1, replicas=1)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = FileLayout(chunk_size=16384, chains=[fab.chain_id])
            data = bytes(range(256)) * 128
            await sc.write_file_range(lay, 5, 0, data)

            # emulate an OLD server: its serde drops the unknown packed
            # request fields and its responses carry no packed_results
            orig_call = fab.client.call
            calls = []

            async def old_server_call(addr, method, req=None, **kw):
                if method == "Storage.batch_read":
                    calls.append(bool(req.packed_ios))
                    assert not req.packed_ios, \
                        "client packed to a server that never advertised"
                    req.want_packed = False
                return await orig_call(addr, method, req, **kw)
            fab.client.call = old_server_call

            for _ in range(3):
                got, results = await sc.read_file_range(lay, 5, 0, len(data))
                assert got == data
                assert all(r.status.code == 0 for r in results)
            assert calls and all(c is False for c in calls)
            assert not sc._packed_ver      # never advertised -> never learned
        finally:
            await fab.stop()
    _a.run(body())


def test_batch_read_downgrades_to_v1_packed_server():
    """Version negotiation: a server that advertises
    packed_ver=1 must receive v1 (43-byte) blobs — a v2 blob would
    mis-parse there (43 v2 entries == 51 v1 entries byte-for-byte).
    The real server decodes the v1 blob via req.packed_ver."""
    import asyncio as _a

    async def body():
        from t3fs_torch.testing.fabric import StorageFabric
        from t3fs_torch.client.storage_client import StorageClient
        from t3fs_torch.client.layout import FileLayout
        from t3fs_torch.storage.types import _READIO_FMT_V1
        fab = StorageFabric(num_nodes=1, replicas=1)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = FileLayout(chunk_size=16384, chains=[fab.chain_id])
            data = bytes(range(256)) * 128
            await sc.write_file_range(lay, 6, 0, data)

            orig_call = fab.client.call
            packed_lens = []

            async def v1_server_call(addr, method, req=None, **kw):
                rsp, payload = await orig_call(addr, method, req, **kw)
                if method == "Storage.batch_read":
                    if req.packed_ios:
                        packed_lens.append(len(req.packed_ios))
                        assert req.packed_ver == 1
                    if rsp.packed_results:
                        rsp.packed_ver = 1      # server speaks v1 only
                return rsp, payload
            fab.client.call = v1_server_call

            got, _ = await sc.read_file_range(lay, 6, 0, len(data))
            assert got == data                  # struct first batch
            assert sc._packed_ver and \
                {v for v, _ in sc._packed_ver.values()} == {1}
            got, _ = await sc.read_file_range(lay, 6, 0, len(data))
            assert got == data                  # v1-packed second batch
            assert packed_lens and all(
                n % _READIO_FMT_V1.size == 0 for n in packed_lens)
        finally:
            await fab.stop()
    _a.run(body())


def test_read_chain_version_fence():
    """Reads carry chain_ver like writes.  A stamped version
    that diverges from the server's routing answers
    CHAIN_VERSION_MISMATCH (no stale read); chain_ver=0 keeps the
    relaxed CRAQ read-any behavior."""
    import asyncio as _a

    async def body():
        from t3fs_torch.storage.types import BatchReadReq, ReadIO
        from t3fs_torch.testing.fabric import StorageFabric
        fab = StorageFabric(num_nodes=1, replicas=1)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = FileLayout(chunk_size=16384, chains=[fab.chain_id])
            await sc.write_file_range(lay, 7, 0, b"fence" * 100)
            chain = fab.routing.chain(fab.chain_id)
            addr = fab.routing.node_address(chain.head().node_id)

            def io(ver):
                return ReadIO(chunk_id=ChunkId(7, 0), chain_id=fab.chain_id,
                              length=500, chain_ver=ver)

            # diverged version -> fenced
            rsp, _ = await fab.client.call(
                addr, "Storage.batch_read",
                BatchReadReq(ios=[io(chain.chain_ver + 5)]))
            assert rsp.results[0].status.code == \
                int(StatusCode.CHAIN_VERSION_MISMATCH)
            # matching version and the 0 opt-out both serve
            for ver in (chain.chain_ver, 0):
                rsp, payload = await fab.client.call(
                    addr, "Storage.batch_read", BatchReadReq(ios=[io(ver)]))
                assert rsp.results[0].status.code == int(StatusCode.OK)
                assert payload == b"fence" * 100
            # and the high-level client (which stamps its routing's
            # version) round-trips
            got, _ = await sc.read_file_range(lay, 7, 0, 500)
            assert got == b"fence" * 100
        finally:
            await fab.stop()
    _a.run(body())

def test_packed_updateio_roundtrip():
    """pack_updateio must be byte-accurate for the common case and
    refuse RemoteBuf / fault-injection / oversized-id IOs."""
    from t3fs_torch.net.rdma import RemoteBuf
    from t3fs_torch.storage.types import (
        UpdateIO, UpdateType, pack_updateio, unpack_updateio,
    )
    from t3fs_torch.utils.fault_injection import DebugFlags

    io = UpdateIO(chunk_id=ChunkId((1 << 63) | 5, 7), chain_id=3,
                  chain_ver=2, update_type=UpdateType.TRUNCATE, offset=64,
                  length=4096, chunk_size=1 << 20, update_ver=9,
                  commit_ver=8, checksum=0xDEADBEEF, channel=4,
                  channel_seq=17, client_id="sc-0011aabbccdd",
                  inline=True, is_sync=True, from_head=True,
                  commit_only=True)
    blob = pack_updateio(io)
    assert blob is not None and unpack_updateio(blob) == io

    assert pack_updateio(UpdateIO(buf=RemoteBuf())) is None
    assert pack_updateio(UpdateIO(
        debug=DebugFlags(inject_server_error_prob=0.5))) is None
    assert pack_updateio(UpdateIO(client_id="x" * 300)) is None


def test_write_path_uses_packed_wire_and_falls_back():
    """End-to-end: client writes ride Storage.write_packed and the CRAQ
    forward hop rides Storage.update_packed; an old server (method
    missing) triggers a one-shot fallback with the address memoized."""
    import asyncio as _a

    async def body():
        from t3fs_torch.testing.fabric import StorageFabric
        from t3fs_torch.utils.status import make_error
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = FileLayout(chunk_size=16384, chains=[fab.chain_id])
            calls = []
            orig_call = fab.client.call

            async def spying_call(addr, method, req=None, **kw):
                calls.append(method)
                return await orig_call(addr, method, req, **kw)
            fab.client.call = spying_call

            data = bytes(range(256)) * 64
            await sc.write_file_range(lay, 8, 0, data)
            got, _ = await sc.read_file_range(lay, 8, 0, len(data))
            assert got == data
            assert "Storage.write_packed" in calls
            assert "Storage.write" not in calls

            # forward hops between replicas also ride the packed method
            # (they go through each node's own client, not fab.client —
            # verify via the forwarding memoization being EMPTY and the
            # replicas having the data)
            for node in fab.nodes:
                assert not node.forwarding._no_packed

            # old server: write_packed answers RPC_METHOD_NOT_FOUND
            sc2 = StorageClient(lambda: fab.routing, client=fab.client)
            calls2 = []

            async def old_server_call(addr, method, req=None, **kw):
                calls2.append(method)
                if method == "Storage.write_packed":
                    raise make_error(StatusCode.RPC_METHOD_NOT_FOUND, method)
                return await orig_call(addr, method, req, **kw)
            fab.client.call = old_server_call

            await sc2.write_file_range(lay, 9, 0, data)
            got, _ = await sc2.read_file_range(lay, 9, 0, len(data))
            assert got == data
            assert calls2.count("Storage.write_packed") == 1  # memoized
            assert calls2.count("Storage.write") >= 1
        finally:
            await fab.stop()
    _a.run(body())


def test_packed_ver_memo_dies_with_the_connection():
    """A server restart may be a ROLLBACK to an older
    packed stride, so the advertised-version memo must not outlive the
    connection — after a reconnect the next batch re-negotiates on the
    struct path instead of packing at the stale version."""
    import asyncio as _a

    async def body():
        from t3fs_torch.testing.fabric import StorageFabric
        fab = StorageFabric(num_nodes=1, replicas=1)
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = FileLayout(chunk_size=16384, chains=[fab.chain_id])
            data = bytes(range(256)) * 64
            await sc.write_file_range(lay, 11, 0, data)

            packed_seen = []
            orig_call = fab.client.call

            async def spy(addr, method, req=None, **kw):
                if method == "Storage.batch_read":
                    packed_seen.append(bool(req.packed_ios))
                return await orig_call(addr, method, req, **kw)
            fab.client.call = spy

            await sc.read_file_range(lay, 11, 0, len(data))   # learn
            await sc.read_file_range(lay, 11, 0, len(data))   # packed
            assert packed_seen == [False, True], packed_seen

            # sever every connection (server restart analog): epoch
            # bumps on reconnect, memo is stale -> struct + re-learn
            for conn in list(fab.client._conns.values()):
                await conn.close()
            await sc.read_file_range(lay, 11, 0, len(data))
            assert packed_seen[-1] is False, packed_seen
            await sc.read_file_range(lay, 11, 0, len(data))
            assert packed_seen[-1] is True, packed_seen
        finally:
            await fab.stop()
    _a.run(body())


def test_read_file_ranges_out_of_order_and_overlapping():
    """One batch_read fan-out serves many ranges regardless of order or
    overlap; per-range (bytes, per-piece IOResults) stay aligned with the
    request list (ckpt resharded-restore leans on this)."""
    async def body():
        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client)
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            data = bytes(range(256)) * 48          # 12288B = 3 chunks
            await sc.write_file_range(lay, 60, 0, data)
            await sc.write_file_range(lay, 61, 0, b"B" * 5000)

            ranges = [
                (60, 8000, 2000),     # out of order: tail chunk first
                (60, 0, 4096),        # exactly chunk 0
                (60, 2000, 4000),     # overlaps the previous two ranges
                (61, 100, 200),       # second inode interleaved
                (60, 2000, 4000),     # duplicate range
                (60, 12000, 1000),    # runs past EOF: zero-padded tail
                (62, 0, 300),         # absent inode: hole, zero-filled
            ]
            out = await sc.read_file_ranges(lay, ranges)
            assert len(out) == len(ranges)
            want = [
                data[8000:10000], data[0:4096], data[2000:6000],
                b"B" * 200, data[2000:6000],
                data[12000:] + b"\x00" * (13000 - len(data)),
                b"\x00" * 300,
            ]
            for (got, results), w, (inode, off, ln) in zip(out, want, ranges):
                assert got == w, (inode, off, ln)
                assert len(got) == ln
                # one IOResult per chunk piece of THIS range
                assert len(results) == len(lay.chunk_span(off, ln))
            # the hole range surfaced CHUNK_NOT_FOUND, not OK
            assert out[-1][1][0].status.code == \
                int(StatusCode.CHUNK_NOT_FOUND)
            ok = out[1][1]
            assert all(r.status.code == int(StatusCode.OK) for r in ok)
        finally:
            await fabric.stop()
    run(body())


def test_read_file_ranges_retry_exhaustion_surfaces_errors():
    """Chain fully down: after max_retries the per-piece IOResults carry
    the transport error (NOT silently OK, NOT an exception) and the bytes
    zero-fill, so callers can distinguish hole from failure.

    Once its server stops, the node's routing address moves to a port this
    test holds bound without listening, so every connect is refused: a
    stopped server's port could otherwise be reused by a server of another
    test process, which would answer the retries."""
    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1)
        await fabric.start()
        held = socket.socket()
        held.bind(("127.0.0.1", 0))
        try:
            sc = StorageClient(
                lambda: fabric.routing, client=fabric.client,
                config=StorageClientConfig(max_retries=2,
                                           retry_backoff_s=0.01))
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            data = b"x" * 6000
            await sc.write_file_range(lay, 70, 0, data)
            got, _ = await sc.read_file_range(lay, 70, 0, 6000)
            assert got == data

            await fabric.servers[0].stop()
            fabric.routing.nodes[1].address = "127.0.0.1:%d" % held.getsockname()[1]
            out = await sc.read_file_ranges(
                lay, [(70, 0, 6000), (70, 1000, 500)])
            for got, results in out:
                assert got == b"\x00" * len(got)
                assert results, "per-piece results must surface"
                for r in results:
                    assert r.status.code != int(StatusCode.OK)
                    assert r.status.code != \
                        int(StatusCode.CHUNK_NOT_FOUND), \
                        "failure must not read as a hole"
            assert len(out[0][0]) == 6000 and len(out[1][0]) == 500
        finally:
            held.close()
            await fabric.stop()
    run(body())


def test_truncate_boundary_failure_raises_instead_of_silent_success():
    """The boundary-chunk TRUNCATE returns its failure in the IOResult, not
    as an exception; truncate_file used to discard it, so a failed truncate
    left the old tail bytes readable past new_length while the caller saw
    success (found by t3fslint's status-discarded rule)."""
    async def body():
        from t3fs_torch.net.wire import WireStatus
        from t3fs_torch.storage.types import IOResult, UpdateType
        from t3fs_torch.utils.status import StatusError

        fabric = StorageFabric(num_nodes=2, replicas=2)
        await fabric.start()
        try:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client)
            lay = FileLayout(chunk_size=4096, chains=[fabric.chain_id])
            await sc.write_file_range(lay, 46, 0, b"z" * 10000)

            orig = sc.write_chunk

            async def failing_write_chunk(*args, **kwargs):
                if kwargs.get("update_type") == UpdateType.TRUNCATE:
                    return IOResult(status=WireStatus(
                        int(StatusCode.CHUNK_STALE_UPDATE), "injected"))
                return await orig(*args, **kwargs)

            sc.write_chunk = failing_write_chunk
            with pytest.raises(StatusError):
                await sc.truncate_file(lay, 46, 5000)
        finally:
            await fabric.stop()
    run(body())
