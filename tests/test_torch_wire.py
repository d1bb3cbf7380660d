"""The port speaks the reference's wire: serde bytes of the storage
messages and a framed MessagePacket are equal between t3fs and t3fs_torch
for the same seeded values, and each package's StorageClient writes to and
reads from the other's storage fabric."""

import asyncio
import types as pytypes

import numpy as np
import pytest

import t3fs.client.layout
import t3fs.client.storage_client
import t3fs.mgmtd.types
import t3fs.net.client
import t3fs.net.rdma
import t3fs.net.wire
import t3fs.storage.types
import t3fs.testing.fabric
import t3fs.utils.fault_injection
import t3fs.utils.serde
import t3fs_torch.client.layout
import t3fs_torch.client.storage_client
import t3fs_torch.mgmtd.types
import t3fs_torch.net.rdma
import t3fs_torch.net.wire
import t3fs_torch.storage.types
import t3fs_torch.testing.fabric
import t3fs_torch.utils.fault_injection
import t3fs_torch.utils.serde
from t3fs_torch.storage.codec_backend import CudaChecksumBackend


def _pkg(root) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        layout=root.client.layout, client=root.client.storage_client,
        mgmtd=root.mgmtd.types, rdma=root.net.rdma, wire=root.net.wire,
        st=root.storage.types, fabric=root.testing.fabric,
        debug=root.utils.fault_injection, serde=root.utils.serde)


REF = _pkg(t3fs)
PORT = _pkg(t3fs_torch)


def _messages(p, seed: int) -> dict:
    """One value of each wire type, its fields drawn from a seeded rng."""
    rng = np.random.default_rng(seed)

    def u(bits=63):
        return int(rng.integers(0, 1 << bits, dtype=np.uint64))

    st, mg = p.st, p.mgmtd
    cid = st.ChunkId(u(), u(32))
    debug = p.debug.DebugFlags(inject_server_error_prob=float(rng.random()),
                               num_points_before_fail=u(8))
    io = st.UpdateIO(
        chunk_id=cid, chain_id=u(32), chain_ver=u(16),
        update_type=st.UpdateType(int(rng.integers(0, len(st.UpdateType)))),
        offset=u(20), length=u(22), chunk_size=4 << 20, update_ver=u(16),
        commit_ver=u(16), checksum=u(32), channel=u(8), channel_seq=u(20),
        client_id=f"sc-{u(48):012x}", inline=bool(rng.integers(2)),
        from_head=True, debug=debug, stream_id=f"s{u(20)}",
        remove_fence_ver=u(8))
    remote = p.rdma.RemoteBuf(buf_id=u(20), offset=u(16), length=u(16),
                              rkey=u(32))
    reads = [st.ReadIO(chunk_id=st.ChunkId(u(), i), chain_id=u(8),
                       offset=u(16), length=u(20),
                       buf=remote if i == 1 else None,
                       verify_checksum=bool(i % 2), no_payload=i == 2,
                       chain_ver=u(8)) for i in range(4)]
    result = st.IOResult(p.wire.WireStatus(int(rng.integers(0, 6000)),
                                           f"status {u(16)}"),
                         u(22), u(16), u(16), u(16), u(32))
    chain = mg.ChainInfo(chain_id=u(16), chain_ver=u(8), targets=[
        mg.ChainTargetInfo(u(16), u(8), mg.PublicTargetState(s))
        for s in range(1, 4)], preferred_target_order=[u(8), u(8)])
    routing = mg.RoutingInfo(
        version=u(16), nodes={n: mg.NodeInfo(n, f"127.0.0.1:{u(15)}",
                                             generation=float(rng.random()))
                              for n in (1, 2, 3)},
        chains={chain.chain_id: chain},
        chain_tables={1: mg.ChainTable(1, [chain.chain_id], table_ver=u(8))})
    return {"UpdateIO": io, "WriteReq": st.WriteReq(io=io),
            "BatchReadReq": st.BatchReadReq(ios=reads, debug=debug,
                                            want_packed=True),
            "IOResult": result, "ChainInfo": chain, "RoutingInfo": routing}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("name", ["UpdateIO", "WriteReq", "BatchReadReq",
                                  "IOResult", "ChainInfo", "RoutingInfo"])
def test_serde_bytes_equal(name, seed):
    ref = REF.serde.dumps(_messages(REF, seed)[name])
    port = PORT.serde.dumps(_messages(PORT, seed)[name])
    assert port == ref
    # and each package decodes the other's bytes to the same value
    assert PORT.serde.dumps(PORT.serde.loads(ref)) == ref
    assert REF.serde.dumps(REF.serde.loads(port)) == port


def test_default_target_op_req_bytes_equal():
    """A default TargetOpReq (engine_backend "native") is the same bytes
    from either package, and each decodes the other's to its default."""
    ref = REF.serde.dumps(REF.st.TargetOpReq())
    port = PORT.serde.dumps(PORT.st.TargetOpReq())
    assert port == ref
    assert PORT.serde.loads(ref) == PORT.st.TargetOpReq()
    assert PORT.st.TargetOpReq().engine_backend == "native"
    full = dict(target_id=7, root="/data/t7", engine_backend="py", chain_id=3)
    assert PORT.serde.dumps(PORT.st.TargetOpReq(**full)) == \
        REF.serde.dumps(REF.st.TargetOpReq(**full))


def test_reference_default_create_target_on_port_node(tmp_path):
    """A reference sender's default create_target reaches a port node,
    which opens the native engine it asks for."""
    from t3fs_torch.storage.native_engine import NativeChunkEngine

    async def body():
        fab = PORT.fabric.StorageFabric(num_nodes=1, replicas=1,
                                        checksum_backend="cpu")
        await fab.start()
        client = t3fs.net.client.Client()
        try:
            req = REF.st.TargetOpReq(target_id=555, root=str(tmp_path / "t"))
            rsp, _ = await client.call(fab.routing.node_address(1),
                                       "Storage.create_target", req)
            assert rsp.target_id == 555
            assert isinstance(fab.nodes[0].targets[555].engine,
                              NativeChunkEngine)
        finally:
            await client.close()
            await fab.stop()
    asyncio.run(body())


def _frame(p, seed: int, payload: bytes) -> bytes:
    msgs = _messages(p, seed)
    packet = p.wire.MessagePacket(
        uuid=seed + 7, method="Storage.write", body=msgs["WriteReq"],
        ts_client_called=1234.5, trace_id=99, parent_span_id=5, sampled=True)
    msg = p.serde.dumps(packet)
    return p.wire.pack_header(len(msg), len(payload), p.wire.FLAG_IS_REQ,
                              p.wire.crc32c_ref(msg)) + msg + payload


@pytest.mark.parametrize("seed", range(3))
def test_framed_message_packet_bytes_equal(seed):
    payload = np.random.default_rng(seed).bytes(1000)
    ref, port = _frame(REF, seed, payload), _frame(PORT, seed, payload)
    assert port == ref
    # the port's framing checks pass on the reference's frame
    head = ref[:PORT.wire.HEADER_SIZE]
    msg_len, payload_len, _, msg_crc = PORT.wire.unpack_header(head)
    msg = ref[PORT.wire.HEADER_SIZE:PORT.wire.HEADER_SIZE + msg_len]
    PORT.wire.check_msg_crc(msg, msg_crc)
    assert payload_len == len(payload)


async def _cross(server: pytypes.SimpleNamespace, client, fabric_kw) -> None:
    """client's StorageClient writes a file over server's 3-replica fabric
    and reads it back; every replica holds the client's CRC."""
    fab = server.fabric.StorageFabric(num_nodes=3, replicas=3, **fabric_kw)
    await fab.start()
    try:
        sc = client.client.StorageClient(
            lambda: _translate_routing(fab.routing, client.mgmtd),
            client=None)
        try:
            lay = client.layout.FileLayout(chunk_size=96 << 10,
                                           chains=[fab.chain_id])
            data = np.random.default_rng(3).bytes(300_000)
            results = await sc.write_file_range(lay, inode=5, offset=0,
                                                data=data)
            assert [r.status.code for r in results] == [0] * 4
            got, _ = await sc.read_file_range(lay, 5, 0, len(data))
            assert got == data
            got, _ = await sc.read_file_range(lay, 5, 90_000, 20_000)
            assert got == data[90_000:110_000]
            assert await sc.query_last_chunk(lay, 5) == len(data)
            for i, node in enumerate(fab.nodes):
                engine = node.targets[fab.target_id(i)].engine
                for idx, r in enumerate(results):
                    meta = engine.get_meta(server.st.ChunkId(5, idx))
                    assert meta.checksum == r.checksum
                    assert meta.commit_ver == meta.update_ver == 1
        finally:
            await sc.close()
    finally:
        await fab.stop()


def _translate_routing(routing, mgmtd):
    """The server's routing as the client package's types (a routing view
    travels through mgmtd's RPCs in a deployment; here it is rebuilt)."""
    return mgmtd.RoutingInfo(
        version=routing.version,
        nodes={k: mgmtd.NodeInfo(n.node_id, n.address)
               for k, n in routing.nodes.items()},
        chains={k: mgmtd.ChainInfo(c.chain_id, c.chain_ver, [
            mgmtd.ChainTargetInfo(t.target_id, t.node_id,
                                  mgmtd.PublicTargetState(int(t.public_state)))
            for t in c.targets]) for k, c in routing.chains.items()})


@pytest.mark.parametrize("pipeline", ["off", "overlap"])
def test_port_client_against_reference_fabric(pipeline):
    asyncio.run(_cross(REF, PORT, {"checksum_backend": "cpu",
                                   "write_pipeline": pipeline}))


@pytest.mark.parametrize("backend", ["cpu", "device"])
def test_reference_client_against_port_fabric(backend):
    be = "cpu" if backend == "cpu" else (
        lambda: CudaChecksumBackend(device="cpu", min_device_bytes=0,
                                    max_wait_us=200))
    asyncio.run(_cross(PORT, REF, {"checksum_backend": be}))
