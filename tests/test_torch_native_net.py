"""The port's native io_uring transport (t3fs_torch/net/native_conn.py over
t3fs_torch/csrc/net_pump.cpp), held against the reference's
(t3fs/net/native_conn.py over t3fs/native/net_pump.cpp) on the CPU.

- A twin of each of the 10 tests of tests/test_native_net.py, on the port's
  Server and Client with T3FS_NATIVE_NET=1, at the reference's sizes; each
  also checks the pump's counters against those sizes (client and server
  share one pump per event loop, so every byte one end stages or pins is a
  byte the other end receives: rx_bytes + 24 * rx_frames equals
  tx_staged_bytes + tx_zc_bytes).
- Each package's client against the other package's server, over the pump
  at both ends and over the pump at one end and asyncio at the other.
- One seeded sequence of calls and of requests through each package's
  NativeConnection and asyncio Connection on a socket pair whose other end
  is a raw socket: the bytes each writes are equal, and the two pumps'
  counters are equal.
- A 3-replica CRAQ write and an RS(8+2) stripe through each package's
  storage fabric over its own pump: equal stored bytes, ChunkMeta and
  codec counts.
- The pump's source and the sanitizer switch of the host library's build.
- chip_smoke.py's pump probe and phase 34, both branches, at a small size.

Nothing here needs a GPU: the port's fabrics run the cpu checksum backend
and TorchECCodec(device="cpu").
"""

import asyncio
import itertools
import os
import re
import socket
import struct
import types as pytypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pytest

import t3fs.client.layout
import t3fs.client.storage_client
import t3fs.net.client
import t3fs.net.conn
import t3fs.net.native_conn
import t3fs.net.rdma
import t3fs.net.server
import t3fs.net.wire
import t3fs.ops.codec
import t3fs.testing.fabric
import t3fs.utils.serde
import t3fs.utils.status
import t3fs_torch.client.layout
import t3fs_torch.client.storage_client
import t3fs_torch.net.client
import t3fs_torch.net.conn
import t3fs_torch.net.native_conn
import t3fs_torch.net.rdma
import t3fs_torch.net.server
import t3fs_torch.net.wire
import t3fs_torch.ops.codec
import t3fs_torch.testing.fabric
import t3fs_torch.utils.serde
import t3fs_torch.utils.status

ROOT = Path(__file__).resolve().parent.parent


def run(coro):
    return asyncio.run(coro)


def _pkg(root) -> pytypes.SimpleNamespace:
    p = pytypes.SimpleNamespace(
        name=root.__name__, Server=root.net.server.Server,
        Client=root.net.client.Client, native=root.net.native_conn,
        conn=root.net.conn, wire=root.net.wire, rdma=root.net.rdma,
        serde=root.utils.serde, status=root.utils.status,
        crc32c=root.ops.codec.crc32c, fabric=root.testing.fabric,
        layout=root.client.layout, sc=root.client.storage_client,
        dispatcher=root.net.server.build_dispatcher)

    @p.serde.serde_struct
    @dataclass
    class TNEchoReq:
        n: int = 0
        tag: str = ""

    @root.net.server.service("NEcho")
    class EchoSvc:
        @root.net.server.rpc_method
        async def echo(self, req, payload, conn):
            # payload is a bytes-like buffer (zero-copy RX hands a
            # memoryview); bytes() materializes before the reverse
            return TNEchoReq(n=req.n + 1, tag=req.tag), bytes(payload)[::-1]

        @root.net.server.rpc_method
        async def boom(self, req, payload, conn):
            raise p.status.make_error(p.status.StatusCode.INVALID_ARG, "boom")

    p.Req, p.EchoSvc = TNEchoReq, EchoSvc
    return p


REF = _pkg(t3fs)
PORT = _pkg(t3fs_torch)
PKGS = {"ref": REF, "port": PORT}
SC = PORT.status.StatusCode
StatusError = PORT.status.StatusError
HEADER = 24


def wire_balanced(stats: dict) -> bool:
    """One pump at both ends: what it put on the wire it took off again."""
    return (stats["rx_bytes"] + HEADER * stats["rx_frames"]
            == stats["tx_staged_bytes"] + stats["tx_zc_bytes"])


# --- the twins of tests/test_native_net.py, on the port ----------------------

async def _roundtrip(n_calls: int = 50, payload=b"x" * 100_000) -> dict:
    srv = PORT.Server()
    srv.add_service(PORT.EchoSvc())
    await srv.start()
    cli = PORT.Client()
    try:
        for i in range(n_calls):
            rsp, p = await cli.call(srv.address, "NEcho.echo",
                                    PORT.Req(n=i, tag="t" * (i % 7)),
                                    payload=payload)
            assert rsp.n == i + 1 and p == payload[::-1]
        with pytest.raises(StatusError) as ei:
            await cli.call(srv.address, "NEcho.boom", PORT.Req())
        assert ei.value.code == SC.INVALID_ARG
        assert isinstance(cli._conns[srv.address], PORT.native.NativeConnection)
        return PORT.native.NativePump.get().stats()
    finally:
        await cli.close()
        await srv.stop()


def test_native_transport_roundtrip(monkeypatch):
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")
    st = run(_roundtrip())
    # 50 echoes and one error: 102 frames, every 100 000 B payload pinned
    assert st["rx_frames"] == 102 and st["tx_zc_bytes"] == 100 * 100_000, st
    assert wire_balanced(st), st


def test_native_transport_concurrent_calls(monkeypatch):
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")

    async def body():
        srv = PORT.Server()
        srv.add_service(PORT.EchoSvc())
        await srv.start()
        cli = PORT.Client()
        try:
            payload = os.urandom(64 << 10)

            async def one(i):
                rsp, p = await cli.call(srv.address, "NEcho.echo",
                                        PORT.Req(n=i), payload=payload)
                assert rsp.n == i + 1 and p == payload[::-1]
            await asyncio.gather(*[one(i) for i in range(200)])
            return PORT.native.NativePump.get().stats()
        finally:
            await cli.close()
            await srv.stop()
    st = run(body())
    assert st["rx_frames"] == 400 and st["tx_zc_bytes"] == 400 * (64 << 10), st
    assert wire_balanced(st), st


def test_native_server_asyncio_client_interop(monkeypatch):
    """Same wire format both ways: a native-transport server serves an
    asyncio-transport client and vice versa."""
    async def native_server():
        monkeypatch.setenv("T3FS_NATIVE_NET", "1")
        srv = PORT.Server()
        srv.add_service(PORT.EchoSvc())
        await srv.start()
        monkeypatch.setenv("T3FS_NATIVE_NET", "0")   # client side: asyncio
        cli = PORT.Client()
        try:
            rsp, p = await cli.call(srv.address, "NEcho.echo",
                                    PORT.Req(n=41), payload=b"abc")
            assert rsp.n == 42 and p == b"cba"
            assert type(cli._conns[srv.address]) is PORT.conn.Connection
            return PORT.native.NativePump.get().stats()
        finally:
            await cli.close()
            await srv.stop()
    st = run(native_server())
    # the server's pump took the request off the wire and staged the reply
    assert st["rx_frames"] == 1 and st["tx_zc_bytes"] == 0, st
    assert st["tx_staged_bytes"] > HEADER + 3, st

    async def native_client():
        monkeypatch.setenv("T3FS_NATIVE_NET", "0")
        srv = PORT.Server()
        srv.add_service(PORT.EchoSvc())
        await srv.start()
        monkeypatch.setenv("T3FS_NATIVE_NET", "1")
        cli = PORT.Client()
        try:
            rsp, p = await cli.call(srv.address, "NEcho.echo",
                                    PORT.Req(n=1), payload=b"xyz")
            assert rsp.n == 2 and p == b"zyx"
            assert isinstance(cli._conns[srv.address],
                              PORT.native.NativeConnection)
            return PORT.native.NativePump.get().stats()
        finally:
            await cli.close()
            await srv.stop()
    st = run(native_client())
    assert st["rx_frames"] == 1 and st["tx_zc_bytes"] == 0, st


def test_native_transport_peer_death(monkeypatch):
    """Server stop must fail in-flight/subsequent calls with a transport
    status, and the client must reconnect to a revived server."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")

    async def body():
        srv = PORT.Server()
        srv.add_service(PORT.EchoSvc())
        await srv.start()
        address = srv.address
        cli = PORT.Client()
        try:
            rsp, _ = await cli.call(address, "NEcho.echo", PORT.Req(n=0))
            assert rsp.n == 1
            epoch = cli.epoch(address)
            await srv.stop()
            with pytest.raises(StatusError) as ei:
                await cli.call(address, "NEcho.echo", PORT.Req(n=0),
                               timeout=3.0)
            assert ei.value.code in (SC.RPC_SEND_FAILED,
                                     SC.RPC_CONNECT_FAILED, SC.RPC_TIMEOUT)
            # revive on the same port; the client's next call reconnects
            host, port = address.rsplit(":", 1)
            srv2 = PORT.Server(host=host, port=int(port))
            srv2.add_service(PORT.EchoSvc())
            await srv2.start()
            rsp, _ = await cli.call(address, "NEcho.echo", PORT.Req(n=7))
            assert rsp.n == 8
            assert cli.epoch(address) == epoch + 1
            await srv2.stop()
            return PORT.native.NativePump.get().stats()
        finally:
            await cli.close()
    st = run(body())
    # two round trips reached a server; the failed call reached none
    assert st["rx_frames"] == 4, st


def test_native_transport_large_frames(monkeypatch):
    """Multi-megabyte payloads cross the pump intact (partial sends and
    recv reassembly across many 256 KiB reads)."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")
    st = run(_roundtrip(n_calls=4, payload=os.urandom(8 << 20)))
    assert st["rx_frames"] == 10 and st["tx_zc_bytes"] == 8 * (8 << 20), st
    assert wire_balanced(st), st


def test_native_transport_compression(monkeypatch):
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")

    async def body():
        srv = PORT.Server(compress_threshold=1024)
        srv.add_service(PORT.EchoSvc())
        await srv.start()
        cli = PORT.Client(compress_threshold=1024)
        try:
            payload = b"A" * 200_000          # highly compressible
            rsp, p = await cli.call(srv.address, "NEcho.echo",
                                    PORT.Req(n=5), payload=payload)
            assert rsp.n == 6 and p == payload[::-1]
            return PORT.native.NativePump.get().stats()
        finally:
            await cli.close()
            await srv.stop()
    st = run(body())
    # both frames shrank below ZC_MIN on the wire, so both were staged
    assert st["rx_frames"] == 2 and st["tx_zc_bytes"] == 0, st
    assert st["rx_bytes"] < 2 * PORT.native.ZC_MIN and wire_balanced(st), st


def test_native_server_kills_conn_on_garbage(monkeypatch):
    """A peer sending garbage (bad magic / corrupt CRC) must get its
    connection dropped by the pump's C++ parser without touching other
    clients or the listener."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")

    async def body():
        srv = PORT.Server()
        srv.add_service(PORT.EchoSvc())
        await srv.start()
        cli = PORT.Client()
        try:
            host, port = srv.address.rsplit(":", 1)

            def attack(frame: bytes) -> bool:
                """Send bytes; True ONLY if the server actively closed
                on us (EOF/RST).  A TIMEOUT means the server neither
                answered nor dropped — a stalled parser FAILS here."""
                s = socket.create_connection((host, int(port)), timeout=5)
                try:
                    s.sendall(frame)
                    s.settimeout(5)
                    try:
                        return s.recv(1) == b""     # EOF = dropped
                    except socket.timeout:
                        return False                # stalled = regression
                except (ConnectionResetError, BrokenPipeError):
                    return True
                finally:
                    s.close()

            pack_header = PORT.wire.pack_header
            # bad magic
            assert await asyncio.to_thread(attack, b"GARBAGE!" * 8)
            # valid magic, corrupted header CRC
            good = pack_header(8, 0, 0, 0)
            head = good[:20] + struct.pack(
                "<I", struct.unpack("<I", good[20:])[0] ^ 0xFFFF)
            assert await asyncio.to_thread(attack, head + b"x" * 8)
            # valid header, corrupted MESSAGE CRC
            msg = b"m" * 16
            head = pack_header(len(msg), 0, 0, PORT.crc32c(msg) ^ 1)
            assert await asyncio.to_thread(attack, head + msg)
            # oversized length field (header itself is self-consistent)
            head = pack_header(1 << 30, 0, 0, 0)
            assert await asyncio.to_thread(attack, head)

            # a real client still works after all of that
            rsp, _ = await cli.call(srv.address, "NEcho.echo",
                                    PORT.Req(n=10))
            assert rsp.n == 11
            return PORT.native.NativePump.get().stats()
        finally:
            await cli.close()
            await srv.stop()
    st = run(body())
    # no garbage frame was delivered: only the one real round trip
    assert st["rx_frames"] == 2 and wire_balanced(st), st


def test_native_transport_fragmented_frames(monkeypatch):
    """Frames arriving one byte at a time must reassemble in the pump's
    staging buffer exactly like the asyncio readexactly path."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")
    wire, serde = PORT.wire, PORT.serde

    async def body():
        srv = PORT.Server()
        srv.add_service(PORT.EchoSvc())
        try:
            await srv.start()
            host, port = srv.address.rsplit(":", 1)

            pkt = wire.MessagePacket(uuid=77, method="NEcho.echo", is_req=True)
            pkt.body = PORT.Req(n=5)
            msg = serde.dumps(pkt)
            payload = b"frag"
            frame = wire.pack_header(len(msg), len(payload), 1,
                                     PORT.crc32c(msg)) + msg + payload

            def drip():
                s = socket.create_connection((host, int(port)), timeout=10)
                try:
                    for b in frame:
                        s.sendall(bytes([b]))
                    s.settimeout(10)
                    head = b""
                    while len(head) < wire.HEADER_SIZE:
                        chunk = s.recv(wire.HEADER_SIZE - len(head))
                        assert chunk, "server closed instead of replying"
                        head += chunk
                    msg_len, payload_len, _flags, _crc = wire.unpack_header(head)
                    body_b = b""
                    while len(body_b) < msg_len + payload_len:
                        chunk = s.recv(msg_len + payload_len - len(body_b))
                        assert chunk
                        body_b += chunk
                    return serde.loads(body_b[:msg_len]), body_b[msg_len:]
                finally:
                    s.close()

            rsp, rsp_payload = await asyncio.to_thread(drip)
            # a full round trip through the byte-at-a-time reassembly:
            # the ECHOED body, not merely any reply
            assert rsp.status.code == 0 and rsp.body.n == 6, rsp
            assert rsp_payload == b"garf"
            return PORT.native.NativePump.get().stats(), len(frame)
        finally:
            await srv.stop()
    st, n = run(body())
    assert st["rx_frames"] == 1 and st["rx_bytes"] == n - HEADER, st


def test_zero_copy_bulk_plane(monkeypatch):
    """Payloads at/above ZC_MIN cross the native pump WITHOUT a staging
    copy — TX pins the caller's buffer (tx_zc_bytes counts it,
    tx_staged_bytes only carries headers+small frames) and RX hands the
    payload to handlers as a memoryview over the pump's pooled buffer.
    Pins must drain once the frames are on the wire."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")
    NativePump, ZC_MIN = PORT.native.NativePump, PORT.native.ZC_MIN

    async def body():
        seen_types = []

        @t3fs_torch.net.server.service("ZCProbe")
        class Probe:
            @t3fs_torch.net.server.rpc_method
            async def sink(self, req, payload, conn):
                seen_types.append((len(payload), type(payload).__name__))
                # CRC over the zero-copy view must work w/o materializing
                return PORT.Req(n=PORT.crc32c(payload) & 0x7FFFFFFF), b""

        srv = PORT.Server()
        srv.add_service(Probe())
        await srv.start()
        cli = PORT.Client()
        try:
            big = os.urandom(1 << 20)
            small = os.urandom(256)
            r1, _ = await cli.call(srv.address, "ZCProbe.sink",
                                   PORT.Req(), payload=big)
            assert r1.n == PORT.crc32c(big) & 0x7FFFFFFF
            r2, _ = await cli.call(srv.address, "ZCProbe.sink",
                                   PORT.Req(), payload=small)
            assert r2.n == PORT.crc32c(small) & 0x7FFFFFFF

            pump = NativePump.get()
            stats = pump.stats()
            # the 1 MiB payload rode the zero-copy path, and only it...
            assert stats["tx_zc_bytes"] == len(big), stats
            # ...and was NOT staged: staged carries only headers + the
            # small frame (well under one big payload)
            assert stats["tx_staged_bytes"] < len(big) // 2, stats
            assert stats["rx_frames"] == 4 and wire_balanced(stats), stats
            # the server saw a memoryview for the big payload, bytes for
            # the small one (copy threshold)
            assert dict((n >= ZC_MIN, t) for n, t in seen_types) == {
                True: "memoryview", False: "bytes"}, seen_types
            # pins drain once the kernel is done with the buffers
            for _ in range(100):
                if pump.stats()["tx_pins"] == 0:
                    break
                await asyncio.sleep(0.02)
            assert pump.stats()["tx_pins"] == 0
        finally:
            await cli.close()
            await srv.stop()
    run(body())


def test_zero_copy_remote_buf_plane(monkeypatch):
    """RemoteBuf transfers ride the zero-copy plane: a one-sided READ
    ships the registered region's view directly (send-from-pool), and a
    one-sided WRITE lands the RX view straight into the registered
    buffer."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")

    async def body():
        reg = PORT.rdma.BufferRegistry()
        srv = PORT.Server()
        srv.add_service(reg)
        await srv.start()
        cli = PORT.Client()
        try:
            data = os.urandom(512 << 10)
            handle = reg.register(data)
            conn = await cli._get_conn(srv.address)
            assert isinstance(conn, PORT.native.NativeConnection)
            got = await PORT.rdma.remote_read(conn, handle)
            assert bytes(got) == data
            # one-sided write into a fresh registered region
            h2 = reg.register(len(data))
            await PORT.rdma.remote_write(conn, h2, data)
            assert bytes(reg.local_view(h2)) == data
            return PORT.native.NativePump.get().stats(), len(data)
        finally:
            await cli.close()
            await srv.stop()
    st, n = run(body())
    # the READ's reply and the WRITE's request, each pinned once
    assert st["rx_frames"] == 4 and st["tx_zc_bytes"] == 2 * n, st
    assert wire_balanced(st), st


# --- each package's client against the other's server -------------------------

SEED = 2024
COMPRESS = 128 << 10


def call_sequence(zc_min: int) -> list[tuple[str, int, bytes]]:
    """(method, n, payload) of the seeded sequence: payloads below, at and
    above ZC_MIN, one compressible frame past COMPRESS, one error status,
    and one 8 MiB frame (the 64 MiB class, cut to a test's size)."""
    rng = np.random.default_rng(SEED)
    sizes = (100, zc_min - 1, zc_min, 64 << 10)
    seq = [("NEcho.echo", i, rng.bytes(n)) for i, n in enumerate(sizes)]
    seq.append(("NEcho.echo", 10, b"A" * (256 << 10)))
    seq.append(("NEcho.boom", 11, b"x" * 40))
    seq.append(("NEcho.echo", 12, rng.bytes(8 << 20)))
    return seq


@pytest.mark.parametrize("client_native,server_native",
                         [(1, 1), (1, 0), (0, 1)],
                         ids=["native-native", "native-asyncio",
                              "asyncio-native"])
@pytest.mark.parametrize("cli_pkg,srv_pkg", [("port", "ref"), ("ref", "port")],
                         ids=["port-client-ref-server",
                              "ref-client-port-server"])
def test_client_against_the_other_package_server(monkeypatch, cli_pkg, srv_pkg,
                                                 client_native, server_native):
    """The seeded call sequence from one package's Client to the other
    package's Server, each end on the pump or on asyncio as asked: every
    echo comes back reversed, the error status arrives as its code, and
    each end's connections are of the transport it asked for."""
    c, s = PKGS[cli_pkg], PKGS[srv_pkg]
    seq = call_sequence(c.native.ZC_MIN)

    async def body():
        monkeypatch.setenv("T3FS_NATIVE_NET", str(server_native))
        srv = s.Server(compress_threshold=COMPRESS)
        srv.add_service(s.EchoSvc())
        await srv.start()
        monkeypatch.setenv("T3FS_NATIVE_NET", str(client_native))
        cli = c.Client(compress_threshold=COMPRESS)
        try:
            for method, n, payload in seq:
                if method == "NEcho.boom":
                    with pytest.raises(c.status.StatusError) as ei:
                        await cli.call(srv.address, method, c.Req(n=n),
                                       payload=payload)
                    assert ei.value.code == c.status.StatusCode.INVALID_ARG
                    continue
                rsp, p = await cli.call(srv.address, method, c.Req(n=n),
                                        payload=payload)
                assert rsp.n == n + 1 and bytes(p) == payload[::-1], n
            conn = cli._conns[srv.address]
            assert isinstance(conn, c.native.NativeConnection) == bool(client_native)
            assert all(isinstance(sc, s.native.NativeConnection)
                       == bool(server_native) for sc in srv._conns)
            assert len(srv._conns) == 1
            return {pkg.name: pkg.native.NativePump.get().stats()
                    for pkg, native in ((c, client_native), (s, server_native))
                    if native}
        finally:
            await cli.close()
            await srv.stop()
    pumps = run(body())
    for name, st in pumps.items():
        # each pump served one end of the one connection: every frame of
        # the sequence crossed it once, in one direction or the other
        assert st["rx_frames"] == len(seq), (name, st)


# --- the bytes each package's connections put on the wire ---------------------

T0 = 1_760_000_000.25


def read_frame(sock: socket.socket) -> bytes | None:
    """One whole frame off a blocking socket (None at EOF)."""
    def exactly(n: int) -> bytes | None:
        buf = bytearray()
        while len(buf) < n:
            chunk = sock.recv(min(n - len(buf), 1 << 20))
            if not chunk:
                return None
            buf += chunk
        return bytes(buf)
    head = exactly(HEADER)
    if head is None:
        return None
    msg_len, payload_len, _, _ = REF.wire.unpack_header(head)
    body = exactly(msg_len + payload_len) if msg_len + payload_len else b""
    return head + body


def parse_frame(frame: bytes) -> tuple[object, bytes, int]:
    """(packet, payload, flags) of a captured frame, inflated if needed."""
    msg_len, _, flags, _ = REF.wire.unpack_header(frame[:HEADER])
    msg, payload = frame[HEADER:HEADER + msg_len], frame[HEADER + msg_len:]
    if flags & REF.wire.FLAG_COMPRESS:
        msg, payload = REF.wire.decompress_frame(msg, payload, flags)
    return REF.serde.loads(msg), payload, flags


def request_frames(seq) -> list[bytes]:
    """The seeded sequence as request frames, as a peer's client sends them."""
    frames = []
    for uuid, (method, n, payload) in enumerate(seq, start=1):
        pkt = REF.wire.MessagePacket(uuid=uuid, method=method, is_req=True,
                                     ts_client_called=T0)
        pkt.body = REF.Req(n=n)
        msg = REF.serde.dumps(pkt)
        frames.append(REF.wire.pack_header(
            len(msg), len(payload), REF.wire.FLAG_IS_REQ,
            REF.crc32c(msg)) + msg + payload)
    return frames


def answer(frame: bytes) -> bytes:
    """A server's reply to a captured request: the echo, or an error."""
    pkt, payload, _ = parse_frame(frame)
    rsp = REF.wire.MessagePacket(uuid=pkt.uuid, method=pkt.method, is_req=False)
    if pkt.method == "NEcho.boom":
        rsp.status = REF.wire.WireStatus(int(SC.INVALID_ARG), "boom")
        payload = b""
    else:
        rsp.body = REF.Req(n=pkt.body.n + 1)
        payload = bytes(payload)[::-1]
    msg = REF.serde.dumps(rsp)
    return REF.wire.pack_header(len(msg), len(payload), 0,
                                REF.crc32c(msg)) + msg + payload


async def open_conn(p, native: bool, sock: socket.socket, dispatcher):
    sock.setblocking(False)
    if native:
        conn = p.native.NativeConnection(
            sock, p.native.NativePump.get(), dispatcher, name="capture",
            compress_threshold=COMPRESS)
    else:
        reader, writer = await asyncio.open_connection(sock=sock)
        conn = p.conn.Connection(reader, writer, dispatcher, name="capture",
                                 compress_threshold=COMPRESS)
    conn.start()
    return conn


async def capture(p, native: bool, side: str) -> tuple[list[bytes], dict | None]:
    """The frames `p`'s connection (native or asyncio) writes on a socket
    pair whose other end is a raw socket: as the client of the seeded call
    sequence (side "client"), or as the server of the seeded request frames
    (side "server").  Returns them with the pump's counters."""
    seq = call_sequence(p.native.ZC_MIN)
    mine, peer = socket.socketpair()
    peer.settimeout(30)
    written: list[bytes] = []
    if side == "client":
        conn = await open_conn(p, native, mine, None)

        def serve():
            for _ in seq:
                frame = read_frame(peer)
                written.append(frame)
                peer.sendall(answer(frame))
        served = asyncio.create_task(asyncio.to_thread(serve))
        for method, n, payload in seq:
            try:
                await conn.call(method, p.Req(n=n), payload)
            except p.status.StatusError as e:
                assert e.code == p.status.StatusCode.INVALID_ARG
        await served
    else:
        conn = await open_conn(p, native, mine, p.dispatcher(p.EchoSvc()))

        def drive():
            for frame in request_frames(seq):
                peer.sendall(frame)
                written.append(read_frame(peer))
        await asyncio.to_thread(drive)
    stats = p.native.NativePump.get().stats() if native else None
    await conn.close()
    peer.close()
    return written, stats


@pytest.mark.parametrize("side", ["client", "server"])
def test_both_packages_write_the_same_frames(monkeypatch, side):
    """The seeded sequence through each package's NativeConnection and
    asyncio Connection, as a client (requests) and as a server (replies,
    one of them an error status), with the clock and the uuid counters
    pinned: the four byte streams are equal, frame for frame, and the two
    pumps' counters are equal."""
    import time
    monkeypatch.setattr(time, "time", lambda: T0)
    runs = {}
    for name, p in PKGS.items():
        for native in (True, False):
            monkeypatch.setattr(p.conn.Connection, "_uuid_counter",
                                itertools.count(1))
            runs[(name, native)] = run(capture(p, native, side))
    frames, stats = runs[("port", True)]
    for key, (other, other_stats) in runs.items():
        assert len(other) == len(frames), key
        for i, (a, b) in enumerate(zip(frames, other)):
            assert a == b, (key, i, len(a), len(b))
    assert stats == runs[("ref", True)][1]
    seq = call_sequence(PORT.native.ZC_MIN)
    assert stats["rx_frames"] == len(seq) and stats["tx_pins"] == 0, stats
    # what the sequence was built to hold: frames below and at or above
    # ZC_MIN, one compressed, one error status, the 8 MiB one pinned
    parsed = [parse_frame(f) for f in frames]
    lengths = [len(payload) for _, payload, _ in parsed]
    assert min(lengths) < PORT.native.ZC_MIN <= max(lengths)
    assert [bool(f & PORT.wire.FLAG_COMPRESS) for _, _, f in parsed].count(True) == 1
    assert stats["tx_zc_bytes"] >= 8 << 20
    if side == "server":
        assert [pkt.status.code for pkt, _, _ in parsed].count(
            int(SC.INVALID_ARG)) == 1
        assert all(pkt.ts_server_replied == T0 for pkt, _, _ in parsed)


# --- a storage cluster over the pump -------------------------------------------

CHAIN_CHUNK = 256 << 10
CHAIN_BYTES = 3 * CHAIN_CHUNK + 12345


def _stored(fab) -> list:
    """Every chunk on every target: its ChunkMeta fields and its bytes."""
    out = []
    for node in fab.nodes:
        for tid in sorted(node.targets):
            engine = node.targets[tid].engine
            for meta in sorted(engine.all_metas(),
                               key=lambda m: m.chunk_id.encode()):
                out.append((tid, meta.chunk_id.encode(), meta.length,
                            meta.update_ver, meta.commit_ver, meta.chain_ver,
                            meta.checksum, int(meta.state),
                            engine.read(meta.chunk_id)))
    return out


def _over_pump(p, fab) -> dict:
    """The pump's counters, after checking that the fabric's connections
    ride it."""
    conns = [c for srv in fab.servers for c in srv._conns]
    conns += [c for c in fab.client._conns.values()]
    assert conns and all(isinstance(c, p.native.NativeConnection)
                         for c in conns), conns
    return p.native.NativePump.get().stats()


async def chain_record(p) -> dict:
    fab = p.fabric.StorageFabric(num_nodes=3, replicas=3,
                                 checksum_backend="cpu")
    await fab.start()
    sc = p.sc.StorageClient(lambda: fab.routing, client=fab.client)
    try:
        data = np.random.default_rng(SEED + 1).bytes(CHAIN_BYTES)
        lay = p.layout.FileLayout(chunk_size=CHAIN_CHUNK, chains=[fab.chain_id])
        results = await sc.write_file_range(lay, inode=7, offset=0, data=data)
        got, _ = await sc.read_file_range(lay, 7, 0, len(data))
        assert got == data
        return {"results": [(r.status.code, r.length, r.update_ver,
                             r.commit_ver, r.checksum) for r in results],
                "stored": _stored(fab), "pump": _over_pump(p, fab)}
    finally:
        await sc.close()
        await fab.stop()


def test_chain_write_over_the_pump_equals_reference(monkeypatch):
    """A 3-replica CRAQ write and read of a seeded file through each
    package's StorageFabric and StorageClient with T3FS_NATIVE_NET=1:
    every replica holds the same bytes and ChunkMeta in both packages."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")
    ref = run(chain_record(REF))
    port = run(chain_record(PORT))
    assert port["results"] == ref["results"]
    assert port["stored"] == ref["stored"]
    assert len(port["stored"]) == 3 * -(-CHAIN_BYTES // CHAIN_CHUNK)
    assert all(c[6] == PORT.crc32c(c[8]) for c in port["stored"])
    # the payloads rode the zero-copy plane in both packages
    for st in (ref["pump"], port["pump"]):
        assert st["rx_frames"] > 0 and st["tx_zc_bytes"] >= 3 * CHAIN_BYTES, st


async def stripe_record(name: str) -> dict:
    if name == "ref":
        from t3fs.client.ec_client import ECLayout, ECStorageClient
        from t3fs.client.ec_codec import ECCodec
        p, codec = REF, ECCodec()
    else:
        from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
        from t3fs_torch.client.ec_codec import TorchECCodec
        p, codec = PORT, TorchECCodec(device="cpu")
    fab = p.fabric.StorageFabric(num_nodes=5, replicas=1, num_chains=10,
                                 checksum_backend="cpu")
    await fab.start()
    sc = p.sc.StorageClient(lambda: fab.routing, client=fab.client)
    ec = ECStorageClient(sc, codec=codec)
    try:
        lay = ECLayout.create(k=8, m=2, chunk_size=16 << 10,
                              chains=fab.chain_ids)
        data = np.random.default_rng(SEED + 2).bytes(8 * (16 << 10))
        writes = await ec.write_stripe(lay, 9, 0, data)
        rec = {"writes": [(r.status.code, r.length, r.checksum)
                          for r in writes],
               "stored": _stored(fab),
               "codec": {k.split("-", 1)[1]: v
                         for k, v in codec.codec_counts.items()},
               "pump": _over_pump(p, fab)}
        if name == "port":
            # the reference's read_stripe raises over its own pump: its
            # zero-copy shards are memoryviews, which have no ljust
            assert await ec.read_stripe(lay, 9, 0, len(data)) == data
        return rec
    finally:
        await ec.close()
        await sc.close()
        await fab.stop()


def test_ec_stripe_over_the_pump_equals_reference(monkeypatch):
    """One RS(8+2) stripe written through each package's ECStorageClient
    over its StorageFabric with T3FS_NATIVE_NET=1 (the port on the plain
    codec): equal stored shards, ChunkMeta and codec counts, the route
    names aside of their package prefix; the port reads the stripe back
    over the pump."""
    monkeypatch.setenv("T3FS_NATIVE_NET", "1")
    # the reference's Pallas kernels interpreted, as tests/test_ckpt.py
    # runs them: its encode takes the words route, the port's B2
    monkeypatch.setenv("T3FS_FORCE_PALLAS_INTERPRET", "1")
    ref = run(stripe_record("ref"))
    port = run(stripe_record("port"))
    assert port["writes"] == ref["writes"]
    assert port["stored"] == ref["stored"] and len(port["stored"]) == 10
    assert port["codec"] == ref["codec"] and port["codec"], port["codec"]
    assert port["pump"]["rx_frames"] == ref["pump"]["rx_frames"] > 0


# --- the pump's source and the host library's build ----------------------------

def _code(path: Path) -> list[str]:
    """The source's lines without its comments."""
    out = []
    for line in path.read_text().splitlines():
        line = re.sub(r"//.*", "", line).rstrip()
        if line:
            out.append(line)
    return out


def test_pump_source_is_the_reference_code():
    """csrc/net_pump.cpp is t3fs/native/net_pump.cpp line for line, its
    comments aside: the frame format, the RX high-water mark, the
    user_data encoding and the exported t3fs_pump_* ABI are the
    reference's; and the host library builds it."""
    from t3fs_torch.ops import _build

    assert _code(_build.SRC_DIR / "net_pump.cpp") == \
        _code(ROOT / "t3fs" / "native" / "net_pump.cpp")
    assert "net_pump.cpp" in _build.HOST_SOURCES
    lib = _build.host_library()
    for fn in ("create", "eventfd", "add", "send", "send2", "tx_depth",
               "poll", "free", "free2", "stats", "close", "destroy"):
        assert hasattr(lib, f"t3fs_pump_{fn}"), fn


@pytest.mark.parametrize("mode", ["", "thread", "address", "memory"])
def test_sanitize_switch(monkeypatch, mode):
    """T3FS_SANITIZE=thread|address builds the host library at -O1 with
    that sanitizer and frame pointers, under a name of its own; empty
    builds the usual one; any other value raises ValueError."""
    from t3fs_torch.ops import _build

    monkeypatch.delenv("T3FS_SANITIZE", raising=False)
    plain = _build._host_target()
    monkeypatch.setenv("T3FS_SANITIZE", mode)
    if mode == "memory":
        with pytest.raises(ValueError, match="'thread' or 'address'"):
            _build.host_flags()
        with pytest.raises(ValueError):
            _build._host_target()
        return
    flags, name = _build.host_flags()
    if not mode:
        assert flags == _build.HOST_CXX_FLAGS and _build._host_target() == plain
        return
    assert "-O2" not in flags and "-O1" in flags
    assert flags[-2:] == (f"-fsanitize={mode}", "-fno-omit-frame-pointer")
    target = _build._host_target()
    assert target != plain and target.name.startswith(f"lib{name}-")
    assert name == f"{_build.HOST_LIB}.{mode[0]}san"


# --- chip_smoke.py's probe and phase 34, rehearsed on the CPU -----------------

def test_chip_smoke_phase_34_on_the_cpu(monkeypatch, capsys):
    """chip_smoke.py's pump probe and phase 34 at a small size on the CPU
    (the checksum backends run B1's plain version, so no launch counts):
    here the probe says "available" and the chain pass runs over the pump,
    then over asyncio, every byte and CRC checked.  With every new pump
    refused, the probe names the refusal and the refused branch proves the
    fast OSError, RPC_CONNECT_FAILED and the asyncio call after it; the
    switch is as it was after each."""
    import torch

    import chip_smoke as cs
    from torch_net_refused import refuse_pump

    monkeypatch.delenv("T3FS_NATIVE_NET", raising=False)
    assert cs.net_probe() == "available"
    launches = cs.phase_net(torch.device("cpu"), file_bytes=4 * (256 << 10),
                            chunk_bytes=256 << 10)
    assert launches and not any(launches.values()), launches
    out = capsys.readouterr().out
    assert "[0] native net: available" in out
    assert "[34] pump:" in out and "[34] asyncio:" in out
    assert "T3FS_NATIVE_NET" not in os.environ

    monkeypatch.setenv("T3FS_NATIVE_NET", "0")
    refuse_pump(monkeypatch)
    answer = cs.net_probe()
    assert answer.startswith("refused: t3fs_pump_create"), answer
    cs.phase_net_refused(answer)
    out = capsys.readouterr().out
    assert f"[34] not run: {answer}" in out
    assert "raised OSError (t3fs_pump_create failed" in out
    assert "a Client call raised RPC_CONNECT_FAILED" in out
    assert os.environ["T3FS_NATIVE_NET"] == "0"
