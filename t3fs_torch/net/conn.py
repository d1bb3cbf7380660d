"""Duplex framed connection: waiter table + request dispatch, both directions.

Reference analogs: common/net/Transport.h:22 (connection object),
common/net/Processor.h:28-50 (decode -> dispatch), common/net/Waiter
(uuid -> coroutine wakeup).  Unlike the reference's client->server-only RPC
plus one-sided RDMA verbs, a t3fs connection lets EITHER side issue requests:
that is the TCP emulation of RDMA READ/WRITE (see net/__init__ docstring).
"""

from __future__ import annotations

import asyncio
import itertools
import logging
import time
from typing import Awaitable, Callable

from t3fs_torch.net.wire import (
    HEADER_SIZE, FLAG_COMPRESS, FLAG_IS_REQ, FrameError, MessagePacket,
    WireStatus, check_msg_crc, decompress_frame, maybe_compress, pack_header,
    unpack_header,
)
from t3fs_torch.net.rpcstats import RPC_STATS, SERVER_STATS
from t3fs_torch.ops.codec import crc32c
from t3fs_torch.utils import serde, tracing
from t3fs_torch.utils.status import Status, StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.net")

# handler(body, payload, conn) -> (rsp_body, rsp_payload)
Handler = Callable[[object, bytes, "Connection"], Awaitable[tuple[object, bytes]]]


class Connection:
    """One duplex framed stream; safe for concurrent calls."""

    _uuid_counter = itertools.count(1)

    def __init__(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter,
                 dispatcher: dict[str, Handler] | None = None, name: str = "?",
                 on_close: Callable[["Connection"], None] | None = None,
                 compress_threshold: int = 0, compress_level: int = 1):
        self.reader = reader
        self.writer = writer
        self.dispatcher = dispatcher if dispatcher is not None else {}
        self.name = name
        self.on_close = on_close
        # outbound frames >= threshold bytes ship zlib-compressed
        # (UseCompress analog); 0 disables.  Inbound compressed frames are
        # always understood regardless of this setting.
        self.compress_threshold = compress_threshold
        self.compress_level = compress_level
        # serving address, set by Server on accepted conns: tags server
        # spans with the node that ran the handler (multi-node-in-one-
        # process fabrics can't use a global for this)
        self.local_address = ""
        self._waiters: dict[int, asyncio.Future] = {}
        self._send_lock = asyncio.Lock()
        self._closed = False
        self._loop_task: asyncio.Task | None = None
        # asyncio holds only weak refs to tasks; keep handlers alive here
        self._tasks: set[asyncio.Task] = set()

    def start(self) -> None:
        self._loop_task = asyncio.create_task(self._read_loop(), name=f"conn-{self.name}")

    @property
    def closed(self) -> bool:
        return self._closed

    def _spawn(self, coro, name: str) -> asyncio.Task:
        task = asyncio.create_task(coro, name=name)
        self._tasks.add(task)
        task.add_done_callback(self._tasks.discard)
        return task

    async def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._loop_task:
            self._loop_task.cancel()
        if self.on_close is not None:
            try:
                self.on_close(self)
            except Exception:
                pass
        try:
            self.writer.close()
            await self.writer.wait_closed()
        except Exception:
            pass
        err = make_error(StatusCode.RPC_SEND_FAILED, f"connection {self.name} closed")
        for fut in self._waiters.values():
            if not fut.done():
                fut.set_exception(err)
                # the awaiting call() may itself have been cancelled (loop
                # teardown): mark the exception retrieved so asyncio doesn't
                # log "Future exception was never retrieved"; a live awaiter
                # still receives it normally
                fut.exception()
        self._waiters.clear()

    # frames past this size compress/decompress in a worker thread so a
    # multi-MiB zlib pass never stalls the event loop (heartbeats, other
    # conns); below it the thread hop costs more than the compression
    OFFLOAD_BYTES = 1 << 20

    async def _prep_frame(self, packet: MessagePacket, payload: bytes,
                          flags: int) -> tuple[bytes, bytes, bytes]:
        """Serde + (optional) compression + envelope CRC + header —
        everything byte-identical between the asyncio and native
        transports, shared so the wire formats can never diverge.
        Returns (header, msg, payload)."""
        msg = serde.dumps(packet)
        if self.compress_threshold > 0:
            if len(msg) + len(payload) >= self.OFFLOAD_BYTES:
                msg, payload, zflag = await asyncio.to_thread(
                    maybe_compress, msg, payload,
                    self.compress_threshold, self.compress_level)
            else:
                msg, payload, zflag = maybe_compress(
                    msg, payload, self.compress_threshold,
                    self.compress_level)
            flags |= zflag
        # envelope CRC (post-compression bytes); off-thread for big
        # envelopes so the CRC pass never stalls the loop either
        if len(msg) >= self.OFFLOAD_BYTES:
            mcrc = await asyncio.to_thread(crc32c, msg)
        else:
            mcrc = crc32c(msg) if msg else 0
        return pack_header(len(msg), len(payload), flags, mcrc), msg, payload

    async def _send_frame(self, packet: MessagePacket, payload: bytes, flags: int) -> None:
        head, msg, payload = await self._prep_frame(packet, payload, flags)
        # frame atomicity: header+payload must hit the stream without
        # interleaving, so drain() deliberately runs under the lock
        async with self._send_lock:  # t3fslint: allow(async-lock-await-discipline)
            if self._closed:
                raise make_error(StatusCode.RPC_SEND_FAILED, "connection closed")
            try:
                # ONE buffer -> ONE send syscall: separate write() calls
                # each attempt an immediate send when the transport buffer
                # is empty, tripling the syscall count per frame (profiled
                # at ~30% of client CPU on the multi-process path).  Big
                # payloads are worth a copy-free second write.
                if payload and len(payload) > 64 << 10:
                    self.writer.write(head + msg)
                    self.writer.write(payload)
                elif payload and not isinstance(payload, bytes):
                    # forwarded zero-copy RX memoryview: bytes.__add__
                    # rejects it, so ship it as a second write
                    self.writer.write(head + msg)
                    self.writer.write(payload)
                else:
                    self.writer.write(head + msg + payload)
                await self.writer.drain()
            except (OSError, asyncio.IncompleteReadError) as e:
                raise make_error(StatusCode.RPC_SEND_FAILED,
                                 f"send on {self.name}: {e}") from None

    def _stamp_trace(self, packet: MessagePacket) -> None:
        """Propagate the active span's context onto the envelope.  When no
        span is active (head sampling said no, or tracing is off) the
        fields keep their serde defaults — zero extra state on the wire."""
        sp = tracing.current_span()
        if sp is not None:
            packet.trace_id = sp.trace_id
            packet.parent_span_id = sp.span_id
            packet.sampled = True

    async def post(self, method: str, body: object = None,
                   payload: bytes = b"") -> None:
        """One-way request: uuid 0 means the peer runs the handler but
        sends no response frame, and none is awaited here.  Carries the
        bulk frames of an UPDATE_FRAG stream, whose failures surface on
        the stream's windowed call()s / final update RPC instead.  (The
        uuid counter starts at 1, so 0 can never collide with a waiter.)"""
        packet = MessagePacket(uuid=0, method=method, is_req=True).stamp_called()
        packet.body = body
        self._stamp_trace(packet)
        await self._send_frame(packet, payload, FLAG_IS_REQ)

    async def call(self, method: str, body: object = None, payload: bytes = b"",
                   timeout: float = 30.0) -> tuple[object, bytes]:
        """Issue a request, await the typed response (+ raw payload).
        Raises StatusError on non-OK response or transport failure."""
        uuid = next(self._uuid_counter)
        packet = MessagePacket(uuid=uuid, method=method, is_req=True).stamp_called()
        packet.body = body
        self._stamp_trace(packet)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._waiters[uuid] = fut
        try:
            await self._send_frame(packet, payload, FLAG_IS_REQ)
            try:
                rsp, rsp_payload = await asyncio.wait_for(fut, timeout)
            except asyncio.TimeoutError:
                raise make_error(StatusCode.RPC_TIMEOUT,
                                 f"{method} timed out after {timeout}s") from None
            if rsp.ts_server_replied:
                # latency decomposition (rpcstats module docstring);
                # squeue/server are same-clock server intervals, network
                # is the clock-skew-free remainder
                total = time.time() - packet.ts_client_called
                server_span = rsp.ts_server_replied - rsp.ts_server_received
                started = rsp.ts_server_started or rsp.ts_server_received
                RPC_STATS.record(
                    method, total,
                    squeue=started - rsp.ts_server_received,
                    server=rsp.ts_server_replied - started,
                    network=max(0.0, total - server_span),
                    ok=rsp.status.code == int(StatusCode.OK))
            status = rsp.status.to_status()
            status.raise_if_error()
            return rsp.body, rsp_payload
        finally:
            self._waiters.pop(uuid, None)

    async def _read_loop(self) -> None:
        try:
            while True:
                head = await self.reader.readexactly(HEADER_SIZE)
                msg_len, payload_len, flags, msg_crc = unpack_header(head)
                msg = await self.reader.readexactly(msg_len) if msg_len else b""
                payload = await self.reader.readexactly(payload_len) if payload_len else b""
                if flags & FLAG_COMPRESS:
                    # always off-thread: on-wire size says nothing about
                    # decompressed size (a zeros-heavy 256 MiB frame can
                    # arrive <1 MiB), and the hop is cheap vs any zlib pass
                    def _verify_inflate(m=msg, p=payload, f=flags, c=msg_crc):
                        check_msg_crc(m, c)   # CRC covers on-wire bytes
                        return decompress_frame(m, p, f)
                    msg, payload = await asyncio.to_thread(_verify_inflate)
                elif msg_len >= self.OFFLOAD_BYTES:
                    await asyncio.to_thread(check_msg_crc, msg, msg_crc)
                else:
                    check_msg_crc(msg, msg_crc)
                self._dispatch_packet(serde.loads(msg), payload)
        except (asyncio.IncompleteReadError, ConnectionResetError, BrokenPipeError):
            pass
        except asyncio.CancelledError:
            raise
        except FrameError as e:
            log.warning("conn %s: frame error: %s", self.name, e)
        except Exception:
            log.exception("conn %s: read loop died", self.name)
        finally:
            if not self._closed:
                self._spawn(self.close(), f"close-{self.name}")

    def _dispatch_packet(self, packet: MessagePacket,
                         payload: bytes) -> None:
        """Post-decode dispatch shared by the asyncio read loop and the
        native-pump path: spawn the handler for requests (stamping the
        receive time), wake the waiter for responses."""
        if packet.is_req:
            self._spawn(self._handle_request(packet, payload, time.time()),
                        f"req-{packet.method}")
        else:
            fut = self._waiters.get(packet.uuid)
            if fut is not None and not fut.done():
                fut.set_result((packet, payload))

    async def _handle_request(self, packet: MessagePacket, payload: bytes,
                              recv_ts: float = 0.0) -> None:
        rsp = MessagePacket(uuid=packet.uuid, method=packet.method, is_req=False)
        rsp.ts_server_received = recv_ts or time.time()
        rsp.ts_server_started = time.time()   # gap = server-side queueing
        rsp_payload = b""
        handler = self.dispatcher.get(packet.method)
        if packet.sampled and packet.trace_id:
            # server span: the handler (and anything it calls, including
            # downstream RPCs) runs inside it.  wire_s spans both clocks
            # (skew rides in it); queue_s is same-clock loop queueing.
            scope = tracing.server_scope(
                packet.method, packet.trace_id, packet.parent_span_id,
                addr=self.local_address,
                wire_s=max(0.0, rsp.ts_server_received - packet.ts_client_called),
                queue_s=rsp.ts_server_started - rsp.ts_server_received)
        else:
            scope = tracing.server_scope(packet.method, 0, 0)   # no-op
        with scope as sp:
            try:
                if handler is None:
                    raise make_error(StatusCode.RPC_METHOD_NOT_FOUND, packet.method)
                rsp.body, rsp_payload = await handler(packet.body, payload, self)
            except StatusError as e:
                rsp.status = WireStatus.from_status(e.status)
                sp.set_status(int(e.status.code))
            except Exception as e:
                log.exception("handler %s failed", packet.method)
                rsp.status = WireStatus(int(StatusCode.INTERNAL), f"{type(e).__name__}: {e}")
                sp.set_status(int(StatusCode.INTERNAL))
        rsp.ts_server_replied = time.time()
        # serving-side per-method stats: unlike the client-side record in
        # call() (which attributes latency to the CALLER's process), this
        # lands in the process that served the request — the per-node
        # signal the monitor's health rollups fold (t3fs/monitor/rollup.py)
        SERVER_STATS.record(
            packet.method, rsp.ts_server_replied - rsp.ts_server_received,
            squeue=rsp.ts_server_started - rsp.ts_server_received,
            server=rsp.ts_server_replied - rsp.ts_server_started,
            network=0.0, ok=rsp.status.code == int(StatusCode.OK))
        if packet.uuid == 0:
            return  # one-way post(): no response frame (errors logged above)
        try:
            await self._send_frame(rsp, rsp_payload, 0)
        except Exception:
            pass  # peer gone; response dropped like a lost ack
