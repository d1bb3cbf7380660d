"""RPC server: service registry + listener.

Reference analogs: common/net/Server.h:19-41, ServiceGroup.h:20-38 (services
registered on a server), Processor dispatch.  Services are classes whose
@rpc_method coroutines take (req_body, payload, conn) and return
(rsp_body, rsp_payload).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Any

from t3fs_torch.net.conn import Connection, Handler

log = logging.getLogger("t3fs_torch.net")


def rpc_method(fn):
    """Mark a coroutine method as RPC-exposed."""
    fn.__rpc_method__ = True
    return fn


def service(name: str):
    """Class decorator: set the wire service name."""
    def deco(cls):
        cls.__service_name__ = name
        return cls
    return deco


def build_dispatcher(*services: Any) -> dict[str, Handler]:
    """Collect {Service.method: bound coroutine} from service objects."""
    table: dict[str, Handler] = {}
    for svc in services:
        sname = getattr(type(svc), "__service_name__", type(svc).__name__)
        for attr in dir(svc):
            fn = getattr(svc, attr)
            if callable(fn) and getattr(fn, "__rpc_method__", False):
                table[f"{sname}.{attr}"] = fn
    return table


class Server:
    """Asyncio TCP server hosting a set of serde services."""

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 compress_threshold: int = 0):
        self.host = host
        self.port = port
        self.compress_threshold = compress_threshold
        self.dispatcher: dict[str, Handler] = {}
        self._server: asyncio.AbstractServer | None = None
        self._conns: set[Connection] = set()
        self._lsock = None                    # native-transport listener
        self._accept_task: asyncio.Task | None = None

    def add_service(self, svc: Any) -> None:
        self.dispatcher.update(build_dispatcher(svc))

    async def start(self) -> None:
        from t3fs_torch.net.native_conn import native_enabled
        if native_enabled():
            await self._start_native()
            return
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("server listening on %s:%d (%d methods)",
                 self.host, self.port, len(self.dispatcher))

    async def _start_native(self) -> None:
        """Accept on a raw socket and hand every connection to the
        io_uring frame pump (net/native_conn.py) — accepting via
        asyncio streams and stealing the fd would race the transport's
        first read."""
        import socket as _socket

        from t3fs_torch.net.native_conn import NativePump
        # fail FAST if io_uring is unavailable (e.g. a seccomp profile
        # blocking it): raising here surfaces at Server.start() instead
        # of killing the accept loop on the first inbound connection
        NativePump.get()
        s = _socket.socket(_socket.AF_INET, _socket.SOCK_STREAM)
        s.setsockopt(_socket.SOL_SOCKET, _socket.SO_REUSEADDR, 1)
        s.bind((self.host, self.port))
        s.listen(256)
        s.setblocking(False)
        self._lsock = s
        self.port = s.getsockname()[1]
        self._accept_task = asyncio.create_task(
            self._accept_loop(), name=f"accept-{self.port}")
        log.info("server (native transport) listening on %s:%d (%d methods)",
                 self.host, self.port, len(self.dispatcher))

    async def _accept_loop(self) -> None:
        import socket as _socket

        from t3fs_torch.net.native_conn import NativeConnection, NativePump
        loop = asyncio.get_running_loop()
        while True:
            try:
                sock, peer = await loop.sock_accept(self._lsock)
            except asyncio.CancelledError:
                return          # stop() cancelled the accept loop
            except OSError:
                return          # listener closed under us
            try:
                sock.setsockopt(_socket.IPPROTO_TCP,
                                _socket.TCP_NODELAY, 1)
                conn = NativeConnection(
                    sock, NativePump.get(), self.dispatcher,
                    name=f"srv<-{peer}", on_close=self._conns.discard,
                    compress_threshold=self.compress_threshold)
                conn.local_address = self.address
                self._conns.add(conn)
                conn.start()
            except Exception:
                # a per-connection failure must not kill the listener
                log.exception("native accept of %s failed", peer)
                sock.close()

    async def _on_conn(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        peer = writer.get_extra_info("peername")
        conn = Connection(reader, writer, self.dispatcher, name=f"srv<-{peer}",
                          on_close=self._conns.discard,
                          compress_threshold=self.compress_threshold)
        # server spans carry the serving node's address (tracing)
        conn.local_address = self.address
        self._conns.add(conn)
        conn.start()

    async def stop(self) -> None:
        # close live connections BEFORE wait_closed(): since 3.12,
        # Server.wait_closed() blocks until every connection transport is
        # closed, so the old order deadlocks while clients stay connected
        if self._server:
            self._server.close()
        if self._accept_task is not None:
            self._accept_task.cancel()
            try:
                await self._accept_task
            except asyncio.CancelledError:
                pass
        if self._lsock is not None:
            self._lsock.close()
        # drain until empty: a connection accepted during shutdown may be
        # registered after a one-shot snapshot would have been taken
        while self._conns:
            await next(iter(self._conns)).close()
        if self._server:
            await self._server.wait_closed()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"
