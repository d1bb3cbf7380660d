"""RPC server: service registry + listener.

Reference analogs: common/net/Server.h:19-41, ServiceGroup.h:20-38 (services
registered on a server), Processor dispatch.  Services are classes whose
@rpc_method coroutines take (req_body, payload, conn) and return
(rsp_body, rsp_payload).
"""

from __future__ import annotations

import asyncio
import logging
import os
from typing import Any

from t3fs_torch.net.conn import Connection, Handler

log = logging.getLogger("t3fs_torch.net")


def refuse_native_net() -> None:
    """Raise while T3FS_NATIVE_NET=1.  The reference reads that switch per
    connection (t3fs/net/native_conn.py native_enabled) and then runs its
    io_uring frame pump; the port has no pump yet, so it refuses the switch
    rather than run its asyncio transport under it."""
    if os.environ.get("T3FS_NATIVE_NET") == "1":
        raise NotImplementedError(
            "T3FS_NATIVE_NET=1 asks for the io_uring frame pump "
            "(net/native_conn.py), which the port has not ported yet "
            "(ROADMAP A12d)")


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

    def add_service(self, svc: Any) -> None:
        self.dispatcher.update(build_dispatcher(svc))

    async def start(self) -> None:
        refuse_native_net()
        self._server = await asyncio.start_server(self._on_conn, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        log.info("server listening on %s:%d (%d methods)",
                 self.host, self.port, len(self.dispatcher))

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
        # drain until empty: a connection accepted during shutdown may be
        # registered after a one-shot snapshot would have been taken
        while self._conns:
            await next(iter(self._conns)).close()
        if self._server:
            await self._server.wait_closed()

    @property
    def address(self) -> str:
        return f"{self.host}:{self.port}"
