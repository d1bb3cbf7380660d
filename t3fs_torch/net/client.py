"""RPC client with per-address connection pooling.

Reference analogs: common/net/Client.h:16, TransportPool (per-peer pooling),
serde ClientContext::call (common/serde/ClientContext.h:40).  The client may
also register local services (e.g. the buffer service that lets storage
servers pull/push bulk data — the RDMA emulation).
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any

from t3fs_torch.net.conn import Connection
from t3fs_torch.net.rpcstats import READ_STATS
from t3fs_torch.net.server import build_dispatcher, refuse_native_net
from t3fs_torch.utils import tracing
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.net")


class Client:
    def __init__(self, connect_timeout: float = 5.0,
                 compress_threshold: int = 0):
        self.connect_timeout = connect_timeout
        self.compress_threshold = compress_threshold
        self.dispatcher: dict = {}
        self._conns: dict[str, Connection] = {}
        self._locks: dict[str, asyncio.Lock] = {}
        # bumped on every NEW connection to an address: callers that
        # memoize per-peer negotiated state (e.g. the storage client's
        # packed-wire version) scope it to the epoch, so a server
        # restart — possibly a ROLLBACK to an older binary — forces
        # re-negotiation instead of mis-parsing
        self._epochs: dict[str, int] = {}

    def add_service(self, svc: Any) -> None:
        """Expose a local service to servers (reverse-direction RPC)."""
        self.dispatcher.update(build_dispatcher(svc))

    async def _get_conn(self, address: str) -> Connection:
        conn = self._conns.get(address)
        if conn is not None and not conn.closed:
            return conn
        lock = self._locks.setdefault(address, asyncio.Lock())
        async with lock:
            conn = self._conns.get(address)
            if conn is not None and not conn.closed:
                return conn
            refuse_native_net()
            host, port = address.rsplit(":", 1)
            try:
                reader, writer = await asyncio.wait_for(
                    asyncio.open_connection(host, int(port)), self.connect_timeout)
            except (OSError, asyncio.TimeoutError) as e:
                raise make_error(StatusCode.RPC_CONNECT_FAILED,
                                 f"connect {address}: {e}") from None
            conn = Connection(reader, writer, self.dispatcher,
                              name=f"cli->{address}",
                              compress_threshold=self.compress_threshold)
            conn.start()
            self._conns[address] = conn
            self._epochs[address] = self._epochs.get(address, 0) + 1
            return conn

    def epoch(self, address: str) -> int:
        """Connection generation for address (0 = never connected).
        When the current connection is closed/absent, returns the epoch
        the NEXT call will establish — so a caller checking its memo
        BEFORE a call already sees the stale-ness of state negotiated on
        the dead connection."""
        n = self._epochs.get(address, 0)
        conn = self._conns.get(address)
        if conn is None or conn.closed:
            return n + 1
        return n

    async def call(self, address: str, method: str, body: object = None,
                   payload: bytes = b"", timeout: float = 30.0,
                   stats_method: str | None = None) -> tuple[object, bytes]:
        # stats_method: name reported to READ_STATS when it differs from
        # the wire method — ring write batches share Storage.ring_rw on
        # the wire but must not feed the adaptive READ latency estimate
        conn = await self._get_conn(address)
        # per-ADDRESS in-flight/latency tracker behind the adaptive read
        # path (READ_STATS keeps latency for read methods only; in-flight
        # counts every RPC as load).  Begins after connect so a refused
        # connection never inflates the gauge.
        READ_STATS.begin(address)
        t0 = time.monotonic()
        ok = False
        nbytes = 0
        try:
            # per-hop client span (no-op scope when unsampled): the wire
            # context Connection.call stamps parents under it, so every
            # downstream server span hangs off this hop
            with tracing.span(f"rpc.{method}", kind="client", addr=address):
                result = await conn.call(method, body, payload, timeout)
            ok = True
            # response payload size drives the read-size-class tail
            # estimate (per-(address, size-class) hedge delay)
            nbytes = len(result[1])
            return result
        finally:
            READ_STATS.end(address, stats_method or method,
                           time.monotonic() - t0, ok, nbytes)

    async def post(self, address: str, method: str, body: object = None,
                   payload: bytes = b"") -> None:
        """One-way send (Connection.post): no response awaited."""
        conn = await self._get_conn(address)
        await conn.post(method, body, payload)

    async def close(self) -> None:
        for conn in list(self._conns.values()):
            await conn.close()
        self._conns.clear()
