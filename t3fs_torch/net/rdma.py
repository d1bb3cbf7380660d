"""RemoteBuf: registered-buffer indirection + one-sided transfer emulation.

Reference analogs: common/net/ib/RDMABuf.h (pooled registered memory,
RDMARemoteBuf (addr,rkey) serde handle), IBSocket::rdmaRead/rdmaWrite
batched one-sided verbs (IBSocket.h:81-180).

Over TCP the "one-sided" ops become reverse-direction RPCs on the duplex
connection: a server holding a RemoteBuf handle calls Buf.read / Buf.write
back at the peer that registered it.  The handle shape (id, offset, length,
rkey) is kept serde-serializable so a real verbs/EFA backend can replace the
emulation without touching callers — same seam the reference keeps between
IBSocket and TcpSocket.

Batched one-sided transport (ROADMAP item 3): per-IO Buf.read/Buf.write
round trips are replaced by `Buf.batch`, one scatter/gather frame carrying N
packed (buf_id, offset, length, rkey, opcode) descriptors plus one
concatenated payload region — the IBSocket batched-verbs discipline.  Ops
submit through a per-connection staging queue (batched_read/batched_write)
and flush once per event-loop tick per connection, the doorbell analog; all
completions of a flush resolve in one wakeup.  Peers that predate Buf.batch
answer RPC_METHOD_NOT_FOUND and the queue falls back to per-op RPCs,
memoized per connection (so the memo dies with the connection, like the
ring/packed-wire epoch memos).
"""

from __future__ import annotations

import asyncio
import itertools
import os
import secrets
import weakref
from dataclasses import dataclass, field

from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.net.wire import (
    BUF_OP_READ as BATCH_OP_READ, BUF_OP_WRITE as BATCH_OP_WRITE, BUF_DESC,
    BUF_RES, pack_buf_descs, unpack_buf_descs,
)
from t3fs_torch.utils.metrics import CallbackGauge
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, StatusError, make_error


@serde_struct
@dataclass
class RemoteBuf:
    """Serializable handle to a peer-registered buffer region.

    `rkey` is the capability token minted at registration (RDMARemoteBuf's
    rkey analog): unguessable, scoped to ONE registration, so a stale
    handle — e.g. held by a server across the client's ring re-attach —
    fails closed with STALE_RKEY instead of silently addressing whatever
    buffer now owns a recycled buf_id.  rkey=0 marks a handle minted by a
    pre-rkey peer and is accepted unchecked for wire compat."""
    buf_id: int = 0
    offset: int = 0
    length: int = 0
    rkey: int = 0

    def slice(self, off: int, length: int) -> "RemoteBuf":
        if off < 0 or length < 0 or off + length > self.length:
            raise make_error(StatusCode.INVALID_ARG, "RemoteBuf slice out of range")
        return RemoteBuf(self.buf_id, self.offset + off, length, self.rkey)


# ---- Buf.batch wire envelope ----
#
# Request:  BufBatchReq.descs = N fixed-stride BUF_DESC descriptors
# (net/wire.py); the raw payload channel carries the WRITE regions
# concatenated in descriptor order (READ descriptors contribute no request
# payload).  Response: BufBatchRsp.results = N packed BUF_RES
# (status_code, out_length) pairs; the response payload is the READ regions
# of the successful READ ops concatenated in descriptor order.


@serde_struct
@dataclass
class BufBatchReq:
    descs: bytes = b""


@serde_struct
@dataclass
class BufBatchRsp:
    results: bytes = b""
    # index-aligned error text, populated only when some op failed (the
    # pack_ioresults convention: the common all-OK batch pays nothing)
    msgs: list = field(default_factory=list)


class BufTransportStats:
    """Process-wide counters for the batched one-sided plane (exported via
    CallbackGauge below and the `admin buf-stats` view)."""

    __slots__ = ("doorbells", "batched_ops", "fallback_ops", "batched_bytes")

    def __init__(self):
        self.doorbells = 0        # Buf.batch frames issued
        self.batched_ops = 0      # one-sided ops that rode a batch frame
        self.fallback_ops = 0     # ops that fell back to per-op Buf RPCs
        self.batched_bytes = 0    # payload bytes moved by batch frames

    def ops_per_doorbell(self) -> float:
        return self.batched_ops / self.doorbells if self.doorbells else 0.0

    def snapshot(self) -> dict:
        return {"doorbells": self.doorbells, "batched_ops": self.batched_ops,
                "fallback_ops": self.fallback_ops,
                "batched_bytes": self.batched_bytes,
                "ops_per_doorbell": round(self.ops_per_doorbell(), 2)}


BATCH_STATS = BufTransportStats()

# kill switch for A/B benches and old-server simulation: per-op RPCs only
ONE_SIDED_BATCH = os.environ.get("T3FS_ONE_SIDED_BATCH", "1") != "0"

# test seam: called with (dst_view, src) for every region scattered by the
# batched receive path — proves src is a zero-copy view of the frame
# payload, never a per-IO staging `bytes`
RX_PROBE = None


@service("Buf")
class BufferRegistry:
    """Per-process registry of registered buffers; exposes the Buf service
    that peers use to emulate one-sided access."""

    def __init__(self):
        # bytearray (owned) or writable memoryview (register_external)
        self._bufs: dict[int, bytearray | memoryview] = {}
        self._rkeys: dict[int, int] = {}
        self._ids = itertools.count(1)

    def _mint(self, buf) -> RemoteBuf:
        buf_id = next(self._ids)
        rkey = secrets.randbits(63) | 1      # nonzero: 0 means "unchecked"
        self._bufs[buf_id] = buf
        self._rkeys[buf_id] = rkey
        return RemoteBuf(buf_id, 0, len(buf), rkey)

    def register(self, size_or_data: int | bytes | bytearray) -> RemoteBuf:
        # int -> zeroed buffer, bytes -> copy
        return self._mint(bytearray(size_or_data))

    def register_external(self, view) -> RemoteBuf:
        """Register caller-owned memory WITHOUT copying (the ring data
        plane's arena iovs): one-sided Buf.read/Buf.write and local_view
        then operate on the caller's buffer in place — the pin-don't-copy
        registration a verbs backend performs on the same seam."""
        mv = memoryview(view).cast("B")
        if mv.readonly:
            raise make_error(StatusCode.INVALID_ARG,
                             "register_external needs writable memory")
        return self._mint(mv)

    def deregister(self, handle: RemoteBuf) -> None:
        buf = self._bufs.pop(handle.buf_id, None)
        self._rkeys.pop(handle.buf_id, None)
        if isinstance(buf, memoryview):
            # unpin: a register_external view holds the caller's buffer
            # exported (a bytearray can't resize, an shm arena can't
            # detach) for as long as it lives — release it NOW instead of
            # whenever the GC notices
            buf.release()

    def local_view(self, handle: RemoteBuf) -> memoryview:
        buf = self._bufs.get(handle.buf_id)
        if buf is None:
            raise make_error(StatusCode.NOT_FOUND, f"buf {handle.buf_id} not registered")
        rkey = getattr(handle, "rkey", 0)
        if rkey and rkey != self._rkeys.get(handle.buf_id):
            raise make_error(StatusCode.STALE_RKEY,
                             f"buf {handle.buf_id}: rkey does not match the "
                             f"live registration (stale handle)")
        if (handle.offset < 0 or handle.length < 0
                or handle.offset + handle.length > len(buf)):
            raise make_error(StatusCode.INVALID_ARG,
                             f"buf {handle.buf_id}: region [{handle.offset}, "
                             f"+{handle.length}) outside {len(buf)}B buffer")
        return memoryview(buf)[handle.offset: handle.offset + handle.length]

    # --- Buf service (called by the remote peer over the duplex conn) ---

    @rpc_method
    async def read(self, body: RemoteBuf, payload: bytes, conn):
        """Peer pulls bytes from our registered buffer (RDMA READ analog).
        The VIEW ships directly — on the native transport the pump pins
        it and sends from the registered memory without a staging copy
        (send-from-pool); concurrent mutation of
        the region during the pull is the caller's race to manage,
        exactly as with a real one-sided READ."""
        return None, self.local_view(body)

    @rpc_method
    async def write(self, body: RemoteBuf, payload: bytes, conn):
        """Peer pushes bytes into our registered buffer (RDMA WRITE analog)."""
        view = self.local_view(body)
        if len(payload) != len(view):
            raise make_error(StatusCode.INVALID_ARG,
                             f"payload {len(payload)} != region {len(view)}")
        view[:] = payload
        return None, b""

    @rpc_method
    async def batch(self, body: BufBatchReq, payload, conn):
        """Scatter/gather one-sided batch (IBSocket::rdmaBatchRead/Write
        analog): N descriptors, one frame each way, per-op status codes.

        WRITE regions scatter straight from the frame payload into the
        registered (arena / pool) memory as memoryview slices — no per-IO
        staging bytes; on the native transport the frame payload itself is
        a pump-buffer view, so the path is copy-free end to end.  Per-op
        failures (stale rkey, bounds, unknown buf) are result codes; the
        frame only fails as a whole for a malformed payload length."""
        descs = unpack_buf_descs(body.descs)
        want = sum(d[2] for d in descs if d[4] == BATCH_OP_WRITE)
        if want != (len(payload) if payload else 0):
            raise make_error(StatusCode.INVALID_ARG,
                             f"batch payload {len(payload)}B != "
                             f"{want}B of WRITE descriptors")
        pmv = memoryview(payload) if payload else None
        results, msgs, out = [], [], []
        failed = False
        pos = 0
        for buf_id, off, length, rkey, op in descs:
            src = None
            if op == BATCH_OP_WRITE:
                src = pmv[pos:pos + length] if pmv is not None else b""
                pos += length
            try:
                view = self.local_view(RemoteBuf(buf_id, off, length, rkey))
                if op == BATCH_OP_WRITE:
                    if RX_PROBE is not None:
                        RX_PROBE(view, src)
                    view[:] = src
                    results.append(BUF_RES.pack(0, 0))
                else:
                    out.append(view)
                    results.append(BUF_RES.pack(0, length))
                msgs.append("")
            except StatusError as e:
                results.append(BUF_RES.pack(int(e.status.code), 0))
                msgs.append(e.status.message)
                failed = True
        BATCH_STATS.doorbells += 1
        BATCH_STATS.batched_ops += len(descs)
        BATCH_STATS.batched_bytes += pos + sum(len(v) for v in out)
        rsp = BufBatchRsp(results=b"".join(results),
                          msgs=msgs if failed else [])
        # single READ region ships as the registered view itself
        # (send-from-pool); multiple regions pay one gather join
        return rsp, (out[0] if len(out) == 1 else b"".join(out))


class BufferPool:
    """Two-tier pool of registered buffers (reference BufferPool.h:24-27:
    4 MiB x 1024 + 64 MiB x 64 of RDMA-registered memory).

    Pooling matters for two reasons the reference cares about and the TPU
    staging path inherits: registration is expensive (under verbs it pins
    pages and programs the NIC; here it allocates + zeroes), and long-lived
    stable buffers are what pinned-memory device DMA wants.  acquire()
    returns a (RemoteBuf, release) pair; release returns the buffer to the
    pool instead of deregistering."""

    SMALL = 4 << 20
    LARGE = 64 << 20

    def __init__(self, registry: BufferRegistry,
                 small_count: int = 64, large_count: int = 4):
        self.registry = registry
        self._free: dict[int, list[RemoteBuf]] = {self.SMALL: [],
                                                  self.LARGE: []}
        self._cap = {self.SMALL: small_count, self.LARGE: large_count}
        self._live = {self.SMALL: 0, self.LARGE: 0}
        self.hits = 0
        self.misses = 0
        _POOLS.add(self)

    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "live_small": self._live[self.SMALL],
                "live_large": self._live[self.LARGE],
                "free_small": len(self._free[self.SMALL]),
                "free_large": len(self._free[self.LARGE])}

    def _tier(self, size: int) -> int:
        if size <= self.SMALL:
            return self.SMALL
        if size <= self.LARGE:
            return self.LARGE
        return 0   # oversized: unpooled one-off

    def acquire(self, size: int) -> tuple[RemoteBuf, "callable"]:
        tier = self._tier(size)
        if tier == 0:
            handle = self.registry.register(size)

            def release_oversize(discard: bool = False):
                self.registry.deregister(handle)
            return handle, release_oversize
        free = self._free[tier]
        if free:
            self.hits += 1
            buf = free.pop()
        else:
            self.misses += 1
            buf = self.registry.register(tier)
            self._live[tier] += 1
        handle = buf.slice(0, size)

        def release(buf=buf, tier=tier, discard: bool = False):
            """discard=True drops the buffer entirely (a stale one-sided op
            may still target it) with the pool's accounting kept straight."""
            if not discard and len(self._free[tier]) < self._cap[tier]:
                self._free[tier].append(buf)
            else:
                self.registry.deregister(buf)
                self._live[tier] -= 1
        return handle, release


# live pools, for aggregate gauge export (one process usually has one, but
# fabrics host several nodes in-process; the WeakSet keeps test pools from
# leaking into steady-state numbers forever)
_POOLS: "weakref.WeakSet[BufferPool]" = weakref.WeakSet()


def register_buf_metrics() -> None:
    """Register the registered-memory plane's gauges with the in-process
    metric registry (idempotent: the registry is keyed by name).  Called at
    import so any process that touches the Buf seam exports them; callable
    again by tests after metrics.reset_registry()."""
    s = BATCH_STATS
    CallbackGauge("rdma.batch.doorbells", lambda: s.doorbells)
    CallbackGauge("rdma.batch.batched_ops", lambda: s.batched_ops)
    CallbackGauge("rdma.batch.fallback_ops", lambda: s.fallback_ops)
    CallbackGauge("rdma.batch.batched_bytes", lambda: s.batched_bytes)
    CallbackGauge("rdma.batch.ops_per_doorbell", s.ops_per_doorbell)
    CallbackGauge("rdma.pool.hits", lambda: sum(p.hits for p in _POOLS))
    CallbackGauge("rdma.pool.misses", lambda: sum(p.misses for p in _POOLS))
    CallbackGauge("rdma.pool.live",
                  lambda: sum(sum(p._live.values()) for p in _POOLS))


register_buf_metrics()


async def remote_read(conn, handle: RemoteBuf, timeout: float = 30.0) -> bytes:
    """Pull the bytes behind a peer's RemoteBuf (server-side doUpdate analog,
    StorageOperator.cc:560-591)."""
    _, payload = await conn.call("Buf.read", handle, timeout=timeout)
    return payload


async def remote_write(conn, handle: RemoteBuf, data: bytes, timeout: float = 30.0) -> None:
    """Push bytes into a peer's RemoteBuf (batchRead result delivery analog,
    StorageOperator.cc:178-226)."""
    await conn.call("Buf.write", handle, payload=data, timeout=timeout)


# ---- per-connection staging queue (doorbell batching) ----
#
# batched_read/batched_write are drop-in awaitable replacements for
# remote_read/remote_write: ops enqueue on the connection's staging queue
# and a flush task — scheduled with call_soon, so it runs after everything
# queued THIS loop tick — rings one doorbell: a single Buf.batch frame for
# the whole queue (mirroring RingClient's per-(address, kind) coalescing).
# Completions of a flush resolve together in one wakeup.


class _ConnBatcher:
    __slots__ = ("conn", "pending", "scheduled", "unsupported", "tasks")

    def __init__(self, conn):
        self.conn = conn
        # (desc_tuple, write_data | None, future, timeout)
        self.pending: list = []
        self.scheduled = False
        self.unsupported = False     # peer answered RPC_METHOD_NOT_FOUND
        self.tasks: set = set()


def _batcher(conn) -> _ConnBatcher:
    b = getattr(conn, "_buf_batcher", None)
    if b is None:
        b = conn._buf_batcher = _ConnBatcher(conn)
    return b


async def batched_read(conn, handle: RemoteBuf, timeout: float = 30.0):
    """remote_read through the staging queue.  Returns a memoryview over
    the batch response payload (zero staging copy); falls back to the
    per-op RPC against pre-batch peers."""
    b = _batcher(conn)
    if not ONE_SIDED_BATCH or b.unsupported:
        BATCH_STATS.fallback_ops += 1
        return await remote_read(conn, handle, timeout)
    desc = (handle.buf_id, handle.offset, handle.length, handle.rkey,
            BATCH_OP_READ)
    return await _enqueue(b, desc, None, timeout)


async def batched_write(conn, handle: RemoteBuf, data, timeout: float = 30.0) -> None:
    """remote_write through the staging queue.  `data` may be any
    bytes-like (memoryviews ship without an intermediate copy); it must
    stay unmutated until the await returns, as with a posted verbs WQE."""
    await submit_batched_write(conn, handle, data, timeout)


def submit_batched_write(conn, handle: RemoteBuf, data,
                         timeout: float = 30.0) -> "asyncio.Future":
    """batched_write without the coroutine: returns the completion
    future directly, so a hot wave (a whole ring_rw read batch's
    pushes) posts N work elements with ZERO per-op tasks and awaits
    them in one gather — the WQE-post/CQ-reap split of a verbs send
    queue."""
    b = _batcher(conn)
    if not ONE_SIDED_BATCH or b.unsupported:
        BATCH_STATS.fallback_ops += 1
        return asyncio.ensure_future(
            remote_write(conn, handle, data, timeout))
    if len(data) != handle.length:
        raise make_error(StatusCode.INVALID_ARG,
                         f"payload {len(data)} != region {handle.length}")
    desc = (handle.buf_id, handle.offset, handle.length, handle.rkey,
            BATCH_OP_WRITE)
    return _enqueue(b, desc, data, timeout)


def _enqueue(b: _ConnBatcher, desc, data, timeout: float) -> asyncio.Future:
    loop = asyncio.get_running_loop()
    fut = loop.create_future()
    b.pending.append((desc, data, fut, timeout))
    if not b.scheduled:
        b.scheduled = True
        # flush on the NEXT tick: every one-sided op submitted this tick —
        # a whole ring_rw batch's pulls/pushes, concurrent update pulls —
        # coalesces into one doorbell
        loop.call_soon(_spawn_flush, b)
    return fut


def _spawn_flush(b: _ConnBatcher) -> None:
    t = asyncio.get_running_loop().create_task(_flush(b))
    b.tasks.add(t)
    t.add_done_callback(b.tasks.discard)


async def _flush(b: _ConnBatcher) -> None:
    entries, b.pending = b.pending, []
    b.scheduled = False
    if not entries:
        return
    descs = pack_buf_descs(e[0] for e in entries)
    parts = [e[1] for e in entries if e[1] is not None]
    payload = parts[0] if len(parts) == 1 else b"".join(parts)
    timeout = max(e[3] for e in entries)
    try:
        rsp, pl = await b.conn.call("Buf.batch", BufBatchReq(descs=descs),
                                    payload=payload, timeout=timeout)
    except asyncio.CancelledError:
        for _, _, fut, _ in entries:
            if not fut.done():
                fut.cancel()
        raise
    except StatusError as e:
        if e.status.code == StatusCode.RPC_METHOD_NOT_FOUND:
            b.unsupported = True     # pre-batch peer: memo dies with conn
            await _flush_per_op(b.conn, entries)
            return
        _fail_all(entries, e)
        return
    except Exception as e:
        _fail_all(entries, e)
        return
    pmv = pl if isinstance(pl, memoryview) else memoryview(pl)
    msgs = rsp.msgs
    pos = 0
    for i, (desc, _, fut, _) in enumerate(entries):
        code, out_len = BUF_RES.unpack_from(rsp.results, i * BUF_RES.size)
        res = pmv[pos:pos + out_len] if out_len else None
        pos += out_len
        if fut.done():
            continue
        if code:
            fut.set_exception(make_error(
                StatusCode(code), msgs[i] if i < len(msgs) else
                f"one-sided {'read' if desc[4] == BATCH_OP_READ else 'write'}"
                f" failed on buf {desc[0]}"))
        elif desc[4] == BATCH_OP_READ:
            fut.set_result(res)
        else:
            fut.set_result(None)


async def _flush_per_op(conn, entries) -> None:
    """Pre-batch peer: replay the staged queue as individual Buf RPCs,
    byte-identical results (the mixed-version interop contract)."""
    BATCH_STATS.fallback_ops += len(entries)

    async def one(entry):
        (buf_id, off, length, rkey, op), data, fut, timeout = entry
        h = RemoteBuf(buf_id, off, length, rkey)
        try:
            if op == BATCH_OP_READ:
                r = await remote_read(conn, h, timeout)
            else:
                await remote_write(conn, h, data, timeout)
                r = None
        except Exception as e:
            if not fut.done():
                fut.set_exception(e)
            return
        if not fut.done():
            fut.set_result(r)

    await asyncio.gather(*(one(e) for e in entries))


def _fail_all(entries, exc: Exception) -> None:
    for _, _, fut, _ in entries:
        if not fut.done():
            fut.set_exception(exc)
