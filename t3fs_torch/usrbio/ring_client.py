"""RingClient: registered-arena, batched submit/reap data plane.

Reference analog: the native USRBIO client (hf3fs_usrbio.h iov/ior API +
IBSocket/RDMABuf): app buffers register ONCE per storage node, and whole
submission batches move as fixed-stride SQE arrays — no per-IO RPC
envelope, no per-IO serde, no payload bytes inside frames.

Protocol (docs/usrbio.md):

  attach   Storage.ring_attach registers this client's arena with a node.
           Same-host nodes alias the arena's shm segment by name (bytes
           then move by plain memcpy on the server); cross-host nodes
           fall back to one-sided Buf.read/Buf.write on the registered
           handle.  Sessions are scoped to the connection epoch and
           re-established transparently after a server restart.
  submit   Storage.ring_rw carries one packed SQE array per frame.
           Concurrent submitters to the same address coalesce: SQEs
           queue per (address, read|write) and flush once per event-loop
           tick as ONE frame (the batched submit_ios of the shm ring,
           applied to the wire).
  reap     The response is a packed CQE array (per-IO status + device
           CRC32C from the chunk engine/codec) installed straight back
           into the caller's completion path.

Negotiation is by method name: an old server answers
RPC_METHOD_NOT_FOUND, the address is memoized, and every path falls back
to the rpc data plane — `data_plane = ring` is safe against mixed
clusters, missing native libs, and arena pressure (IOs that don't fit a
slot simply ride the rpc path).

The port of t3fs/usrbio/ring_client.py, a copy with its imports re-pointed:
the arena's shm iov comes from the port's own host library
(t3fs_torch/lib/usrbio.py over csrc/usrbio.cpp).  One addition: the
client counts the SQEs of the frames the nodes answered (`sqes`) and the
IOs it handed to rpc (`spills`), so a run can show that nothing fell back.
"""

from __future__ import annotations

import asyncio
import logging
import os
import random

from t3fs_torch.net.rdma import BufferRegistry, RemoteBuf
from t3fs_torch.net.wire import WireStatus
from t3fs_torch.storage.types import (
    ChunkId, IOResult, ReadIO, RING_F_NO_PAYLOAD, RING_F_UNCOMMITTED,
    RING_F_VERIFY, RING_OP_READ, RING_OP_WRITE, RingAttachReq, RingDetachReq,
    RingRWReq, UpdateIO, pack_ring_sqes, unpack_ioresults,
)
from t3fs_torch.usrbio.slots import SlotAllocator
from t3fs_torch.utils.status import Status, StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.usrbio")


class RingUnsupported(Exception):
    """The ring data plane cannot serve this request (pre-ring server,
    no arena slot, out-of-range field): the caller falls back to rpc."""


class RingArena:
    """Registered client-side staging memory for the ring data plane.

    Backed by a named shm iov when the native lib is available (same-host
    storage nodes alias it by name), and ALWAYS registered in the
    client's BufferRegistry without copying, so a cross-host node moves
    the same bytes one-sided over the duplex connection."""

    def __init__(self, registry: BufferRegistry, view, size: int,
                 shm_name: str = "", iov=None, owns_iov: bool = False):
        self.registry = registry
        self.size = size
        self.shm_name = shm_name
        self._iov = iov
        self._owns_iov = owns_iov
        self._view = memoryview(view).cast("B")
        self.handle: RemoteBuf = registry.register_external(self._view)

    @classmethod
    def create(cls, registry: BufferRegistry, size: int) -> "RingArena":
        """Private staging arena (the StorageClient hook paths).  Prefers
        a named shm iov; a process without the native lib still gets a
        working arena (plain registered bytearray, one-sided only)."""
        name = f"t3fs-arena-{os.getpid()}-{random.getrandbits(32):08x}"
        try:
            from t3fs_torch.lib.usrbio import IoVec
            iov = IoVec(name, size)
        except Exception:
            return cls(registry, bytearray(size), size)
        return cls(registry, iov.buf, size, shm_name=iov.name, iov=iov,
                   owns_iov=True)

    @classmethod
    def wrap_iov(cls, registry: BufferRegistry, iov) -> "RingArena":
        """Expose an EXISTING app iov (e.g. the FUSE ring's) as the
        arena: reads land straight in the app's buffer — end-to-end
        zero copy.  The iov's lifetime stays with its owner."""
        return cls(registry, iov.buf, iov.size, shm_name=iov.name, iov=iov)

    def write_at(self, off: int, data) -> None:
        self._view[off:off + len(data)] = data

    def read_at(self, off: int, length: int) -> bytes:
        return bytes(self._view[off:off + length])

    def close(self) -> None:
        self.registry.deregister(self.handle)
        self._view.release()
        if self._owns_iov and self._iov is not None:
            self._iov.close()
            self._iov = None


class RingClient:
    """Companion to a StorageClient: same routing, retry policy, update
    channels, and Client (so READ_STATS sees per-address begin/end and
    adaptive selection + hedging keep working on the ring plane)."""

    def __init__(self, sc, arena: RingArena | None = None,
                 slot_size: int | None = None, slots: int | None = None):
        self.sc = sc
        self.slot_size = slot_size or getattr(sc.cfg, "ring_slot_size",
                                              256 << 10)
        nslots = slots or getattr(sc.cfg, "ring_slots", 64)
        if arena is None:
            arena = RingArena.create(sc.buf_registry,
                                     self.slot_size * nslots)
            # quarantine = the one-sided discard discipline for staging
            # slots: a timed-out op's slot must outlive any late server
            # dereference (an aliased read writes INTO the arena with no
            # connection involved) before it is reissued
            self.alloc = SlotAllocator(
                nslots, self.slot_size,
                quarantine_s=2.0 * sc.cfg.request_timeout_s)
        else:
            # app-owned arena (wrap_iov): SQE offsets come from the app's
            # own iov bookkeeping, no staging slots here
            self.alloc = None
        self.arena = arena
        # address -> (ring_id, connection epoch, aliased); epoch-scoped
        # like the packed-wire memo — a server restart drops its sessions
        # with its connections, so the memo dies with the epoch
        self._sessions: dict[str, tuple[int, int, bool]] = {}
        self._attach_locks: dict[str, asyncio.Lock] = {}
        self._no_ring: set[str] = set()
        # micro-batch submit: (address, kind) -> [(blob, count, future)],
        # flushed once per event-loop tick as ONE ring_rw frame
        self._pending: dict[tuple[str, str], list] = {}
        self._flush_scheduled: set[tuple[str, str]] = set()
        self._flush_tasks: set[asyncio.Task] = set()
        # the SQEs of every frame a node answered, by kind, and the IOs
        # handed to the rpc path instead (spills): what shows that an IO
        # rode the ring (the nodes count the same SQEs in ring_rw)
        self.sqes = {"read": 0, "write": 0}
        self.spills = 0

    # ---- attach / negotiate ----

    async def _attach(self, address: str) -> tuple[int, bool]:
        if address in self._no_ring:
            raise RingUnsupported(address)
        client = self.sc.client
        memo = self._sessions.get(address)
        if memo is not None and memo[1] == client.epoch(address):
            return memo[0], memo[2]
        lock = self._attach_locks.setdefault(address, asyncio.Lock())
        async with lock:  # t3fslint: allow(async-lock-await-discipline)
            memo = self._sessions.get(address)
            if memo is not None and memo[1] == client.epoch(address):
                return memo[0], memo[2]
            # ring_no_shm withholds the segment name, so the server can
            # never alias and every IO rides the one-sided batch plane —
            # the cross-host transport, forced on a same-host pair
            req = RingAttachReq(client_id=self.sc.client_id,
                                shm_name=("" if getattr(
                                    self.sc.cfg, "ring_no_shm", False)
                                    else self.arena.shm_name),
                                shm_size=self.arena.size,
                                buf=self.arena.handle)
            try:
                rsp, _ = await client.call(
                    address, "Storage.ring_attach", req,
                    timeout=self.sc.cfg.request_timeout_s)
            except StatusError as e:
                if e.code == StatusCode.RPC_METHOD_NOT_FOUND:
                    self._no_ring.add(address)    # pre-ring server
                    raise RingUnsupported(address) from None
                raise
            self._sessions[address] = (rsp.ring_id, client.epoch(address),
                                       rsp.aliased)
            return rsp.ring_id, rsp.aliased

    # ---- micro-batched submit/reap ----

    def _enqueue(self, address: str, kind: str, blob: bytes,
                 count: int) -> asyncio.Future:
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        key = (address, kind)
        self._pending.setdefault(key, []).append((blob, count, fut))
        if key not in self._flush_scheduled:
            self._flush_scheduled.add(key)
            # flush on the NEXT tick: everything submitted this tick —
            # concurrent write_chunk calls, a whole batch_read group —
            # coalesces into one wire frame
            loop.call_soon(self._spawn_flush, key)
        return fut

    def _spawn_flush(self, key: tuple[str, str]) -> None:
        t = asyncio.get_running_loop().create_task(self._flush(key))
        self._flush_tasks.add(t)
        t.add_done_callback(self._flush_tasks.discard)

    async def _flush(self, key: tuple[str, str]) -> None:
        address, kind = key
        self._flush_scheduled.discard(key)
        entries = self._pending.pop(key, [])
        if not entries:
            return
        blob = b"".join(e[0] for e in entries)
        total = sum(e[1] for e in entries)
        try:
            results = await self._ring_call(address, kind, blob, total)
        except asyncio.CancelledError:
            for _, _, fut in entries:
                if not fut.done():
                    fut.cancel()
            raise
        except Exception as e:
            for _, _, fut in entries:
                if not fut.done():
                    fut.set_exception(e)
            return
        pos = 0
        for _, count, fut in entries:
            if not fut.done():
                fut.set_result(results[pos: pos + count])
            pos += count

    async def _ring_call(self, address: str, kind: str, blob: bytes,
                         count: int) -> list[IOResult]:
        sc = self.sc
        for attempt in (0, 1):
            ring_id, _aliased = await self._attach(address)
            # the SQE blob rides the raw payload channel — the serde pass
            # covers only this fixed three-field envelope, so the per-IO
            # wire cost is one struct.pack stride, nothing object-shaped
            req = RingRWReq(ring_id=ring_id, client_id=sc.client_id)
            try:
                rsp, pl = await sc.client.call(
                    address, "Storage.ring_rw", req, payload=blob,
                    timeout=sc.cfg.request_timeout_s,
                    # write batches share the wire method but must not
                    # feed the adaptive READ latency estimate
                    stats_method=("Storage.ring_rw" if kind == "read"
                                  else "Storage.ring_rw.write"))
            except StatusError as e:
                if e.code == StatusCode.RPC_METHOD_NOT_FOUND:
                    self._no_ring.add(address)
                    raise RingUnsupported(address) from None
                if e.code == StatusCode.NOT_FOUND and attempt == 0:
                    # the node restarted and lost its sessions (or GC'd
                    # ours): drop the memo and re-attach once
                    self._sessions.pop(address, None)
                    continue
                raise
            packed = pl or rsp.cqes
            results = unpack_ioresults(packed) if packed else rsp.results
            if len(results) != count:
                raise make_error(
                    StatusCode.INTERNAL,
                    f"ring_rw: {len(results)} cqes for {count} sqes")
            self.sqes[kind] += count
            return results
        raise make_error(StatusCode.INTERNAL, "ring re-attach loop ended")

    # ---- StorageClient hook: batched reads ----

    async def read_group(self, address: str, idxs: list[int],
                         ios: list[ReadIO], install, src: str
                         ) -> list[int] | None:
        """_read_group, its leftovers counted as spills."""
        left = await self._read_group(address, idxs, ios, install, src)
        self.spills += len(idxs) if left is None else len(left)
        return left

    async def _read_group(self, address: str, idxs: list[int],
                          ios: list[ReadIO], install, src: str
                          ) -> list[int] | None:
        """Serve one batch_read node-group on the ring plane.  Returns
        None when the whole group must ride the rpc path, else the
        leftover idxs the rpc path should still handle (ineligible IOs,
        arena pressure, rare oversize results).  Installed results are
        byte-identical to the rpc path's."""
        sc = self.sc
        if self.alloc is None or address in self._no_ring:
            return None
        d = sc.cfg.debug
        if d.inject_server_error_prob or d.inject_client_error_prob or \
                d.num_points_before_fail:
            return None     # fault-injection flags ride the struct path
        own = self.arena.handle.buf_id
        leftover: list[int] = []
        # plan: (idx, slot | None, arena offset, capacity)
        plan: list[tuple[int, int | None, int, int]] = []
        recs: list[tuple] = []
        settled = False
        try:
            for i in idxs:
                io = ios[i]
                if io.buf is not None:
                    if io.buf.buf_id != own:
                        leftover.append(i)   # foreign registered buffer
                        continue
                    off, cap = io.buf.offset, io.buf.length
                    slot = None
                elif io.no_payload:
                    off = cap = 0
                    slot = None
                elif io.length > self.slot_size:
                    leftover.append(i)
                    continue
                else:
                    slot = self.alloc.try_acquire()
                    if slot is None:
                        leftover.append(i)   # arena pressure: rpc path
                        continue
                    off = self.alloc.offset(slot)
                    # length 0 = whole chunk, size unknown a priori: cap
                    # at the slot; the server truncates and the client
                    # re-reads the rare oversize via rpc
                    cap = io.length if io.length else self.slot_size
                flags = ((RING_F_VERIFY if io.verify_checksum else 0)
                         | (RING_F_UNCOMMITTED if io.allow_uncommitted else 0)
                         | (RING_F_NO_PAYLOAD if io.no_payload else 0))
                recs.append((io.chunk_id.inode, io.chunk_id.index,
                             io.chain_id, io.offset, io.length, off, cap,
                             0, 0, 0, io.chain_ver, RING_OP_READ, flags))
                plan.append((i, slot, off, cap))
            if not plan:
                return leftover if leftover else []
            blob = pack_ring_sqes(recs)
            if blob is None:
                return None     # out-of-range field: whole group via rpc
            try:
                results = await self._enqueue(address, "read", blob,
                                              len(plan))
                settled = True
            except RingUnsupported:
                return None
            except StatusError as e:
                # transport failure: same shape as the rpc path — error
                # results install and the retry loop fails the IOs over
                for i, _slot, _off, _cap in plan:
                    install(i, IOResult(WireStatus(int(e.code), str(e))),
                            b"", src)
                return leftover
            for (i, _slot, off, cap), r in zip(plan, results):
                io = ios[i]
                if io.no_payload or io.buf is not None:
                    install(i, r, b"", src)
                    continue
                if r.status.code == int(StatusCode.OK) and r.length > cap:
                    leftover.append(i)   # grew past the slot: re-read
                    continue
                p = (self.arena.read_at(off, r.length)
                     if r.status.code == int(StatusCode.OK) else b"")
                install(i, r, p, src)
            return leftover
        finally:
            # an unsettled frame (timeout, cancellation, transport
            # failure) may still be processed server-side — its reads
            # would land bytes in these slots long after we give up, so
            # they sit out the quarantine instead of being reissued
            for _i, slot, _off, _cap in plan:
                if slot is not None:
                    self.alloc.release(slot, discard=not settled)

    # ---- StorageClient hook: one CRAQ write ----

    async def write_io(self, address: str, io: UpdateIO,
                       data: bytes) -> IOResult:
        """_write_io, a RingUnsupported counted as a spill."""
        try:
            return await self._write_io(address, io, data)
        except RingUnsupported:
            self.spills += 1
            raise

    async def _write_io(self, address: str, io: UpdateIO,
                        data: bytes) -> IOResult:
        """One head write through the ring: payload staged in the arena
        (the server reads it via shm alias or one-sided pull), SQE
        coalesced with everything else bound for this address this tick.
        Raises RingUnsupported to route this attempt via rpc."""
        if self.alloc is None or address in self._no_ring:
            raise RingUnsupported(address)
        if len(data) > self.slot_size:
            raise RingUnsupported("payload exceeds slot")
        slot = self.alloc.try_acquire()
        if slot is None:
            raise RingUnsupported("arena full")
        off = self.alloc.offset(slot)
        settled = False
        try:
            self.arena.write_at(off, data)
            blob = pack_ring_sqes([(
                io.chunk_id.inode, io.chunk_id.index, io.chain_id,
                io.offset, len(data), off, io.chunk_size, io.checksum,
                io.channel, io.channel_seq, io.chain_ver,
                RING_OP_WRITE, 0)])
            if blob is None:
                raise RingUnsupported("field out of range")
            results = await self._enqueue(address, "write", blob, 1)
            settled = True
            return results[0]
        finally:
            # release AFTER completion: the server consumed the payload
            # (aliased: synchronously in the handler; one-sided: over the
            # same now-settled call) before the CQE came back.  An op
            # that did NOT settle (timeout, cancellation) may still be
            # pending server-side — quarantine the slot so a late
            # dereference can't touch a newer occupant's bytes
            self.alloc.release(slot, discard=not settled)

    # ---- lean path: ranges straight into an app-owned arena ----

    async def read_ranges_into(self, layout,
                               ranges: list[tuple[int, int, int, int]]
                               ) -> list[int]:
        """Read (inode, file_off, length, arena_off) ranges DIRECTLY into
        the app arena — the RingWorker drain path.  Chunks each range via
        the layout, packs SQEs per address with iov_off pointing into the
        app's own iov (zero client-side copies), retries with target
        failover, and zero-fills holes/short tails/errors in place —
        the read_file_ranges contract, minus every per-IO object.
        Returns the per-range byte counts (the full requested lengths)."""
        sc = self.sc
        # pieces: (inode, idx, chain_id, chunk_off, span, arena_off)
        pieces: list[tuple[int, int, int, int, int, int]] = []
        totals: list[int] = []
        for inode, off, length, aoff in ranges:
            pos = 0
            for idx, coff, span in layout.chunk_span(off, length):
                pieces.append((inode, idx, layout.chain_of(idx), coff,
                               span, aoff + pos))
                pos += span
            totals.append(pos)
        resolved: list[IOResult | None] = [None] * len(pieces)
        stamp = sc._refresh_routing is not None
        pending = list(range(len(pieces)))
        for attempt in range(sc.cfg.max_retries):
            routing = sc.routing()
            groups: dict[str, list[int]] = {}
            # one target pick per chain per attempt (not per piece): the
            # whole wave of a chain lands on ONE replica, so it coalesces
            # into one ring frame instead of scattering across replicas —
            # load spreads across waves, which repick every call
            picks: dict[int, str | StatusError] = {}
            for j in pending:
                chain_id = pieces[j][2]
                addr = picks.get(chain_id)
                if addr is None:
                    chain = routing.chain(chain_id)
                    if chain is None:
                        addr = make_error(StatusCode.TARGET_NOT_FOUND,
                                          f"chain {chain_id}")
                    else:
                        try:
                            target = sc._pick_read_target(chain, attempt,
                                                          routing)
                            addr = routing.node_address(target.node_id)
                        except StatusError as e:
                            addr = e
                    picks[chain_id] = addr
                if isinstance(addr, StatusError):
                    resolved[j] = IOResult(WireStatus(int(addr.code),
                                                      str(addr)))
                    continue
                groups.setdefault(addr, []).append(j)
            if groups:
                await asyncio.gather(*(
                    self._lean_group(a, js, pieces, resolved, routing,
                                     stamp)
                    for a, js in groups.items()))
            pending = [
                j for j in pending
                if resolved[j] is not None
                and resolved[j].status.code != int(StatusCode.OK)
                and Status(StatusCode(resolved[j].status.code)).retryable]
            if not pending:
                break
            await sc._backoff(attempt)
            await sc._maybe_refresh()
        # zero-fill holes, short tails, and failed pieces in place
        zeros = b"\x00" * 4096
        for j, (_ino, _idx, _chain, _coff, span, aoff) in enumerate(pieces):
            r = resolved[j]
            n = (min(r.length, span)
                 if r is not None and r.status.code == int(StatusCode.OK)
                 else 0)
            pos = aoff + n
            left = span - n
            while left > 0:
                step = min(left, len(zeros))
                self.arena.write_at(pos, zeros[:step])
                pos += step
                left -= step
        return totals

    async def _lean_group(self, address: str, js: list[int], pieces,
                          resolved, routing, stamp: bool) -> None:
        sc = self.sc
        if address not in self._no_ring:
            recs = []
            for j in js:
                inode, idx, chain_id, coff, span, aoff = pieces[j]
                cver = (routing.chain(chain_id).chain_ver if stamp else 0)
                flags = RING_F_VERIFY if sc.cfg.verify_checksums else 0
                recs.append((inode, idx, chain_id, coff, span, aoff, span,
                             0, 0, 0, cver, RING_OP_READ, flags))
            blob = pack_ring_sqes(recs)
            if blob is not None:
                try:
                    results = await self._enqueue(address, "read", blob,
                                                  len(js))
                except RingUnsupported:
                    pass     # fall through to the rpc fallback below
                except StatusError as e:
                    err = IOResult(WireStatus(int(e.code), str(e)))
                    for j in js:
                        resolved[j] = err
                    return
                else:
                    for j, r in zip(js, results):
                        resolved[j] = r
                    return
        # rpc fallback (pre-ring node / unpackable): ordinary batch_read,
        # payloads copied into the arena here
        self.spills += len(js)
        ios = [ReadIO(chunk_id=ChunkId(p[0], p[1]), chain_id=p[2],
                      offset=p[3], length=p[4],
                      verify_checksum=sc.cfg.verify_checksums)
               for p in (pieces[j] for j in js)]
        results, payloads = await sc.batch_read(ios)
        for j, r, data in zip(js, results, payloads):
            if data:
                self.arena.write_at(pieces[j][5], data)
            resolved[j] = r

    # ---- lifecycle ----

    async def close(self) -> None:
        """Best-effort detach from every node, then drop the arena."""
        for address, (ring_id, _epoch, _aliased) in list(
                self._sessions.items()):
            try:
                await self.sc.client.call(
                    address, "Storage.ring_detach",
                    RingDetachReq(ring_id=ring_id), timeout=2.0)
            except Exception:
                pass    # node gone: its session died with it
        self._sessions.clear()
        self.arena.close()
