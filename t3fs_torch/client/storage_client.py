"""StorageClient: chunk slicing, per-node batching, exactly-once channels,
retry/failover, target selection.

Reference analogs: client/storage/StorageClient.h:338-556 (batchRead/
batchWrite/read/write/queryLastChunk/removeChunks/truncateChunks),
StorageClientImpl.cc (chunk slicing, groupOpsByNodeId :1030, retry loop w/
backoff :492-566,1151-1266, UpdateChannelAllocator), TargetSelection.h:31-49
(LoadBalance/RoundRobin/TailTarget/HeadTarget — reads to any serving target,
writes to head).

The port of t3fs/client/storage_client.py.  Its host CRC of each chunk
payload runs the port's native host CRC (t3fs_torch/ops/codec.py); the
usrbio ring data plane is not ported yet, so data_plane="ring" raises.
"""

from __future__ import annotations

import asyncio
import enum
import itertools
import logging
import random
from dataclasses import dataclass, field
from typing import Callable

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.mgmtd.types import ChainInfo, PublicTargetState, RoutingInfo
from t3fs_torch.net.client import Client
from t3fs_torch.net.rpcstats import READ_STATS
from t3fs_torch.net.wire import WireStatus
from t3fs_torch.ops.codec import crc32c as crc32c_ref
from t3fs_torch.storage.types import (
    BatchReadReq, BatchReadRsp, ChunkId, IOResult, PACKED_READIO_VER,
    QueryLastChunkReq, QueryLastChunkRsp, ReadIO, RemoveChunksReq,
    TruncateChunkReq, UpdateIO, UpdateType, WriteReq, pack_readios,
    unpack_ioresults, update_rpc,
)
from t3fs_torch.utils import tracing
from t3fs_torch.utils.fault_injection import DebugFlags
from t3fs_torch.utils.status import Status, StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.client")


class TargetSelection(enum.IntEnum):
    LOAD_BALANCE = 0
    ROUND_ROBIN = 1
    HEAD_TARGET = 2
    TAIL_TARGET = 3
    # latency-aware: weigh each serving target's in-flight RPC count and
    # observed read p50 (READ_STATS) so hot or degraded nodes shed reads
    # to clean replicas automatically
    ADAPTIVE = 4


@dataclass
class StorageClientConfig:
    max_retries: int = 8
    retry_backoff_s: float = 0.02
    request_timeout_s: float = 30.0
    generate_checksums: bool = True
    verify_checksums: bool = False
    read_selection: TargetSelection = TargetSelection.LOAD_BALANCE
    num_channels: int = 64
    # hedged batch reads (storage.read_hedging = off|on): IOs still
    # pending after an adaptive delay — the primary address's tracked
    # p9x, clamped to [floor, cap] — are re-issued to a DIFFERENT serving
    # replica; the first OK result wins and the loser is discarded.
    # "off" is byte-for-byte the unhedged read path.
    read_hedging: str = "off"
    hedge_delay_floor_s: float = 0.002
    hedge_delay_cap_s: float = 0.5
    # token-bucket hedge budget: issuing a primary read earns
    # hedge_budget_pct tokens (capped at hedge_budget_burst), hedging one
    # IO spends one — total hedges <= pct * reads + burst, so hedging can
    # never amplify a tail-latency incident into a load incident
    hedge_budget_pct: float = 0.05
    hedge_budget_burst: int = 8
    # transfer discipline for bulk payloads: "inline" frames data in the RPC
    # (one round trip; best on TCP), "remote_buf" registers a pooled buffer
    # and lets the server pull/push one-sided (the reference's RDMA flow,
    # StorageOperator.cc:560-591/178-226 — the mode a verbs backend uses)
    transfer_mode: str = "inline"
    remote_buf_threshold: int = 512 << 10
    # fault-injection flags carried in every request (reference
    # StorageClient.h:162-166 driving DebugFlags, Common.h:290-307)
    debug: DebugFlags = field(default_factory=DebugFlags)
    # data plane: "rpc" = the struct/packed RPC paths above.  The
    # reference's "ring" plane (t3fs/usrbio) is not ported: it raises
    data_plane: str = "rpc"


class _HedgeBudget:
    """Token bucket bounding hedged re-issues to a fraction of reads.
    Starts full (burst) so a cold client can hedge its first slow reads;
    refills only by issuing primary reads, so a quiet client cannot bank
    unlimited hedges."""

    def __init__(self, pct: float, burst: int):
        self.pct = pct
        self.burst = float(burst)
        self.tokens = float(burst)

    def earn(self, reads: int) -> None:
        self.tokens = min(self.tokens + self.pct * reads, self.burst)

    def take(self, want: int) -> int:
        grant = min(int(self.tokens), want)
        self.tokens -= grant
        return grant


class UpdateChannelAllocator:
    """Pool of (channel, seq) pairs: one in-flight write per channel keeps
    updates exactly-once + in-order (client/storage/UpdateChannelAllocator.h)."""

    def __init__(self, num_channels: int):
        self._free = list(range(1, num_channels + 1))
        self._seqs = {c: 0 for c in self._free}
        self._cond = asyncio.Condition()

    async def acquire(self) -> tuple[int, int]:
        async with self._cond:
            while not self._free:
                await self._cond.wait()
            ch = self._free.pop()
            self._seqs[ch] += 1
            return ch, self._seqs[ch]

    async def release(self, channel: int) -> None:
        async with self._cond:
            self._free.append(channel)
            self._cond.notify()


class StorageClient:
    def __init__(self, routing_provider: Callable[[], RoutingInfo],
                 client: Client | None = None,
                 config: StorageClientConfig | None = None,
                 client_id: str | None = None,
                 refresh_routing: Callable[[], "asyncio.Future | None"] | None = None):
        self.cfg = config or StorageClientConfig()
        if self.cfg.data_plane != "rpc":
            raise ValueError(
                f"data_plane={self.cfg.data_plane!r}: the port has the rpc "
                "data plane only (the usrbio ring plane is on the ROADMAP)")
        self._routing = routing_provider
        self._refresh_routing = refresh_routing
        self.client = client or Client()
        self.client_id = client_id or f"sc-{random.getrandbits(48):012x}"
        self.channels = UpdateChannelAllocator(self.cfg.num_channels)
        self._rr = itertools.count()
        # shared across copy.copy views (EC fast reads, kvcache): the
        # budget bounds this PROCESS's hedge amplification, not one view's
        self._hedge_budget = _HedgeBudget(self.cfg.hedge_budget_pct,
                                          self.cfg.hedge_budget_burst)
        # per-address (packed-ReadIO version, connection epoch) the
        # server ADVERTISED via BatchReadRsp.packed_ver (absent =
        # unknown: send struct; a pre-packed server never advertises —
        # see read_group).  Scoped to the connection epoch: a server
        # restart may be a rollback to an older stride, so the memo dies
        # with the connection and the next batch re-negotiates.
        self._packed_ver: dict[str, tuple[int, int]] = {}
        # addresses whose server predates Storage.write_packed (detected
        # by RPC_METHOD_NOT_FOUND; see _call_write)
        self._no_packed_write: set[str] = set()
        # registered-buffer pool for remote_buf transfers (BufferPool.h:24-27
        # analog); the registry rides this client's duplex connections so
        # servers can one-sided read/write it
        from t3fs_torch.net.rdma import BufferPool, BufferRegistry
        existing = getattr(self.client, "buf_registry", None)
        if existing is None:
            existing = BufferRegistry()
            self.client.add_service(existing)
            self.client.buf_registry = existing
        self.buf_registry = existing
        self.buf_pool = BufferPool(self.buf_registry)

    def routing(self) -> RoutingInfo:
        return self._routing()

    async def _maybe_refresh(self) -> None:
        if self._refresh_routing is not None:
            res = self._refresh_routing()
            if asyncio.iscoroutine(res) or isinstance(res, asyncio.Future):
                await res

    # --- target selection ---

    @staticmethod
    def _adaptive_score(routing: RoutingInfo, target) -> float:
        """Load x latency: (in-flight RPCs + 1) * observed read p50.  An
        address with no samples scores 0.0 — optimism under uncertainty,
        so fresh/unknown replicas get probed instead of starved."""
        address = routing.node_address(target.node_id)
        return (READ_STATS.inflight(address) + 1) * READ_STATS.p50(address)

    def _pick_read_target(self, chain: ChainInfo, attempt: int,
                          routing: RoutingInfo | None = None):
        serving = chain.serving()
        if not serving:
            raise make_error(StatusCode.TARGET_OFFLINE,
                             f"chain {chain.chain_id}: no serving targets")
        sel = self.cfg.read_selection
        if sel == TargetSelection.HEAD_TARGET:
            pick = serving[0]
        elif sel == TargetSelection.TAIL_TARGET:
            pick = serving[-1]
        elif sel == TargetSelection.ROUND_ROBIN:
            pick = serving[next(self._rr) % len(serving)]
        elif sel == TargetSelection.ADAPTIVE:
            routing = routing if routing is not None else self.routing()
            scored = [(self._adaptive_score(routing, t), t) for t in serving]
            best = min(s for s, _ in scored)
            # random tie-break among the leaders: with no samples yet every
            # score is 0.0 and this must not collapse into head-hammering
            ties = [t for s, t in scored if s == best]
            pick = ties[random.randrange(len(ties))]
        else:
            pick = serving[random.randrange(len(serving))]
        # failover: later attempts walk the chain
        if attempt:
            pick = serving[(serving.index(pick) + attempt) % len(serving)]
        return pick

    def _pick_hedge_target(self, chain: ChainInfo, routing: RoutingInfo,
                           exclude_address: str):
        """Best serving target on a DIFFERENT node than the (slow) primary;
        None when the chain has no alternative to hedge to."""
        alts = [t for t in chain.serving()
                if routing.node_address(t.node_id) != exclude_address]
        if not alts:
            return None
        return min(alts, key=lambda t: self._adaptive_score(routing, t))

    # --- single-chunk ops ---

    async def write_chunk(self, chain_id: int, chunk_id: ChunkId, offset: int,
                          data: bytes, chunk_size: int,
                          update_type: UpdateType = UpdateType.WRITE,
                          truncate_len: int = 0,
                          checksum: int | None = None,
                          remove_fence_ver: int = 0) -> IOResult:
        """One chunk-granular CRAQ write (retries are seq-stable).

        `checksum` is an optional precomputed CRC32C of `data` (e.g. the EC
        client's fused device decode+verify step): when given, the host-side
        crc32c is skipped — the caller vouches for the bytes it computed
        the CRC over.

        `remove_fence_ver` (REMOVE only): the update fails with
        CHUNK_STALE_UPDATE instead of removing when the chunk's version
        advanced past the fence — the conditional delete KVCache eviction
        uses so a concurrently re-put block survives its own GC."""
        with tracing.start_root("storage_client.write_chunk",
                                chunk=str(chunk_id), nbytes=len(data)) as sp:
            result = await self._write_chunk_inner(
                chain_id, chunk_id, offset, data, chunk_size, update_type,
                truncate_len, checksum, remove_fence_ver)
            if result.status.code:
                sp.set_status(result.status.code)
            return result

    async def _write_chunk_inner(self, chain_id: int, chunk_id: ChunkId,
                                 offset: int, data: bytes, chunk_size: int,
                                 update_type: UpdateType,
                                 truncate_len: int, checksum: int | None,
                                 remove_fence_ver: int) -> IOResult:
        channel, seq = await self.channels.acquire()
        try:
            io = UpdateIO(
                chunk_id=chunk_id, chain_id=chain_id,
                update_type=update_type, offset=offset,
                length=len(data) if update_type == UpdateType.WRITE else truncate_len,
                chunk_size=chunk_size,
                checksum=(checksum if checksum is not None else
                          crc32c_ref(data)
                          if (self.cfg.generate_checksums and data) else 0),
                channel=channel, channel_seq=seq,
                client_id=self.client_id, inline=True,
                remove_fence_ver=remove_fence_ver,
                debug=self.cfg.debug)
            release = None
            handle = None
            if (self.cfg.transfer_mode == "remote_buf"
                    and len(data) >= self.cfg.remote_buf_threshold):
                # stage the payload in a pooled registered buffer; the head
                # pulls it one-sided (doUpdate RDMA READ analog)
                handle, release = self.buf_pool.acquire(len(data))
                self.buf_registry.local_view(handle)[:] = data
                io.buf = handle
                io.inline = False
                data_on_wire = b""
            else:
                data_on_wire = data
            transport_failures: list[int] = []
            clean = False
            try:
                result = await self._write_with_retry(
                    io, data_on_wire, transport_failures=transport_failures)
                clean = True
                return result
            finally:
                if release is not None:
                    if transport_failures or not clean:
                        # ANY attempt that timed out / lost its connection —
                        # or any abnormal exit, incl. CancelledError landing
                        # mid-RPC — may leave a server-side one-sided pull
                        # in flight; DISCARD the buffer so a stale pull
                        # fails loudly instead of reading a reused buffer's
                        # new bytes
                        release(discard=True)
                    else:
                        release()
        finally:
            await self.channels.release(channel)

    async def _call_write(self, address: str, io: UpdateIO,
                          data: bytes) -> IOResult:
        """One write RPC, packed wire when the server supports it (the
        write path's serde cost is the multi-process bottleneck — same
        motivation as the batch-read packed path)."""
        return await update_rpc(
            self.client, address, io, data, self.cfg.request_timeout_s,
            self._no_packed_write, "Storage.write_packed", "Storage.write",
            WriteReq(io=io))

    async def _write_with_retry(self, io: UpdateIO, data: bytes,
                                transport_failures: list | None = None
                                ) -> IOResult:
        last: IOResult | None = None
        for attempt in range(self.cfg.max_retries):
            routing = self.routing()
            chain = routing.chain(io.chain_id)
            if chain is None:
                raise make_error(StatusCode.TARGET_NOT_FOUND, f"chain {io.chain_id}")
            head = chain.head()
            if head is None:
                await self._backoff(attempt)
                await self._maybe_refresh()
                continue
            io.chain_ver = chain.chain_ver
            address = routing.node_address(head.node_id)
            try:
                last = await self._call_write(address, io, data)
                status = Status(StatusCode(last.status.code), last.status.message)
                if status.ok:
                    return last
                if not status.retryable:
                    return last
            except StatusError as e:
                if transport_failures is not None:
                    transport_failures.append(attempt)
                if not e.status.retryable:
                    raise
                last = IOResult(WireStatus(int(e.code), str(e)))
            await self._backoff(attempt)
            await self._maybe_refresh()
        if last is not None:
            return last
        if transport_failures is not None:
            transport_failures.append(-1)
        return IOResult(
            WireStatus(int(StatusCode.TIMEOUT), "write retries exhausted"))

    async def read_chunk(self, chain_id: int, chunk_id: ChunkId,
                         offset: int = 0, length: int = 0) -> tuple[IOResult, bytes]:
        results, payloads = await self.batch_read(
            [ReadIO(chunk_id=chunk_id, chain_id=chain_id, offset=offset,
                    length=length, verify_checksum=self.cfg.verify_checksums)])
        return results[0], payloads[0]

    # --- batched ops ---

    async def batch_read(self, ios: list[ReadIO], *,
                         stats: dict | None = None,
                         hedging: str | None = None
                         ) -> tuple[list[IOResult], list[bytes]]:
        """Group by serving node, dispatch per-node batches in parallel,
        retry failed IOs with target failover.

        With read hedging on, IOs still pending after an adaptive delay
        (the primary address's tracked read p9x for this batch's
        SIZE CLASS, clamped to [hedge_delay_floor_s, hedge_delay_cap_s])
        are re-issued to a different serving replica under the
        token-bucket hedge budget; the first OK result wins, the loser
        is discarded.  "off" is byte-for-byte the unhedged path (same
        RPC sequence).

        `hedging` ("on"/"off") overrides cfg.read_hedging for THIS call —
        the per-call opt-in checkpoint restores and KVCache reads use
        instead of cloning the client with a different config.

        `stats`, when provided, accumulates this call's
        hedge_fired/hedge_won/hedge_wasted counts (kvcache get_many
        surfaces them to its callers)."""
        with tracing.start_root("storage_client.batch_read",
                                ios=len(ios)) as sp:
            results, payloads = await self._batch_read_inner(
                ios, stats=stats, hedging=hedging)
            bad = next((r.status.code for r in results if r.status.code), 0)
            if bad:
                sp.set_status(bad)
            return results, payloads

    async def _batch_read_inner(self, ios: list[ReadIO], *,
                                stats: dict | None = None,
                                hedging: str | None = None
                                ) -> tuple[list[IOResult], list[bytes]]:
        results: list[IOResult | None] = [None] * len(ios)
        payloads: list[bytes] = [b""] * len(ios)
        winner: list[str] = [""] * len(ios)
        hedging = (hedging or self.cfg.read_hedging) == "on"
        hstats = {"hedge_fired": 0, "hedge_won": 0, "hedge_wasted": 0}
        # chain_ver stamping policy: an IO the CALLER versioned is left
        # alone; the rest are (re)stamped from routing each attempt —
        # but only when this client can refresh routing, else one chain
        # reshape would wedge every read behind a permanently stale
        # version (the relaxed chain_ver=0 read is the better contract
        # for a static-routing client)
        stamp = self._refresh_routing is not None
        caller_versioned = [io.chain_ver != 0 for io in ios]
        if stamp and not all(caller_versioned):
            # restamp PRIVATE clones: a caller-reused ReadIO list must not
            # carry this call's stamped version into its next use
            ios = [io if v else io.clone()
                   for io, v in zip(ios, caller_versioned)]

        def _install(i: int, r: IOResult, p: bytes, src: str) -> None:
            cur = results[i]
            if cur is not None and cur.status.code == int(StatusCode.OK):
                return   # first OK won; the loser's duplicate is discarded
            results[i] = r
            payloads[i] = p
            winner[i] = src

        pending = list(range(len(ios)))
        for attempt in range(self.cfg.max_retries):
            routing = self.routing()
            groups: dict[str, list[int]] = {}
            for i in pending:
                chain = routing.chain(ios[i].chain_id)
                if chain is None:
                    results[i] = IOResult(WireStatus(int(StatusCode.TARGET_NOT_FOUND),
                                                     f"chain {ios[i].chain_id}"))
                    continue
                try:
                    target = self._pick_read_target(chain, attempt, routing)
                except StatusError as e:
                    results[i] = IOResult(WireStatus(int(e.code), str(e)))
                    continue
                # stamp our routing version: a node whose view diverged
                # (e.g. a self-fenced deposed head) answers
                # CHAIN_VERSION_MISMATCH instead of a stale read
                if stamp and not caller_versioned[i]:
                    ios[i].chain_ver = chain.chain_ver
                groups.setdefault(routing.node_address(target.node_id), []).append(i)

            async def read_group(address: str, idxs: list[int],
                                 src: str = "primary"):
                group = [ios[i] for i in idxs]
                # packed fast path: one fixed-stride blob instead of ~70
                # nested structs per batch through the tag codec (the
                # multi-process small-IO path is serde-CPU-bound).
                # Version negotiation is SERVER-ADVERTISED (sending
                # v2 blindly mis-parses on a v1 server, and
                # 43 v2 entries = 51 v1 entries byte-for-byte): the
                # first batch per address rides the struct path with
                # want_packed, the server's BatchReadRsp.packed_ver says
                # what it decodes, and later batches pack at min(server,
                # ours).  A pre-packed server never answers
                # packed_results, so this client never packs to it.
                epoch = self.client.epoch(address)
                memo = self._packed_ver.get(address)
                sver = memo[0] if memo is not None and memo[1] == epoch \
                    else 0
                packed = pack_readios(group, sver) if sver else None
                if packed is not None:
                    req = BatchReadReq(packed_ios=packed, want_packed=True,
                                       packed_ver=sver,
                                       debug=self.cfg.debug)
                else:
                    req = BatchReadReq(ios=group, want_packed=True,
                                       debug=self.cfg.debug)
                try:
                    rsp, payload = await self.client.call(
                        address, "Storage.batch_read", req,
                        timeout=self.cfg.request_timeout_s)
                except StatusError as e:
                    for i in idxs:
                        _install(i, IOResult(
                            WireStatus(int(e.code), str(e))), b"", src)
                    return
                if packed is not None and \
                        self.client.epoch(address) != epoch:
                    # the connection recycled DURING the call (lazy
                    # reconnect inside client.call): the packed blob may
                    # have been decoded by a restarted — possibly
                    # rolled-back — server at the wrong stride, and a
                    # 43-IO v2 batch parses as 51 v1 entries without
                    # error.  Distrust the response: re-send this group
                    # on the struct path.
                    self._packed_ver.pop(address, None)
                    try:
                        rsp, payload = await self.client.call(
                            address, "Storage.batch_read",
                            BatchReadReq(ios=group, want_packed=True,
                                         debug=self.cfg.debug),
                            timeout=self.cfg.request_timeout_s)
                    except StatusError as e:
                        for i in idxs:
                            _install(i, IOResult(
                                WireStatus(int(e.code), str(e))), b"", src)
                        return
                if rsp.packed_results and sver == 0:
                    # memoize under the PRE-call epoch: if the conn
                    # recycled mid-call the memo is instantly stale and
                    # the next batch re-learns (never the unsafe way)
                    self._packed_ver[address] = (
                        min(rsp.packed_ver, PACKED_READIO_VER), epoch)
                rsp_results = (unpack_ioresults(rsp.packed_results)
                               if rsp.packed_results else rsp.results)
                pos = 0
                for i, r in zip(idxs, rsp_results):
                    # inline payloads are concatenated in request order;
                    # no_payload (verify-only) and buf-push IOs contribute
                    # zero bytes regardless of r.length
                    if ios[i].no_payload or ios[i].buf is not None:
                        n = 0
                    else:
                        n = r.length if r.status.code == int(StatusCode.OK) \
                            else 0
                    _install(i, r, payload[pos: pos + n], src)
                    pos += n

            async def hedged_group(address: str, idxs: list[int]):
                primary = asyncio.create_task(read_group(address, idxs))
                # size-class-aware delay: a large batch must not hedge on
                # small-read tail estimates.  length 0 = whole chunk,
                # unknown a priori — assume a small-IO nominal (the
                # KVCache block-get shape that dominates 0-length reads).
                expect = sum(ios[i].length or (64 << 10) for i in idxs)
                delay = min(max(READ_STATS.p9x(address, expect),
                                self.cfg.hedge_delay_floor_s),
                            self.cfg.hedge_delay_cap_s)
                done, _ = await asyncio.wait({primary}, timeout=delay)
                if done:
                    # t3fslint: allow(blocking-in-async) — primary is in asyncio.wait's done set — result() cannot block
                    primary.result()   # propagate unexpected exceptions
                    return
                # primary is past its p9x: plan hedges, one different
                # serving replica per IO (skip chains with no alternative)
                plan: list[tuple[int, str]] = []
                for i in idxs:
                    chain = routing.chain(ios[i].chain_id)
                    alt = (self._pick_hedge_target(chain, routing, address)
                           if chain is not None else None)
                    if alt is not None:
                        plan.append((i, routing.node_address(alt.node_id)))
                grant = self._hedge_budget.take(len(plan))
                if grant <= 0 or not plan:
                    # budget exhausted / nowhere to hedge: behave exactly
                    # like the plain path and wait out the primary (the
                    # retry loop handles its failures)
                    await primary
                    return
                plan = plan[:grant]
                hgroups: dict[str, list[int]] = {}
                for i, a in plan:
                    hgroups.setdefault(a, []).append(i)
                hedged = [i for i, _ in plan]
                hstats["hedge_fired"] += len(hedged)
                tracing.add_event("hedge.fired",
                                  f"n={len(hedged)} primary={address}")
                READ_STATS.hedge(address, fired=len(hedged))
                hedge = asyncio.gather(*[read_group(a, his, "hedge")
                                         for a, his in hgroups.items()])
                tasks = {primary, hedge}
                try:
                    while tasks:
                        done, tasks = await asyncio.wait(
                            tasks, return_when=asyncio.FIRST_COMPLETED)
                        for t in done:
                            # t3fslint: allow(blocking-in-async) — t is in asyncio.wait's done set — result() cannot block
                            t.result()   # surface unexpected exceptions
                        if all(results[i] is not None
                               and results[i].status.code == int(StatusCode.OK)
                               for i in idxs):
                            break   # all settled OK: the loser is discarded
                finally:
                    for t in tasks:
                        t.cancel()
                    if tasks:
                        await asyncio.gather(*tasks, return_exceptions=True)
                won = sum(1 for i in hedged if winner[i] == "hedge")
                hstats["hedge_won"] += won
                hstats["hedge_wasted"] += len(hedged) - won
                if won:
                    tracing.add_event("hedge.won", f"n={won}")
                if len(hedged) - won:
                    tracing.add_event("hedge.cancelled",
                                      f"n={len(hedged) - won}")
                READ_STATS.hedge(address, won=won, wasted=len(hedged) - won)

            if hedging:
                # tokens accrue per primary read issued; hedges spend them
                self._hedge_budget.earn(sum(len(v) for v in groups.values()))
                await asyncio.gather(*[hedged_group(a, idxs)
                                       for a, idxs in groups.items()])
            else:
                await asyncio.gather(*[read_group(a, idxs)
                                       for a, idxs in groups.items()])
            pending = [i for i in pending
                       if results[i] is not None
                       and results[i].status.code != int(StatusCode.OK)
                       and Status(StatusCode(results[i].status.code)).retryable]
            if not pending:
                break
            await self._backoff(attempt)
            await self._maybe_refresh()
        if stats is not None:
            for key, v in hstats.items():
                stats[key] = stats.get(key, 0) + v
        return [r or IOResult(WireStatus(int(StatusCode.INTERNAL), "unset"))
                for r in results], payloads

    # --- file-level ops over a layout ---

    async def write_file_range(self, layout: FileLayout, inode: int,
                               offset: int, data: bytes) -> list[IOResult]:
        """Slice [offset, +len) into chunk writes and run them concurrently."""
        pieces = layout.chunk_span(offset, len(data))
        tasks = []
        pos = 0
        for idx, coff, span in pieces:
            chunk_data = data[pos: pos + span]
            pos += span
            tasks.append(self.write_chunk(
                layout.chain_of(idx), ChunkId(inode, idx), coff, chunk_data,
                chunk_size=layout.chunk_size))
        return list(await asyncio.gather(*tasks))

    async def read_file_range(self, layout: FileLayout, inode: int,
                              offset: int, length: int,
                              hedging: str | None = None
                              ) -> tuple[bytes, list[IOResult]]:
        out = await self.read_file_ranges(layout, [(inode, offset, length)],
                                          hedging=hedging)
        return out[0]

    async def read_file_ranges(
            self, layout: FileLayout,
            ranges: list[tuple[int, int, int]],
            hedging: str | None = None,
    ) -> list[tuple[bytes, list[IOResult]]]:
        """Many (inode, offset, length) ranges in ONE batch_read fan-out —
        the coalescing the reference gets from PioV gathering a ring's
        sqes into one StorageClient batch op (src/fuse/PioV.h:14-37).
        Holes and short chunks zero-fill, same contract as
        read_file_range.  `hedging` opts this call in/out of hedged reads
        (healthy-path checkpoint restores and KVCache ledger scans ride
        the hedged path without a hedging-on client)."""
        all_pieces: list[list[tuple[int, int, int]]] = []
        ios: list[ReadIO] = []
        bounds: list[tuple[int, int]] = []
        for inode, offset, length in ranges:
            pieces = layout.chunk_span(offset, length)
            all_pieces.append(pieces)
            start = len(ios)
            ios.extend(ReadIO(chunk_id=ChunkId(inode, idx),
                              chain_id=layout.chain_of(idx),
                              offset=coff, length=span,
                              verify_checksum=self.cfg.verify_checksums)
                       for idx, coff, span in pieces)
            bounds.append((start, len(ios)))
        results, payloads = await self.batch_read(ios, hedging=hedging)
        out: list[tuple[bytes, list[IOResult]]] = []
        for pieces, (lo, hi) in zip(all_pieces, bounds):
            data = bytearray()
            for (idx, coff, span), r, p in zip(pieces, results[lo:hi],
                                               payloads[lo:hi]):
                if r.status.code == int(StatusCode.CHUNK_NOT_FOUND):
                    data += b"\x00" * span  # hole
                else:
                    data += p
                    if len(p) < span:
                        data += b"\x00" * (span - len(p))  # short tail
            out.append((bytes(data), results[lo:hi]))
        return out

    async def _call_chain_head(self, chain_id: int, method: str, req,
                               *, check_result: bool = False):
        """Call `method` on the chain's CURRENT head, refreshing routing
        and retrying retryable failures — a just-failed-over head is the
        common case (meta's close path lands here moments after a storage
        kill, when its routing cache can still name the dead node; the
        test_app_cluster failure once the test's waits went event-driven
        and outpaced the cache).  A chain that stays missing/headless is
        an ERROR, not a skip: callers settle lengths or reclaim chunks,
        and silently skipping would under-report a length or leak chunks.
        check_result=True additionally unwraps rsp.result.status."""
        last: StatusError | None = None
        for attempt in range(self.cfg.max_retries):
            routing = self.routing()
            chain = routing.chain(chain_id)
            head = chain.head() if chain is not None else None
            if head is None:
                last = StatusError(StatusCode.TARGET_NOT_FOUND,
                                   f"chain {chain_id}: no head in routing")
            else:
                try:
                    rsp, _ = await self.client.call(
                        routing.node_address(head.node_id), method, req)
                    if not check_result:
                        return rsp
                    st = Status(StatusCode(rsp.result.status.code),
                                rsp.result.status.message)
                    if st.ok:
                        return rsp
                    last = StatusError(st.code, st.message)
                    if not st.retryable:
                        break
                except StatusError as e:
                    last = e
                    if not e.status.retryable:
                        break
            await self._backoff(attempt)
            await self._maybe_refresh()
        raise last if last is not None else StatusError(
            StatusCode.TIMEOUT, f"chain {chain_id}: retries exhausted")

    async def query_last_chunk(self, layout: FileLayout, inode: int) -> int:
        """File length via per-chain last-chunk queries (FileOperation
        analog), failover-robust per _call_chain_head."""
        best = 0
        for chain_id in set(layout.chains):
            rsp = await self._call_chain_head(
                chain_id, "Storage.query_last_chunk",
                QueryLastChunkReq(chain_id=chain_id, inode=inode))
            if rsp.last_index >= 0:
                best = max(best, rsp.last_index * layout.chunk_size
                           + rsp.last_length)
        return best

    async def remove_file_chunks(self, layout: FileLayout, inode: int) -> None:
        """Remove the file's chunks on every chain; raises on failure so
        callers (meta GC) requeue instead of leaking chunks."""
        for chain_id in set(layout.chains):
            await self._call_chain_head(
                chain_id, "Storage.remove_chunks",
                RemoveChunksReq(chain_id=chain_id, inode=inode),
                check_result=True)

    async def truncate_file(self, layout: FileLayout, inode: int,
                            new_length: int) -> None:
        """Remove whole chunks past the cut, truncate the boundary chunk."""
        boundary = new_length // layout.chunk_size
        boundary_off = new_length - boundary * layout.chunk_size
        begin = boundary + (1 if boundary_off else 0)
        for chain_id in set(layout.chains):
            await self._call_chain_head(
                chain_id, "Storage.remove_chunks",
                RemoveChunksReq(chain_id=chain_id, inode=inode,
                                begin_index=begin),
                check_result=True)
        if boundary_off:
            r = await self.write_chunk(
                layout.chain_of(boundary), ChunkId(inode, boundary), 0, b"",
                chunk_size=layout.chunk_size, update_type=UpdateType.TRUNCATE,
                truncate_len=boundary_off)
            if r.status.code not in (int(StatusCode.OK),
                                     int(StatusCode.CHUNK_NOT_FOUND)):
                # a failed boundary truncate silently left the old tail
                # bytes readable past new_length (CHUNK_NOT_FOUND is fine:
                # nothing was ever written there, so there is no tail)
                raise make_error(StatusCode(r.status.code),
                                 f"truncate boundary chunk {boundary} of "
                                 f"inode {inode}: {r.status.message}")

    async def _backoff(self, attempt: int) -> None:
        await asyncio.sleep(self.cfg.retry_backoff_s * (2 ** min(attempt, 6))
                            * (0.5 + random.random()))

    async def close(self) -> None:
        await self.client.close()
