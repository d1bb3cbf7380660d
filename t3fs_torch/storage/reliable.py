"""Exactly-once update channels + reliable chain forwarding.

Reference analogs: storage/service/ReliableUpdate.h:19-54 (per-(client,
channel) seqnum dedupe so retries don't re-apply), ReliableForwarding.cc:
33-138 (forward to successor with retry-until-routing-change).
"""

from __future__ import annotations

import asyncio
import logging
import time
import uuid as _uuid
from dataclasses import dataclass, field

from t3fs_torch.storage.types import (
    IOResult, UpdateFragReq, UpdateIO, update_rpc,
)
from t3fs_torch.net.rpcstats import RPC_STATS
from t3fs_torch.net.wire import UpdateFrag, WireStatus, pack_update_frag
from t3fs_torch.ops.codec import crc32c, crc32c_combine
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.storage")


class ReliableUpdate:
    """Dedupe map: (client_id, chain_id, channel) -> (last seq, cached result).

    A client serializes updates per channel; a retry re-sends the same seq.
    Seq regressions are rejected (late duplicates of older requests)."""

    # A channel that has seen no traffic for this long is forgotten; a client
    # that comes back later starts a fresh dedupe window (it must bump seq
    # monotonically per its own channel allocator anyway).  The reference
    # bounds the same map through mgmtd client-session expiry
    # (MgmtdClientSessionsChecker.h); t3fs bounds it locally.
    SESSION_TTL_S = 3600.0
    SESSION_CAPACITY = 65536

    def __init__(self, ttl_s: float = SESSION_TTL_S,
                 capacity: int = SESSION_CAPACITY):
        from t3fs_torch.utils.lock_manager import ExpiringMap, LockManager

        # key -> (last seq, cached result, assigned update_ver, in_flight)
        # in-flight entries are pinned: evicting one mid-update would let a
        # concurrent duplicate run instead of seeing BUSY
        self._sessions = ExpiringMap(ttl_s=ttl_s, capacity=capacity,
                                     pin=lambda v: bool(v and v[3]))
        self._locks = LockManager(high_water=capacity)

    def lock_for(self, io: UpdateIO) -> asyncio.Lock:
        key = (io.client_id, io.chain_id, io.channel)
        return self._locks.get(key)

    def sweep(self) -> int:
        """Expire idle channels (called from the node's background sweep)."""
        return self._sessions.sweep()

    def check(self, io: UpdateIO) -> IOResult | None:
        """Returns cached result for a retry, None for a fresh update."""
        if io.channel == 0:
            return None  # unchanneled (e.g. internal) updates skip dedupe
        key = (io.client_id, io.chain_id, io.channel)
        entry = self._sessions.get(key)
        if entry is None:
            return None
        last_seq, result, _ver, in_flight = entry
        if io.channel_seq == last_seq:
            if result is not None:
                return result
            if in_flight:
                return IOResult(WireStatus(int(StatusCode.BUSY), "in flight"))
            return None   # failed retryably: the retry proceeds (same ver)
        if io.channel_seq < last_seq:
            raise make_error(StatusCode.CHUNK_STALE_UPDATE,
                             f"channel {io.channel} seq {io.channel_seq} < {last_seq}")
        return None

    def begin(self, io: UpdateIO) -> None:
        if io.channel:
            key = (io.client_id, io.chain_id, io.channel)
            prev = self._sessions.get(key)
            keep_ver = prev[2] if prev and prev[0] == io.channel_seq else 0
            self._sessions[key] = (io.channel_seq, None, keep_ver, True)

    def remember_version(self, io: UpdateIO) -> None:
        """Pin the update_ver assigned to this (channel, seq): a retry after
        a retryable failure re-enters with the SAME version and hits the
        replica's idempotent-pending branch instead of CHUNK_BUSY-wedging on
        its own abandoned DIRTY marker."""
        if io.channel:
            key = (io.client_id, io.chain_id, io.channel)
            self._sessions[key] = (io.channel_seq, None, io.update_ver, True)

    def assigned_version(self, io: UpdateIO) -> int:
        if not io.channel:
            return 0
        entry = self._sessions.get((io.client_id, io.chain_id, io.channel))
        if entry and entry[0] == io.channel_seq:
            return entry[2]
        return 0

    def record(self, io: UpdateIO, result: IOResult) -> None:
        """Record an attempt's outcome.  Guards (each prevents a session-
        state corruption a failure path could otherwise cause):
          - seq regressions are ignored (a late duplicate of an older seq
            must not roll the channel backward past a newer cached result);
          - a cached FINAL result (ok or non-retryable) is never clobbered
            by a later failure of the same seq (e.g. a pre-check raise);
          - the BUSY cache-echo served to concurrent duplicates is never
            recorded (it would flip in_flight while the original attempt
            still runs);
          - a failure recorded before version assignment (io.update_ver==0)
            preserves the previously remembered version."""
        if not io.channel:
            return
        from t3fs_torch.utils.status import Status
        st = Status(StatusCode(result.status.code), result.status.message)
        key = (io.client_id, io.chain_id, io.channel)
        prev = self._sessions.get(key)
        prev_ver = 0
        if prev is not None:
            last_seq, prev_res, prev_ver0, _in_flight = prev
            if io.channel_seq < last_seq:
                return
            if io.channel_seq == last_seq:
                prev_ver = prev_ver0
                if prev_res is not None:
                    prev_st = Status(StatusCode(prev_res.status.code),
                                     prev_res.status.message)
                    if prev_st.ok or not prev_st.retryable:
                        return
        if st.code == StatusCode.BUSY and "in flight" in st.message:
            return
        ver = io.update_ver or prev_ver
        if not st.ok and st.retryable:
            # a RETRYABLE failure (disk error, stale chain, successor down)
            # must not pin the failure: the client retries the SAME seq after
            # the chain reshapes — keep only the assigned version so the
            # retry is idempotent against the pending DIRTY chunk
            self._sessions[key] = (io.channel_seq, None, ver, False)
            return
        self._sessions[key] = (io.channel_seq, result, ver, False)


@dataclass
class _FragStream:
    """One in-flight UPDATE_FRAG stream on the receiving hop."""
    frags: dict[int, tuple[bytes, int]] = field(default_factory=dict)
    total_len: int = 0
    eof_seq: int = -1
    nbytes: int = 0
    deadline: float = 0.0
    relayed_to: str | None = None      # cut-through relay destination
    waiter: asyncio.Future | None = None

    def complete(self) -> bool:
        return (self.eof_seq >= 0 and len(self.frags) == self.eof_seq + 1
                and self.nbytes == self.total_len)


class FragmentStore:
    """Reassembles UPDATE_FRAG streams (pipelined CRAQ writes).

    Fragments arrive out of order (one-way posts racing windowed calls,
    relayed frames racing the update RPC that consumes them) keyed by
    stream id; take() awaits completion, rolls the per-fragment CRCs up to
    the chunk checksum (crc32c_combine — no second pass over the bytes),
    and returns the assembled payload.  Buffered bytes are bounded
    node-wide; a stream orphaned by a dead sender expires by TTL on the
    next put/take (there is no background sweeper to leak)."""

    def __init__(self, max_bytes: int = 256 << 20, ttl_s: float = 30.0,
                 combine=crc32c_combine):
        self.max_bytes = max_bytes
        self.ttl_s = ttl_s
        self.combine = combine
        self.buffered_bytes = 0
        self._streams: dict[str, _FragStream] = {}

    def _sweep(self, now: float) -> None:
        for sid, s in list(self._streams.items()):
            if s.deadline and now > s.deadline and (
                    s.waiter is None or s.waiter.done()):
                self.discard(sid)

    def _stream(self, stream_id: str) -> _FragStream:
        s = self._streams.get(stream_id)
        if s is None:
            s = _FragStream(deadline=time.monotonic() + self.ttl_s)
            self._streams[stream_id] = s
        return s

    def put(self, frag: UpdateFrag, payload: bytes) -> int:
        """Buffer one fragment; returns bytes of this stream buffered so
        far.  Raises BUSY (retryable) when the node-wide buffer is full —
        the sender's windowed call fails and it falls back to inline."""
        now = time.monotonic()
        self._sweep(now)
        s = self._stream(frag.stream_id)
        s.deadline = now + self.ttl_s
        if frag.seq not in s.frags:          # duplicate frames are dropped
            # capacity-gate only NEW bytes: a retransmitted frame of an
            # already-buffered fragment adds nothing and must not BUSY
            if self.buffered_bytes + len(payload) > self.max_bytes:
                raise make_error(
                    StatusCode.BUSY,
                    f"fragment buffer full ({self.buffered_bytes}b)")
            s.frags[frag.seq] = (payload, frag.frag_crc)
            s.nbytes += len(payload)
            self.buffered_bytes += len(payload)
        s.total_len = frag.total_len
        if frag.eof:
            s.eof_seq = frag.seq
        if s.complete() and s.waiter is not None and not s.waiter.done():
            s.waiter.set_result(True)
        return s.nbytes

    def mark_relayed(self, stream_id: str, address: str) -> None:
        self._stream(stream_id).relayed_to = address

    async def take(self, stream_id: str,
                   timeout: float) -> tuple[bytes, int, str | None]:
        """Await stream completion; returns (payload, rolled-up CRC,
        relay destination or None).  A stream that never completes within
        timeout (predecessor died mid-stream) fails retryably."""
        s = self._stream(stream_id)
        if not s.complete():
            s.waiter = asyncio.get_running_loop().create_future()
            s.deadline = 0.0          # pinned while a consumer waits
            try:
                await asyncio.wait_for(s.waiter, timeout)
            except asyncio.TimeoutError:
                self.discard(stream_id)
                raise make_error(
                    StatusCode.TIMEOUT,
                    f"fragment stream {stream_id} incomplete after "
                    f"{timeout}s") from None
            finally:
                s.waiter = None
        parts = [s.frags[i] for i in range(s.eof_seq + 1)]
        payload = b"".join(p for p, _ in parts)
        crc = parts[0][1]
        for data, c in parts[1:]:
            crc = self.combine(crc, c, len(data))
        relayed_to = s.relayed_to
        self.discard(stream_id)
        return payload, crc, relayed_to

    def discard(self, stream_id: str) -> None:
        s = self._streams.pop(stream_id, None)
        if s is not None:
            self.buffered_bytes -= s.nbytes


class ReliableForwarding:
    """Forward an applied update to the chain successor, retrying until it
    succeeds or the routing epoch moves past the successor."""

    FRAG_METHOD = "Storage.update_frag"

    def __init__(self, node, max_attempts: int = 30, retry_delay_s: float = 0.05):
        self.node = node  # StorageNode (provides client + routing)
        self.max_attempts = max_attempts
        self.retry_delay_s = retry_delay_s
        # successors whose server predates Storage.update_packed
        # (detected by RPC_METHOD_NOT_FOUND, same negotiation as the
        # client's packed write path)
        self._no_packed: set[str] = set()
        # same negotiation for Storage.update_frag
        self._no_frag: set[str] = set()

    async def _call_update(self, address: str, fwd: UpdateIO,
                           payload: bytes) -> IOResult:
        return await update_rpc(
            self.node.client, address, fwd, payload,
            self.node.forward_timeout_s, self._no_packed,
            "Storage.update_packed", "Storage.update", fwd)

    def _should_stream(self, payload: bytes, attempt: int,
                       address: str) -> bool:
        # only first attempts stream: a retry after a mid-stream failure
        # resends the whole payload inline, so convergence never depends
        # on partial stream state on the successor (it just expires)
        node = self.node
        return (node.write_pipeline == "streamed" and attempt == 0
                and address not in self._no_frag
                and len(payload) >= node.stream_threshold)

    async def _stream_payload(self, address: str, stream_id: str,
                              chain_id: int, chain_ver: int, payload: bytes,
                              relay: bool) -> bool:
        """Ship payload as UPDATE_FRAG frames.  The first, every window-th,
        and the EOF frame are call()s — negotiation (an old server answers
        RPC_METHOD_NOT_FOUND), stream admission, and the cumulative window
        ack bounding unacknowledged in-flight frames; the rest are one-way
        post()s.  True = the whole stream (incl. the EOF ack) landed;
        False = fall back to the inline frame for this attempt."""
        node = self.node
        frag_bytes = max(1, node.stream_frag_bytes)
        window = max(1, node.stream_window)
        total = len(payload)
        nfrags = max(1, -(-total // frag_bytes))
        try:
            for seq in range(nfrags):
                part = payload[seq * frag_bytes:(seq + 1) * frag_bytes]
                frag = UpdateFrag(stream_id=stream_id, chain_id=chain_id,
                                  chain_ver=chain_ver, seq=seq,
                                  total_len=total, frag_crc=crc32c(part),
                                  eof=seq == nfrags - 1, relay=relay)
                req = UpdateFragReq(blob=pack_update_frag(frag))
                if seq == 0 or frag.eof or seq % window == 0:
                    await node.client.call(address, self.FRAG_METHOD, req,
                                           payload=part,
                                           timeout=node.forward_timeout_s)
                else:
                    await node.client.post(address, self.FRAG_METHOD, req,
                                           payload=part)
            return True
        except StatusError as e:
            if e.code == StatusCode.RPC_METHOD_NOT_FOUND:
                self._no_frag.add(address)     # old server: don't retry
            else:
                log.debug("frag stream to %s failed (%s); inline fallback",
                          address, e)
            return False

    async def relay_frag(self, address: str, req: UpdateFragReq,
                         payload: bytes, eof: bool) -> None:
        """Cut-through relay of one received fragment to the successor:
        one-way posts keep the relay off the inbound ack path; the EOF
        frame is a call() so the relay's tail lands before the final
        update RPC chases it.  Failures are swallowed — a broken relay
        surfaces as the downstream take() timeout, which is retryable."""
        try:
            if eof:
                await self.node.client.call(
                    address, self.FRAG_METHOD, req, payload=payload,
                    timeout=self.node.forward_timeout_s)
            else:
                await self.node.client.post(address, self.FRAG_METHOD, req,
                                            payload=payload)
        except Exception as e:
            log.debug("frag relay to %s failed: %s", address, e)

    async def forward(self, target_id: int, io: UpdateIO, payload: bytes,
                      relayed_to: str | None = None) -> IOResult | None:
        """Returns successor's IOResult, or None when there is no successor
        (this target is the tail).  relayed_to: where this hop's
        FragmentStore already relayed the inbound stream (cut-through) —
        when it matches the successor, only the payload-free update RPC
        is sent."""
        attempt = 0
        while True:
            routing = self.node.routing()
            chain = routing.chain(io.chain_id)
            if chain is None:
                raise make_error(StatusCode.TARGET_NOT_FOUND,
                                 f"chain {io.chain_id} gone from routing")
            if chain.chain_ver != io.chain_ver:
                # The chain reshaped between this update's validation and
                # its forward.  Adopting the NEW topology here is how acked
                # data gets lost: a head whose successors were just demoted
                # would see "no successor", declare itself the tail, and
                # commit a single-copy write that mgmtd's authoritative
                # lineage (LASTSRV) later erases via resync.  The reference
                # instead pins every step to the update's chain version
                # (VersionedChainId re-check in StorageOperator::handleUpdate)
                # — fail retryably and let the client re-route at the new
                # version.
                raise make_error(
                    StatusCode.CHAIN_VERSION_MISMATCH,
                    f"chain {io.chain_id} moved v{io.chain_ver} -> "
                    f"v{chain.chain_ver} mid-update")
            succ = chain.successor_of(target_id)
            if succ is None:
                return None
            address = routing.node_address(succ.node_id)
            fwd = io.clone(from_head=True, inline=True, buf=None,
                           chain_ver=chain.chain_ver, stream_id="")
            send_payload = payload
            if self._should_stream(payload, attempt, address):
                if io.stream_id and relayed_to == address:
                    # cut-through: the fragments were already relayed to
                    # this successor as they arrived; send only the
                    # (payload-free) update RPC that consumes them
                    fwd.stream_id = io.stream_id
                    send_payload = b""
                else:
                    sid = _uuid.uuid4().hex
                    if await self._stream_payload(
                            address, sid, io.chain_id, chain.chain_ver,
                            payload, relay=True):
                        fwd.stream_id = sid
                        send_payload = b""
            t0 = time.perf_counter()
            try:
                result = await self._call_update(address, fwd, send_payload)
                # per-hop forward latency for rpc-top / bench diagnosis
                RPC_STATS.record("Storage.forward_hop",
                                 time.perf_counter() - t0, 0.0, 0.0, 0.0)
                return result
            except StatusError as e:
                attempt += 1
                # retry until mgmtd reshapes the chain past the dead successor
                # (infinite-retry semantics, ReliableForwarding.cc:33); bounded
                # here so tests terminate — the bound maps to the heartbeat
                # window within which mgmtd must act
                if attempt >= self.max_attempts:
                    raise make_error(
                        StatusCode.TARGET_OFFLINE,
                        f"forward to t{succ.target_id}@{address} failed after "
                        f"{attempt} attempts: {e}") from None
                await asyncio.sleep(self.retry_delay_s)
