"""Storage service: the CRAQ data-plane brain.

Reference analog: storage/service/StorageOperator.{h,cc} — write (:233) ->
handleUpdate (:333) -> doUpdate (:516) -> forward -> checksum cross-check
(:464-485) -> doCommit (:611); batchRead (:82-231).  One StorageNode hosts
many StorageTargets (one per disk/chain), wired to a routing provider
(mgmtd client or a static fake) and an RPC client for chain forwarding.

Commit ordering is CRAQ: apply locally (DIRTY), forward down the chain,
commit after the successor acks — so the TAIL commits first and the head
replies to the client only after the whole chain committed
(docs/design_notes.md:153-176).

The port of t3fs/storage/service.py.  Every hop's payload CRC goes through
the node's checksum backend, by default the CUDA one (B1,
t3fs_torch/csrc/crc_words.cu, for payloads at or above its cutoff).  Not
ported yet: the usrbio ring plane (Storage.ring_*) and the
StorageEventTrace log.
"""

from __future__ import annotations

import asyncio
import logging
import os
import time as _time
from typing import Callable

from t3fs_torch.mgmtd.types import (
    ChainInfo, LocalTargetState, PublicTargetState, RoutingInfo,
)
from t3fs_torch.net.conn import Connection
from t3fs_torch.net.rdma import batched_read, batched_write
from t3fs_torch.net.server import rpc_method, service
from t3fs_torch.net.wire import UpdateFrag, WireStatus, unpack_update_frag
from t3fs_torch.storage.chunk_engine import ChunkEngine
from t3fs_torch.storage.chunk_replica import ChunkReplica
from t3fs_torch.storage.reliable import (
    FragmentStore, ReliableForwarding, ReliableUpdate,
)
from t3fs_torch.storage.types import (
    BatchReadReq, BatchReadRsp, ChunkId, IOResult, PACKED_READIO_VER,
    PackedIOReq, PackedIORsp,
    QueryChunkReq, QueryChunkRsp, QueryLastChunkReq, QueryLastChunkRsp,
    ReadIO, RemoveChunksReq, SpaceInfoRsp, SyncDoneReq,
    SyncDoneRsp, SyncStartReq, SyncStartRsp, TargetOpReq, TargetOpRsp,
    TruncateChunkReq, UpdateFragReq, UpdateFragRsp, UpdateIO, UpdateType,
    WriteReq, WriteRsp,
    pack_ioresults, unpack_readios, unpack_updateio,
)
from t3fs_torch.utils.fault_injection import fault_raise
from t3fs_torch.utils.metrics import CountRecorder, LatencyRecorder
from t3fs_torch.utils.status import Status, StatusCode, StatusError, make_error
from t3fs_torch.utils import tracing
from t3fs_torch.utils.tracing import add_event as trace_add

log = logging.getLogger("t3fs_torch.storage")

# reads at or below this run inline on the event loop (thread hop costs more
# than the read); larger ones go through the bounded read pool
SMALL_READ_INLINE_BYTES = 64 << 10


class StorageTarget:
    """One target (disk) = chunk engine + CRAQ replica + per-chunk locks.

    Disk mutations run on a dedicated single worker thread per target (the
    reference's UpdateWorker, storage/update/UpdateWorker.{h,cc}): the RPC
    event loop never blocks on pwrite/fsync, and per-disk write ordering
    stays deterministic."""

    def __init__(self, target_id: int, root: str, engine_backend: str = "native"):
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        from t3fs_torch.storage.native_engine import make_engine

        self.target_id = target_id
        # VIRGIN-disk detection for the chain state machine: a target
        # booting on a directory with no prior engine state (fresh disk
        # swap / wiped data) must not be reseated as a chain AUTHORITY —
        # heartbeats carry this until a resync completes, and mgmtd's
        # next_chain_state demotes a "fresh" LASTSRV instead of letting
        # resync propagate its empty disk (craq mega-sweep seed 2802880)
        self.booted_fresh = not (
            _os.path.isdir(root) and _os.listdir(root))
        self.engine = make_engine(root, backend=engine_backend)
        self.replica = ChunkReplica(self.engine)
        from t3fs_torch.utils.lock_manager import LockManager

        # bounded keyed lock table (LockManager reclaims idle locks; the
        # plain dict would grow one asyncio.Lock per chunk forever)
        self._chunk_locks = LockManager(high_water=8192)
        self.update_executor = ThreadPoolExecutor(
            1, thread_name_prefix=f"t3fs-upd-{target_id}")

    def chunk_lock(self, chunk_id: ChunkId) -> asyncio.Lock:
        return self._chunk_locks.get(chunk_id)

    async def run_update(self, fn, *args):
        """Run a replica/engine mutation on this target's update worker."""
        try:
            return await asyncio.get_running_loop().run_in_executor(
                self.update_executor, fn, *args)
        except RuntimeError as e:
            if "after shutdown" in str(e):
                # an in-flight RPC raced the node's stop(): answer with a
                # RETRYABLE code so the client fails over to the reshaped
                # chain instead of surfacing an opaque INTERNAL error
                raise make_error(StatusCode.TARGET_OFFLINE,
                                 "target shutting down") from None
            raise

    def close(self) -> None:
        self.update_executor.shutdown(wait=True)
        self.engine.close()


class StorageNode:
    """Hosts targets + the Storage RPC service on one node."""

    def __init__(self, node_id: int, routing_provider: Callable[[], RoutingInfo],
                 client, forward_timeout_s: float = 10.0,
                 checksum_backend="cuda", read_concurrency: int = 16,
                 write_pipeline: str = "off"):
        from t3fs_torch.storage.codec_backend import make_checksum_backend

        self.node_id = node_id
        self._routing_provider = routing_provider
        self.client = client
        self.forward_timeout_s = forward_timeout_s
        # the codec seam (north star): cuda | cpu | null
        self.codec = make_checksum_backend(checksum_backend)
        self.read_concurrency = read_concurrency
        # pipelined CRAQ writes (docs/design_notes.md §3): off = serialize
        # apply -> CRC -> forward exactly as before; overlap = dispatch the
        # successor forward concurrently with the local CRC+apply; streamed
        # = overlap + cut-through UPDATE_FRAG forwarding above
        # stream_threshold.  All hot-updatable (StorageConfig).
        self.write_pipeline = write_pipeline
        self.stream_threshold = 512 << 10
        self.stream_frag_bytes = 256 << 10
        self.stream_window = 4
        # test/bench hook: injected per-read latency (seconds), making this
        # node a deterministic straggler for the adaptive read path
        self.read_delay_s = 0.0
        self.frag_store = FragmentStore(combine=self.codec.combine)
        self._read_sem: asyncio.Semaphore | None = None
        # io_uring read pipeline (AioReadWorker.h:21-44 analog); started by
        # the server or the fabric when the kernel supports it, else large
        # reads keep the thread-pool path
        self.aio = None
        self.targets: dict[int, StorageTarget] = {}
        # local target states reported in heartbeats (failure-detection input,
        # fbs/mgmtd/LocalTargetInfo.h analog): a fresh/restarted target is
        # ONLINE (data possibly stale) until resync marks it UPTODATE
        self.local_states: dict[int, LocalTargetState] = {}
        self.reliable_update = ReliableUpdate()
        self.forwarding = ReliableForwarding(self)
        self.write_latency = LatencyRecorder(f"storage.write.n{node_id}")
        self.read_count = CountRecorder(f"storage.read_ios.n{node_id}")
        # optional CriticalSectionAuditor (t3fs/testing/race.py §5.2 analog);
        # tests/sims set it to assert per-chunk mutual exclusion live
        self.audit = None
        # self-fencing hook (() -> bool): wired to the mgmtd client's
        # lease tracker by StorageServer; True = this node's mgmtd lease
        # lapsed, refuse writes (reference: suicide.cc at lease/2)
        self.fence: Callable[[], bool] | None = None
        # when set, create_target with an empty root provisions
        # the chunk dir at <default_root>/t<target_id> — the node owns its
        # disk layout, so a remote orchestrator (the rebalancer) doesn't
        # need to know per-node paths
        self.default_root = ""

    def fenced(self) -> bool:
        return self.fence is not None and self.fence()

    def routing(self) -> RoutingInfo:
        return self._routing_provider()

    def add_target(self, target_id: int, root: str,
                   state: LocalTargetState = LocalTargetState.ONLINE,
                   engine_backend: str = "native") -> StorageTarget:
        t = StorageTarget(target_id, root, engine_backend)
        if not self.codec.verify_enabled:
            # null backend: EVERY path (append combine, overwrite recompute,
            # read verify) must agree on checksum 0, or stored checksums
            # diverge across update types and spuriously fail verification
            t.replica.crc = lambda data, crc=0: 0
            t.replica.crc_combine = lambda a, b, len_b: 0
        self.targets[target_id] = t
        self.local_states[target_id] = state
        return t

    # --- chain helpers ---

    def mark_if_disk_error(self, target: StorageTarget, err: Exception) -> bool:
        """Write-error -> offline the target so heartbeats pull it out of its
        chains (reference StorageOperator.cc:604-606 offlineTargets).  Only
        genuine I/O failures qualify: OSError from the python engine, or the
        native engine's typed DISK_ERROR status."""
        is_disk = isinstance(err, OSError) or (
            isinstance(err, StatusError)
            and err.code == StatusCode.DISK_ERROR)
        if not is_disk:
            return False
        if self.local_states.get(target.target_id) != LocalTargetState.OFFLINE:
            log.error("target %d: disk error, going OFFLINE: %s",
                      target.target_id, err)
            self.local_states[target.target_id] = LocalTargetState.OFFLINE
        return True

    def _target_for_chain(self, chain: ChainInfo) -> StorageTarget | None:
        for ct in chain.targets:
            if ct.node_id == self.node_id and ct.target_id in self.targets:
                return self.targets[ct.target_id]
        return None

    def _check_chain(self, chain_id: int, chain_ver: int,
                     require_head: bool = False) -> tuple[ChainInfo, StorageTarget]:
        chain = self.routing().chain(chain_id)
        if chain is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND, f"chain {chain_id}")
        if chain_ver and chain_ver != chain.chain_ver:
            raise make_error(StatusCode.CHAIN_VERSION_MISMATCH,
                             f"chain {chain_id}: req v{chain_ver} != v{chain.chain_ver}")
        target = self._target_for_chain(chain)
        if target is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND,
                             f"chain {chain_id} has no target on node {self.node_id}")
        if require_head:
            head = chain.head()
            if head is None or head.target_id != target.target_id:
                raise make_error(StatusCode.NOT_HEAD,
                                 f"target {target.target_id} is not head of chain {chain_id}")
        return chain, target


@service("Storage")
class StorageService:
    """RPC surface (fbs/storage/Service.h:8-24 analog)."""

    def __init__(self, node: StorageNode):
        self.node = node

    # ---- write path ----

    async def _update_to_result(self, io: UpdateIO, payload: bytes,
                                conn: Connection, require_head: bool) -> IOResult:
        """All gating/transport failures become per-IO result statuses
        (reference: IOResult carries status, not RPC-level errors).  EVERY
        failure is recorded against the update channel — an exception that
        escaped after reliable_update.begin() would otherwise leave the
        session in_flight forever and BUSY-wedge all retries of that seq."""
        try:
            result = await self._handle_update(io, payload, conn, require_head)
        except StatusError as e:
            result = IOResult(WireStatus(int(e.code), str(e)))
        except OSError as e:
            result = IOResult(WireStatus(int(StatusCode.DISK_ERROR),
                                         f"i/o error: {e}"))
        except Exception as e:  # e.g. RuntimeError from a closing executor
            log.exception("update %s failed unexpectedly", io.chunk_id)
            result = IOResult(WireStatus(int(StatusCode.INTERNAL), str(e)))
        if require_head and result.status.code != int(StatusCode.OK):
            self.node.reliable_update.record(io, result)
        return result

    @rpc_method
    async def write(self, req: WriteReq, payload: bytes, conn: Connection):
        """Client entry point; must land on the chain head."""
        with self.node.write_latency.time():
            result = await self._update_to_result(req.io, payload, conn,
                                                  require_head=True)
        return WriteRsp(result=result), b""

    @rpc_method
    async def update(self, req: UpdateIO, payload: bytes, conn: Connection):
        """Chain-internal hop from the predecessor."""
        if not req.from_head:
            raise make_error(StatusCode.INVALID_ARG, "update must come from chain")
        result = await self._update_to_result(req, payload, conn,
                                              require_head=False)
        return WriteRsp(result=result), b""

    # -- packed twins (negotiated by method name: an old server answers
    # RPC_METHOD_NOT_FOUND and the caller falls back to the struct RPC) --

    @staticmethod
    def _packed_rsp(result: IOResult) -> "PackedIORsp":
        packed = pack_ioresults([result])
        if packed is not None:
            return PackedIORsp(packed=packed)
        return PackedIORsp(result=result)   # error message must survive

    @rpc_method
    async def write_packed(self, req: PackedIOReq, payload: bytes,
                           conn: Connection):
        """Client entry point, packed-wire twin of write()."""
        io = unpack_updateio(req.blob)
        with self.node.write_latency.time():
            result = await self._update_to_result(io, payload, conn,
                                                  require_head=True)
        return self._packed_rsp(result), b""

    @rpc_method
    async def update_packed(self, req: PackedIOReq, payload: bytes,
                            conn: Connection):
        """Chain-internal hop, packed-wire twin of update()."""
        io = unpack_updateio(req.blob)
        if not io.from_head:
            raise make_error(StatusCode.INVALID_ARG, "update must come from chain")
        result = await self._update_to_result(io, payload, conn,
                                              require_head=False)
        return self._packed_rsp(result), b""

    # -- fragment streaming (write_pipeline=streamed; design_notes.md §3) --

    @rpc_method
    async def update_frag(self, req: UpdateFragReq, payload: bytes,
                          conn: Connection):
        """One UPDATE_FRAG frame: buffer it for the update RPC that will
        consume the stream, and — cut-through — relay it toward the chain
        successor before this hop's own apply ever runs.  Fragments are
        unvalidated bytes until the version-gated update consumes them; a
        stream orphaned by a dead sender expires by TTL in FragmentStore."""
        node = self.node
        frag = unpack_update_frag(req.blob)
        received = node.frag_store.put(frag, payload)
        if frag.relay and node.write_pipeline == "streamed":
            address = self._frag_relay_address(frag)
            if address is not None:
                node.frag_store.mark_relayed(frag.stream_id, address)
                await node.forwarding.relay_frag(address, req, payload,
                                                 frag.eof)
        return UpdateFragRsp(received=received), b""

    def _frag_relay_address(self, frag: UpdateFrag) -> str | None:
        """Successor address for cut-through relay, or None to keep the
        fragments local (tail, SYNCING successor — which needs the full
        applied chunk, not raw fragments — or a moved/unknown chain; the
        consuming update's own forward handles every such case)."""
        node = self.node
        routing = node.routing()
        chain = routing.chain(frag.chain_id) if routing else None
        if chain is None or chain.chain_ver != frag.chain_ver:
            return None
        target = node._target_for_chain(chain)
        if target is None:
            return None
        succ = chain.successor_of(target.target_id)
        if succ is None or succ.public_state == PublicTargetState.SYNCING:
            return None
        return routing.node_address(succ.node_id)

    async def _handle_update(self, io: UpdateIO, payload: bytes,
                             conn: Connection, require_head: bool) -> IOResult:
        """Trace-wrapped update: when a distributed span is active (sampled
        request), the trace dict tags the hop's server span with the
        apply/forward decomposition."""
        sp = tracing.current_span()
        if sp is None:
            return await self._handle_update_inner(io, payload, conn, require_head)
        result: IOResult | None = None
        trace: dict = {}
        try:
            result = await self._handle_update_inner(io, payload, conn,
                                                     require_head, trace)
            return result
        finally:
            for k in ("target_id", "apply_s", "forward_s", "forward_status"):
                if k in trace:
                    sp.set_tag(k, trace[k])
            sp.set_tag("chunk", str(io.chunk_id))
            sp.set_tag("update_ver", io.update_ver)
            sp.set_tag("head", require_head)
            if result is not None and result.status.code:
                sp.set_status(result.status.code)

    async def _handle_update_inner(self, io: UpdateIO, payload: bytes,
                                   conn: Connection, require_head: bool,
                                   trace: dict | None = None) -> IOResult:
        node = self.node
        if trace is None:
            trace = {}
        fault_raise("storage.update.entry")
        trace_add("storage.update.enter", f"chunk={io.chunk_id}")
        if io.debug.server_should_fail():
            raise make_error(StatusCode.INTERNAL, "injected server error")
        if node.fenced():
            # self-fencing (reference suicide.cc at lease/2): our mgmtd
            # lease lapsed, so routing may already name a new head for
            # this chain — acking any write here could lose acknowledged
            # data when the promoted chain diverges.  TARGET_OFFLINE is
            # retryable: the client refreshes routing and lands on the
            # live chain.  Reads keep serving UNDER THE CLIENT'S CHOICE:
            # a ReadIO stamped with the client's routing chain_ver is
            # version-checked in batch_read (fresh clients bounce off a
            # deposed head via CHAIN_VERSION_MISMATCH); chain_ver=0 opts
            # into the relaxed guarantee (stale read bounded by the
            # committed prefix; a stale ACK is not).
            raise make_error(
                StatusCode.TARGET_OFFLINE,
                f"node {node.node_id} self-fenced: mgmtd lease expired")
        chain, target = node._check_chain(io.chain_id, io.chain_ver,
                                          require_head=require_head)
        trace["target_id"] = target.target_id

        # exactly-once channel dedupe (head only — forwarded hops are
        # version-gated by the replica)
        if require_head:
            cached = node.reliable_update.check(io)
            if cached is not None:
                return cached

        # CRAQ: per-chunk update order must match forward order down
        # the chain, so _locked_update's forward RPC deliberately
        # holds the chunk lock (docs/design_notes.md §3)
        async with target.chunk_lock(io.chunk_id):  # t3fslint: allow(async-lock-await-discipline)
            if node.audit is not None:
                # sanitizer hook (t3fs/testing/race.py): the region from
                # here to return must be per-chunk mutually exclusive —
                # overlap means the chunk lock is broken, and the auditor
                # reports it at the interleaving itself (TSan analog)
                node.audit.enter(("chunk", target.target_id, io.chunk_id),
                                 f"update v{io.update_ver}")
            try:
                return await self._locked_update(
                    node, chain, target, io, payload, conn, require_head,
                    trace)
            finally:
                if node.audit is not None:
                    node.audit.exit(("chunk", target.target_id, io.chunk_id))

    async def _locked_update(self, node, chain, target, io: UpdateIO,
                             payload: bytes, conn: Connection,
                             require_head: bool, trace: dict) -> IOResult:
        from t3fs_torch.storage.types import UpdateType
        if require_head:
            node.reliable_update.begin(io)
        # fetch payload: one-sided pull from requester, inline frame, or
        # UPDATE_FRAG stream (already buffered/relayed by update_frag)
        frags_relayed_to: str | None = None
        stream_crc: int | None = None
        if io.buf is not None and not io.inline:
            payload = await batched_read(conn, io.buf)
            trace_add("storage.update.pulled", f"len={len(payload)}")
        elif io.stream_id and not payload:
            payload, stream_crc, frags_relayed_to = \
                await node.frag_store.take(io.stream_id,
                                           timeout=node.forward_timeout_s)
            trace_add("storage.update.stream", f"len={len(payload)}")
        if io.update_ver == 0:
            # a retry of a retryably-failed attempt reuses the version it
            # was assigned: the replica's idempotent-pending branch then
            # accepts it instead of wedging on its own DIRTY marker
            remembered = node.reliable_update.assigned_version(io) \
                if require_head else 0
            if remembered:
                io.update_ver = remembered
            else:
                meta = target.engine.get_meta(io.chunk_id)
                io.update_ver = (meta.update_ver if meta else 0) + 1
                if require_head:
                    node.reliable_update.remember_version(io)
        io.chain_ver = chain.chain_ver

        # hop overlap (write_pipeline != off): dispatch the successor
        # forward CONCURRENTLY with the local CRC+apply below, instead of
        # after them.  Commit ordering is preserved — the tail still
        # commits first, every replica version-gates what it applies, and
        # the head acks only after BOTH legs returned OK — so the only new
        # state is a successor holding a DIRTY version whose local apply
        # failed, which the same retry/resync machinery that already
        # handles the mirror case (local applied, forward failed)
        # reconciles.  Excluded: a SYNCING successor, whose forward ships
        # the full APPLIED chunk and so needs the local apply first.
        overlap = node.write_pipeline != "off" \
            and self._overlap_ok(chain, target, io)

        # checksum via the codec seam: the device backend micro-batches
        # CRCs across every update concurrently in flight on this node
        # (BASELINE north star; replaces folly::crc32c, Common.h:158)
        payload_crc: int | None = None
        if payload and io.update_type in (UpdateType.WRITE,
                                          UpdateType.REPLACE):
            if not node.codec.verify_enabled:
                io.checksum = 0
                payload_crc = 0
            elif stream_crc is not None:
                # fragment CRCs rolled up at reassembly — no second pass
                payload_crc = stream_crc
            elif not overlap:
                payload_crc = await node.codec.payload_crc(payload)
                # else: computed under the overlap window below

        fwd_task: asyncio.Task | None = None
        t_fwd = _time.perf_counter()
        if overlap:
            fwd_task = asyncio.ensure_future(self._forward(
                chain, target, io, payload, frags_relayed_to,
                defer_full_replace=True))

        t_apply = _time.perf_counter()
        try:
            if overlap and payload_crc is None and payload and \
                    io.update_type in (UpdateType.WRITE, UpdateType.REPLACE):
                payload_crc = await node.codec.payload_crc(payload)
            result = await target.run_update(
                target.replica.apply_update, io, payload, payload_crc)
            trace_add("storage.update.applied", f"ver={io.update_ver}")
        except (OSError, StatusError) as e:
            if fwd_task is not None:
                # let the in-flight forward settle before surfacing the
                # local failure: the successor may apply this version, and
                # version gating + retry/resync reconcile it either way
                await asyncio.gather(fwd_task, return_exceptions=True)
            if node.mark_if_disk_error(target, e):
                result = IOResult(WireStatus(int(StatusCode.DISK_ERROR),
                                             f"disk error: {e}"))
            else:
                result = IOResult(WireStatus(int(e.code), str(e)))
            return result  # _update_to_result records all failures
        trace["apply_s"] = _time.perf_counter() - t_apply

        # forward down the chain (tail commits first); under overlap the
        # forward has been in flight since before the apply
        try:
            if fwd_task is not None:
                succ_result = await fwd_task
            else:
                t_fwd = _time.perf_counter()
                succ_result = await self._forward(chain, target, io, payload,
                                                  frags_relayed_to)
            if succ_result is not None and succ_result.status.code == int(
                    StatusCode.CHUNK_MISSING_UPDATE) \
                    and io.update_type in (UpdateType.WRITE,
                                           UpdateType.TRUNCATE) and overlap:
                # deferred full-replace: under overlap the fallback must
                # wait for the LOCAL apply (it ships the applied chunk),
                # so _forward returned the miss for us to retry here
                succ_result = await self._forward_full_replace(target, io)
            trace_add("storage.update.forwarded")
            trace["forward_s"] = _time.perf_counter() - t_fwd
            if succ_result is not None:
                trace["forward_status"] = succ_result.status.code
        except StatusError as e:
            trace["forward_s"] = _time.perf_counter() - t_fwd
            return IOResult(WireStatus(int(e.code), f"forward: {e}"))

        if succ_result is not None and succ_result.status.code == int(StatusCode.OK):
            # checksum cross-check vs successor (StorageOperator.cc:464-485)
            if (io.update_type == UpdateType.WRITE
                    and succ_result.checksum != result.checksum):
                raise make_error(
                    StatusCode.CHECKSUM_MISMATCH,
                    f"{io.chunk_id}: successor {succ_result.checksum:#x} "
                    f"!= local {result.checksum:#x}")
        elif succ_result is not None:
            return succ_result  # propagate successor failure up the chain

        if io.update_type not in (UpdateType.REMOVE,):
            try:
                result = await target.run_update(
                    target.replica.commit, io.chunk_id, io.update_ver,
                    chain.chain_ver)
            except (OSError, StatusError) as e:
                # a disk that dies between apply and commit must offline
                # the target just like one that dies during apply
                node.mark_if_disk_error(target, e)
                raise
            trace_add("storage.update.committed")
        if require_head:
            node.reliable_update.record(io, result)
        return result

    @staticmethod
    def _overlap_ok(chain: ChainInfo, target: StorageTarget,
                    io: UpdateIO) -> bool:
        """Overlap only when the forward doesn't depend on the LOCAL apply
        having finished: a SYNCING successor gets the full APPLIED chunk
        (_forward_full_replace), which exists only after apply."""
        succ = chain.successor_of(target.target_id)
        if succ is None:
            return False   # tail: nothing to overlap with
        return not (succ.public_state == PublicTargetState.SYNCING
                    and io.update_type in (UpdateType.WRITE,
                                           UpdateType.TRUNCATE))

    async def _forward(self, chain: ChainInfo, target: StorageTarget,
                       io: UpdateIO, payload: bytes,
                       relayed_to: str | None = None,
                       defer_full_replace: bool = False) -> IOResult | None:
        succ = chain.successor_of(target.target_id)
        if succ is None:
            return None
        if succ.public_state == PublicTargetState.SYNCING and \
                io.update_type in (UpdateType.WRITE, UpdateType.TRUNCATE):
            # write-during-recovery: ship the FULL updated chunk so the
            # syncing successor converges (design_notes.md:240-246)
            return await self._forward_full_replace(target, io)
        result = await self.node.forwarding.forward(target.target_id, io,
                                                    payload, relayed_to)
        if result is not None and result.status.code == int(
                StatusCode.CHUNK_MISSING_UPDATE) \
                and io.update_type in (UpdateType.WRITE, UpdateType.TRUNCATE):
            # successor misses earlier updates of this chunk — e.g. it was
            # promoted from SYNCING by a resync round that skipped the chunk
            # because it was DIRTY here.  The reference's doForward falls
            # back to full-chunk forwarding (ReliableForwarding.cc:33-138);
            # replace with our applied content, version-gated so it can
            # never regress a newer successor copy.
            if defer_full_replace:
                # overlap mode: the local apply may still be running —
                # _locked_update retries the full replace after gathering
                # both legs, when the applied content exists
                return result
            return await self._forward_full_replace(target, io)
        return result

    async def _forward_full_replace(self, target: StorageTarget,
                                    io: UpdateIO) -> IOResult | None:
        meta = target.engine.get_meta(io.chunk_id)
        full = target.engine.read(io.chunk_id)
        rep = io.clone(update_type=UpdateType.REPLACE, offset=0,
                       length=len(full), checksum=meta.checksum,
                       commit_ver=0,  # commit decided by chain flow
                       stream_id="")
        return await self.node.forwarding.forward(target.target_id, rep, full)

    # ---- read path ----

    async def _read_one(self, io: ReadIO) -> tuple[IOResult, bytes]:
        """One chunk read to completion: chain check, then inline /
        io_uring / thread-pool engine read.
        Raises StatusError; payload delivery is the caller's business."""
        node = self.node
        node.read_count.add()
        # io.chain_ver = 0 keeps CRAQ read-any semantics; a
        # client that stamps its routing version is fenced off a
        # node with a diverged view (incl. a self-fenced deposed
        # head whose stale routing no longer matches fresh
        # clients') — the relaxed read guarantee
        chain, target = node._check_chain(io.chain_id, io.chain_ver)
        # small IOs run inline: the thread hop costs more than the
        # read itself (KVCache-style 4-64 KiB random reads); large
        # reads hop to a worker so they can't stall the event loop
        meta_hint = None
        length_hint = io.length
        if not length_hint:
            meta_hint = target.engine.get_meta(io.chunk_id)
            length_hint = meta_hint.length if meta_hint else 0
        if length_hint <= SMALL_READ_INLINE_BYTES:
            result, data = target.replica.read(io, meta_hint)
        elif node.aio is not None:
            # io_uring path: disk read runs in the kernel, no
            # thread hop, no engine lock held across the IO
            async with node._read_sem:
                result, data = await target.replica.read_aio(
                    io, node.aio, meta_hint)
        else:
            async with node._read_sem:
                result, data = await asyncio.to_thread(
                    target.replica.read, io, meta_hint)
        return result, data

    @rpc_method
    async def batch_read(self, req: BatchReadReq, payload: bytes, conn: Connection):
        """Reads go to ANY serving target (CRAQ read-any).

        IOs run CONCURRENTLY: engine reads hop to worker threads (both
        engines take shared/brief locks, so reads parallelize) bounded by a
        node-wide semaphore — the reference's AioReadWorker + job-split
        architecture (storage/aio/AioReadWorker.h:21-44, job split at
        StorageOperator.cc:162-169).  Response order is preserved."""
        node = self.node
        if req.debug.server_should_fail():
            raise make_error(StatusCode.INTERNAL, "injected server error")
        if node.read_delay_s:
            await asyncio.sleep(node.read_delay_s)   # injected straggler
        if node._read_sem is None:
            node._read_sem = asyncio.Semaphore(node.read_concurrency)
        ios = (unpack_readios(req.packed_ios, req.packed_ver)
               if req.packed_ios else req.ios)
        sp = tracing.current_span()
        if sp is not None:
            # total payload bytes: lets the health rollup bucket this
            # span's latency into the client's read size classes
            sp.set_tag("bytes", sum(io.length for io in ios))

        async def one(io: ReadIO) -> tuple[IOResult, bytes | None]:
            try:
                result, data = await self._read_one(io)
                if io.no_payload:
                    return result, b""   # verify-only: status travels, bytes don't
                if io.buf is not None:
                    await batched_write(conn, io.buf.slice(0, len(data)),
                                        data)
                    return result, None
                return result, data
            except StatusError as e:
                return (IOResult(WireStatus(int(e.code), str(e))),
                        None if io.buf is not None else b"")

        pairs = await asyncio.gather(*(one(io) for io in ios))
        results = [r for r, _ in pairs]
        inline_parts = [d for _, d in pairs if d is not None]
        if req.want_packed:
            packed = pack_ioresults(results)
            if packed is not None:
                # packed_ver advertises OUR request-side decode stride;
                # the client packs later batches at min(this, its own)
                return (BatchReadRsp(packed_results=packed,
                                     packed_ver=PACKED_READIO_VER),
                        b"".join(inline_parts))
        return BatchReadRsp(results=results), b"".join(inline_parts)

    # ---- metadata-ish ops ----

    @rpc_method
    async def query_last_chunk(self, req: QueryLastChunkReq, payload, conn):
        _, target = self.node._check_chain(req.chain_id, 0)
        metas = target.engine.query_range(req.inode)
        rsp = QueryLastChunkRsp()
        if metas:
            last = metas[-1]
            rsp.last_index = last.chunk_id.index
            rsp.last_length = last.length
            rsp.total_chunks = len(metas)
            rsp.total_length = sum(m.length for m in metas)
        return rsp, b""

    @rpc_method
    async def remove_chunks(self, req: RemoveChunksReq, payload, conn):
        """Range remove via the chain (head entry), chunk by chunk.

        Each chunk's remove re-resolves the chain and retries bounded on
        retryable failures: a chain-version bump mid-loop (e.g. our own
        routing refresh landing between IOs) must not silently skip chunks
        — a skipped remove leaves the chunk resurrectable by resync.  A
        chunk that still fails makes the whole RPC report that failure so
        the caller can retry."""
        _, target = self.node._check_chain(req.chain_id, 0, require_head=True)
        removed = 0
        first_fail: IOResult | None = None
        for meta in target.engine.query_range(req.inode, req.begin_index,
                                              req.end_index):
            result = None
            for _ in range(5):
                chain, _t = self.node._check_chain(req.chain_id, 0,
                                                   require_head=True)
                io = UpdateIO(chunk_id=meta.chunk_id, chain_id=req.chain_id,
                              chain_ver=chain.chain_ver,
                              update_type=UpdateType.REMOVE,
                              update_ver=meta.update_ver + 1, from_head=True)
                result = await self._update_to_result(io, b"", conn,
                                                      require_head=False)
                st = Status(StatusCode(result.status.code),
                            result.status.message)
                if st.ok or not st.retryable:
                    break
                await asyncio.sleep(0.05)
            if result is not None and result.status.code == int(StatusCode.OK):
                removed += 1
            elif first_fail is None:
                first_fail = result
        if first_fail is not None:
            return WriteRsp(result=first_fail), b""
        return WriteRsp(result=IOResult(WireStatus(), removed)), b""

    @rpc_method
    async def truncate_chunk(self, req: TruncateChunkReq, payload, conn):
        chain, _ = self.node._check_chain(req.chain_id, 0, require_head=True)
        io = UpdateIO(chunk_id=req.chunk_id, chain_id=req.chain_id,
                      chain_ver=chain.chain_ver, update_type=UpdateType.TRUNCATE,
                      length=req.new_length, chunk_size=req.chunk_size)
        result = await self._update_to_result(io, b"", conn, require_head=True)
        return WriteRsp(result=result), b""

    @rpc_method
    async def space_info(self, req, payload, conn):
        used = sum(t.engine.stats().used_bytes for t in self.node.targets.values())
        alloc = sum(t.engine.stats().allocated_bytes for t in self.node.targets.values())
        return SpaceInfoRsp(capacity=alloc, used=used, free=max(0, alloc - used)), b""

    # ---- admin target ops (fbs/storage/Service.h:8-24) ----

    @rpc_method
    async def create_target(self, req: TargetOpReq, payload, conn):
        """Provision a new target (disk dir) on this node; it joins chains
        via mgmtd update_chain + resync."""
        node = self.node
        root = req.root
        if not root:
            if not node.default_root:
                raise make_error(StatusCode.INVALID_ARG,
                                 "create_target: no root (and this node has "
                                 "no default data root configured)")
            root = os.path.join(node.default_root, f"t{req.target_id}")
        existing = node.targets.get(req.target_id)
        if existing is not None:
            # idempotent re-create: same id + same root is a no-op success
            # (a restarted orchestrator re-attaches); a different root is a
            # conflict — silently reusing the other disk would be wrong
            if existing.engine.root == root:
                # re-provisioning an OFFLINE target brings it back ONLINE:
                # a rebalance that moves a chain back onto a previously
                # drained target must not leave it wedged at local OFFLINE
                # (the chain machine would never promote it past public
                # OFFLINE).  Its stale chunks are reconciled by resync —
                # ONLINE, not UPTODATE, so it re-enters via SYNCING.
                if node.local_states.get(req.target_id) == \
                        LocalTargetState.OFFLINE:
                    node.local_states[req.target_id] = \
                        LocalTargetState.ONLINE
                return TargetOpRsp(
                    target_id=req.target_id,
                    state=int(node.local_states.get(
                        req.target_id, LocalTargetState.ONLINE))), b""
            raise make_error(StatusCode.INVALID_ARG,
                             f"target {req.target_id} already exists at "
                             f"{existing.engine.root}")
        t = node.add_target(req.target_id, root,
                            state=LocalTargetState.ONLINE,
                            engine_backend=req.engine_backend)
        return TargetOpRsp(target_id=t.target_id,
                           state=int(LocalTargetState.ONLINE)), b""

    @rpc_method
    async def offline_target(self, req: TargetOpReq, payload, conn):
        """Operator-initiated offline: heartbeats propagate it and mgmtd
        pulls the target out of its chains."""
        node = self.node
        if req.target_id not in node.targets:
            raise make_error(StatusCode.TARGET_NOT_FOUND, str(req.target_id))
        node.local_states[req.target_id] = LocalTargetState.OFFLINE
        return TargetOpRsp(target_id=req.target_id,
                           state=int(LocalTargetState.OFFLINE)), b""

    @rpc_method
    async def remove_target(self, req: TargetOpReq, payload, conn):
        """Drop a target from this node.  Requires the target locally
        OFFLINE *and* out of the live chain in routing (OFFLINE/WAITING):
        removing (then re-creating) a still-SERVING/LASTSRV target would
        seat an empty disk as an authoritative copy."""
        node = self.node
        t = node.targets.get(req.target_id)
        if t is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND, str(req.target_id))
        if node.local_states.get(req.target_id) != LocalTargetState.OFFLINE:
            raise make_error(StatusCode.INVALID_ARG,
                             f"target {req.target_id} not OFFLINE")
        routing = node.routing()
        if routing is not None:
            for chain in routing.chains.values():
                for ct in chain.targets:
                    if ct.target_id == req.target_id and ct.public_state not \
                            in (PublicTargetState.OFFLINE,
                                PublicTargetState.WAITING):
                        raise make_error(
                            StatusCode.INVALID_ARG,
                            f"target {req.target_id} is still "
                            f"{ct.public_state.name} in chain "
                            f"{chain.chain_id}; wait for mgmtd to demote it")
        node.targets.pop(req.target_id, None)
        node.local_states.pop(req.target_id, None)
        # close() joins the update worker — never on the event loop
        await asyncio.to_thread(t.close)
        return TargetOpRsp(target_id=req.target_id), b""

    @rpc_method
    async def query_chunk(self, req: QueryChunkReq, payload, conn):
        """One chunk's metadata (admin/debug; reference queryChunk)."""
        if req.target_id:
            target = self.node.targets.get(req.target_id)
            if target is None:
                # never silently answer from a different target
                raise make_error(StatusCode.TARGET_NOT_FOUND,
                                 f"target {req.target_id}")
        else:
            _, target = self.node._check_chain(req.chain_id, 0)
        meta = target.engine.get_meta(req.chunk_id)
        return QueryChunkRsp(found=meta is not None, meta=meta), b""

    @rpc_method
    async def get_all_chunk_metadata(self, req: TargetOpReq, payload, conn):
        """Full chunk-meta dump by target id (admin sweep analog of the
        resync-path sync_start, which addresses by chain)."""
        t = self.node.targets.get(req.target_id)
        if t is None:
            raise make_error(StatusCode.TARGET_NOT_FOUND, str(req.target_id))
        return SyncStartRsp(metas=t.engine.all_metas()), b""

    # ---- resync protocol (predecessor-driven, ResyncWorker.cc analog) ----

    @rpc_method
    async def sync_start(self, req: SyncStartReq, payload, conn):
        """Return the full chunk-meta dump of this chain's local target so the
        predecessor can diff (ResyncWorker.cc:101-180)."""
        _, target = self.node._check_chain(req.chain_id, 0)
        return SyncStartRsp(metas=target.engine.all_metas()), b""

    @rpc_method
    async def sync_done(self, req: SyncDoneReq, payload, conn):
        """Predecessor finished streaming diffs: this target's data is now
        up to date — report UPTODATE in heartbeats so mgmtd promotes it."""
        _, target = self.node._check_chain(req.chain_id, 0)
        self.node.local_states[target.target_id] = LocalTargetState.UPTODATE
        target.booted_fresh = False     # now holds the chain's lineage
        return SyncDoneRsp(), b""
