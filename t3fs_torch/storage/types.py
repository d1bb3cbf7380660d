"""Storage wire/engine types.

Reference analogs: fbs/storage/Common.h — ChunkId (128-bit inode||index,
:82-110), ChunkState (:60), IOResult (:221), ReadIO/UpdateIO/CommitIO
(:309-355), VersionedChainId (:252-268), UpdateChannel/MessageTag (:271-288).
"""

from __future__ import annotations

import enum
import struct
from dataclasses import dataclass, field, replace as _dc_replace

from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.net.wire import WireStatus
from t3fs_torch.net.rdma import RemoteBuf
from t3fs_torch.utils.fault_injection import DebugFlags


@serde_struct
@dataclass(frozen=True, order=True)
class ChunkId:
    """128-bit chunk address: (inode/object id, chunk index) — clients compute
    chunk->chain placement from this with zero metadata involvement."""
    inode: int = 0
    index: int = 0

    def encode(self) -> bytes:
        return struct.pack(">QQ", self.inode, self.index)

    @classmethod
    def decode(cls, b: bytes) -> "ChunkId":
        hi, lo = struct.unpack(">QQ", b)
        return cls(hi, lo)

    def __str__(self) -> str:
        return f"{self.inode:x}.{self.index}"


class ChunkState(enum.IntEnum):
    COMMIT = 0     # committed, serveable
    DIRTY = 1      # update applied, commit pending (CRAQ "pending version")


@serde_struct
@dataclass
class ChunkMeta:
    chunk_id: ChunkId = field(default_factory=ChunkId)
    length: int = 0
    update_ver: int = 0
    commit_ver: int = 0
    chain_ver: int = 0
    checksum: int = 0          # CRC32C of current content
    state: ChunkState = ChunkState.COMMIT


class UpdateType(enum.IntEnum):
    WRITE = 0
    TRUNCATE = 1
    REMOVE = 2
    REPLACE = 3    # full-chunk-replace (resync path)


@serde_struct
@dataclass
class UpdateIO:
    """One CRAQ update as shipped client->head->successors."""
    chunk_id: ChunkId = field(default_factory=ChunkId)
    chain_id: int = 0
    chain_ver: int = 0
    update_type: UpdateType = UpdateType.WRITE
    offset: int = 0
    length: int = 0
    chunk_size: int = 0        # size class to create the chunk in
    update_ver: int = 0        # 0 on client entry; head assigns
    commit_ver: int = 0
    checksum: int = 0          # CRC32C of the payload
    channel: int = 0           # exactly-once: (client channel, seqnum)
    channel_seq: int = 0
    client_id: str = ""
    buf: RemoteBuf | None = None       # pull payload from requester (RDMA READ)
    inline: bool = False               # payload rides the frame instead
    is_sync: bool = False              # full-chunk-replace during resync
    from_head: bool = False            # set on forwarded hops
    commit_only: bool = False
    debug: DebugFlags = field(default_factory=DebugFlags)
    # fragment-streamed payload (write pipelining, docs/design_notes.md §3):
    # non-empty names an UPDATE_FRAG stream the receiver reassembles instead
    # of reading the frame payload.  Appended last (serde add-only).
    stream_id: str = ""
    # REMOVE fence (KVCache eviction): nonzero means "remove only if the
    # chunk's update_ver is still <= this" — a racing write that bumped
    # the version past the fence answers CHUNK_STALE_UPDATE and the newer
    # block survives.  Checked under the head's per-chunk lock, so
    # verify-read -> fenced-remove is race-free end to end.  Serde
    # add-only; fenced removes ride the struct wire path (pack_updateio
    # declines them), which is fine — GC removes are paced, not IOPS-hot.
    remove_fence_ver: int = 0

    def clone(self, **overrides) -> "UpdateIO":
        """Copy for a forwarded/derived hop.  The old
        `UpdateIO(**io.__dict__)` idiom shared the mutable DebugFlags (a
        fault-injection countdown on the copy would tick the original's
        state too, and vice versa); clone gives the copy its own debug
        unless the caller overrides it."""
        out = _dc_replace(self, **overrides)
        if "debug" not in overrides:
            out.debug = _dc_replace(self.debug)
        return out


@serde_struct
@dataclass
class ReadIO:
    chunk_id: ChunkId = field(default_factory=ChunkId)
    chain_id: int = 0
    offset: int = 0
    length: int = 0
    buf: RemoteBuf | None = None       # push result into requester (RDMA WRITE)
    verify_checksum: bool = False
    allow_uncommitted: bool = False
    # verify-only: server reads + checks but returns NO payload (admin
    # checksum sweeps would otherwise ship every chunk to the operator)
    no_payload: bool = False
    # routing-version fence, like UpdateIO: 0 = unfenced
    # (the relaxed CRAQ read-any guarantee — a fenced/deposed node may
    # serve its committed prefix); a client that stamps its routing's
    # chain_ver gets CHAIN_VERSION_MISMATCH from any node whose view
    # diverged, closing the stale-read window during a partition.
    # Appended last so positional construction stays stable.
    chain_ver: int = 0

    def clone(self, **overrides) -> "ReadIO":
        """Copy for a derived attempt: batch_read restamps chain_ver per
        attempt and must do so on a PRIVATE copy, or a caller-reused
        ReadIO list carries a stale stamped version into its next call."""
        return _dc_replace(self, **overrides)


@serde_struct
@dataclass
class IOResult:
    """Per-IO outcome (fbs/storage/Common.h:221)."""
    status: WireStatus = field(default_factory=WireStatus)
    length: int = 0
    update_ver: int = 0
    commit_ver: int = 0
    commit_chain_ver: int = 0
    checksum: int = 0


@serde_struct
@dataclass
class BatchReadReq:
    ios: list[ReadIO] = field(default_factory=list)
    inline: bool = False
    debug: DebugFlags = field(default_factory=DebugFlags)
    # packed fast path (append-only fields): the KVCache-style small-IO
    # batches are IOPS-bound on serde CPU — a 32-IO batch is ~70 nested
    # structs each way through the tag-walking codec.  packed_ios is the
    # same list as ONE fixed-stride blob (pack_readios); want_packed asks
    # the server to answer in kind, so old clients/servers interop: an
    # old client never sets it, an old server ignores both fields.
    packed_ios: bytes = b""
    want_packed: bool = False
    # packed_ios stride version.  v1 (43-byte entries, no chain_ver) is
    # the default an OLD client's serde implies by omitting the field;
    # v2 appends chain_ver (51 bytes).  The server picks the unpack
    # stride from this tag — stride-sniffing would mis-parse a 51-IO v1
    # batch (51*43 is a multiple of both strides).
    packed_ver: int = 1


@serde_struct
@dataclass
class BatchReadRsp:
    results: list[IOResult] = field(default_factory=list)
    # inline payloads are concatenated in the frame payload, per-IO lengths
    # in results[i].length
    # packed IOResults (pack_ioresults; only when the request set
    # want_packed and no result carries an error message)
    packed_results: bytes = b""
    # HIGHEST packed_ios stride version this server decodes.  A v1-era
    # server's serde omits the field -> decodes as 1; a pre-packed
    # server answers no packed_results at all.  The client sends its
    # FIRST batch per address on the struct path and packs subsequent
    # batches at the server's advertised version — never above it
    # (a v2 blob on a v1 server mis-parses, and 43 v2
    # entries = 51 v1 entries byte-for-byte, silently).
    packed_ver: int = 1


@serde_struct
@dataclass
class WriteReq:
    io: UpdateIO = field(default_factory=UpdateIO)


@serde_struct
@dataclass
class WriteRsp:
    result: IOResult = field(default_factory=IOResult)


@serde_struct
@dataclass
class QueryLastChunkReq:
    chain_id: int = 0
    inode: int = 0


@serde_struct
@dataclass
class QueryLastChunkRsp:
    status: WireStatus = field(default_factory=WireStatus)
    last_index: int = -1           # -1: no chunks
    last_length: int = 0
    total_chunks: int = 0
    total_length: int = 0


@serde_struct
@dataclass
class RemoveChunksReq:
    chain_id: int = 0
    inode: int = 0
    begin_index: int = 0
    end_index: int = 1 << 62


@serde_struct
@dataclass
class TruncateChunkReq:
    chain_id: int = 0
    chunk_id: ChunkId = field(default_factory=ChunkId)
    new_length: int = 0
    chunk_size: int = 0


@serde_struct
@dataclass
class SpaceInfoRsp:
    capacity: int = 0
    used: int = 0
    free: int = 0


@serde_struct
@dataclass
class SyncStartReq:
    """Predecessor asks the syncing target for its full chunk-meta dump
    (reference: syncStart RPC, ResyncWorker.cc:101-180)."""
    chain_id: int = 0


@serde_struct
@dataclass
class SyncStartRsp:
    metas: list[ChunkMeta] = field(default_factory=list)


@serde_struct
@dataclass
class TargetOpReq:
    """Admin target ops (fbs/storage/Service.h:8-24: createTarget,
    offlineTarget, removeTarget, getAllChunkMetadata)."""
    target_id: int = 0
    root: str = ""               # create_target: data directory
    engine_backend: str = "native"
    chain_id: int = 0            # alternative addressing for meta dumps


@serde_struct
@dataclass
class TargetOpRsp:
    ok: bool = True
    target_id: int = 0
    state: int = 0               # LocalTargetState after the op


@serde_struct
@dataclass
class QueryChunkReq:
    """queryChunk: one chunk's metadata on one target (admin/debug)."""
    chain_id: int = 0
    target_id: int = 0
    chunk_id: ChunkId = field(default_factory=lambda: ChunkId(0, 0))


@serde_struct
@dataclass
class QueryChunkRsp:
    found: bool = False
    meta: ChunkMeta | None = None


@serde_struct
@dataclass
class SyncDoneReq:
    chain_id: int = 0


@serde_struct
@dataclass
class SyncDoneRsp:
    ok: bool = True


# ---- packed batch-IO fast path (see BatchReadReq.packed_ios) ----

# inode/index are UNSIGNED 64-bit (KVCache derives inodes from hashes
# with the top bit set; EC parity uses bit 62)
_IORESULT_FMT = struct.Struct("<6q")            # code len uv cv ccv crc
PACKED_READIO_VER = 2
_READIO_FMT = struct.Struct("<2Q3q3Bq")  # v2: inode idx chain off len +flags +chain_ver
_READIO_FMT_V1 = struct.Struct("<2Q3q3B")  # legacy (pre-chain_ver) stride


def pack_ioresults(results: list[IOResult]) -> bytes | None:
    """Fixed-stride encoding of a result list; None when any result
    carries an error message (the detail must survive, so those batches
    stay on the struct path)."""
    out = bytearray()
    pack = _IORESULT_FMT.pack
    try:
        for r in results:
            if r.status.message:
                return None
            out += pack(r.status.code, r.length, r.update_ver, r.commit_ver,
                        r.commit_chain_ver, r.checksum)
    except struct.error:
        return None     # out-of-range field: the struct path handles it
    return bytes(out)


def unpack_ioresults(blob: bytes) -> list[IOResult]:
    return [IOResult(WireStatus(code), length, uv, cv, ccv, crc)
            for code, length, uv, cv, ccv, crc
            in _IORESULT_FMT.iter_unpack(blob)]


def pack_readios(ios: list[ReadIO],
                 ver: int = PACKED_READIO_VER) -> bytes | None:
    """Fixed-stride encoding of a read batch at the given protocol
    version (never above what the server advertised); None when any IO
    carries a RemoteBuf (buf-push IOs need the full struct)."""
    out = bytearray()
    v1 = ver < PACKED_READIO_VER
    pack = (_READIO_FMT_V1 if v1 else _READIO_FMT).pack
    try:
        for io in ios:
            if io.buf is not None:
                return None
            if v1:
                # a v1 server ignores chain_ver anyway (relaxed reads)
                out += pack(io.chunk_id.inode, io.chunk_id.index,
                            io.chain_id, io.offset, io.length,
                            io.verify_checksum, io.allow_uncommitted,
                            io.no_payload)
            else:
                out += pack(io.chunk_id.inode, io.chunk_id.index,
                            io.chain_id, io.offset, io.length,
                            io.verify_checksum, io.allow_uncommitted,
                            io.no_payload, io.chain_ver)
    except struct.error:
        return None     # out-of-range field: the struct path handles it
    return bytes(out)


def unpack_readios(blob: bytes, ver: int = 1) -> list[ReadIO]:
    if ver < PACKED_READIO_VER:
        # old client: legacy stride, chain_ver absent -> 0 (relaxed read)
        return [ReadIO(ChunkId(inode, idx), chain, off, length, None,
                       bool(vc), bool(au), bool(np_))
                for inode, idx, chain, off, length, vc, au, np_
                in _READIO_FMT_V1.iter_unpack(blob)]
    return [ReadIO(ChunkId(inode, idx), chain, off, length, None,
                   bool(vc), bool(au), bool(np_), cv)
            for inode, idx, chain, off, length, vc, au, np_, cv
            in _READIO_FMT.iter_unpack(blob)]

# ---- packed UpdateIO fast path (write / chain-forward hop) ----
# The write path walks ~20 tagged fields per UpdateIO each way through
# the tag codec — on the 1-CPU multi-process fabric serde IS the write
# bottleneck (reads got the same treatment).  The
# common-case UpdateIO (no RemoteBuf, no fault injection) packs to one
# fixed-stride head + the client_id tail.  Negotiation is by METHOD
# name: Storage.write_packed / Storage.update_packed answer
# RPC_METHOD_NOT_FOUND on an old server, and the caller memoizes the
# address and falls back to the struct path.

_UPDATEIO_FMT = struct.Struct("<2Q10q3B")   # inode idx | chain chain_ver off
# len csize uver cver cksum chan chanseq | type flags cid_len


def pack_updateio(io: UpdateIO) -> bytes | None:
    """None when the IO needs the full struct (RemoteBuf pull, fault
    injection flags, oversized client_id, out-of-range field)."""
    d = io.debug
    if io.buf is not None or io.stream_id or io.remove_fence_ver or \
            d.inject_server_error_prob or \
            d.inject_client_error_prob or d.num_points_before_fail:
        return None
    cid = io.client_id.encode()
    if len(cid) > 255:
        return None
    flags = (io.inline | io.is_sync << 1 | io.from_head << 2
             | io.commit_only << 3)
    try:
        head = _UPDATEIO_FMT.pack(
            io.chunk_id.inode, io.chunk_id.index, io.chain_id, io.chain_ver,
            io.offset, io.length, io.chunk_size, io.update_ver,
            io.commit_ver, io.checksum, io.channel, io.channel_seq,
            int(io.update_type), flags, len(cid))
    except struct.error:
        return None
    return head + cid


def unpack_updateio(blob: bytes) -> UpdateIO:
    (inode, idx, chain, cver, off, length, csize, uver, commit_ver, cksum,
     chan, chanseq, utype, flags, cid_len) = _UPDATEIO_FMT.unpack_from(blob)
    cid = blob[_UPDATEIO_FMT.size:]
    if len(cid) != cid_len:
        raise ValueError(f"packed UpdateIO tail {len(cid)} != {cid_len}")
    return UpdateIO(
        chunk_id=ChunkId(inode, idx), chain_id=chain, chain_ver=cver,
        update_type=UpdateType(utype), offset=off, length=length,
        chunk_size=csize, update_ver=uver, commit_ver=commit_ver,
        checksum=cksum, channel=chan, channel_seq=chanseq,
        client_id=cid.decode(), inline=bool(flags & 1),
        is_sync=bool(flags & 2), from_head=bool(flags & 4),
        commit_only=bool(flags & 8))


@serde_struct
@dataclass
class PackedIOReq:
    """One packed UpdateIO (write_packed / update_packed): a single
    bytes field instead of a ~20-field nested struct."""
    blob: bytes = b""


@serde_struct
@dataclass
class PackedIORsp:
    """packed = _IORESULT_FMT when the result has no error message;
    result carries the full struct otherwise."""
    packed: bytes = b""
    result: IOResult | None = None


@serde_struct
@dataclass
class UpdateFragReq:
    """One UPDATE_FRAG frame (pipelined writes): the fixed-stride frag
    descriptor (t3fs/net/wire.py pack_update_frag) rides a single bytes
    field, the fragment data rides the frame payload."""
    blob: bytes = b""


@serde_struct
@dataclass
class UpdateFragRsp:
    """Window ack for a call()-type fragment; received = bytes of this
    stream buffered so far on the receiver (diagnostics)."""
    ok: bool = True
    received: int = 0


# ---- ring data plane (t3fs_torch/usrbio/ring_client.py; docs/usrbio.md) ----
# One Storage.ring_rw frame carries a WHOLE submission batch as a single
# fixed-stride SQE array (CSqe analog, lib/usrbio.py) — one envelope, one
# serde pass, N IOs — and answers with a packed CQE array (_IORESULT_FMT
# stride) carrying per-IO status + the device CRC32C from the chunk
# engine/codec.  Bulk payload bytes never ride these frames: they move
# through the attach-time registered arena (shm aliasing on the same
# host, one-sided Buf.read/Buf.write across hosts).  Negotiation is by
# METHOD name, exactly like the packed write twins above: an old server
# answers RPC_METHOD_NOT_FOUND and the client falls back to the rpc
# data plane for that address.

RING_OP_READ = 0
RING_OP_WRITE = 1
# read-SQE flag bits (mirror ReadIO's booleans)
RING_F_VERIFY = 1
RING_F_UNCOMMITTED = 2
RING_F_NO_PAYLOAD = 4

# inode idx | chain off len iov_off aux cksum chan chanseq chain_ver | op flags
# `aux` is per-op: read = destination capacity at iov_off (the server
# truncates delivery to it; the client re-reads rare oversizes via rpc),
# write = chunk_size.  cksum/chan/chanseq are write-only (0 on reads).
_RING_SQE_FMT = struct.Struct("<2Q9q2B")


def pack_ring_sqes(recs) -> bytes | None:
    """Fixed-stride encoding of ring SQE tuples (13 fields, see
    _RING_SQE_FMT); None when any field is out of range — that IO takes
    the struct rpc path instead."""
    out = bytearray()
    pack = _RING_SQE_FMT.pack
    try:
        for r in recs:
            out += pack(*r)
    except struct.error:
        return None
    return bytes(out)


def unpack_ring_sqes(blob: bytes):
    return _RING_SQE_FMT.iter_unpack(blob)


@serde_struct
@dataclass
class RingAttachReq:
    """Register a client arena with this storage node.  shm_name names
    the arena's iov segment for same-host aliasing (the server tries to
    open it by name); buf is the one-sided fallback handle over the same
    memory, served by the client's BufferRegistry."""
    client_id: str = ""
    shm_name: str = ""
    shm_size: int = 0
    buf: RemoteBuf | None = None
    proto_ver: int = 1


@serde_struct
@dataclass
class RingAttachRsp:
    ring_id: int = 0
    aliased: bool = False      # server mapped the shm segment directly
    proto_ver: int = 1


@serde_struct
@dataclass
class RingDetachReq:
    ring_id: int = 0


@serde_struct
@dataclass
class RingDetachRsp:
    ok: bool = True


@serde_struct
@dataclass
class RingRWReq:
    """One submission batch: ring_id names the attached arena, sqes is
    the packed SQE array (_RING_SQE_FMT stride)."""
    ring_id: int = 0
    sqes: bytes = b""
    client_id: str = ""


@serde_struct
@dataclass
class RingRWRsp:
    """cqes = packed IOResults (_IORESULT_FMT stride) in request order;
    the struct list fallback carries results whose error message must
    survive (pack_ioresults declines those)."""
    cqes: bytes = b""
    results: list[IOResult] = field(default_factory=list)


async def update_rpc(client, address: str, io: UpdateIO, payload: bytes,
                     timeout: float, no_packed: set[str],
                     packed_method: str, struct_method: str,
                     struct_req: object) -> IOResult:
    """One update-shaped RPC, packed wire when the server supports it.
    Shared by the client write path and the CRAQ forward hop (the
    negotiation protocol must never diverge between them): try the
    packed method, and on RPC_METHOD_NOT_FOUND memoize the address as
    pre-packed and fall back to the struct RPC."""
    from t3fs_torch.utils.status import StatusCode, StatusError

    if address not in no_packed:
        blob = pack_updateio(io)
        if blob is not None:
            try:
                rsp, _ = await client.call(
                    address, packed_method, PackedIOReq(blob=blob),
                    payload=payload, timeout=timeout)
                if rsp.packed:
                    return unpack_ioresults(rsp.packed)[0]
                return rsp.result
            except StatusError as e:
                if e.code != StatusCode.RPC_METHOD_NOT_FOUND:
                    raise
                no_packed.add(address)      # old server
    rsp, _ = await client.call(address, struct_method, struct_req,
                               payload=payload, timeout=timeout)
    return rsp.result
