"""Wire framing: MessageHeader + MessagePacket envelope.

Reference analogs: common/net/MessageHeader.h:13-33 (CRC-magic framing) and
common/serde/MessagePacket.h:12-63 (uuid, flags, version, timestamps).
"""

from __future__ import annotations

import struct
import time
from dataclasses import dataclass, field

from t3fs_torch.ops.codec import crc32c as crc32c_ref
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import Status, StatusCode

# "t3f" + wire version.  v2 added msg_crc (header 20 -> 24 bytes); bumping
# the magic makes a mixed-version peer fail as an explicit "bad magic"
# instead of a phantom "header crc mismatch" during rolling restarts.
MAGIC = 0x74336632  # "t3f2"
# magic, msg_len, payload_len, flags, msg_crc, header_crc.  msg_crc covers
# the serde MessagePacket bytes (envelope integrity: ids, methods, status,
# inline bodies); the bulk payload is NOT wire-checksummed — chunk data
# carries its own end-to-end ChecksumInfo at the app layer, exactly like
# the reference (MessageHeader.h CRCs the header; fbs/storage/Common.h:113
# checksums the data).
HEADER_FMT = "<IIIIII"
HEADER_SIZE = struct.calcsize(HEADER_FMT)

FLAG_IS_REQ = 1 << 0
FLAG_COMPRESS = 1 << 1
FLAG_CONTROL = 1 << 2

MAX_FRAME = 512 << 20  # hard cap against corrupt length fields


class FrameError(Exception):
    pass


@serde_struct
@dataclass
class OkRsp:
    """Shared empty-success response for admin/maintenance RPCs."""
    ok: bool = True


def maybe_compress(msg: bytes, payload: bytes, threshold: int,
                   level: int = 1) -> tuple[bytes, bytes, int]:
    """Compress a frame when it pays (MessagePacket UseCompress analog,
    common/serde/MessagePacket.h:12-63; zlib instead of the reference's
    zstd — stdlib, no extra dependency).  threshold<=0 disables; frames
    that don't shrink by >=10% ship uncompressed (chunk payloads are often
    already-incompressible random data).  Returns (msg, payload, flag)."""
    import zlib
    total = len(msg) + len(payload)
    if threshold <= 0 or total < threshold:
        return msg, payload, 0
    zmsg = zlib.compress(msg, level) if msg else b""
    zpay = zlib.compress(payload, level) if payload else b""
    if len(zmsg) + len(zpay) > total * 9 // 10:
        return msg, payload, 0
    return zmsg, zpay, FLAG_COMPRESS


def _safe_decompress(data: bytes) -> bytes:
    """Bounded decompression: a hostile/corrupt frame must not expand past
    MAX_FRAME (decompression-bomb guard)."""
    import zlib
    d = zlib.decompressobj()
    try:
        out = d.decompress(data, MAX_FRAME + 1)
    except zlib.error as e:
        raise FrameError(f"bad compressed frame: {e}") from None
    if len(out) > MAX_FRAME or d.unconsumed_tail:
        raise FrameError("decompressed frame exceeds MAX_FRAME")
    if not d.eof:
        # valid prefix of a cut-short stream decompresses without error;
        # partial data must not reach a handler as if complete
        raise FrameError("truncated compressed frame")
    return out


def decompress_frame(msg: bytes, payload: bytes,
                     flags: int) -> tuple[bytes, bytes]:
    if not flags & FLAG_COMPRESS:
        return msg, payload
    return (_safe_decompress(msg) if msg else b"",
            _safe_decompress(payload) if payload else b"")


def pack_header(msg_len: int, payload_len: int, flags: int,
                msg_crc: int = 0) -> bytes:
    head = struct.pack("<IIIII", MAGIC, msg_len, payload_len, flags, msg_crc)
    crc = crc32c_ref(head)
    return head + struct.pack("<I", crc)


def unpack_header(data: bytes) -> tuple[int, int, int, int]:
    (magic, msg_len, payload_len, flags, msg_crc,
     crc) = struct.unpack(HEADER_FMT, data)
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic:#x}")
    if crc != crc32c_ref(data[:20]):
        raise FrameError("header crc mismatch")
    if msg_len > MAX_FRAME or payload_len > MAX_FRAME:
        raise FrameError(f"oversized frame {msg_len}/{payload_len}")
    return msg_len, payload_len, flags, msg_crc


def check_msg_crc(msg: bytes, msg_crc: int) -> None:
    """Envelope integrity: the serde packet bytes must match the header's
    msg_crc (a torn/bit-flipped envelope must fail closed, not decode)."""
    if msg and crc32c_ref(msg) != msg_crc:
        raise FrameError("message crc mismatch")


# ---- UPDATE_FRAG framing (pipelined CRAQ writes) ----
# A fragment stream ships one update's payload as bounded frames AHEAD of
# the update RPC that consumes it (cut-through forwarding, storage/
# reliable.py).  Like the packed batch-read path, the descriptor is a
# fixed-stride struct riding one bytes field, negotiated by method name
# (Storage.update_frag answers RPC_METHOD_NOT_FOUND on an old server).

FRAG_EOF = 1 << 0      # last fragment of the stream
FRAG_RELAY = 1 << 1    # receiver should relay downstream (cut-through)

_FRAG_FMT = struct.Struct("<4qIBB")  # chain chain_ver seq total_len crc flags sid_len


@dataclass
class UpdateFrag:
    """Decoded UPDATE_FRAG descriptor (not a serde struct: packed)."""
    stream_id: str = ""
    chain_id: int = 0
    chain_ver: int = 0
    seq: int = 0           # 0-based fragment index
    total_len: int = 0     # whole payload length (every frame carries it)
    frag_crc: int = 0      # CRC32C of this fragment's bytes
    eof: bool = False
    relay: bool = False


def pack_update_frag(frag: UpdateFrag) -> bytes:
    sid = frag.stream_id.encode()
    if len(sid) > 255:
        raise FrameError(f"stream id too long ({len(sid)})")
    flags = (FRAG_EOF if frag.eof else 0) | (FRAG_RELAY if frag.relay else 0)
    return _FRAG_FMT.pack(frag.chain_id, frag.chain_ver, frag.seq,
                          frag.total_len, frag.frag_crc, flags,
                          len(sid)) + sid


def unpack_update_frag(blob: bytes) -> UpdateFrag:
    (chain_id, chain_ver, seq, total_len, crc, flags,
     sid_len) = _FRAG_FMT.unpack_from(blob)
    sid = blob[_FRAG_FMT.size:]
    if len(sid) != sid_len:
        raise FrameError(f"frag stream-id tail {len(sid)} != {sid_len}")
    return UpdateFrag(stream_id=sid.decode(), chain_id=chain_id,
                      chain_ver=chain_ver, seq=seq, total_len=total_len,
                      frag_crc=crc, eof=bool(flags & FRAG_EOF),
                      relay=bool(flags & FRAG_RELAY))


# ---- Buf.batch scatter/gather descriptors (net/rdma.py) ----
#
# Same packed-stride-in-a-bytes-field discipline as UPDATE_FRAG and the ring
# SQE array: N one-sided work elements ride ONE serde envelope, their bulk
# bytes ride the raw payload channel concatenated in descriptor order.

BUF_OP_READ = 0    # issuer pulls peer bytes (RDMA READ)
BUF_OP_WRITE = 1   # issuer pushes bytes into peer memory (RDMA WRITE)

BUF_DESC = struct.Struct("<QqqQB")   # buf_id, offset, length, rkey, opcode
BUF_RES = struct.Struct("<qq")       # per-op status code, payload bytes


def pack_buf_descs(descs) -> bytes:
    """descs: iterable of (buf_id, offset, length, rkey, opcode)."""
    return b"".join(BUF_DESC.pack(*d) for d in descs)


def unpack_buf_descs(blob) -> list:
    if len(blob) % BUF_DESC.size:
        raise FrameError(f"buf-desc blob {len(blob)}B not a multiple "
                         f"of {BUF_DESC.size}")
    return [BUF_DESC.unpack_from(blob, off)
            for off in range(0, len(blob), BUF_DESC.size)]


@serde_struct
@dataclass
class WireStatus:
    code: int = int(StatusCode.OK)
    message: str = ""

    @classmethod
    def from_status(cls, s: Status) -> "WireStatus":
        return cls(int(s.code), s.message)

    def to_status(self) -> Status:
        return Status(StatusCode(self.code), self.message)


@serde_struct
@dataclass
class MessagePacket:
    """RPC envelope: req (method set) or rsp (status set), + serde body."""
    uuid: int = 0
    method: str = ""              # "Service.method" on requests
    is_req: bool = True
    status: WireStatus = field(default_factory=WireStatus)
    version: int = 1
    ts_client_called: float = 0.0
    ts_server_received: float = 0.0
    ts_server_replied: float = 0.0
    body: object = None           # registered serde struct (or None)
    # when the handler task first ran (vs received = read-loop time):
    # the gap is server-side queueing.  Appended last (serde add-only);
    # reference carries 8 such stamps (serde/MessagePacket.h:43-50)
    ts_server_started: float = 0.0
    # distributed-tracing context (t3fs/utils/tracing.py): stamped by
    # Connection.call/post when a sampled span is active, re-opened as a
    # server span in dispatch.  Appended after ts_server_started — same
    # add-only compat rule (old peers drop them, missing ones default off)
    trace_id: int = 0
    parent_span_id: int = 0
    sampled: bool = False

    def stamp_called(self) -> "MessagePacket":
        self.ts_client_called = time.time()
        return self
