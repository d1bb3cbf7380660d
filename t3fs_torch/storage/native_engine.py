"""ctypes binding for the native C++ chunk engine (t3fs_torch/csrc/chunk_engine.cpp).

Same Python API as t3fs_torch.storage.chunk_engine.ChunkEngine so
StorageTarget can select either via config (`engine="native"|"py"`) — the
seam the reference has at store/StorageTarget.h:85-162 (`only_chunk_engine`
choosing the Rust engine v2 over the C++ ChunkStore v1).

The port of t3fs/storage/native_engine.py.  The library is the port's own:
csrc/chunk_engine.cpp and csrc/aio_reader.cpp, built by the host compiler
into t3fs_torch/_build/ at first use (ops/_build.py, host_library); the
reference's t3fs/native library is never loaded.  The same library holds
the host CRC32C that t3fs_torch.ops.codec binds through crc32c_native.
"""

from __future__ import annotations

import ctypes as C

from t3fs_torch.storage.chunk_engine import EngineStats, size_class_of  # noqa: F401
from t3fs_torch.storage.types import ChunkId, ChunkMeta, ChunkState
from t3fs_torch.utils.status import StatusCode, make_error


class _CeMeta(C.Structure):
    _fields_ = [
        ("length", C.c_uint64),
        ("update_ver", C.c_uint64),
        ("commit_ver", C.c_uint64),
        ("chain_ver", C.c_uint64),
        ("checksum", C.c_uint32),
        ("state", C.c_uint32),
    ]


_ROW_BYTES = 16 + C.sizeof(_CeMeta)


def _bind():
    from t3fs_torch.ops._build import host_library

    lib = host_library()
    lib.t3fs_ce_open.restype = C.c_void_p
    lib.t3fs_ce_open.argtypes = [C.c_char_p, C.c_int]
    lib.t3fs_ce_close.argtypes = [C.c_void_p]
    lib.t3fs_ce_last_error.restype = C.c_char_p
    lib.t3fs_ce_last_error.argtypes = [C.c_void_p]
    lib.t3fs_ce_put.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                C.c_uint64, C.c_uint64, C.POINTER(_CeMeta)]
    lib.t3fs_ce_read.argtypes = [C.c_void_p, C.c_char_p, C.c_uint64,
                                 C.c_uint64, C.c_void_p,
                                 C.POINTER(C.c_uint64)]
    lib.t3fs_ce_read_into.restype = C.c_int
    lib.t3fs_ce_read_into.argtypes = [C.c_void_p, C.c_char_p, C.c_uint64,
                                      C.c_uint64, C.c_void_p, C.c_uint64,
                                      C.c_int, C.POINTER(C.c_uint64),
                                      C.POINTER(_CeMeta)]
    lib.t3fs_ce_locate.argtypes = [C.c_void_p, C.c_char_p, C.c_uint64,
                                   C.c_uint64, C.POINTER(C.c_int32),
                                   C.POINTER(C.c_uint64),
                                   C.POINTER(C.c_uint64),
                                   C.POINTER(C.c_uint64)]
    lib.t3fs_ce_get_meta.argtypes = [C.c_void_p, C.c_char_p,
                                     C.POINTER(_CeMeta)]
    lib.t3fs_ce_set_meta.argtypes = [C.c_void_p, C.c_char_p,
                                     C.POINTER(_CeMeta)]
    lib.t3fs_ce_remove.argtypes = [C.c_void_p, C.c_char_p]
    lib.t3fs_ce_query_range.restype = C.c_uint64
    lib.t3fs_ce_query_range.argtypes = [C.c_void_p, C.c_char_p, C.c_char_p,
                                        C.c_void_p, C.c_uint64]
    lib.t3fs_ce_stats.argtypes = [C.c_void_p, C.POINTER(C.c_uint64),
                                  C.POINTER(C.c_uint64),
                                  C.POINTER(C.c_uint64)]
    lib.t3fs_ce_compact.argtypes = [C.c_void_p]
    lib.t3fs_ce_punch_freed.restype = C.c_uint64
    lib.t3fs_ce_punch_freed.argtypes = [C.c_void_p, C.c_uint64]
    lib.t3fs_crc32c.restype = C.c_uint32
    # c_void_p, not c_char_p: accepts bytes AND ctypes views over
    # writable buffers, so zero-copy RX payloads (memoryview over the
    # net pump's buffer) CRC without a copy
    lib.t3fs_crc32c.argtypes = [C.c_void_p, C.c_uint64, C.c_uint32]
    lib.t3fs_crc32c_combine.restype = C.c_uint32
    lib.t3fs_crc32c_combine.argtypes = [C.c_uint32, C.c_uint32, C.c_uint64]
    return lib


_libholder: list = []


def native_lib():
    if not _libholder:
        _libholder.append(_bind())
    return _libholder[0]


def crc32c_native(data, crc: int = 0) -> int:
    """Hardware (SSE4.2) CRC32C — the CPU-side checksum oracle/fast path.
    Accepts any bytes-like input; bytes and writable buffers (incl. the
    net pump's zero-copy RX memoryviews) pass WITHOUT a staging copy —
    a bytes(data) here would be a hidden per-payload copy on the write
    path."""
    if isinstance(data, bytes):
        return native_lib().t3fs_crc32c(data, len(data), crc)
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.readonly or not mv.c_contiguous:
        b = bytes(mv)
        return native_lib().t3fs_crc32c(b, len(b), crc)
    arr = (C.c_ubyte * mv.nbytes).from_buffer(mv)
    return native_lib().t3fs_crc32c(arr, mv.nbytes, crc)


def crc32c_combine_native(a: int, b: int, len_b: int) -> int:
    return native_lib().t3fs_crc32c_combine(a, b, len_b)


def _meta_to_c(meta: ChunkMeta, length: int | None = None) -> _CeMeta:
    return _CeMeta(length if length is not None else meta.length,
                   meta.update_ver, meta.commit_ver, meta.chain_ver,
                   meta.checksum & 0xFFFFFFFF, int(meta.state))


def _meta_from_c(cid: ChunkId, cm: _CeMeta) -> ChunkMeta:
    return ChunkMeta(cid, cm.length, cm.update_ver, cm.commit_ver,
                     cm.chain_ver, cm.checksum, ChunkState(cm.state))


class NativeChunkEngine:
    """Drop-in replacement for ChunkEngine backed by the C++ library."""

    def __init__(self, root: str, *, sync_writes: bool = False):
        import os

        self.root = root
        os.makedirs(root, exist_ok=True)
        self._lib = native_lib()
        self._h = self._lib.t3fs_ce_open(root.encode(), int(sync_writes))
        if not self._h:
            raise make_error(StatusCode.INTERNAL,
                             "native engine open failed: "
                             + (self._lib.t3fs_ce_last_error(None) or b"").decode())

    def _err(self) -> str:
        return (self._lib.t3fs_ce_last_error(self._h) or b"").decode()

    def _handle(self):
        """Live engine handle, or a typed error after close().  A request
        that drains after its node shut down (straggler/hedged read) must
        fail orderly — passing NULL into the C ABI segfaulted here."""
        if not self._h:
            raise make_error(StatusCode.INTERNAL, "native engine closed")
        return self._h

    def _io_error(self, prefix: str):
        """Typed disk-error for engine I/O failures: the service offlines
        the target on DISK_ERROR instead of parsing message strings.  Pure
        validation failures from the C side stay INVALID_ARG."""
        msg = self._err()
        if "bad chunk size" in msg:
            return make_error(StatusCode.INVALID_ARG, f"{prefix}: {msg}")
        return make_error(StatusCode.DISK_ERROR, f"{prefix}: {msg}")

    def get_meta(self, chunk_id: ChunkId) -> ChunkMeta | None:
        cm = _CeMeta()
        r = self._lib.t3fs_ce_get_meta(self._handle(), chunk_id.encode(), C.byref(cm))
        return _meta_from_c(chunk_id, cm) if r == 1 else None

    def locate(self, chunk_id: ChunkId, offset: int,
               length: int) -> tuple[int, int, int, int] | None:
        """(fd, abs_offset, n, gen) of the chunk's CURRENT bytes for
        lock-free aio preads.  gen is the slot's allocation generation:
        callers re-locate after the read and require the SAME gen (plus
        unchanged meta) — this closes the remove+recreate ABA where a new
        incarnation reproduces identical meta on a reused block.  None =
        unknown chunk."""
        fd = C.c_int32()
        abs_off = C.c_uint64()
        n = C.c_uint64()
        gen = C.c_uint64()
        r = self._lib.t3fs_ce_locate(self._handle(), chunk_id.encode(), offset,
                                     length, C.byref(fd), C.byref(abs_off),
                                     C.byref(n), C.byref(gen))
        if r != 1:
            return None
        return fd.value, abs_off.value, n.value, gen.value

    def read(self, chunk_id: ChunkId, offset: int = 0, length: int = -1,
             meta: "ChunkMeta | None" = None) -> bytes:
        # meta: caller-supplied sizing hint (skips one get_meta round
        # trip); ce_read re-validates existence, and optimistic readers
        # (ChunkReplica.read) re-check meta after the fetch anyway
        if meta is None:
            meta = self.get_meta(chunk_id)
        if meta is None:
            raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))
        if length < 0:
            length = meta.length - offset
        length = max(0, min(length, meta.length - offset))
        if length == 0:
            return b""
        buf = C.create_string_buffer(length)
        out_len = C.c_uint64()
        r = self._lib.t3fs_ce_read(self._handle(), chunk_id.encode(), offset, length,
                                   buf, C.byref(out_len))
        if r < 0:
            raise self._io_error("read")
        if r == 0:
            raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))
        return buf.raw[: out_len.value]

    def read_into(self, chunk_id: ChunkId, offset: int, length: int,
                  dest=None, verify: bool = False, *,
                  addr: int = 0, cap: int = 0) -> tuple[int, ChunkMeta]:
        """One-call hot read: meta snapshot + pread + optional full-chunk
        CRC verify under a SINGLE engine lock, landing bytes directly in
        `dest` (a writable buffer — the ring plane's registered arena).
        length 0 = to end of chunk; the read clamps to len(dest).
        Returns (bytes_read, meta); the meta pairs atomically with the
        bytes (the pread ran under the same lock).  `addr`/`cap` is the
        no-wrapper variant: a raw destination pointer the CALLER bounds-
        checked (the ring session's pinned arena), skipping the per-IO
        memoryview + from_buffer dance."""
        cm = _CeMeta()
        out_len = C.c_uint64()
        if addr:
            buf, nbytes = C.c_void_p(addr), cap
        else:
            mv = dest if isinstance(dest, memoryview) else memoryview(dest)
            buf, nbytes = (C.c_ubyte * mv.nbytes).from_buffer(mv), mv.nbytes
        r = self._lib.t3fs_ce_read_into(
            self._handle(), chunk_id.encode(), offset, length, buf,
            nbytes, 1 if verify else 0, C.byref(out_len), C.byref(cm))
        if r == 0:
            raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))
        if r == -2:
            meta = _meta_from_c(chunk_id, cm)
            raise make_error(
                StatusCode.CHECKSUM_MISMATCH,
                f"{chunk_id}: stored {meta.checksum:#x} != read bytes")
        if r < 0:
            raise self._io_error("read_into")
        return out_len.value, _meta_from_c(chunk_id, cm)

    def put(self, chunk_id: ChunkId, content: bytes, meta: ChunkMeta,
            chunk_size: int) -> None:
        cm = _meta_to_c(meta, length=len(content))
        r = self._lib.t3fs_ce_put(self._handle(), chunk_id.encode(), bytes(content),
                                  len(content), chunk_size, C.byref(cm))
        if r != 1:
            raise self._io_error("put failed")

    def set_meta(self, chunk_id: ChunkId, meta: ChunkMeta) -> None:
        cm = _meta_to_c(meta)
        r = self._lib.t3fs_ce_set_meta(self._handle(), chunk_id.encode(), C.byref(cm))
        if r != 1:
            raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))

    def remove(self, chunk_id: ChunkId) -> bool:
        return self._lib.t3fs_ce_remove(self._handle(), chunk_id.encode()) == 1

    def _query(self, lo: bytes, hi: bytes) -> list[ChunkMeta]:
        n = self._lib.t3fs_ce_query_range(self._handle(), lo, hi, None, 0)
        if n == 0:
            return []
        buf = C.create_string_buffer(int(n) * _ROW_BYTES)
        n2 = self._lib.t3fs_ce_query_range(self._handle(), lo, hi, buf, n)
        out = []
        for i in range(min(int(n), int(n2))):
            row = buf.raw[i * _ROW_BYTES:(i + 1) * _ROW_BYTES]
            cid = ChunkId.decode(row[:16])
            cm = _CeMeta.from_buffer_copy(row[16:])
            out.append(_meta_from_c(cid, cm))
        return out

    def query_range(self, inode: int, begin_index: int = 0,
                    end_index: int = 1 << 62) -> list[ChunkMeta]:
        return self._query(ChunkId(inode, begin_index).encode(),
                           ChunkId(inode, end_index).encode())

    def all_metas(self) -> list[ChunkMeta]:
        return self._query(b"\x00" * 16, b"\xff" * 16)

    def uncommitted(self) -> list[ChunkMeta]:
        return [m for m in self.all_metas() if m.state == ChunkState.DIRTY]

    def stats(self) -> EngineStats:
        chunks = C.c_uint64()
        used = C.c_uint64()
        alloc = C.c_uint64()
        self._lib.t3fs_ce_stats(self._handle(), C.byref(chunks), C.byref(used),
                                C.byref(alloc))
        return EngineStats(chunks.value, used.value, alloc.value)

    def compact(self) -> None:
        self._lib.t3fs_ce_compact(self._handle())

    def punch_freed(self, max_blocks: int = 1024) -> int:
        """Hole-punch freed blocks; returns bytes reclaimed
        (PunchHoleWorker analog)."""
        return self._lib.t3fs_ce_punch_freed(self._handle(), max_blocks)

    def close(self) -> None:
        if self._h:
            self._lib.t3fs_ce_close(self._h)
            self._h = None


def make_engine(root: str, *, backend: str = "native", sync_writes: bool = False):
    """Engine factory: native C++ if available, else pure-Python.

    Fallback applies ONLY when the native library cannot be built/loaded
    (no toolchain, unsupported arch) — an open failure on an existing native
    store is surfaced, never masked as an empty target.  On-disk format is
    sticky: a root written by one engine reopens with that engine regardless
    of the requested backend (meta.db = SQLite engine; meta.wal/meta.snap =
    native engine)."""
    import os

    from t3fs_torch.storage.chunk_engine import ChunkEngine

    has_py = os.path.exists(os.path.join(root, "meta.db"))
    has_native = (os.path.exists(os.path.join(root, "meta.wal"))
                  or os.path.exists(os.path.join(root, "meta.snap")))
    if has_py and not has_native:
        backend = "py"
    elif has_native and not has_py:
        backend = "native_required"

    if backend.startswith("native"):
        try:
            native_lib()
        except Exception:
            if backend == "native_required":
                raise
            return ChunkEngine(root, sync_writes=sync_writes)
        return NativeChunkEngine(root, sync_writes=sync_writes)
    return ChunkEngine(root, sync_writes=sync_writes)
