"""Chunk engine: size-class block files + free-list allocator + SQLite meta.

Reference analogs (SURVEY.md §2.3): the C++ ChunkStore (256 files per size
class 64KiB..64MiB, bitmap allocation, chunk metadata in LevelDB/RocksDB,
COW updates — docs/design_notes.md:286) and the Rust chunk_engine v2
(allocator hierarchy + RocksDB WriteBatch crash atomicity, engine.rs:31-712).

t3fs design: one data file per size class (sparse, grows by block), an
in-memory free list rebuilt from metadata on open (the Rust engine reloads
allocator state the same way), and chunk metadata rows in SQLite WAL —
each COW update is: write new block, one SQL txn flips the metadata, old
block returns to the free list.  Crash between steps leaves only a leaked
block, never a torn chunk (write-ahead meta flip is atomic).
"""

from __future__ import annotations

import os
import sqlite3
import threading
from dataclasses import dataclass

from t3fs_torch.storage.types import ChunkId, ChunkMeta, ChunkState
from t3fs_torch.utils.status import StatusCode, make_error

MIN_CHUNK_SIZE = 4096          # test-friendly floor (reference floor is 64KiB)
MAX_CHUNK_SIZE = 64 << 20


def size_class_of(chunk_size: int) -> int:
    """Round up to the next power-of-two size class."""
    if chunk_size <= 0 or chunk_size > MAX_CHUNK_SIZE:
        raise make_error(StatusCode.INVALID_ARG, f"bad chunk size {chunk_size}")
    c = MIN_CHUNK_SIZE
    while c < chunk_size:
        c <<= 1
    return c


@dataclass
class EngineStats:
    chunks: int = 0
    used_bytes: int = 0
    allocated_bytes: int = 0


class ChunkEngine:
    """Thread-safe physical chunk store for one storage target."""

    def __init__(self, root: str, *, sync_writes: bool = False):
        self.root = root
        self.sync_writes = sync_writes
        os.makedirs(root, exist_ok=True)
        self._lock = threading.RLock()
        # allocation generation per chunk (ABA guard for lock-free aio
        # reads; process-lifetime only, mirrors the native engine Slot::gen)
        self._gen_counter = 0
        self._gens: dict[bytes, int] = {}
        self._db = sqlite3.connect(os.path.join(root, "meta.db"),
                                   check_same_thread=False)
        self._db.execute("PRAGMA journal_mode=WAL")
        self._db.execute("PRAGMA synchronous=NORMAL")
        self._db.execute("""
            CREATE TABLE IF NOT EXISTS chunks (
                cid BLOB PRIMARY KEY,
                size_class INTEGER NOT NULL,
                block INTEGER NOT NULL,
                length INTEGER NOT NULL,
                update_ver INTEGER NOT NULL,
                commit_ver INTEGER NOT NULL,
                chain_ver INTEGER NOT NULL,
                checksum INTEGER NOT NULL,
                state INTEGER NOT NULL
            )""")
        self._db.commit()
        self._files: dict[int, int] = {}          # size_class -> fd
        self._next_block: dict[int, int] = {}     # size_class -> watermark
        self._free: dict[int, list[int]] = {}     # size_class -> free blocks
        self._punched: dict[int, set[int]] = {}   # free blocks already punched
        self._rebuild_allocator()

    # --- allocator ---

    def _fd(self, size_class: int) -> int:
        fd = self._files.get(size_class)
        if fd is None:
            path = os.path.join(self.root, f"blocks_{size_class}")
            fd = os.open(path, os.O_RDWR | os.O_CREAT, 0o644)
            self._files[size_class] = fd
        return fd

    def _rebuild_allocator(self) -> None:
        """Reload allocator state from metadata (crash-safe reopen)."""
        used: dict[int, set[int]] = {}
        for sc, block in self._db.execute("SELECT size_class, block FROM chunks"):
            used.setdefault(sc, set()).add(block)
        for sc, blocks in used.items():
            top = max(blocks) + 1
            self._next_block[sc] = top
            self._free[sc] = [b for b in range(top) if b not in blocks]

    def _allocate(self, size_class: int) -> int:
        free = self._free.setdefault(size_class, [])
        if free:
            block = free.pop()
            self._punched.get(size_class, set()).discard(block)
            return block
        block = self._next_block.get(size_class, 0)
        self._next_block[size_class] = block + 1
        return block

    def _release(self, size_class: int, block: int) -> None:
        # freed blocks are reused by _allocate; punch-hole space reclaim runs
        # in the background via punch_freed() (reference PunchHoleWorker)
        self._free.setdefault(size_class, []).append(block)

    def punch_freed(self, max_blocks: int = 1024) -> int:
        """Hole-punch free blocks so the filesystem reclaims their space
        (PunchHoleWorker analog).  Runs under the engine lock so a block
        cannot be re-allocated mid-punch; returns bytes reclaimed."""
        import fcntl as _fcntl  # noqa: F401  (presence implies linux)
        FALLOC_FL_KEEP_SIZE, FALLOC_FL_PUNCH_HOLE = 0x1, 0x2
        try:
            import ctypes
            libc = ctypes.CDLL(None, use_errno=True)
            fallocate = libc.fallocate
        except (OSError, AttributeError):
            return 0
        reclaimed = punched = 0
        with self._lock:
            for sc, free in self._free.items():
                fd = self._fd(sc)
                pending = self._punched.setdefault(sc, set())
                for block in free:
                    if punched >= max_blocks:
                        break
                    if block in pending:
                        continue
                    if fallocate(fd, FALLOC_FL_PUNCH_HOLE | FALLOC_FL_KEEP_SIZE,
                                 ctypes.c_uint64(block * sc),
                                 ctypes.c_uint64(sc)) == 0:
                        pending.add(block)
                        reclaimed += sc
                        punched += 1
        return reclaimed

    # --- meta helpers ---

    @staticmethod
    def _row_to_meta(row) -> tuple[ChunkMeta, int, int]:
        cid, sc, block, length, uv, cv, chv, csum, state = row
        meta = ChunkMeta(ChunkId.decode(cid), length, uv, cv, chv,
                         csum & 0xFFFFFFFF, ChunkState(state))
        return meta, sc, block

    def _get_row(self, chunk_id: ChunkId):
        cur = self._db.execute("SELECT * FROM chunks WHERE cid=?",
                               (chunk_id.encode(),))
        return cur.fetchone()

    # --- public API (mirrors chunk_engine/src/core/engine.rs:31-712) ---

    def get_meta(self, chunk_id: ChunkId) -> ChunkMeta | None:
        with self._lock:
            row = self._get_row(chunk_id)
            return self._row_to_meta(row)[0] if row else None

    def locate(self, chunk_id: ChunkId, offset: int,
               length: int) -> tuple[int, int, int, int] | None:
        """(fd, abs_offset, n, gen) for lock-free aio preads; same seqlock
        + allocation-generation contract as the native engine (re-locate
        after reading, require same gen and unchanged meta)."""
        with self._lock:
            row = self._get_row(chunk_id)
            if row is None:
                return None
            meta, sc, block = self._row_to_meta(row)
            n = max(0, min(length, meta.length - offset)) \
                if offset < meta.length else 0
            return (self._fd(sc), block * sc + offset, n,
                    self._gens.get(chunk_id.encode(), 0))

    def read(self, chunk_id: ChunkId, offset: int = 0, length: int = -1,
             meta: ChunkMeta | None = None) -> bytes:
        # meta hint accepted for engine-API parity (native_engine.read);
        # this engine needs the row under its lock regardless
        with self._lock:
            row = self._get_row(chunk_id)
            if row is None:
                raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))
            meta, sc, block = self._row_to_meta(row)
            if length < 0:
                length = meta.length - offset
            length = max(0, min(length, meta.length - offset))
            if length == 0:
                return b""
            fd = self._fd(sc)
            # pread stays under the lock: a concurrent COW put may free this
            # block and a later allocation reuse it mid-read (the native
            # engine preads under its shared lock for the same reason; the
            # reference uses Arc'd chunk handles — engine.rs read safety)
            return os.pread(fd, length, block * sc + offset)

    def read_into(self, chunk_id: ChunkId, offset: int, length: int,
                  dest=None, verify: bool = False, *,
                  addr: int = 0, cap: int = 0) -> tuple[int, ChunkMeta]:
        """One-call hot read into a caller buffer (native_engine.read_into
        parity): meta + pread + optional full-chunk CRC verify under the
        engine lock — the meta pairs atomically with the landed bytes.
        length 0 = to end of chunk; clamps to len(dest).  `addr`/`cap`
        names a caller-bounds-checked raw destination (the ring arena)."""
        if dest is None:
            import ctypes
            dest = memoryview((ctypes.c_ubyte * cap).from_address(addr))
        with self._lock:
            row = self._get_row(chunk_id)
            if row is None:
                raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))
            meta, sc, block = self._row_to_meta(row)
            want = length if length else meta.length - offset
            n = (max(0, min(want, meta.length - offset, len(dest)))
                 if offset < meta.length else 0)
            if n:
                got = os.preadv(self._fd(sc), [dest[:n]],
                                block * sc + offset)
                if got != n:
                    raise make_error(StatusCode.DISK_ERROR,
                                     f"{chunk_id}: short read {got}/{n}")
                if verify and offset == 0 and n == meta.length:
                    from t3fs_torch.ops.codec import crc32c
                    actual = crc32c(dest[:n])
                    if actual != meta.checksum:
                        raise make_error(
                            StatusCode.CHECKSUM_MISMATCH,
                            f"{chunk_id}: stored {meta.checksum:#x}"
                            f" != read {actual:#x}")
            return n, meta

    def put(self, chunk_id: ChunkId, content: bytes, meta: ChunkMeta,
            chunk_size: int) -> None:
        """COW write: new block + atomic metadata flip; old block freed.

        The data pwrite/fsync runs OUTSIDE the lock: the fresh block was
        reserved under the lock and is invisible to readers until the meta
        flip, so holding the lock across a (potentially hundreds of ms)
        fsync would only serve to stall every reader — including inline
        small reads on the event loop."""
        sc = size_class_of(max(chunk_size, len(content)))
        with self._lock:
            block = self._allocate(sc)
            fd = self._fd(sc)
        try:
            os.pwrite(fd, content, block * sc)
            if self.sync_writes:
                os.fsync(fd)
        except OSError:
            with self._lock:
                self._release(sc, block)
            raise
        with self._lock:
            row = self._get_row(chunk_id)
            old = self._row_to_meta(row) if row else None
            with self._db:
                self._db.execute(
                    "INSERT OR REPLACE INTO chunks VALUES (?,?,?,?,?,?,?,?,?)",
                    (chunk_id.encode(), sc, block, len(content),
                     meta.update_ver, meta.commit_ver, meta.chain_ver,
                     meta.checksum, int(meta.state)))
            if old is not None:
                self._release(old[1], old[2])
            self._gen_counter += 1
            self._gens[chunk_id.encode()] = self._gen_counter

    def set_meta(self, chunk_id: ChunkId, meta: ChunkMeta) -> None:
        """Metadata-only flip (commit: DIRTY -> COMMIT), atomic."""
        with self._lock:
            row = self._get_row(chunk_id)
            if row is None:
                raise make_error(StatusCode.CHUNK_NOT_FOUND, str(chunk_id))
            with self._db:
                self._db.execute(
                    "UPDATE chunks SET length=?, update_ver=?, commit_ver=?,"
                    " chain_ver=?, checksum=?, state=? WHERE cid=?",
                    (meta.length, meta.update_ver, meta.commit_ver,
                     meta.chain_ver, meta.checksum, int(meta.state),
                     chunk_id.encode()))

    def remove(self, chunk_id: ChunkId) -> bool:
        with self._lock:
            row = self._get_row(chunk_id)
            if row is None:
                return False
            _, sc, block = self._row_to_meta(row)
            with self._db:
                self._db.execute("DELETE FROM chunks WHERE cid=?",
                                 (chunk_id.encode(),))
            self._release(sc, block)
            self._gens.pop(chunk_id.encode(), None)
            return True

    def query_range(self, inode: int, begin_index: int = 0,
                    end_index: int = 1 << 62) -> list[ChunkMeta]:
        """All chunk metas of one inode in [begin, end) index order."""
        lo = ChunkId(inode, begin_index).encode()
        hi = ChunkId(inode, end_index).encode()
        with self._lock:
            rows = self._db.execute(
                "SELECT * FROM chunks WHERE cid >= ? AND cid < ? ORDER BY cid",
                (lo, hi)).fetchall()
        return [self._row_to_meta(r)[0] for r in rows]

    def all_metas(self) -> list[ChunkMeta]:
        """Full chunk-meta dump (resync syncStart analog)."""
        with self._lock:
            rows = self._db.execute("SELECT * FROM chunks ORDER BY cid").fetchall()
        return [self._row_to_meta(r)[0] for r in rows]

    def uncommitted(self) -> list[ChunkMeta]:
        """Chunks left DIRTY (crash recovery, engine.rs:572-607 analog)."""
        with self._lock:
            rows = self._db.execute(
                "SELECT * FROM chunks WHERE state=?", (int(ChunkState.DIRTY),)
            ).fetchall()
        return [self._row_to_meta(r)[0] for r in rows]

    def stats(self) -> EngineStats:
        with self._lock:
            n, used = self._db.execute(
                "SELECT COUNT(*), COALESCE(SUM(length),0) FROM chunks").fetchone()
            alloc = sum(sc * self._next_block.get(sc, 0)
                        for sc in self._next_block)
        return EngineStats(n, used, alloc)

    def close(self) -> None:
        with self._lock:
            self._db.close()
            for fd in self._files.values():
                os.close(fd)
            self._files.clear()

