"""VFS: POSIX-shaped file operations over MetaClient + StorageClient.

Reference analog: src/fuse/FuseOps.cc (lookup :644, getattr :732, read/write/
readdirplus bridging to MetaClient/StorageClient) and src/fuse/PioV.{h,cc}
(gathering ring entries into StorageClient batch ops).  t3fs exposes the same
bridge as a library class instead of a kernel FUSE mount — the USRBIO shm
ring (t3fs/usrbio) and CLI/tools drive it; a fuse_lowlevel binding would sit
directly on top of these methods.

Write visibility follows the reference's design: chunks are written directly
to storage (lengths reported to meta as hints every write; precise length
computed on close/sync via storage queryLastChunk — docs/design_notes.md:89-95).

The port of t3fs/fuse/vfs.py.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.client.meta_client import MetaClient
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.meta.schema import DirEntry, Inode, InodeType
from t3fs_torch.storage.types import ChunkId, ReadIO
from t3fs_torch.utils.status import StatusCode, StatusError, make_error


@dataclass
class FileHandle:
    fd: int
    inode: Inode
    session_id: str = ""
    writable: bool = False
    append: bool = False
    max_written: int = 0       # high-water mark for length reporting


class FileSystem:
    """One mounted t3fs namespace for one client process."""

    def __init__(self, meta: MetaClient, storage: StorageClient):
        self.meta = meta
        self.storage = storage
        self._fds: dict[int, FileHandle] = {}
        self._next_fd = 3

    # ---- namespace ops (FuseOps lookup/mkdir/unlink/rename analogs) ----

    async def stat(self, path: str) -> Inode:
        return await self.meta.stat(path)

    async def mkdirs(self, path: str, perm: int = 0o755,
                     recursive: bool = True) -> Inode:
        return await self.meta.mkdirs(path, perm, recursive)

    async def readdir(self, path: str) -> list[DirEntry]:
        return await self.meta.readdir(path)

    async def unlink(self, path: str, recursive: bool = False) -> None:
        await self.meta.remove(path, recursive=recursive)

    async def rename(self, src: str, dst: str) -> None:
        await self.meta.rename(src, dst)

    async def symlink(self, path: str, target: str) -> Inode:
        return await self.meta.symlink(path, target)

    async def truncate(self, path: str, length: int) -> Inode:
        ino = await self.meta.stat(path)
        return await self.meta.truncate(ino.inode_id, length)

    # ---- open/close (FileSession lifecycle) ----

    async def create(self, path: str, perm: int = 0o644,
                     chunk_size: int = 0) -> FileHandle:
        ino, session = await self.meta.create(path, perm, chunk_size,
                                              write=True)
        return self._register(ino, session, writable=True)

    async def open(self, path: str, mode: str = "r") -> FileHandle:
        """mode: 'r' | 'w' (write session) | 'a' (append)."""
        write = mode in ("w", "a")
        ino, session = await self.meta.open(path, write=write)
        if ino.itype != InodeType.FILE:
            raise make_error(StatusCode.INVALID_ARG, f"not a file: {path}")
        if mode == "w" and ino.layout is not None:
            # POSIX O_TRUNC: drop existing bytes so a shorter rewrite does
            # not leave the old tail (meta truncate removes stale chunks)
            ino = await self.meta.truncate(ino.inode_id, 0)
        fh = self._register(ino, session, writable=write, append=(mode == "a"))
        if mode == "a":
            fh.max_written = await self.file_length(ino)
        return fh

    def _register(self, ino: Inode, session: str, writable: bool,
                  append: bool = False) -> FileHandle:
        fd = self._next_fd
        self._next_fd += 1
        fh = FileHandle(fd, ino, session, writable, append)
        self._fds[fd] = fh
        return fh

    def handle(self, fd: int) -> FileHandle:
        fh = self._fds.get(fd)
        if fh is None:
            raise make_error(StatusCode.INVALID_ARG, f"bad fd {fd}")
        return fh

    async def close(self, fh: FileHandle) -> Inode:
        """Close: compute precise length (queryLastChunk path) and drop the
        write session (deferred-deletion unblock)."""
        length = None
        if fh.writable:
            length = max(fh.max_written,
                         await self.file_length(fh.inode))
        ino = await self.meta.close(
            fh.inode.inode_id, fh.session_id,
            length=length if length is not None else -1)
        self._fds.pop(fh.fd, None)
        return ino

    # ---- data path ----

    def _layout(self, fh: FileHandle) -> FileLayout:
        if fh.inode.layout is None:
            raise make_error(StatusCode.INVALID_ARG, "file has no layout")
        return fh.inode.layout

    async def file_length(self, ino: Inode) -> int:
        """Precise length via storage queryLastChunk over the file's chains
        (reference meta/components/FileHelper.h)."""
        if ino.layout is None:
            return 0
        return await self.storage.query_last_chunk(ino.layout, ino.inode_id)

    async def write(self, fh: FileHandle, offset: int, data: bytes) -> int:
        if not fh.writable:
            raise make_error(StatusCode.INVALID_ARG, "fd not writable")
        if fh.append:
            offset = fh.max_written
        lay = self._layout(fh)
        results = await self.storage.write_file_range(
            lay, fh.inode.inode_id, offset, data)
        for r in results:
            if r.status.code != int(StatusCode.OK):
                raise StatusError(r.status.code, r.status.message)
        fh.max_written = max(fh.max_written, offset + len(data))
        # async length-hint report (design_notes:91-95: clients report max
        # write position; close computes precise length)
        await self.meta.report_write_position(fh.inode.inode_id,
                                              fh.max_written)
        return len(data)

    async def read(self, fh: FileHandle, offset: int, length: int) -> bytes:
        lay = self._layout(fh)
        file_len = max(fh.inode.length, fh.inode.length_hint, fh.max_written)
        if offset + length > file_len:
            # local view may be stale (another process/ring wrote): refresh
            # from meta, like FUSE's attr revalidation before read
            fh.inode = await self.meta.stat_inode(fh.inode.inode_id)
            file_len = max(fh.inode.length, fh.inode.length_hint,
                           fh.max_written)
        if offset >= file_len:
            return b""
        length = min(length, file_len - offset)
        data, _ = await self.storage.read_file_range(
            lay, fh.inode.inode_id, offset, length)
        return data

    async def fsync(self, fh: FileHandle) -> Inode:
        """Settle the precise length from storage (meta sync does the
        queryLastChunk round server-side)."""
        ino = await self.meta.sync(fh.inode.inode_id)
        fh.inode = ino
        return ino

    # ---- whole-file conveniences (hf3fs api/hf3fs.h analogs) ----

    async def write_file(self, path: str, data: bytes,
                         chunk_size: int = 0) -> Inode:
        try:
            fh = await self.create(path, chunk_size=chunk_size)
        except StatusError:
            fh = await self.open(path, "w")
        await self.write(fh, 0, data)
        return await self.close(fh)

    async def read_file(self, path: str) -> bytes:
        fh = await self.open(path)
        try:
            ino = fh.inode
            length = max(ino.length, ino.length_hint)
            if not length:
                length = await self.file_length(ino)
            return await self.read(fh, 0, length) if length else b""
        finally:
            await self.close(fh)


class PioV:
    """Batch gatherer: accumulate ring-style read/write ops across many fds,
    execute as one parallel storage batch (reference src/fuse/PioV.h:11-37)."""

    def __init__(self, fs: FileSystem):
        self.fs = fs
        self._reads: list[tuple[FileHandle, int, int, int]] = []
        self._writes: list[tuple[FileHandle, int, bytes, int]] = []

    def add_read(self, fh: FileHandle, offset: int, length: int,
                 tag: int = 0) -> None:
        self._reads.append((fh, offset, length, tag))

    def add_write(self, fh: FileHandle, offset: int, data: bytes,
                  tag: int = 0) -> None:
        self._writes.append((fh, offset, data, tag))

    async def execute(self) -> dict[int, tuple[int, bytes | int]]:
        """Run all queued ops concurrently; returns {tag: (status, payload)}
        where payload is bytes for reads, written-length for writes."""
        out: dict[int, tuple[int, bytes | int]] = {}

        async def run_read(fh, off, ln, tag):
            try:
                out[tag] = (0, await self.fs.read(fh, off, ln))
            except StatusError as e:
                out[tag] = (e.code, b"")

        async def run_write(fh, off, data, tag):
            try:
                out[tag] = (0, await self.fs.write(fh, off, data))
            except StatusError as e:
                out[tag] = (e.code, 0)

        await asyncio.gather(
            *(run_read(*r) for r in self._reads),
            *(run_write(*w) for w in self._writes))
        self._reads.clear()
        self._writes.clear()
        return out
