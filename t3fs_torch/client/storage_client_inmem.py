"""StorageClientInMem: the whole storage client on a dict — used by meta and
FUSE tests to avoid storage entirely (reference:
client/storage/StorageClientInMem.cc, 395 LoC fake).

The port of t3fs/client/storage_client_inmem.py."""

from __future__ import annotations

from dataclasses import dataclass, field

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.net.wire import WireStatus
from t3fs_torch.ops.codec import crc32c as crc32c_ref
from t3fs_torch.storage.types import ChunkId, IOResult, ReadIO, UpdateType
from t3fs_torch.utils.status import StatusCode


@dataclass
class _Chunk:
    data: bytes = b""
    update_ver: int = 0


class StorageClientInMem:
    """Duck-typed like StorageClient for the ops meta/FUSE need."""

    def __init__(self):
        self.chunks: dict[tuple[int, ChunkId], _Chunk] = {}

    async def write_chunk(self, chain_id: int, chunk_id: ChunkId, offset: int,
                          data: bytes, chunk_size: int,
                          update_type: UpdateType = UpdateType.WRITE,
                          truncate_len: int = 0,
                          checksum: int | None = None) -> IOResult:
        # checksum: accepted for StorageClient duck-type parity (EC repair
        # passes device-computed CRCs); the fake always re-CRCs itself.
        key = (chain_id, chunk_id)
        cur = self.chunks.get(key, _Chunk())
        if update_type == UpdateType.TRUNCATE:
            content = cur.data[:truncate_len].ljust(truncate_len, b"\x00")
        elif update_type == UpdateType.REMOVE:
            self.chunks.pop(key, None)
            return IOResult(WireStatus(), 0, cur.update_ver + 1, cur.update_ver + 1)
        else:
            end = offset + len(data)
            buf = bytearray(cur.data.ljust(max(len(cur.data), end), b"\x00"))
            buf[offset:end] = data
            content = bytes(buf)
        self.chunks[key] = _Chunk(content, cur.update_ver + 1)
        return IOResult(WireStatus(), len(content), cur.update_ver + 1,
                        cur.update_ver + 1, 1, crc32c_ref(content))

    async def batch_read(self, ios: list[ReadIO]):
        results, payloads = [], []
        for io in ios:
            chunk = self.chunks.get((io.chain_id, io.chunk_id))
            if chunk is None:
                results.append(IOResult(WireStatus(int(StatusCode.CHUNK_NOT_FOUND),
                                                   str(io.chunk_id))))
                payloads.append(b"")
                continue
            data = chunk.data[io.offset: io.offset + io.length
                              if io.length else len(chunk.data)]
            results.append(IOResult(WireStatus(), len(data), chunk.update_ver,
                                    chunk.update_ver, 1, crc32c_ref(chunk.data)))
            payloads.append(data)
        return results, payloads

    async def write_file_range(self, layout: FileLayout, inode: int,
                               offset: int, data: bytes) -> list[IOResult]:
        out = []
        pos = 0
        for idx, coff, span in layout.chunk_span(offset, len(data)):
            out.append(await self.write_chunk(
                layout.chain_of(idx), ChunkId(inode, idx), coff,
                data[pos: pos + span], layout.chunk_size))
            pos += span
        return out

    async def read_file_range(self, layout: FileLayout, inode: int,
                              offset: int, length: int):
        pieces = layout.chunk_span(offset, length)
        ios = [ReadIO(chunk_id=ChunkId(inode, idx), chain_id=layout.chain_of(idx),
                      offset=coff, length=span) for idx, coff, span in pieces]
        results, payloads = await self.batch_read(ios)
        data = bytearray()
        for (idx, coff, span), r, p in zip(pieces, results, payloads):
            data += p.ljust(span, b"\x00") if r.status.code in (
                int(StatusCode.OK), int(StatusCode.CHUNK_NOT_FOUND)) else p
        return bytes(data), results

    async def query_last_chunk(self, layout: FileLayout, inode: int) -> int:
        best = 0
        for (chain_id, cid), chunk in self.chunks.items():
            if cid.inode == inode:
                best = max(best, cid.index * layout.chunk_size + len(chunk.data))
        return best

    async def remove_file_chunks(self, layout: FileLayout, inode: int) -> None:
        for key in [k for k in self.chunks if k[1].inode == inode]:
            del self.chunks[key]

    async def truncate_file(self, layout: FileLayout, inode: int,
                            new_length: int) -> None:
        boundary = new_length // layout.chunk_size
        boundary_off = new_length - boundary * layout.chunk_size
        for key in list(self.chunks):
            if key[1].inode != inode:
                continue
            idx = key[1].index
            if idx > boundary or (idx == boundary and boundary_off == 0):
                del self.chunks[key]
            elif idx == boundary:
                c = self.chunks[key]
                self.chunks[key] = _Chunk(
                    c.data[:boundary_off].ljust(boundary_off, b"\x00"),
                    c.update_ver + 1)
        if boundary_off:
            # the real client TRUNCATE-writes the boundary chunk even when
            # it doesn't exist (exact-length semantics; the differential
            # fuzz caught the fake skipping this) — mirror it
            bkey = (layout.chain_of(boundary), ChunkId(inode, boundary))
            if bkey not in self.chunks:
                self.chunks[bkey] = _Chunk(b"\x00" * boundary_off, 1)

    async def close(self) -> None:
        pass
