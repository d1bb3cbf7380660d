"""One seeded CRAQ update sequence driven through the reference's storage
fabric (t3fs) and the port's (t3fs_torch), recorded in plain tuples so the
two runs compare bit for bit.  Imported by the port's storage tests."""

import numpy as np

from t3fs.ops import codec as ref_codec
from t3fs.storage import types as ref_types
from t3fs.testing.fabric import StorageFabric as RefFabric
from t3fs_torch.ops import codec as port_codec
from t3fs_torch.ops.crc32c import crc32c_ref
from t3fs_torch.storage import types as port_types
from t3fs_torch.testing.fabric import StorageFabric as PortFabric

NUM_UPDATES = 40
CHUNK_SIZE = 160 << 10
INODE = 31
CHUNKS = 3
# around the device backend's 64 KiB cutoff, and a whole chunk
SIZES = (1, 4000, 65535, 65536, 65537, 100_000, CHUNK_SIZE)
KINDS = ("full", "partial", "append", "truncate", "remove")


def make_ops(seed: int) -> list[tuple]:
    """(kind, chunk index, offset or new length, payload) per update, from
    a model of each chunk's length that keeps every write inside the chunk."""
    rng = np.random.default_rng(seed)
    lengths: dict[int, int] = {}
    ops = []
    while len(ops) < NUM_UPDATES:
        idx = int(rng.integers(0, CHUNKS))
        kind = KINDS[int(rng.choice(5, p=[0.25, 0.25, 0.25, 0.15, 0.10]))]
        cur = lengths.get(idx)
        if cur is None and kind != "truncate":
            kind = "full"
        if kind == "append" and cur >= CHUNK_SIZE:
            kind = "partial"
        if kind == "truncate":
            new_len = int(rng.choice([0, 1000, 65536, 70_000, CHUNK_SIZE]))
            ops.append(("truncate", idx, new_len, b""))
            lengths[idx] = new_len
            continue
        if kind == "remove":
            ops.append(("remove", idx, 0, b""))
            lengths.pop(idx)
            continue
        if kind == "full":
            off, n = 0, int(rng.choice(SIZES))
        elif kind == "partial":
            off = int(rng.integers(0, max(cur, 1)))
            n = min(int(rng.choice(SIZES)), CHUNK_SIZE - off)
        else:
            off = cur
            n = min(int(rng.choice(SIZES)), CHUNK_SIZE - off)
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        ops.append(("write", idx, off, data))
        lengths[idx] = max(cur or 0, off + n)
    return ops


def _result(r) -> tuple:
    return (r.status.code, r.length, r.update_ver, r.commit_ver,
            r.commit_chain_ver, r.checksum)


async def drive(fabric, types, crc32c, ops) -> dict:
    """Run ops against a started fabric through its RPCs; record every
    IOResult, then every replica's metas and bytes."""
    results = []
    addr = fabric.head_address()
    cid_of = [types.ChunkId(INODE, i) for i in range(CHUNKS)]
    for seq, (kind, idx, arg, data) in enumerate(ops, start=1):
        if kind == "write":
            req = types.WriteReq(io=types.UpdateIO(
                chunk_id=cid_of[idx], chain_id=fabric.chain_id,
                chain_ver=fabric.chain().chain_ver,
                update_type=types.UpdateType.WRITE, offset=arg,
                length=len(data), chunk_size=CHUNK_SIZE,
                checksum=crc32c(data), channel=1, channel_seq=seq,
                client_id="diff-client", inline=True))
            rsp, _ = await fabric.client.call(addr, "Storage.write", req,
                                              payload=data)
        elif kind == "truncate":
            rsp, _ = await fabric.client.call(
                addr, "Storage.truncate_chunk", types.TruncateChunkReq(
                    chain_id=fabric.chain_id, chunk_id=cid_of[idx],
                    new_length=arg, chunk_size=CHUNK_SIZE))
        else:
            rsp, _ = await fabric.client.call(
                addr, "Storage.remove_chunks", types.RemoveChunksReq(
                    chain_id=fabric.chain_id, inode=INODE, begin_index=idx,
                    end_index=idx + 1))
        results.append(_result(rsp.result))
    replicas = []
    for i, node in enumerate(fabric.nodes):
        engine = node.targets[fabric.target_id(i)].engine
        chunks = []
        for cid in cid_of:
            meta = engine.get_meta(cid)
            if meta is None:
                chunks.append(None)
                continue
            data = engine.read(cid)
            chunks.append((meta.length, meta.update_ver, meta.commit_ver,
                           meta.chain_ver, meta.checksum, int(meta.state),
                           data, crc32c_ref(data) == meta.checksum))
        replicas.append(chunks)
    return {"results": results, "replicas": replicas}


async def run_fabric(fabric, types, crc32c, ops) -> dict:
    await fabric.start()
    try:
        return await drive(fabric, types, crc32c, ops)
    finally:
        await fabric.stop()


# engine -> (engine_backend, aio_read) of both fabrics: the SQLite engine
# with thread-pool reads, or the reference's defaults, the native engine
# with io_uring reads
STORAGE = {"py": ("py", False), "native": ("native", True)}


async def run_both(port_backend, pipeline: str, seed: int,
                   engine: str = "py") -> tuple[dict, dict]:
    """The same ops through the reference fabric (cpu backend) and the
    port's fabric on port_backend, both on `engine`'s storage."""
    ops = make_ops(seed)
    threshold = (64 << 10) if pipeline == "streamed" else None
    engine_backend, aio_read = STORAGE[engine]
    ref = await run_fabric(
        RefFabric(num_nodes=3, replicas=3, checksum_backend="cpu",
                  engine_backend=engine_backend, aio_read=aio_read,
                  write_pipeline=pipeline, stream_threshold=threshold),
        ref_types, ref_codec.crc32c, ops)
    port = await run_fabric(
        PortFabric(num_nodes=3, replicas=3, checksum_backend=port_backend,
                   engine_backend=engine_backend, aio_read=aio_read,
                   write_pipeline=pipeline, stream_threshold=threshold),
        port_types, port_codec.crc32c, ops)
    return ref, port
