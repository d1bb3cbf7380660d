"""The port's in-memory storage client
(t3fs_torch.client.storage_client_inmem) on the CPU: the twin of
tests/test_client_differential.py, the fake against the port's real
client over the port's CRAQ fabric with the same seeds, and the fake
against the reference's fake: one seeded sequence of chunk and file-range
writes, truncates, removes and reads gives equal IOResults and equal bytes
in both packages.  Tolerance: exact equality."""

import asyncio
import random

import pytest

from t3fs.client.layout import FileLayout as RefLayout
from t3fs.client.storage_client_inmem import StorageClientInMem as RefInMem
from t3fs.storage.types import ChunkId as RefChunkId
from t3fs.storage.types import ReadIO as RefReadIO
from t3fs.storage.types import UpdateType as RefUpdateType
from t3fs_torch.client.layout import FileLayout
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.client.storage_client_inmem import StorageClientInMem
from t3fs_torch.storage.types import ChunkId, ReadIO, UpdateType
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.utils.status import StatusError

CHUNK = 4096
FILE_SPAN = 4 * CHUNK


def _gen_ops(rng: random.Random, n: int):
    ops = []
    for _ in range(n):
        inode = rng.choice([7, 8])
        k = rng.random()
        if k < 0.45:
            off = rng.randrange(0, FILE_SPAN - 1)
            ln = rng.randrange(1, min(FILE_SPAN - off, 2 * CHUNK))
            data = bytes(rng.getrandbits(8) for _ in range(ln))
            ops.append(("write", inode, off, data))
        elif k < 0.7:
            off = rng.randrange(0, FILE_SPAN)
            ln = rng.randrange(0, FILE_SPAN - off + 1)
            ops.append(("read", inode, off, ln))
        elif k < 0.8:
            ops.append(("length", inode))
        elif k < 0.9:
            ops.append(("truncate", inode, rng.randrange(0, FILE_SPAN)))
        else:
            ops.append(("remove", inode))
    return ops


async def _apply(client, lay, op):
    kind = op[0]
    try:
        if kind == "write":
            _, inode, off, data = op
            results = await client.write_file_range(lay, inode, off, data)
            return ("write", tuple(r.status.code for r in results))
        if kind == "read":
            _, inode, off, ln = op
            data, _ = await client.read_file_range(lay, inode, off, ln)
            return ("read", data)
        if kind == "length":
            return ("length", await client.query_last_chunk(lay, op[1]))
        if kind == "truncate":
            _, inode, ln = op
            await client.truncate_file(lay, inode, ln)
            return ("truncate", None)
        _, inode = op
        await client.remove_file_chunks(lay, inode)
        return ("remove", None)
    except StatusError as e:
        return ("err", int(e.code))


@pytest.mark.parametrize("seed", [21, 22, 23])
def test_inmem_fake_matches_real_client(seed):
    async def body():
        fab = StorageFabric(num_nodes=2, replicas=2, checksum_backend="cpu")
        await fab.start()
        try:
            real = StorageClient(lambda: fab.routing, client=fab.client)
            fake = StorageClientInMem()
            lay = FileLayout(chunk_size=CHUNK, chains=[fab.chain_id])
            rng = random.Random(seed)
            for op in _gen_ops(rng, 60):
                ra = await _apply(real, lay, op)
                rb = await _apply(fake, lay, op)
                assert ra == rb, (op, ra, rb)
            # final full readback of both files agrees
            for inode in (7, 8):
                la = await real.query_last_chunk(lay, inode)
                lb = await fake.query_last_chunk(lay, inode)
                assert la == lb, inode
                da, _ = await real.read_file_range(lay, inode, 0, la)
                db, _ = await fake.read_file_range(lay, inode, 0, lb)
                assert da == db, inode
            await real.close()
        finally:
            await fab.stop()
    asyncio.run(body())


def _res(r) -> tuple:
    """An IOResult as plain values (the two packages' classes differ)."""
    return (r.status.code, r.status.message, r.length, r.update_ver,
            r.commit_ver, r.commit_chain_ver, r.checksum)


async def _chunk_ops(fake, pkg: str, seed: int) -> list:
    """Seeded chunk-level and file-range ops on one fake: every result."""
    ref = pkg == "ref"
    Layout = RefLayout if ref else FileLayout
    Cid = RefChunkId if ref else ChunkId
    Rio = RefReadIO if ref else ReadIO
    Upd = RefUpdateType if ref else UpdateType
    rng = random.Random(seed)
    lay = Layout(chunk_size=CHUNK, chains=[1, 2, 3])
    seen: list = []
    for _ in range(80):
        k = rng.random()
        chain, inode = rng.choice([1, 2, 3]), rng.choice([5, 6])
        idx = rng.randrange(0, 4)
        if k < 0.25:
            off = rng.randrange(0, CHUNK)
            data = rng.randbytes(rng.randrange(1, CHUNK - off + 1))
            r = await fake.write_chunk(chain, Cid(inode, idx), off, data,
                                       CHUNK, update_type=Upd.WRITE)
            seen.append(("w", _res(r)))
        elif k < 0.35:
            data = rng.randbytes(rng.randrange(0, CHUNK + 1))
            r = await fake.write_chunk(chain, Cid(inode, idx), 0, data,
                                       CHUNK, update_type=Upd.REPLACE)
            seen.append(("replace", _res(r)))
        elif k < 0.45:
            r = await fake.write_chunk(chain, Cid(inode, idx), 0, b"", CHUNK,
                                       update_type=Upd.TRUNCATE,
                                       truncate_len=rng.randrange(0, CHUNK))
            seen.append(("t", _res(r)))
        elif k < 0.52:
            r = await fake.write_chunk(chain, Cid(inode, idx), 0, b"", CHUNK,
                                       update_type=Upd.REMOVE)
            seen.append(("rm", _res(r)))
        elif k < 0.7:
            ios = [Rio(chunk_id=Cid(inode, rng.randrange(0, 4)),
                       chain_id=rng.choice([1, 2, 3]),
                       offset=rng.randrange(0, CHUNK),
                       length=rng.randrange(0, CHUNK))
                   for _ in range(rng.randrange(1, 5))]
            results, payloads = await fake.batch_read(ios)
            seen.append(("br", [_res(r) for r in results], payloads))
        elif k < 0.8:
            off = rng.randrange(0, 3 * CHUNK)
            data = rng.randbytes(rng.randrange(1, 2 * CHUNK))
            rs = await fake.write_file_range(lay, inode, off, data)
            seen.append(("wfr", [_res(r) for r in rs]))
        elif k < 0.88:
            off = rng.randrange(0, 5 * CHUNK)
            data, rs = await fake.read_file_range(
                lay, inode, off, rng.randrange(0, 2 * CHUNK))
            seen.append(("rfr", data, [_res(r) for r in rs]))
        elif k < 0.94:
            await fake.truncate_file(lay, inode, rng.randrange(0, 5 * CHUNK))
            seen.append(("tf", await fake.query_last_chunk(lay, inode)))
        else:
            await fake.remove_file_chunks(lay, inode)
            seen.append(("rmf", await fake.query_last_chunk(lay, inode)))
    seen.append(("state", sorted(
        ((c, k.inode, k.index), v.data, v.update_ver)
        for (c, k), v in fake.chunks.items())))
    await fake.close()
    return seen


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_inmem_fakes_equal_across_packages(seed):
    ref = asyncio.run(_chunk_ops(RefInMem(), "ref", seed))
    port = asyncio.run(_chunk_ops(StorageClientInMem(), "port", seed))
    assert port == ref
    kinds = {s[0] for s in port}
    assert {"w", "replace", "t", "rm", "br", "wfr", "rfr"} <= kinds
    assert port[-1][1], "the sequence left no chunk to compare"
