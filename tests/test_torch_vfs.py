"""The port's FileSystem (t3fs_torch/fuse/vfs.py) over the port's
LocalCluster with its meta service: the cases of tests/test_vfs.py, the
meta GC reclaiming an unlinked file's chunks on every replica, and one
seeded sequence of file operations through both packages' clusters with
equal results.  The port's nodes checksum on the CPU backend (plain
versions)."""

import asyncio
import os

import numpy as np
import pytest

from t3fs_torch.fuse.vfs import FileSystem, PioV
from t3fs_torch.meta.events import MetaEventType
from t3fs_torch.storage.types import ChunkId
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusError


def run(coro):
    return asyncio.run(coro)


def cluster(**kw) -> LocalCluster:
    return LocalCluster(with_meta=True, checksum_backend="cpu", **kw)


def test_vfs_file_lifecycle():
    async def body():
        c = cluster(num_nodes=3, replicas=3, num_chains=3)
        await c.start()
        try:
            fs = FileSystem(c.mc, c.sc)
            await fs.mkdirs("/data/raw")
            fh = await fs.create("/data/raw/a.bin", chunk_size=4096)
            payload = os.urandom(20000)
            assert await fs.write(fh, 0, payload) == len(payload)
            ino = await fs.close(fh)
            assert ino.length == len(payload)
            fh2 = await fs.open("/data/raw/a.bin")
            assert await fs.read(fh2, 0, 1 << 20) == payload
            assert await fs.read(fh2, 5000, 100) == payload[5000:5100]
            await fs.close(fh2)
            fh3 = await fs.open("/data/raw/a.bin", "a")
            tail = b"tail-bytes"
            await fs.write(fh3, 0, tail)
            await fs.close(fh3)
            assert await fs.read_file("/data/raw/a.bin") == payload + tail
            names = {e.name for e in await fs.readdir("/data/raw")}
            assert names == {"a.bin"}
            await fs.rename("/data/raw/a.bin", "/data/raw/b.bin")
            st = await fs.stat("/data/raw/b.bin")
            assert st.length == len(payload) + len(tail)
            await fs.unlink("/data/raw/b.bin")
            with pytest.raises(StatusError):
                await fs.stat("/data/raw/b.bin")
        finally:
            await c.stop()
    run(body())


def test_vfs_write_read_convenience_and_overwrite():
    async def body():
        c = cluster(num_nodes=3, replicas=2)
        await c.start()
        try:
            fs = FileSystem(c.mc, c.sc)
            await fs.mkdirs("/m")
            await fs.write_file("/m/x", b"first", chunk_size=4096)
            assert await fs.read_file("/m/x") == b"first"
            await fs.write_file("/m/x", b"second!")
            assert await fs.read_file("/m/x") == b"second!"
            await fs.write_file("/m/x", b"hi")
            assert await fs.read_file("/m/x") == b"hi"
        finally:
            await c.stop()
    run(body())


def test_piov_batch_mixed_ops():
    async def body():
        c = cluster(num_nodes=3, replicas=3)
        await c.start()
        try:
            fs = FileSystem(c.mc, c.sc)
            await fs.mkdirs("/p")
            handles, blobs = [], []
            for i in range(4):
                fh = await fs.create(f"/p/f{i}", chunk_size=4096)
                blob = os.urandom(6000 + i * 100)
                await fs.write(fh, 0, blob)
                handles.append(fh)
                blobs.append(blob)
            piov = PioV(fs)
            for i, fh in enumerate(handles):
                piov.add_read(fh, 100, 500, tag=i)
            piov.add_write(handles[0], 0, b"Z" * 64, tag=100)
            out = await piov.execute()
            for i in range(4):
                code, data = out[i]
                assert code == 0
                assert data == blobs[i][100:600]
            assert out[100] == (0, 64)
            assert (await fs.read(handles[0], 0, 64)) == b"Z" * 64
            for fh in handles:
                await fs.close(fh)
        finally:
            await c.stop()
    run(body())


def test_meta_gc_removes_unlinked_chunks_on_every_replica():
    """The meta server's GC task (0.1 s period, in the cluster's event
    loop) reclaims an unlinked file's chunks from every replica's engine;
    a file removed while open for write keeps its chunks until its write
    session is released.

    No node is killed, so the heartbeat timeout is one test load cannot
    reach (a fenced replica would miss the REMOVEs until resynced), and
    each check waits for the GC's own event for the inode, not a fixed
    number of polls."""
    async def body():
        c = cluster(num_nodes=3, replicas=3, num_chains=2,
                    heartbeat_timeout_s=60.0)
        await c.start()
        reclaimed: dict[int, asyncio.Event] = {}
        emit = c.meta.store._emit

        def spy(etype, **fields):
            if etype == MetaEventType.GC:
                reclaimed.setdefault(fields["inode_id"], asyncio.Event()).set()
            return emit(etype, **fields)

        async def gc_of(inode) -> None:
            ev = reclaimed.setdefault(inode.inode_id, asyncio.Event())
            await asyncio.wait_for(ev.wait(), timeout=60.0)

        c.meta.store._emit = spy
        try:
            fs = FileSystem(c.mc, c.sc)
            await fs.mkdirs("/gc/a")
            data = np.random.default_rng(9).integers(
                0, 256, 5 * 8192 + 3, dtype=np.uint8).tobytes()
            ino = await fs.write_file("/gc/a/f", data, chunk_size=8192)
            assert ino.length == len(data)
            held = await fs.create("/gc/a/held", chunk_size=8192)
            await fs.write(held, 0, data[:9000])
            await fs.rename("/gc/a/f", "/gc/g")
            assert await fs.read_file("/gc/g") == data
            assert [e.name for e in await fs.readdir("/gc/a")] == ["held"]

            def engines(layout):
                for chain_id in layout.chains:
                    for t in c.chain(chain_id).targets:
                        yield c.storage[t.node_id].node.targets[
                            t.target_id].engine

            def present(inode) -> int:
                """The file's chunks found on any replica of its chains."""
                lay = inode.layout
                n = -(-max(inode.length, 9000) // lay.chunk_size)
                return sum(eng.get_meta(ChunkId(inode.inode_id, i)) is not None
                           for i in range(n) for eng in engines(lay))

            assert present(ino) > 0
            held_ino = (await fs.stat("/gc/a/held"))
            await fs.unlink("/gc/g")
            await fs.unlink("/gc/a", recursive=True)
            await gc_of(ino)
            assert present(ino) == 0
            assert c.meta.gc_count >= 1
            # the open write session pins the held file's chunks
            assert present(held_ino) > 0
            await c.mc.prune_sessions([held.session_id])
            await gc_of(held_ino)
            assert present(held_ino) == 0
        finally:
            await c.stop()
    run(body())


async def fs_sequence(pkg: str) -> list:
    """One seeded sequence of FileSystem operations on pkg's cluster."""
    if pkg == "ref":
        from t3fs.fuse.vfs import FileSystem as FS
        from t3fs.testing.cluster import LocalCluster as LC
        from t3fs.utils import serde
        from t3fs.utils.status import StatusError as SE
        c = LC(num_nodes=3, replicas=2, num_chains=2, with_meta=True)
    else:
        from t3fs_torch.utils import serde
        FS, SE = FileSystem, StatusError
        c = cluster(num_nodes=3, replicas=2, num_chains=2)
    await c.start()
    rng = np.random.default_rng(5)
    out = []
    try:
        fs = FS(c.mc, c.sc)

        async def o(coro):
            try:
                r = await coro
                if hasattr(r, "inode_id"):
                    r = (r.inode_id, r.length, int(r.itype), r.perm,
                         r.nlink, r.layout and serde.dumps(r.layout))
                elif isinstance(r, list):
                    r = [(e.name, e.inode_id, int(e.itype)) for e in r]
                out.append(("ok", r))
            except SE as e:
                out.append(("err", int(e.code)))

        await o(fs.mkdirs("/s/t"))
        for i in range(6):
            blob = rng.integers(0, 256, int(rng.integers(1, 30000)),
                                dtype=np.uint8).tobytes()
            await o(fs.write_file(f"/s/t/f{i}", blob,
                                  chunk_size=4096 << (i % 3)))
            await o(fs.read_file(f"/s/t/f{i}"))
        await o(fs.readdir("/s/t"))
        await o(fs.rename("/s/t/f1", "/s/f1"))
        await o(fs.symlink("/s/link", "/s/t/f2"))
        await o(fs.read_file("/s/link"))
        await o(fs.truncate("/s/t/f3", 1000))
        await o(fs.read_file("/s/t/f3"))
        fh = await fs.open("/s/t/f4", "a")
        await o(fs.write(fh, 0, b"appended"))
        await o(fs.fsync(fh))
        await o(fs.close(fh))
        await o(fs.read_file("/s/t/f4"))
        await o(fs.unlink("/s/t"))
        await o(fs.unlink("/s/t/f0"))
        await o(fs.stat("/s/t/f0"))
        await o(fs.readdir("/s"))
        await o(fs.unlink("/s", recursive=True))
        await o(fs.readdir("/"))
        return out
    finally:
        await c.stop()


def test_file_sequence_matches_reference():
    """The same seeded writes, reads, renames, truncates, appends and
    removes through each package's FileSystem and cluster give the same
    inode ids, lengths, layouts, listings, bytes and error codes."""
    ref, port = run(fs_sequence("ref")), run(fs_sequence("port"))
    assert len(ref) == len(port) > 25
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a == b, (i, a, b)
    assert [k for k, _ in ref].count("err") >= 2
