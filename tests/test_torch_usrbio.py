"""The port's USRBIO shm rings (t3fs_torch/lib/usrbio.py over csrc/usrbio.cpp)
and its FUSE ring worker (t3fs_torch/fuse/ring_worker.py): the cases of
tests/test_usrbio.py run on the port, then held against the JAX package.

The SQE and CQE structs and the shm ring layout are the reference's byte for
byte: a ring or iov created through either package's host library is opened,
popped, completed and read through the other's, and an app ring of either
package is served by the other package's RingWorker over its own cluster
with the same completions and bytes.  Both host libraries are loaded in this
one process, each by ctypes with RTLD_LOCAL, so each binding calls its own
library's t3fs_iov_* and t3fs_ior_* symbols."""

import asyncio
import ctypes
import json
import os
import types as pytypes
import uuid
from pathlib import Path

import numpy as np
import pytest

import t3fs.fuse.ring_worker
import t3fs.fuse.vfs
import t3fs.lib.usrbio
import t3fs.testing.cluster
import t3fs_torch.fuse.ring_worker
import t3fs_torch.fuse.vfs
import t3fs_torch.lib.usrbio
import t3fs_torch.testing.cluster
from t3fs_torch.fuse.ring_worker import RingWorker
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.lib import usrbio
from t3fs_torch.testing.cluster import LocalCluster


def unique(prefix):
    return f"{prefix}-{uuid.uuid4().hex[:8]}"


def _pkg(root) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, usrbio=root.lib.usrbio, vfs=root.fuse.vfs,
        worker=root.fuse.ring_worker, cluster=root.testing.cluster)


REF = _pkg(t3fs)
PORT = _pkg(t3fs_torch)


def port_cluster(**kw) -> LocalCluster:
    return LocalCluster(checksum_backend="cpu", **kw)


# ---------------- tests/test_usrbio.py on the port ----------------

def test_ring_mechanics_same_process():
    """sqe/cqe flow through shm without any storage."""
    iov = usrbio.IoVec(unique("iov"), 1 << 16)
    ring = usrbio.IoRing(unique("ring"), entries=8, iov=iov)
    try:
        for i in range(5):
            ring.prep_io(True, ident=42, iov_off=i * 100, length=100,
                         file_off=i * 1000, userdata=i)
        ring.submit_ios()
        popped = []
        for _ in range(5):
            sqe = ring.pop_sqe(timeout_ms=1000)
            assert sqe is not None
            popped.append((sqe.userdata, sqe.ident, sqe.iov_off,
                           sqe.file_off))
            ring.complete(sqe.userdata, 100, 0)
        assert [p[0] for p in popped] == [0, 1, 2, 3, 4]
        assert all(p[1] == 42 for p in popped)
        cqes = ring.wait_for_ios(max_n=16, min_n=5, timeout_ms=1000)
        assert sorted(c.userdata for c in cqes) == [0, 1, 2, 3, 4]
        assert all(c.result == 100 and c.status == 0 for c in cqes)
        for i in range(ring.entries):
            ring.prep_io(True, 1, 0, 1, 0, userdata=i)
        with pytest.raises(BufferError):
            ring.prep_io(True, 1, 0, 1, 0)
    finally:
        ring.close()
        iov.close()


def test_ring_cross_process_open():
    """A second handle opened by name sees the same ring (daemon attach)."""
    iov_name, ring_name = unique("iov"), unique("ring")
    iov = usrbio.IoVec(iov_name, 4096)
    ring = usrbio.IoRing(ring_name, entries=4, iov=iov)
    try:
        ring2 = usrbio.IoRing(ring_name, create=False)
        assert ring2.iov_name == iov_name
        iov2 = usrbio.IoVec(ring2.iov_name, 4096, create=False)
        iov.write_at(10, b"hello")
        assert iov2.read_at(10, 5) == b"hello"
        ring.prep_io(False, 7, 10, 5, 0, userdata=99)
        ring.submit_ios()
        sqe = ring2.pop_sqe(timeout_ms=1000)
        assert sqe is not None and sqe.userdata == 99 and sqe.ident == 7
        ring2.complete(99, 5, 0)
        got = ring.wait_for_ios(min_n=1, timeout_ms=1000)
        assert got and got[0].userdata == 99
        iov2.close(unlink=False)
        ring2.close()
    finally:
        ring.close()
        iov.close()


def test_usrbio_end_to_end_through_cluster():
    """App rings served by the port's RingWorker against the port's full
    cluster: prep/submit/wait over real storage."""
    async def body():
        cluster = port_cluster(num_nodes=3, replicas=2, num_chains=2,
                               with_meta=True)
        await cluster.start()
        iov_name, ring_name = unique("iov"), unique("ring")
        iov = usrbio.IoVec(iov_name, 1 << 20)
        ring = usrbio.IoRing(ring_name, entries=64, iov=iov)
        worker = None
        try:
            fs = FileSystem(cluster.mc, cluster.sc)
            await fs.mkdirs("/u")
            fh = await fs.create("/u/data", chunk_size=4096)
            ident = usrbio.reg_fd(fh)

            worker = RingWorker(ring_name, cluster.mc, cluster.sc)
            await worker.start()

            blobs = [os.urandom(4096) for _ in range(3)]
            for i, b in enumerate(blobs):
                iov.write_at(i * 4096, b)
                ring.prep_io(False, ident, i * 4096, 4096, i * 4096,
                             userdata=i)
            ring.submit_ios()
            done = await asyncio.get_running_loop().run_in_executor(
                None, lambda: ring.wait_for_ios(max_n=8, min_n=3,
                                                timeout_ms=10000))
            assert len(done) == 3 and all(c.status == 0 for c in done)

            for i in range(3):
                ring.prep_io(True, ident, (8 + i) * 4096, 4096, i * 4096,
                             userdata=100 + i)
            ring.submit_ios()
            done = await asyncio.get_running_loop().run_in_executor(
                None, lambda: ring.wait_for_ios(max_n=8, min_n=3,
                                                timeout_ms=10000))
            assert len(done) == 3 and all(c.status == 0 for c in done)
            for i, b in enumerate(blobs):
                assert iov.read_at((8 + i) * 4096, 4096) == b

            assert await fs.read(fh, 0, 3 * 4096) == b"".join(blobs)
            await fs.close(fh)
        finally:
            if worker:
                await worker.stop()
            ring.close()
            iov.close()
            await cluster.stop()
    asyncio.run(body())


# ---------------- the port against the JAX package ----------------

def test_sqe_cqe_structs_match_reference():
    """CSqe and CCqe: the same size, field names, types and offsets."""
    for name in ("CSqe", "CCqe"):
        a, b = getattr(PORT.usrbio, name), getattr(REF.usrbio, name)
        assert ctypes.sizeof(a) == ctypes.sizeof(b) == (48 if name == "CSqe" else 24)
        assert [(f, t) for f, t in a._fields_] == [(f, t) for f, t in b._fields_]
        assert [getattr(a, f).offset for f, _ in a._fields_] == \
               [getattr(b, f).offset for f, _ in b._fields_]
    assert (PORT.usrbio.OP_READ, PORT.usrbio.OP_WRITE) == \
           (REF.usrbio.OP_READ, REF.usrbio.OP_WRITE) == (0, 1)


def test_each_binding_loads_its_own_library():
    """The port binds its own host library (t3fs_torch/_build), the
    reference its t3fs/native one, both loaded RTLD_LOCAL in this process."""
    port_lib = Path(PORT.usrbio._lib()._name).resolve()
    ref_lib = Path(REF.usrbio._lib()._name).resolve()
    assert port_lib.parent.name == "_build" and \
        port_lib.name.startswith("libnative_storage-")
    assert ref_lib.name.startswith("libt3fs_native")
    assert port_lib != ref_lib
    for lib in (PORT.usrbio._lib(), REF.usrbio._lib()):
        assert ctypes.cast(lib.t3fs_iov_create, ctypes.c_void_p).value
    # each binding's symbol is its own library's
    assert ctypes.cast(PORT.usrbio._lib().t3fs_ior_prep, ctypes.c_void_p).value != \
        ctypes.cast(REF.usrbio._lib().t3fs_ior_prep, ctypes.c_void_p).value


@pytest.mark.parametrize("creator", ["ref", "port"])
def test_shm_ring_layout_shared_across_packages(creator):
    """An iov and a ring created through one package's library are opened
    through the other's: the opener reads the creator's bytes, pops its
    SQEs field for field (single and batched pops), completes them (single
    and batched) and writes the iov; the creator waits the CQEs and reads
    the bytes; the entries and iov name round-trip."""
    mk, op = (REF, PORT) if creator == "ref" else (PORT, REF)
    rng = np.random.default_rng(15)
    iov_name, ring_name = unique("xiov"), unique("xring")
    iov = mk.usrbio.IoVec(iov_name, 16 * 4096)
    ring = mk.usrbio.IoRing(ring_name, entries=32, iov=iov)
    try:
        ring2 = op.usrbio.IoRing(ring_name, create=False)
        iov2 = op.usrbio.IoVec(ring2.iov_name, create=False)
        assert (ring2.iov_name, ring2.entries, iov2.size) == (iov_name, 32, 16 * 4096)
        data = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
        iov.write_at(4096, data)
        assert iov2.read_at(4096, 4096) == data
        sqes = [(bool(rng.integers(0, 2)), int(rng.integers(0, 1 << 62)),
                 int(rng.integers(0, 16)) * 4096, int(rng.integers(1, 4097)),
                 int(rng.integers(0, 1 << 40)), int(rng.integers(0, 1 << 63)))
                for _ in range(9)]
        for is_read, ident, off, length, foff, ud in sqes:
            ring.prep_io(is_read, ident, off, length, foff, userdata=ud)
        ring.submit_ios()
        first = ring2.pop_sqe(timeout_ms=2000)
        rest = ring2.pop_sqes(max_n=32, timeout_ms=2000)
        popped = [first, *rest]
        assert [(s.op == 0, s.ident, s.iov_off, s.len, s.file_off, s.userdata,
                 s.flags) for s in popped] == [(*t, 0) for t in sqes]
        for s in popped:
            iov2.write_at(s.iov_off, bytes([s.userdata & 0xFF]) * s.len)
        ring2.complete(popped[0].userdata, popped[0].len, 0)
        ring2.complete_many([(s.userdata, -1 if i % 3 else s.len, i)
                             for i, s in enumerate(popped[1:], 1)])
        done = ring.wait_for_ios(max_n=32, min_n=9, timeout_ms=2000)
        assert [(c.userdata, c.result, c.status) for c in done] == \
            [(popped[0].userdata, popped[0].len, 0)] + [
                (s.userdata, -1 if i % 3 else s.len, i)
                for i, s in enumerate(popped[1:], 1)]
        last = popped[-1]
        assert iov.read_at(last.iov_off, last.len) == \
            bytes([last.userdata & 0xFF]) * last.len
        assert ring2.pop_sqes(max_n=4, timeout_ms=20) == []
        iov2.close(unlink=False)
        ring2.close()
    finally:
        ring.close()
        iov.close()


async def serve_app_ring(app, daemon, plane: str, seed: int) -> dict:
    """An app ring and iov of package `app`, served by package `daemon`'s
    RingWorker over daemon's own LocalCluster (3 nodes, 2 chains of 2,
    with meta) on `plane`: seeded whole-block and partial writes, then
    reads of every block; returns the CQEs, the iov's read bytes and the
    file read back through the daemon's FileSystem."""
    rng = np.random.default_rng(seed)
    blk, nblk = 4096, 12
    cluster = (daemon.cluster.LocalCluster(num_nodes=3, replicas=2, num_chains=2,
                                           with_meta=True)
               if daemon is REF else
               port_cluster(num_nodes=3, replicas=2, num_chains=2, with_meta=True))
    await cluster.start()
    cluster.sc.cfg.data_plane = plane
    iov_name, ring_name = unique("aiov"), unique("aring")
    iov = app.usrbio.IoVec(iov_name, 2 * nblk * blk)
    ring = app.usrbio.IoRing(ring_name, entries=64, iov=iov)
    worker = None
    loop = asyncio.get_running_loop()

    async def wait(n):
        got = []
        while len(got) < n:
            got += await loop.run_in_executor(None, lambda: ring.wait_for_ios(
                max_n=64, min_n=1, timeout_ms=10000))
        return sorted((c.userdata, c.result, c.status) for c in got)

    try:
        fs = daemon.vfs.FileSystem(cluster.mc, cluster.sc)
        await fs.mkdirs("/app")
        fh = await fs.create("/app/f", chunk_size=blk)
        ident = app.usrbio.reg_fd(fh)
        worker = daemon.worker.RingWorker(ring_name, cluster.mc, cluster.sc)
        assert (worker._ring_plane is not None) == (plane == "ring")
        await worker.start()
        writes = []
        for i in range(nblk):
            n = blk if i % 3 else int(rng.integers(1, blk))
            writes.append((i * blk, rng.integers(0, 256, n, dtype=np.uint8).tobytes()))
        for u, (foff, data) in enumerate(writes):
            iov.write_at(u * blk, data)
            ring.prep_io(False, ident, u * blk, len(data), foff, userdata=u)
        ring.submit_ios()
        wcqes = await wait(len(writes))
        for u in range(nblk):
            ring.prep_io(True, ident, (nblk + u) * blk, blk, u * blk,
                         userdata=1000 + u)
        ring.submit_ios()
        rcqes = await wait(nblk)
        back = [iov.read_at((nblk + u) * blk, blk) for u in range(nblk)]
        whole = await fs.read(fh, 0, nblk * blk)
        await fs.close(fh)
        return {"writes": writes, "wcqes": wcqes, "rcqes": rcqes, "back": back,
                "file": whole}
    finally:
        if worker:
            await worker.stop()
        ring.close()
        iov.close()
        await cluster.stop()


@pytest.mark.parametrize("plane", ["rpc", "ring"])
def test_app_ring_served_across_packages(plane):
    """A reference app ring served by the port's RingWorker over the port's
    cluster, and a port app ring served by the reference's RingWorker over
    the reference's: the same CQEs (userdata, result, status), the written
    bytes read back through the ring and through the daemon's FileSystem,
    on the rpc and on the ring data plane (where the worker's lean path
    lands the reads straight in the other package's iov)."""
    ref_app = asyncio.run(serve_app_ring(REF, PORT, plane, seed=7))
    port_app = asyncio.run(serve_app_ring(PORT, REF, plane, seed=7))
    assert ref_app == port_app
    out = ref_app
    assert [c[1:] for c in out["wcqes"]] == [(len(d), 0) for _, d in out["writes"]]
    assert all(c[1:] == (4096, 0) for c in out["rcqes"])
    for (foff, data), got in zip(out["writes"], out["back"]):
        assert got[:len(data)] == data and not any(got[len(data):])
    assert out["file"] == b"".join(got for got in out["back"])[:len(out["file"])]


def test_usrbio_bench_on_the_cpu():
    """usrbio_bench --cpu --data-plane-ab --verify at a small size: every
    read verified, the ring cell's reads all SQEs on the nodes, the rpc
    cell's none."""
    import contextlib
    import io

    from t3fs_torch.benchmarks import usrbio_bench

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = usrbio_bench.main(["--cpu", "--data-plane-ab", "--trials", "1",
                                "--seconds", "0.5", "--file-size", str(1 << 20),
                                "--verify", "--seed", "3", "--json"])
    assert rc == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    rpc, ring = out["rpc"], out["ring"]
    for r in (rpc, ring):
        assert r["errors"] == 0 and r["wrong_reads"] == 0 and r["reads"] > 0
    assert rpc["ring"]["sqe_reads"] == rpc["ring"]["sqe_writes"] == 0
    assert ring["ring"]["sqe_reads"] == ring["ring"]["sent_reads"] >= ring["reads"]
    assert ring["ring"]["sqe_writes"] == ring["ring"]["sent_writes"] >= 256
    assert ring["ring"]["spills"] == 0 and all(ring["ring"]["aliased"])
