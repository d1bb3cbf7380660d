"""The port's native chunk engine (t3fs_torch/csrc/chunk_engine.cpp behind
t3fs_torch.storage.native_engine), its io_uring read worker
(t3fs_torch/csrc/aio_reader.cpp behind t3fs_torch.storage.aio) and its
asyncio teardown helper, held against the reference.

Twins, on the port's modules, of tests/test_native_engine.py (parity with
the Python engine, crash replay, block reuse, the hardware CRC32C against
the scalar oracle), tests/test_engine_differential.py (seeded random op
sequences, with and without reopen cycles) and tests/test_aio.py
(reap_task).  Then the port against the reference: one seeded op sequence
through both packages' native engines leaves the same ChunkMeta, the same
bytes and the same files on disk; a root either package's native engine
wrote reopens in the other's; the on-disk format is sticky in make_engine.
Last, the io_uring read cases of tests/test_storage_service.py on the
port's fabric and replica.
"""

import asyncio
import logging
import os
import random

import pytest

from t3fs.utils.status import StatusError as RefStatusError
from t3fs_torch.ops.crc32c import crc32c_combine_ref, crc32c_ref
from t3fs_torch.storage.chunk_engine import ChunkEngine
from t3fs_torch.storage.native_engine import (
    NativeChunkEngine, crc32c_combine_native, crc32c_native, make_engine)
from t3fs_torch.storage.types import ChunkId, ChunkMeta, ChunkState
from t3fs_torch.utils.aio import reap_task
from t3fs_torch.utils.status import StatusError


def run(coro):
    return asyncio.run(coro)


# --- tests/test_native_engine.py on the port -------------------------------

def test_crc32c_native_matches_oracle():
    rng = os.urandom
    for ln in (0, 1, 3, 7, 8, 9, 63, 64, 100, 4096, 10000):
        d = rng(ln)
        assert crc32c_native(d) == crc32c_ref(d)
    # streaming continuation
    a, b = rng(123), rng(77)
    assert crc32c_native(b, crc32c_native(a)) == crc32c_ref(a + b)
    # combine
    ca, cb = crc32c_native(a), crc32c_native(b)
    assert crc32c_combine_native(ca, cb, len(b)) == crc32c_ref(a + b)
    assert crc32c_combine_native(ca, cb, len(b)) == \
        crc32c_combine_ref(ca, cb, len(b))


@pytest.fixture(params=["native", "py"])
def engine(request, tmp_path):
    root = str(tmp_path / request.param)
    e = (NativeChunkEngine(root) if request.param == "native"
         else ChunkEngine(root))
    yield e
    e.close()


def test_engine_basic_ops(engine):
    cid = ChunkId(5, 3)
    data = os.urandom(5000)
    meta = ChunkMeta(cid, len(data), 1, 0, 1, crc32c_ref(data),
                     ChunkState.DIRTY)
    engine.put(cid, data, meta, 4096)
    assert engine.read(cid) == data
    assert engine.read(cid, 100, 50) == data[100:150]
    m = engine.get_meta(cid)
    assert (m.length, m.update_ver, m.state) == (5000, 1, ChunkState.DIRTY)

    engine.set_meta(cid, ChunkMeta(cid, len(data), 1, 1, 1, meta.checksum,
                                   ChunkState.COMMIT))
    assert engine.get_meta(cid).state == ChunkState.COMMIT
    assert engine.get_meta(cid).commit_ver == 1

    # COW overwrite
    engine.put(cid, b"x" * 4000,
               ChunkMeta(cid, 4000, 2, 2, 1, 0, ChunkState.COMMIT), 4096)
    assert engine.read(cid) == b"x" * 4000

    assert engine.get_meta(ChunkId(9, 9)) is None
    with pytest.raises(StatusError):
        engine.read(ChunkId(9, 9))


def test_engine_range_and_stats(engine):
    for i in range(10):
        c = ChunkId(7, i)
        engine.put(c, bytes([i]) * 1000,
                   ChunkMeta(c, 1000, 1, 1, 1, 0, ChunkState.COMMIT), 4096)
    assert len(engine.query_range(7)) == 10
    got = engine.query_range(7, 2, 5)
    assert [m.chunk_id.index for m in got] == [2, 3, 4]
    assert len(engine.all_metas()) == 10
    assert engine.stats().chunks == 10
    assert engine.remove(ChunkId(7, 0))
    assert not engine.remove(ChunkId(7, 0))
    assert engine.stats().chunks == 9


def test_native_wal_replay_and_snapshot(tmp_path):
    root = str(tmp_path / "e")
    e = NativeChunkEngine(root)
    cid = ChunkId(1, 1)
    e.put(cid, b"v1" * 100, ChunkMeta(cid, 200, 1, 1, 1, 0,
                                      ChunkState.COMMIT), 4096)
    e.put(cid, b"v2" * 100, ChunkMeta(cid, 200, 2, 2, 1, 0,
                                      ChunkState.DIRTY), 4096)
    del e  # simulate crash: no close() -> no snapshot, WAL only

    e2 = NativeChunkEngine(root)
    assert e2.read(cid) == b"v2" * 100
    assert e2.uncommitted()[0].chunk_id == cid
    e2.close()  # snapshot + wal truncate

    # garbage appended to the WAL (torn tail) must not break replay
    with open(os.path.join(root, "meta.wal"), "ab") as f:
        f.write(b"\xde\xad\xbe\xef torn record")
    e3 = NativeChunkEngine(root)
    assert e3.read(cid) == b"v2" * 100
    e3.close()


def test_native_block_reuse(tmp_path):
    """Freed blocks are reused (group-bitmap allocator)."""
    e = NativeChunkEngine(str(tmp_path / "e"))
    cid = ChunkId(1, 1)
    for ver in range(1, 20):
        e.put(cid, os.urandom(4000),
              ChunkMeta(cid, 4000, ver, ver, 1, 0, ChunkState.COMMIT), 4096)
    # 19 COW rewrites of one chunk must not allocate 19 blocks' worth of space
    assert e.stats().allocated_bytes <= 3 * 4096
    e.close()


# --- tests/test_engine_differential.py on the port -------------------------

CHUNK_SIZE = 4096
INODES = (1, 2)
INDICES = (0, 1, 2)


def _mkmeta(types, cid, data, ver, state, crc=crc32c_ref):
    return types.ChunkMeta(cid, len(data), ver,
                           ver if state == types.ChunkState.COMMIT
                           else max(0, ver - 1), 1, crc(data), state)


def _snapshot(engine):
    """Every externally visible bit: metas (sorted) + full contents."""
    out = []
    for m in engine.all_metas():
        content = engine.read(m.chunk_id)
        out.append((m.chunk_id.encode(), m.length, m.update_ver,
                    m.commit_ver, int(m.state), m.checksum, content))
    return out


def _apply(engine, op, types=None):
    """op holds plain values; `types` (a package's storage.types module)
    builds the package's ChunkId / ChunkMeta."""
    from t3fs_torch.storage import types as port_types

    types = types or port_types
    kind, (inode, index) = op[0], op[1]
    cid = types.ChunkId(inode, index)
    try:
        if kind == "put":
            _, _, data, ver, commit = op
            state = types.ChunkState.COMMIT if commit else types.ChunkState.DIRTY
            engine.put(cid, data, _mkmeta(types, cid, data, ver, state),
                       CHUNK_SIZE)
        elif kind == "commit":
            m = engine.get_meta(cid)
            if m is not None:
                engine.set_meta(cid, types.ChunkMeta(
                    cid, m.length, m.update_ver, m.update_ver, m.chain_ver,
                    m.checksum, types.ChunkState.COMMIT))
        elif kind == "remove":
            engine.remove(cid)
        elif kind == "read":
            _, _, off, ln = op
            return ("ok", engine.read(cid, off, ln))
    except (StatusError, RefStatusError) as e:
        return ("err", int(e.code))
    return ("ok", None)


def _gen_ops(rng: random.Random, n: int):
    ops = []
    ver = {}
    for _ in range(n):
        key = (rng.choice(INODES), rng.choice(INDICES))
        k = rng.random()
        if k < 0.45:
            ver[key] = ver.get(key, 0) + 1
            size = rng.choice([0, 1, 17, 512, CHUNK_SIZE - 1, CHUNK_SIZE])
            data = bytes(rng.getrandbits(8) for _ in range(size))
            ops.append(("put", key, data, ver[key], rng.choice([False, True])))
        elif k < 0.6:
            ops.append(("commit", key))
        elif k < 0.72:
            ops.append(("remove", key))
        else:
            off = rng.randrange(0, CHUNK_SIZE)
            ln = rng.randrange(-1, CHUNK_SIZE)
            ops.append(("read", key, off, ln))
    return ops


@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_engines_agree_on_random_op_sequences(tmp_path, seed):
    rng = random.Random(seed)
    nat = NativeChunkEngine(str(tmp_path / "nat"))
    py = ChunkEngine(str(tmp_path / "py"))
    try:
        for op in _gen_ops(rng, 120):
            ra = _apply(nat, op)
            rb = _apply(py, op)
            assert ra == rb, (op, ra, rb)
            assert _snapshot(nat) == _snapshot(py), op
        assert sorted(m.chunk_id.encode() for m in nat.uncommitted()) == \
            sorted(m.chunk_id.encode() for m in py.uncommitted())
    finally:
        nat.close()
        py.close()


@pytest.mark.parametrize("seed", [11, 12])
def test_engines_agree_across_reopen_cycles(tmp_path, seed):
    """Same sequences with periodic close+reopen (native replays its WAL,
    python reloads sqlite): durable state must stay identical."""
    rng = random.Random(seed)
    roots = {"nat": str(tmp_path / "nat"), "py": str(tmp_path / "py")}
    nat = NativeChunkEngine(roots["nat"])
    py = ChunkEngine(roots["py"])
    try:
        for round_ in range(4):
            for op in _gen_ops(rng, 40):
                assert _apply(nat, op) == _apply(py, op), op
            assert _snapshot(nat) == _snapshot(py)
            nat.close()
            py.close()
            nat = NativeChunkEngine(roots["nat"])
            py = ChunkEngine(roots["py"])
            assert _snapshot(nat) == _snapshot(py), f"after reopen {round_}"
    finally:
        nat.close()
        py.close()


# --- tests/test_aio.py on the port (reap_task) ------------------------------

def test_reap_task_silent_on_tasks_own_cancellation():
    async def body():
        async def forever():
            await asyncio.Event().wait()

        t = asyncio.create_task(forever())
        await asyncio.sleep(0)
        t.cancel()
        await reap_task(t)          # must not raise
        assert t.cancelled()
    run(body())


def test_reap_task_logs_crashed_task(caplog):
    async def body():
        async def boom():
            raise RuntimeError("worker died")

        t = asyncio.create_task(boom())
        await asyncio.sleep(0)
        log = logging.getLogger("test.reap")
        with caplog.at_level(logging.ERROR, logger="test.reap"):
            await reap_task(t, log, "boom worker")   # must not raise
        assert any("boom worker" in r.getMessage()
                   for r in caplog.records)
    run(body())


def test_reap_task_propagates_awaiter_cancellation():
    async def body():
        started = asyncio.Event()

        async def slow():
            started.set()
            await asyncio.Event().wait()

        t = asyncio.create_task(slow())

        async def reaper():
            await started.wait()
            await reap_task(t)

        r = asyncio.create_task(reaper())
        await started.wait()
        await asyncio.sleep(0)
        r.cancel()
        try:
            await r
        except asyncio.CancelledError:
            pass
        else:
            raise AssertionError(
                "awaiter cancellation was swallowed by reap_task")
        assert r.cancelled()
        t.cancel()
        await reap_task(t)
    run(body())


def test_reap_task_accepts_none():
    run(reap_task(None))


# --- the port's native engine against the reference's ----------------------

def _files(root: str) -> dict[str, bytes]:
    out = {}
    for name in sorted(os.listdir(root)):
        with open(os.path.join(root, name), "rb") as f:
            out[name] = f.read()
    return out


@pytest.mark.parametrize("seed", [5, 6])
def test_port_native_engine_equals_reference(tmp_path, seed):
    """One seeded op sequence through the reference's native engine and the
    port's: every result, every ChunkMeta and byte after every op, the
    files on disk after a reopen (WAL replay) and after close (snapshot)."""
    from t3fs.storage import types as ref_types
    from t3fs.storage.native_engine import NativeChunkEngine as RefEngine

    rng = random.Random(seed)
    ops = _gen_ops(rng, 150)
    roots = {"ref": str(tmp_path / "ref"), "port": str(tmp_path / "port")}
    ref, port = RefEngine(roots["ref"]), NativeChunkEngine(roots["port"])
    try:
        for i, op in enumerate(ops):
            assert _apply(ref, op, ref_types) == _apply(port, op), op
            assert _snapshot(ref) == _snapshot(port), op
            if i == len(ops) // 2:
                # the WAL alone (no close, no snapshot), then a replay
                assert _files(roots["ref"]) == _files(roots["port"])
                ref.close()
                port.close()
                ref, port = RefEngine(roots["ref"]), NativeChunkEngine(roots["port"])
                assert _snapshot(ref) == _snapshot(port)
        rs, ps = ref.stats(), port.stats()
        assert (rs.chunks, rs.used_bytes, rs.allocated_bytes) == \
            (ps.chunks, ps.used_bytes, ps.allocated_bytes)
    finally:
        ref.close()
        port.close()
    assert _files(roots["ref"]) == _files(roots["port"])


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_native_root_reopens_across_packages(tmp_path, writer):
    """A root one package's native engine wrote (snapshot and WAL tail both
    present) reopens in the other package's, with the same metas and
    bytes; make_engine picks the native engine for it, whatever is asked."""
    from t3fs.storage import types as ref_types
    from t3fs.storage.native_engine import NativeChunkEngine as RefEngine
    from t3fs.storage.native_engine import make_engine as ref_make_engine

    root = str(tmp_path / "root")
    first, types = ((RefEngine, ref_types) if writer == "reference"
                    else (NativeChunkEngine, None))
    e = first(root)
    ops = _gen_ops(random.Random(21), 60)
    for op in ops[:40]:
        _apply(e, op, types)
    e.close()                       # snapshot
    e = first(root)
    for op in ops[40:]:
        _apply(e, op, types)        # a WAL tail after the snapshot
    want = _snapshot(e)
    del e                           # crash: no close
    other = (make_engine if writer == "reference" else ref_make_engine)
    e2 = other(root, backend="py")  # the on-disk format wins
    try:
        assert type(e2).__name__ == "NativeChunkEngine"
        assert _snapshot(e2) == want
    finally:
        e2.close()


def test_make_engine_on_disk_format_is_sticky(tmp_path):
    """meta.db means the SQLite engine, meta.wal / meta.snap the native
    one, whatever the caller asks; a fresh root takes the request."""
    fresh = make_engine(str(tmp_path / "fresh"))
    assert isinstance(fresh, NativeChunkEngine)
    fresh.close()
    py = make_engine(str(tmp_path / "py"), backend="py")
    assert isinstance(py, ChunkEngine)
    py.close()
    again = make_engine(str(tmp_path / "py"), backend="native")
    assert isinstance(again, ChunkEngine)
    again.close()
    nat = make_engine(str(tmp_path / "fresh"), backend="py")
    assert isinstance(nat, NativeChunkEngine)
    nat.close()


# --- io_uring reads (tests/test_storage_service.py's aio cases) -------------

def test_aio_worker_reads_a_file(tmp_path):
    """The fabric's default read path: preads through the port's io_uring
    worker, concurrently, land the file's bytes."""
    from t3fs_torch.storage.aio import AioReadWorker

    if not AioReadWorker.available():
        pytest.skip("io_uring_setup refused on this kernel")

    async def body():
        aio = AioReadWorker(depth=8)
        aio.start()
        try:
            path = str(tmp_path / "f")
            data = os.urandom(10_000)
            with open(path, "wb") as f:
                f.write(data)
            fd = os.open(path, os.O_RDONLY)
            try:
                got = await asyncio.gather(aio.submit_read(fd, 0, 10_000),
                                           aio.submit_read(fd, 4096, 100))
            finally:
                os.close(fd)
            assert got == [data, data[4096:4196]]
            assert aio.completed == 2
        finally:
            await aio.close()
    run(body())


@pytest.mark.parametrize("engine_backend", ["native", "py"])
def test_large_read_exercises_aio_pipeline(engine_backend):
    """>64 KiB reads route through io_uring on the fabric's defaults;
    bytes and versions as written."""
    from t3fs_torch.testing.fabric import StorageFabric

    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1, checksum_backend="cpu",
                               engine_backend=engine_backend)
        assert fabric.aio_read
        await fabric.start()
        try:
            if fabric.nodes[0].aio is None:
                pytest.skip("io_uring_setup refused on this kernel")
            cid = ChunkId(77, 0)
            data = bytes(range(256)) * 1024            # 256 KiB
            result = await _write(fabric, cid, data)
            assert result.status.code == 0
            r, payload = await _read(fabric, cid)
            assert payload == data
            r, tailp = await _read(fabric, cid, offset=100_000, length=70_000)
            assert tailp == data[100_000:170_000]
            target = fabric.nodes[0].targets[fabric.target_id(0)]
            want = NativeChunkEngine if engine_backend == "native" else ChunkEngine
            assert isinstance(target.engine, want)
            assert fabric.nodes[0].aio.completed >= 2
        finally:
            await fabric.stop()
        assert fabric.nodes[0].aio is None
    run(body())


async def _write(fabric, cid, data, seq=1):
    from t3fs_torch.storage.types import UpdateIO, UpdateType, WriteReq

    req = WriteReq(io=UpdateIO(
        chunk_id=cid, chain_id=fabric.chain_id,
        chain_ver=fabric.chain().chain_ver, update_type=UpdateType.WRITE,
        offset=0, length=len(data), chunk_size=1 << 20,
        checksum=crc32c_ref(data), channel=7, channel_seq=seq,
        client_id="test-client", inline=True))
    rsp, _ = await fabric.client.call(fabric.head_address(), "Storage.write",
                                      req, payload=data)
    return rsp.result


async def _read(fabric, cid, offset=0, length=0):
    from t3fs_torch.storage.types import BatchReadReq, ReadIO

    req = BatchReadReq(ios=[ReadIO(chunk_id=cid, chain_id=fabric.chain_id,
                                   offset=offset, length=length)])
    rsp, payload = await fabric.client.call(fabric.head_address(),
                                            "Storage.batch_read", req)
    return rsp.results[0], payload


def test_aio_read_consistent_under_update_storm():
    """The locate->pread->meta-recheck seqlock: readers racing COW updates
    must always return a (version, checksum, bytes) triple that matches."""
    from t3fs_torch.testing.fabric import StorageFabric

    async def body():
        fabric = StorageFabric(num_nodes=1, replicas=1, checksum_backend="cpu")
        await fabric.start()
        try:
            cid = ChunkId(88, 0)
            versions = [bytes([v]) * (128 << 10) for v in range(1, 9)]
            await _write(fabric, cid, versions[0])

            async def writer():
                for seq, data in enumerate(versions[1:], start=2):
                    r = await _write(fabric, cid, data, seq=seq)
                    assert r.status.code == 0, r.status
                    await asyncio.sleep(0)

            async def reader():
                mismatches = []
                for _ in range(30):
                    r, payload = await _read(fabric, cid)
                    if r.status.code == 0 and payload:
                        if crc32c_ref(payload) != r.checksum:
                            mismatches.append(r)
                    await asyncio.sleep(0)
                return mismatches

            results = await asyncio.gather(writer(), reader(), reader())
            assert results[1] == [] and results[2] == [], results[1:]
            r, payload = await _read(fabric, cid)
            assert payload == versions[-1]
        finally:
            await fabric.stop()
    run(body())


@pytest.mark.parametrize("engine_cls", [NativeChunkEngine, ChunkEngine])
def test_aio_read_aba_remove_recreate_detected(tmp_path, engine_cls):
    """ABA guard: remove + recreate with IDENTICAL meta while an aio read
    is paused mid-flight must NOT validate (the allocation generation
    differs), forcing a retry that returns the new incarnation's bytes."""
    from t3fs_torch.ops.codec import crc32c
    from t3fs_torch.storage.aio import AioReadWorker
    from t3fs_torch.storage.chunk_replica import ChunkReplica
    from t3fs_torch.storage.types import ReadIO

    if not AioReadWorker.available():
        pytest.skip("io_uring_setup refused on this kernel")

    async def body():
        engine = engine_cls(str(tmp_path / "e"))
        replica = ChunkReplica(engine)
        aio = AioReadWorker(depth=32)
        aio.start()
        real_submit = aio.submit_read
        try:
            cid = ChunkId(99, 0)
            data = b"\xab" * (96 << 10)
            meta = ChunkMeta(chunk_id=cid, length=len(data), update_ver=3,
                             commit_ver=3, chain_ver=1, checksum=crc32c(data))
            engine.put(cid, data, meta, chunk_size=len(data))
            calls = {"n": 0}

            async def paused_submit(fd, off, ln):
                calls["n"] += 1
                if calls["n"] == 1:
                    # remove + recreate SAME bytes/meta mid-read
                    engine.remove(cid)
                    engine.put(cid, data, meta, chunk_size=len(data))
                return await real_submit(fd, off, ln)

            aio.submit_read = paused_submit
            result, payload = await replica.read_aio(
                ReadIO(chunk_id=cid, chain_id=1), aio)
            assert calls["n"] >= 2, calls
            assert payload == data and result.checksum == crc32c(data)
        finally:
            aio.submit_read = real_submit
            await aio.close()
            engine.close()
    run(body())
