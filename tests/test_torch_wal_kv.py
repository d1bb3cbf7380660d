"""The port's durable KV (t3fs_torch.kv.wal_engine) against the JAX
package's (t3fs.kv.wal_engine): one seeded transaction sequence through
each package's WalKVEngine (sets, clears, range clears, a window of
pipelined commits met by one group fsync, a compaction at its threshold, a
reopen and the WAL rate cap) gives byte-equal WAL and snapshot files, each
package opens the other's directory and reads the same keys and versions,
and open_kv_engine takes the same specs, the replicated ("remote:") and
range-sharded ("shards:") deployments included, opened against live
KvService groups.  The rate cap's clock is pinned in both packages to the
same fake monotonic clock with monkeypatch; nothing in either package
changes for it."""

import asyncio
import os

import numpy as np
import pytest

from t3fs.kv import engine as ref_engine
from t3fs.kv import wal_engine as ref_wal
from t3fs_torch.kv import engine as port_engine
from t3fs_torch.kv import wal_engine as port_wal

PKGS = {"ref": ref_wal, "port": port_wal}
ENGINES = {"ref": ref_engine, "port": port_engine}
SEED = 2026


class _FakeTime:
    """time stand-in for the rate cap: monotonic() advances 1 ms a call and
    sleep() advances by what it is asked, so every wait is the same in both
    packages and no test sleeps."""

    def __init__(self):
        self.now = 1000.0
        self.slept = []

    def monotonic(self) -> float:
        self.now += 0.001
        return self.now

    def sleep(self, s: float) -> None:
        self.slept.append(round(s, 9))
        self.now += s

    def time(self) -> float:
        return self.now


def _ops(rng: np.random.Generator, n: int) -> list[list[tuple]]:
    """n transactions of 1-4 ops over a small key space."""
    txns = []
    for _ in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 5))):
            k = b"k%03d" % int(rng.integers(0, 64))
            r = rng.random()
            if r < 0.7:
                ops.append(("set", k, rng.bytes(int(rng.integers(0, 300)))))
            elif r < 0.9:
                ops.append(("clear", k))
            else:
                hi = b"k%03d" % min(63, int(k[1:]) + int(rng.integers(1, 6)))
                ops.append(("clear_range", k, hi))
        txns.append(ops)
    return txns


def _apply(txn, ops) -> None:
    for op in ops:
        getattr(txn, op[0])(*op[1:])


async def _dump(kv) -> tuple[int, list]:
    txn = kv.transaction()
    rows = await txn.get_range(b"", b"\xff")
    return kv.current_version(), [(bytes(k), bytes(v)) for k, v in rows]


def _files(root: str) -> dict[str, bytes]:
    return {name: open(os.path.join(root, name), "rb").read()
            for name in sorted(os.listdir(root))}


def run_sequence(pkg: str, root: str) -> dict:
    """The seeded sequence through one package; the files after each stage
    and what a reopen reads."""
    wal = PKGS[pkg]
    rng = np.random.default_rng(SEED)
    out: dict = {}

    async def body():
        kv = wal.WalKVEngine(root, sync="always",
                             compact_threshold_bytes=6 << 10)
        # 1) sequential commits, enough to cross the compaction threshold
        for ops in _ops(rng, 40):
            txn = kv.transaction()
            _apply(txn, ops)
            await kv.commit_async(txn)
        out["after_seq"] = (_files(root), await _dump(kv))
        # 2) pipelined commits: phase A in submit order, then every
        # barrier at once -- one leader's fsync covers the window
        barriers = []
        fsyncs = kv.fsyncs
        for ops in _ops(rng, 12):
            txn = kv.transaction()
            _apply(txn, ops)
            barriers.append(await kv.commit_submit(txn))
        await asyncio.gather(*barriers)
        out["group_fsyncs_le_window"] = kv.fsyncs - fsyncs <= 12
        out["after_group"] = (_files(root), await _dump(kv))
        kv.compact()
        out["after_compact"] = (_files(root), await _dump(kv))
        for ops in _ops(rng, 8):
            txn = kv.transaction()
            _apply(txn, ops)
            await kv.commit_async(txn)
        kv.close()
        # 3) reopen with the rate cap on: every append draws on the bucket
        kv = wal.WalKVEngine(root, sync="os", rate_mbps=0.002)
        out["reopened"] = await _dump(kv)
        for ops in _ops(rng, 10):
            txn = kv.transaction()
            _apply(txn, ops)
            await kv.commit_async(txn)
        out["rate"] = (kv.rate_waits, round(kv.rate_waited_s, 9))
        kv.close()
        out["final"] = _files(root)

    asyncio.run(body())
    return out


def test_wal_files_byte_equal_to_reference(tmp_path, monkeypatch):
    got = {}
    for pkg in PKGS:
        clock = _FakeTime()
        monkeypatch.setattr(PKGS[pkg], "time", clock)
        got[pkg] = run_sequence(pkg, str(tmp_path / pkg))
        got[pkg]["slept"] = clock.slept
    ref, port = got["ref"], got["port"]
    assert set(ref["final"]) == {"kv.snap", "kv.wal"}
    assert ref["group_fsyncs_le_window"] and port["group_fsyncs_le_window"]
    # the sequence really compacted, and the rate cap really waited
    assert len(ref["after_seq"][0]["kv.wal"]) < 6 << 10
    assert ref["rate"][0] > 0 and ref["slept"]
    for stage in ("after_seq", "after_group", "after_compact", "reopened",
                  "rate", "final", "slept"):
        assert port[stage] == ref[stage], stage


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref")])
def test_each_package_opens_the_others_directory(tmp_path, writer, reader):
    root = str(tmp_path / "kv")
    run_sequence(writer, root)
    before = _files(root)

    async def read(pkg):
        kv = PKGS[pkg].WalKVEngine(root, sync="os")
        try:
            return await _dump(kv)
        finally:
            kv.close()

    want = asyncio.run(read(writer))
    got = asyncio.run(read(reader))
    assert got == want and want[1]
    # reading leaves the files as the writer left them
    assert _files(root) == before


def test_torn_tail_discarded_alike(tmp_path):
    """A frame cut mid-write is dropped by both packages, at the same
    offset."""
    src = tmp_path / "src"
    run_sequence("ref", str(src))
    wal_bytes = (src / "kv.wal").read_bytes()
    out = {}
    for pkg in PKGS:
        root = tmp_path / pkg
        root.mkdir()
        (root / "kv.snap").write_bytes((src / "kv.snap").read_bytes())
        (root / "kv.wal").write_bytes(wal_bytes[:-7])

        async def read():
            kv = PKGS[pkg].WalKVEngine(str(root), sync="os")
            try:
                return await _dump(kv)
            finally:
                kv.close()
        out[pkg] = (asyncio.run(read()), _files(str(root)))
    assert out["port"] == out["ref"]
    assert len(out["ref"][1]["kv.wal"]) < len(wal_bytes) - 7


def test_open_kv_engine_specs(tmp_path):
    for pkg, wal in PKGS.items():
        assert isinstance(wal.open_kv_engine("mem"),
                          ENGINES[pkg].MemKVEngine)
        kv = wal.open_kv_engine(f"wal:{tmp_path / pkg}?sync=os&rate_mbps=5")
        assert isinstance(kv, wal.WalKVEngine)
        assert (kv.sync, kv.rate_mbps) == ("os", 5.0)
        kv.close()
        kv = wal.open_kv_engine(f"wal:{tmp_path / pkg}-always")
        assert kv.sync == "always" and kv.rate_mbps == 0.0
        kv.close()
        with pytest.raises(ValueError):
            wal.open_kv_engine("fdb:nope")
    from t3fs_torch.kv.remote import RemoteKVEngine
    from t3fs_torch.kv.service import KvService
    from t3fs_torch.kv.shard import ShardedKVEngine
    from t3fs_torch.net.server import Server

    async def live():
        groups = []
        for _ in range(2):
            svc = KvService(port_engine.MemKVEngine())
            srv = Server()
            srv.add_service(svc)
            await srv.start()
            groups.append((svc, srv))
        a0, a1 = (srv.address for _, srv in groups)
        specs = (f"remote:{a0}", f"shards:{a0};494e4f44;{a1}")
        try:
            remote, sharded = (port_wal.open_kv_engine(s) for s in specs)
            assert isinstance(remote, RemoteKVEngine)
            assert remote.addresses == [a0]
            assert isinstance(sharded, ShardedKVEngine)
            layout = [(r.begin, r.end, r.addresses)
                      for r in sharded.map.ranges]
            ref = ref_wal.open_kv_engine(specs[1])
            assert layout == [(r.begin, r.end, r.addresses)
                              for r in ref.map.ranges]
            assert layout[0][1] == b"INOD" and sharded.map_home == [a0]

            async def put(txn):
                txn.set(b"DENT/a", b"1")
                txn.set(b"INOD/a", b"2")        # one key a shard: 2PC
            await port_engine.with_transaction(sharded, put)
            got = []
            for kv in (remote, sharded):
                async def get(txn):
                    return [await txn.get(b"DENT/a"),
                            await txn.get(b"INOD/a")]
                got.append(await port_engine.with_transaction(kv, get))
                await kv.close()
            assert got == [[b"1", None], [b"1", b"2"]]
            assert [svc.seq > 0 for svc, _ in groups] == [True, True]
        finally:
            for _, srv in groups:
                await srv.stop()
    asyncio.run(live())
