"""The port's trash (t3fs_torch.utils.trash) against the reference's
(t3fs.utils.trash) on the CPU: every case of tests/test_trash.py on the
port's modules and LocalCluster, then one put / list / clean sequence on a
pinned clock through each package's trash over its own cluster, with equal
slot names, listings and cleaner results.  Each cluster runs its nodes'
CRCs on the host with a heartbeat timeout test load cannot reach."""

import asyncio
from datetime import datetime, timedelta, timezone

import pytest

import t3fs.fuse.vfs
import t3fs.testing.cluster
import t3fs.utils.trash
import t3fs_torch.fuse.vfs
import t3fs_torch.testing.cluster
import t3fs_torch.utils.trash
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusError
from t3fs_torch.utils.trash import (
    TRASH_CONFIGS, Trash, TrashCleaner, format_date, parse_date,
    parse_trash_dir,
)

# the pinned wall clock of the cross-package sequence
T0 = datetime(2026, 7, 29, 12, 34, 56, tzinfo=timezone.utc)


def _cluster(pkg, **kw):
    if pkg is t3fs_torch:
        kw["checksum_backend"] = "cpu"
    return pkg.testing.cluster.LocalCluster(
        num_nodes=3, replicas=2, with_meta=True, heartbeat_timeout_s=60.0,
        **kw)


def test_trash_dir_naming_roundtrip():
    cfg = TRASH_CONFIGS["1h"]
    now = datetime(2026, 7, 29, 12, 34, tzinfo=timezone.utc)
    name = cfg.current_dir(now)
    parsed = parse_trash_dir(name)
    assert parsed is not None
    cfg_name, start, end = parsed
    assert cfg_name == "1h"
    assert start <= now
    assert end - start == cfg.expire + cfg.time_slice
    # same slice -> same dir (items batch into slices)
    assert cfg.current_dir(now + timedelta(minutes=1)) == name
    assert parse_trash_dir("not-a-trash-dir-at-all") is None
    assert parse_trash_dir("junk") is None


@pytest.mark.parametrize("minute", [0, 9, 10, 59, 60 * 24 + 7, 60 * 24 * 9])
def test_trash_names_equal_across_packages(minute):
    """Every preset's slot at one instant, and the date helpers, give the
    reference's strings and values."""
    now = T0 + timedelta(minutes=minute)
    ref = t3fs.utils.trash
    assert sorted(TRASH_CONFIGS) == sorted(ref.TRASH_CONFIGS)
    for ttl, cfg in TRASH_CONFIGS.items():
        rcfg = ref.TRASH_CONFIGS[ttl]
        assert (cfg.name, cfg.expire, cfg.time_slice) == (
            rcfg.name, rcfg.expire, rcfg.time_slice)
        name = cfg.current_dir(now)
        assert name == rcfg.current_dir(now)
        assert parse_trash_dir(name) == ref.parse_trash_dir(name)
    assert format_date(now) == ref.format_date(now)
    assert parse_date(format_date(now)) == ref.parse_date(format_date(now))
    for junk in ("junk", "a-b", "1h-20260101_0000-nodate", "x-y-z-w"):
        assert parse_trash_dir(junk) is ref.parse_trash_dir(junk) is None


def test_trash_put_list_clean_cycle():
    async def body():
        cl = LocalCluster(num_nodes=3, replicas=2, with_meta=True,
                          checksum_backend="cpu", heartbeat_timeout_s=60.0)
        await cl.start()
        try:
            fs = FileSystem(cl.mc, cl.sc)
            trash = Trash(fs)
            cleaner = TrashCleaner(fs)
            await fs.mkdirs("/data")
            await fs.write_file("/data/doc", b"keep me for a while")
            await fs.write_file("/data/doc2", b"me too")

            dest = await trash.put("/data/doc", "1h")
            assert dest.startswith("/trash/1h-")
            # name collision gets a suffix
            await fs.write_file("/data/doc", b"second body")
            dest2 = await trash.put("/data/doc", "1h")
            assert dest2 == dest + ".1"

            with pytest.raises(StatusError):
                await fs.stat("/data/doc")
            assert await fs.read_file(dest) == b"keep me for a while"

            slots = await trash.list()
            assert len(slots) == 1 and len(slots[0][2]) == 2

            # not expired yet
            assert await cleaner.clean_once() == []
            # jump past expiry
            future = datetime.now(timezone.utc) + timedelta(hours=2, minutes=11)
            removed = await cleaner.clean_once(now=future)
            assert len(removed) == 1
            assert await trash.list() == []
            with pytest.raises(StatusError):
                await fs.stat(dest)

            with pytest.raises(ValueError):
                await trash.put("/data/doc2", "99years")
        finally:
            await cl.stop()
    asyncio.run(body())


def test_migration_service_unwired_rejects():
    """A migration service with no cluster wiring reports implemented=True
    but refuses job submission (it needs mgmtd + a client)."""
    from t3fs_torch.migration.service import (
        MigrationService, SubmitMigrationReq)
    from t3fs_torch.net.client import Client
    from t3fs_torch.net.server import Server

    async def body():
        srv = Server()
        srv.add_service(MigrationService())
        await srv.start()
        cli = Client()
        try:
            rsp, _ = await cli.call(srv.address, "Migration.status", None)
            assert rsp.implemented is True and rsp.jobs == []
            with pytest.raises(StatusError):
                await cli.call(srv.address, "Migration.submit",
                               SubmitMigrationReq(1, 2))
        finally:
            await cli.close()
            await srv.stop()
    asyncio.run(body())


def _pin_clock(monkeypatch, mod, clock):
    """mod.datetime.now() reads `clock[0]`; the rest of datetime is as it
    is."""
    class Pinned(datetime):
        @classmethod
        def now(cls, tz=None):
            return clock[0].astimezone(tz) if tz else clock[0]

    monkeypatch.setattr(mod, "datetime", Pinned)


async def _sequence(pkg) -> list:
    """put / collide / list / clean at fixed instants; everything it sees."""
    trash_mod = pkg.utils.trash
    cl = _cluster(pkg)
    await cl.start()
    seen: list = []
    try:
        fs = pkg.fuse.vfs.FileSystem(cl.mc, cl.sc)
        trash, cleaner = trash_mod.Trash(fs), trash_mod.TrashCleaner(fs)
        seen.append(("empty-list", await trash.list()))
        seen.append(("empty-clean", await cleaner.clean_once()))
        await fs.mkdirs("/data/sub")
        for name in ("a", "b", "c", "sub/d"):
            await fs.write_file(f"/data/{name}", name.encode() * 100)
        for path, ttl in (("/data/a", "1h"), ("/data/b", "1h"),
                          ("/data/c", "3d"), ("/data/sub/", "7d")):
            seen.append(("put", path, await trash.put(path, ttl)))
        await fs.write_file("/data/a", b"again")
        seen.append(("put", "/data/a", await trash.put("/data/a", "1h")))
        try:
            await trash.put("/data/b", "2h")
        except ValueError as e:
            seen.append(("bad-ttl", str(e)))
        listing = await trash.list()
        seen.append(("list", sorted((s, e, sorted(n)) for s, e, n in listing)))
        # the 1h slot of 12:30 ends at 13:40, 5m04s after T0 + 1h
        for delta in (timedelta(0), timedelta(hours=1, minutes=5),
                      timedelta(hours=1, minutes=6), timedelta(hours=9),
                      timedelta(days=4), timedelta(days=8, hours=1)):
            seen.append(("clean", delta,
                         sorted(await cleaner.clean_once(now=T0 + delta))))
        seen.append(("after", await trash.list()))
    finally:
        await cl.stop()
    return seen


def test_trash_sequence_equal_across_packages(monkeypatch):
    """One put / list / clean sequence on a pinned clock through each
    package's trash over its own LocalCluster: the same slot names, the
    same listings, the same cleaner results."""
    clock = [T0]
    _pin_clock(monkeypatch, t3fs.utils.trash, clock)
    _pin_clock(monkeypatch, t3fs_torch.utils.trash, clock)
    ref = asyncio.run(_sequence(t3fs))
    port = asyncio.run(_sequence(t3fs_torch))
    assert port == ref
    puts = [s for s in port if s[0] == "put"]
    assert puts[0][2] == "/trash/1h-20260729_1230-20260729_1340/a"
    assert puts[-1][2] == "/trash/1h-20260729_1230-20260729_1340/a.1"
    cleans = [s[2] for s in port if s[0] == "clean"]
    assert cleans[0] == [] and cleans[1] == []
    assert cleans[2] == ["1h-20260729_1230-20260729_1340"]
    assert port[-1] == ("after", [])
