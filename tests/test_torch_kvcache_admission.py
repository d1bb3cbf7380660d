"""The port's cross-process admission plane (t3fs_torch/kvcache/admission.py
over t3fs_torch/usrbio/slots.py): every case of
tests/test_kvcache_admission.py run on the port.

The bound that matters: N client processes on one host must never hold
more namespace tokens than ONE process's configured window, and a process
that dies holding tokens must give them back without operator action."""

import asyncio
import functools
import multiprocessing as mp
import os
import uuid

import pytest

from t3fs_torch.kvcache.admission import (
    AdmissionConfig, AdmissionController, AdmissionPlane, _pool_sizes,
    resolve_plane,
)
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.usrbio.slots import ShmTokenArena


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _port_fabric_on_the_cpu(monkeypatch):
    """Every port StorageFabric of this file checksums on the CUDA backend
    run on its plain versions (device="cpu"): the card's code path without
    the card."""
    monkeypatch.setattr(StorageFabric, "default_checksum_backend",
                        functools.partial(CudaChecksumBackend, device="cpu"))


def _name() -> str:
    return f"t3fs-test-{uuid.uuid4().hex[:12]}"


@pytest.fixture
def arena_name():
    name = _name()
    yield name
    # best-effort cleanup: the segment outlives test processes by design
    try:
        ShmTokenArena(name, [1]).unlink()
    except Exception:
        pass


# ---------------- arena basics ----------------

def test_arena_acquire_release_and_geometry(arena_name):
    a = ShmTokenArena(arena_name, [3, 2])
    try:
        slots = [a.try_acquire(0) for _ in range(3)]
        assert None not in slots and len(set(slots)) == 3
        assert a.try_acquire(0) is None          # exhausted
        assert a.used(0) == 3 and a.peak(0) == 3
        assert a.try_acquire(1) is not None      # pools independent
        for s in slots:
            a.release(0, s)
        assert a.used(0) == 0 and a.peak(0) == 3  # peak is sticky
        # double release / foreign slot raises instead of corrupting
        with pytest.raises(ValueError):
            a.release(0, slots[0])
        # a second handle attaches to the same segment and sees state
        b = ShmTokenArena(arena_name)
        assert b.pool_sizes == [3, 2]
        assert b.used(1) == 1
        # geometry mismatch is an error, not silent reuse
        with pytest.raises(ValueError):
            ShmTokenArena(arena_name, [8])
        b.close()
    finally:
        a.close()


def test_arena_release_all(arena_name):
    a = ShmTokenArena(arena_name, [4])
    try:
        for _ in range(3):
            a.try_acquire(0)
        assert a.release_all() == 3
        assert a.used(0) == 0
    finally:
        a.close()


# ---------------- cross-process ----------------

def _greedy_child(name: str, hold_q, release_evt) -> None:
    """Acquire everything we can from pool 0, report, hold until told."""
    a = ShmTokenArena(name)
    got = []
    while (s := a.try_acquire(0)) is not None:
        got.append(s)
    hold_q.put(len(got))
    release_evt.wait(timeout=30)
    for s in got:
        a.release(0, s)
    a.close()


def _crash_child(name: str, q) -> None:
    """Acquire two tokens and die without releasing them."""
    a = ShmTokenArena(name)
    s1, s2 = a.try_acquire(0), a.try_acquire(0)
    q.put((os.getpid(), s1, s2))
    q.close()
    q.join_thread()                 # flush the feeder before dying
    os._exit(0)                     # no atexit, no release — a crash


def test_arena_holds_host_wide_bound_across_processes(arena_name):
    """4 greedy processes + the parent can never over-draw the pool:
    the sum of everyone's acquisitions is exactly the pool size."""
    cap = 8
    a = ShmTokenArena(arena_name, [cap])
    try:
        mine = a.try_acquire(0)
        assert mine is not None
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        evt = ctx.Event()
        procs = [ctx.Process(target=_greedy_child,
                             args=(arena_name, q, evt))
                 for _ in range(4)]
        for p in procs:
            p.start()
        counts = [q.get(timeout=30) for _ in procs]
        assert sum(counts) == cap - 1           # parent holds 1
        assert a.used(0) == cap
        assert a.peak(0) == cap                 # never above the cap
        evt.set()
        for p in procs:
            p.join(timeout=30)
            assert p.exitcode == 0
        a.release(0, mine)
        assert a.used(0) == 0
    finally:
        a.close()


def test_arena_reclaims_dead_process_tokens(arena_name):
    a = ShmTokenArena(arena_name, [4])
    try:
        ctx = mp.get_context("spawn")
        q = ctx.Queue()
        p = ctx.Process(target=_crash_child, args=(arena_name, q))
        p.start()
        pid, s1, s2 = q.get(timeout=30)
        p.join(timeout=30)
        assert a.used(0) == 2                   # the corpse's tokens
        assert a.reclaim_dead() == 2
        assert a.used(0) == 0
        # and try_acquire self-heals on exhaustion without an explicit
        # reclaim call: fill the pool with a second corpse, then draw
        p2 = ctx.Process(target=_crash_child, args=(arena_name, q))
        p2.start()
        q.get(timeout=30)
        p2.join(timeout=30)
        got = [a.try_acquire(0) for _ in range(4)]
        assert None not in got                  # dead tokens reclaimed
        for s in got:
            a.release(0, s)
    finally:
        a.close()


# ---------------- plane + controller ----------------

def test_pool_layout_shard_major_weighted():
    cfg = AdmissionConfig(window=100, class_windows=(10, 20), shards=2,
                          shard_weights=(1.0, 0.5))
    assert _pool_sizes(cfg) == [100, 10, 20, 50, 5, 10]


def test_plane_shards_isolate_hot_tenant():
    """Saturating one shard's window must not make a namespace on
    another shard wait."""
    async def body():
        cfg = AdmissionConfig(window=1, class_windows=(1, 1, 1), shards=2)
        plane = AdmissionPlane(cfg)
        # find two namespaces on different shards
        ns_a = "tenant-a"
        ns_b = next(f"tenant-{i}" for i in range(100)
                    if plane.shard_of(f"tenant-{i}")
                    != plane.shard_of(ns_a))
        hot = plane.controller(ns_a)
        cold = plane.controller(ns_b)
        assert hot.shard != cold.shard
        adm = hot.admit(10)
        await adm.__aenter__()                  # hot shard saturated
        try:
            # same shard: a second tier of the hot tenant would wait
            assert plane.backend.would_wait(hot._ns_pool)
            # other shard: admits immediately
            async with cold.admit(10):
                pass
            assert cold.waits == 0
        finally:
            await adm.__aexit__(None, None, None)
        st = plane.stats()
        assert st["per_shard"][hot.shard]["admitted"] == 1
        assert st["per_shard"][cold.shard]["admitted"] == 1
    run(body())


def test_legacy_controller_still_bounds_and_counts_waits():
    async def body():
        ctl = AdmissionController(window=2, class_windows=(1, 1, 1))
        order = []

        async def job(i, nbytes):
            async with ctl.admit(nbytes):
                order.append(i)
                await asyncio.sleep(0.01)

        # three small jobs through a class window of 1: they serialize
        await asyncio.gather(job(0, 10), job(1, 10), job(2, 10))
        assert sorted(order) == [0, 1, 2]
        assert ctl.waits >= 1
        assert ctl.peak_held == 1               # class window of 1
        assert ctl.held_now == 0
    run(body())


def test_host_scope_plane_uses_arena_and_tracks_host_peak(arena_name):
    async def body():
        cfg = AdmissionConfig(window=4, class_windows=(4, 4, 4),
                              scope="host", group=arena_name)
        plane = AdmissionPlane(cfg)
        try:
            assert plane.scope == "host" and plane.arena is not None
            ctl = plane.controller("ns")
            async with ctl.admit(100):
                async with ctl.admit(100):
                    assert plane.arena.used(ctl._ns_pool) == 2
            assert plane.host_peak(ctl.shard) == 2
            assert plane.arena.used(ctl._ns_pool) == 0
            # a second plane handle (another process, in production)
            # sees the same arena and the same peak
            other = AdmissionPlane(cfg)
            assert other.host_peak(0) == 2
            other.close()
        finally:
            if plane.arena is not None:
                plane.arena.unlink()
            plane.close()
    run(body())


def test_host_scope_falls_back_when_arena_unavailable(monkeypatch):
    import t3fs_torch.usrbio.slots as slots_mod

    def boom(*a, **kw):
        raise OSError("no shm on this box")

    monkeypatch.setattr(slots_mod, "ShmTokenArena", boom)
    plane = AdmissionPlane(AdmissionConfig(scope="host", group=_name()))
    assert plane.scope == "process" and plane.arena is None

    async def body():
        ctl = plane.controller("ns")
        async with ctl.admit(10):               # still bounds this process
            assert ctl.held_now == 1
    run(body())


def test_resolve_plane_group_rendezvous():
    g = _name()
    cfg = AdmissionConfig(group=g)
    p1 = resolve_plane(cfg)
    p2 = resolve_plane(AdmissionConfig(group=g))
    assert p1 is p2                             # same group, same plane
    assert resolve_plane(AdmissionConfig(group=_name())) is not p1
    assert resolve_plane(AdmissionConfig()) is not p1   # "" = private


def test_tier_host_scope_integration(arena_name):
    """Through the tier facade: admit_scope=host serves traffic through
    the arena and reports it in stats."""
    async def body():
        from t3fs_torch.client.storage_client import StorageClient
        from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig
        from t3fs_torch.testing.fabric import StorageFabric
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        tier = None
        try:
            tier = KVCacheTier(
                sc, fab.chain_ids, namespace="host-ns",
                config=KVCacheTierConfig(
                    lanes=2, flush_interval_s=0.005,
                    ledger_flush_interval_s=0.05,
                    admit_scope="host", admit_group=arena_name),
                writer_id=1)
            await tier.start()
            await tier.put(b"k", b"v" * 100)
            await tier.flush()
            assert await tier.get(b"k") == b"v" * 100
            st = tier.stats()
            assert st["admission"]["scope"] == "host"
            assert "arena" in st["admission_plane"]
            assert tier.plane.host_peak(0) >= 1
            await tier.stop()
        finally:
            if tier is not None and tier.plane.arena is not None:
                tier.plane.arena.unlink()
                tier.plane.close()
            await sc.close()
            await fab.stop()
    run(body())
