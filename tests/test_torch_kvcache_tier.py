"""The port's KVCache serving tier (t3fs_torch/kvcache/): every case of
tests/test_kvcache_tier.py run on the port's fabric, then one tier
scenario through both packages, held bit for bit.

The hard cases the subsystem exists for:
- TTL-expired keys whose 64-bit index collided with a live key must not
  take the collision winner's block with them.
- Eviction racing a concurrent put of the same key: the newer block wins
  (remove fence), never a remove-after-put.
- A GC pass that crashes between removal and tombstoning must converge
  on replay (idempotent recovery).
- The write-behind flush barrier orders puts before dependent gets.
- Capacity eviction keeps a namespace within its byte budget under
  churn, with no wrong-bytes reads.
"""

import asyncio
import functools
import os
import time
import types as pytypes

import numpy as np
import pytest

import benchmarks.kvcache_fleet_bench
import t3fs.client.storage_client
import t3fs.kvcache
import t3fs.kvcache.compact
import t3fs.kvcache.gc
import t3fs.kvcache.ledger
import t3fs.kvcache.tier
import t3fs.kvcache.writebehind
import t3fs.net.client
import t3fs.net.rdma
import t3fs.testing.fabric
import t3fs.utils.serde
import t3fs_torch.benchmarks.kvcache_fleet_bench
import t3fs_torch.client.storage_client
import t3fs_torch.kvcache
import t3fs_torch.kvcache.compact
import t3fs_torch.kvcache.gc
import t3fs_torch.kvcache.ledger
import t3fs_torch.kvcache.tier
import t3fs_torch.kvcache.writebehind
import t3fs_torch.net.client
import t3fs_torch.net.rdma
import t3fs_torch.testing.fabric
import t3fs_torch.utils.serde
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.kvcache import (
    KVCacheTier, KVCacheTierConfig, LedgerReader, LedgerTable, LedgerWriter,
)
from t3fs_torch.kvcache.gc import EvictionConfig, EvictionWorker
from t3fs_torch.kvcache.ledger import OP_DEL, OP_PUT, parse_segment, _pack_segment
from t3fs_torch.kvcache.writebehind import WriteBehind, WriteBehindConfig
from t3fs_torch.lib.kvcache import KVCacheStore, _pack_block
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.testing.fabric import StorageFabric


def run(coro):
    return asyncio.run(coro)


@pytest.fixture(autouse=True)
def _port_fabric_on_the_cpu(monkeypatch):
    """Every port StorageFabric of this file checksums on the CUDA backend
    run on its plain versions (device="cpu"): the card's code path without
    the card."""
    monkeypatch.setattr(StorageFabric, "default_checksum_backend",
                        functools.partial(CudaChecksumBackend, device="cpu"))


def _tier_cfg(**kw) -> KVCacheTierConfig:
    kw.setdefault("lanes", 4)
    kw.setdefault("hit_sample", 1)
    kw.setdefault("flush_interval_s", 0.005)
    kw.setdefault("ledger_flush_interval_s", 0.05)
    return KVCacheTierConfig(**kw)


async def _fabric_tier(fab, namespace, **cfg_kw):
    sc = StorageClient(lambda: fab.routing, client=fab.client)
    tier = KVCacheTier(sc, fab.chain_ids, namespace=namespace,
                       config=_tier_cfg(**cfg_kw), writer_id=1)
    await tier.start()
    return sc, tier


# ---------------- ledger ----------------

def test_segment_codec_and_torn_segments():
    from t3fs_torch.kvcache.ledger import LedgerRecord
    recs = [LedgerRecord(OP_PUT, b"key-a", 100, 0.0, 1.0),
            LedgerRecord(OP_DEL, b"key-b", 0, 0.0, 2.0)]
    blob = _pack_segment(7, 3, recs)
    assert parse_segment(blob) == recs
    assert parse_segment(blob[:-1]) == []       # torn tail: whole seg drops
    assert parse_segment(b"junk") == []
    assert parse_segment(b"") == []


def test_ledger_table_last_writer_wins():
    from t3fs_torch.kvcache.ledger import LedgerRecord
    t = LedgerTable()
    t.apply([LedgerRecord(OP_PUT, b"k", 10, 0.0, 1.0),
             LedgerRecord(OP_DEL, b"k", 0, 0.0, 2.0)])
    assert len(t) == 0                          # delete postdates the put
    # a stale DEL cannot kill a newer PUT, regardless of arrival order
    t.apply([LedgerRecord(OP_DEL, b"k", 0, 0.0, 2.5),
             LedgerRecord(OP_PUT, b"k", 20, 0.0, 3.0)])
    assert t.entries[b"k"].size == 20
    # HIT bumps the LRU epoch without resurrecting anything
    t.apply([LedgerRecord(1, b"k", 0, 0.0, 9.0)])
    assert t.entries[b"k"].hit_ts == 9.0
    assert t.live_bytes == 20


def test_ledger_writer_attach_recovery_and_reader_frontier():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            store = KVCacheStore(sc, fab.chain_ids, namespace="led")
            w = LedgerWriter(store, writer_id=5, lanes=4, segment_bytes=256)
            assert await w.attach() == 0
            for i in range(30):
                w.append(OP_PUT, f"key-{i:03d}".encode(), size=64,
                         ts=float(i))
            segs = await w.flush()
            assert segs >= 2                    # 256B segments force splits
            # a restarted writer on the same lane resumes past the log
            w2 = LedgerWriter(store, writer_id=5, lanes=4,
                              segment_bytes=256)
            assert await w2.attach() == w.seq
            # a different process on another lane starts at 0
            w3 = LedgerWriter(store, writer_id=6, lanes=4)
            assert w3.lane != w2.lane
            assert await w3.attach() == 0
            w3.append(OP_PUT, b"other-lane", size=1, ts=100.0)
            await w3.flush()
            # reader sees both lanes; second scan is incremental (empty)
            r = LedgerReader(store, lanes=4, window=2)
            recs = await r.scan()
            assert len(recs) == 31
            assert await r.scan() == []
            w3.append(OP_DEL, b"other-lane", ts=101.0)
            await w3.flush()
            assert len(await r.scan()) == 1     # frontier picked up the tail
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- write-behind ----------------

def test_write_behind_flush_barrier_orders_puts_before_gets():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            store = KVCacheStore(sc, [fab.chain_id], namespace="wb")
            wb = WriteBehind(store, WriteBehindConfig(flush_interval_s=5.0))
            # flusher not started yet: deterministically nothing durable
            await wb.put(b"a", b"v1")
            await wb.put(b"a", b"v2")           # coalesces: one chunk write
            await wb.put(b"b", b"w1")
            # read-your-writes BEFORE anything is durable
            found, collided = wb.lookup([b"a", b"b", b"c"])
            assert found == {b"a": b"v2", b"b": b"w1"} and not collided
            assert (await store.get(b"a")) is None    # not flushed yet
            await wb.start()
            await wb.flush()                    # the barrier
            # after the barrier the STORE (not the buffer) must serve both
            assert await store.get(b"a") == b"v2"
            assert await store.get(b"b") == b"w1"
            assert wb.stats["coalesced"] == 1
            assert wb.stats["flushed"] == 2     # superseded v1 never written
            assert wb.dirty_bytes == 0
            await wb.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_write_behind_backpressure_bounds_dirty_bytes():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            store = KVCacheStore(sc, [fab.chain_id], namespace="bp")
            cap = 8 << 10
            wb = WriteBehind(store, WriteBehindConfig(
                max_dirty_bytes=cap, flush_batch=8,
                flush_interval_s=0.002))
            await wb.start()
            peak = 0
            for i in range(64):
                await wb.put(f"k{i}".encode(), b"x" * 1024)
                peak = max(peak, wb.dirty_bytes)
            await wb.flush()
            # backpressure admits one entry past the cap at most
            assert peak <= cap + 1024 + 16
            assert wb.stats["backpressure_waits"] > 0
            assert await store.get(b"k63") == b"x" * 1024
            await wb.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- eviction semantics ----------------

def test_ttl_expired_but_collided_key_spares_winner_block():
    """An expired key whose chunk was overwritten by a colliding live key
    must be tombstoned WITHOUT removing the chunk — blind removal would
    evict the collision winner's block."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            sc2, tier = await _fabric_tier(fab, "collide", default_ttl_s=0.01)
            victim = b"expired-victim"
            await tier.put(victim, b"old")
            await tier.flush()
            # simulate the 64-bit index collision: another key's block
            # lands in the victim's chunk (what locate() would do on a
            # real blake2b collision)
            chain, cid = tier.store.locate(victim)
            winner_block = _pack_block(b"collision-winner", b"live-bytes")
            await sc.write_chunk(chain, cid, 0, winner_block,
                                 tier.store.cfg.block_size)
            await asyncio.sleep(0.03)           # let the TTL expire
            rep = await tier.run_gc_pass()
            assert rep["ttl"] == 1 and rep["removed"] == 0
            assert rep["collided"] == 1
            assert victim not in tier.table.entries   # tombstoned
            # the winner's block survived the pass
            _, payloads = await sc.batch_read(
                [__import__("t3fs_torch.storage.types", fromlist=["ReadIO"])
                 .ReadIO(chunk_id=cid, chain_id=chain, offset=0, length=0)])
            assert bytes(payloads[0]) == winner_block
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_eviction_racing_put_keeps_newer_block():
    """A put of the victim key that lands between GC's probe and its
    remove must survive: the probed version fences the remove."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            sc2, tier = await _fabric_tier(fab, "race", default_ttl_s=0.01)
            await tier.put(b"hot", b"old-value")
            await tier.flush()
            await asyncio.sleep(0.03)           # expire it
            real_probe = tier.store.probe_many

            async def probe_then_racing_put(keys):
                out = await real_probe(keys)
                # the race: a fresh write-through put AFTER the probe
                await tier.store.put(b"hot", b"new-value")
                tier.ledger.append(OP_PUT, b"hot", size=9,
                                   ts=time.time())
                return out

            tier.store.probe_many = probe_then_racing_put
            rep = await tier.run_gc_pass()
            tier.store.probe_many = real_probe
            assert rep["fence_lost"] == 1 and rep["removed"] == 0
            assert await tier.store.get(b"hot") == b"new-value"
            # replay from scratch agrees the key is live (no tombstone
            # was written for the fenced-out victim)
            fresh = LedgerTable()
            fresh.apply(await LedgerReader(
                tier.store, lanes=tier.cfg.lanes).scan())
            assert b"hot" in fresh.entries
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_ledger_replay_after_crashed_gc_pass_converges():
    """Blocks removed but tombstones lost (crash between remove and
    ledger write): replay still lists the keys; the next pass probes
    them, finds nothing, tombstones, and the table converges empty."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            sc2, tier = await _fabric_tier(fab, "crash", default_ttl_s=0.01)
            keys = [f"gone-{i}".encode() for i in range(8)]
            for k in keys:
                await tier.put(k, b"v")
            await tier.flush()
            # the "crashed pass": blocks removed, NO tombstones appended
            assert await tier.store.remove_many(keys) == 8
            await asyncio.sleep(0.03)
            # a recovering worker replays the ledger from scratch
            store = tier.store
            reader = LedgerReader(store, lanes=tier.cfg.lanes)
            table = LedgerTable()
            writer = LedgerWriter(store, writer_id=2,
                                  lanes=tier.cfg.lanes)
            await writer.attach()
            gc = EvictionWorker(store, reader, table, writer,
                                EvictionConfig())
            rep = await gc.run_pass()
            assert rep["victims"] == 8          # replay still listed them
            assert rep["removed"] == 0          # nothing left to remove
            assert len(table) == 0              # converged
            # and the tombstones are durable: a THIRD replay agrees
            t3 = LedgerTable()
            t3.apply(await LedgerReader(store,
                                        lanes=tier.cfg.lanes).scan())
            assert len(t3) == 0
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_capacity_eviction_keeps_namespace_within_budget_under_churn():
    """The acceptance test: zipf-ish churn against a small byte budget;
    after every GC pass the replayed namespace stays at/under budget and
    no get ever returns bytes other than the value last put for the key."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=4)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            budget = 16 << 10
            sc2, tier = await _fabric_tier(
                fab, "churn", byte_budget=budget, gc_batch=16,
                remove_rate=1e6)
            import random
            rng = random.Random(11)
            expected: dict[bytes, bytes] = {}
            for round_no in range(6):
                for _ in range(40):
                    i = min(int(rng.paretovariate(1.2)), 60)
                    key = f"s{i}".encode()
                    val = (f"r{round_no}-{i}-".encode() * 300)[:2048]
                    await tier.put(key, val)
                    expected[key] = val
                await tier.flush()
                await tier.run_gc_pass()
                assert tier.table.live_bytes <= budget, \
                    f"round {round_no}: {tier.table.live_bytes} > {budget}"
                # correctness: a get returns the last-put value or a miss,
                # NEVER stale/foreign bytes
                sample = rng.sample(sorted(expected),
                                    min(20, len(expected)))
                got = await tier.get_many(sample)
                for k, v in zip(sample, got):
                    assert v is None or v == expected[k], \
                        f"{k!r}: wrong bytes after eviction"
            assert tier.gc.stats["removed"] > 0
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- admission ----------------

def test_admission_windows_bound_inflight_ops():
    from t3fs_torch.kvcache.tier import AdmissionController

    async def body():
        ctl = AdmissionController(window=4, class_windows=(2, 2, 1))
        assert ctl.size_class(100) == 0
        assert ctl.size_class(8 << 10) == 1
        assert ctl.size_class(1 << 20) == 2
        active = {"now": 0, "peak": 0}

        async def op(nbytes):
            async with ctl.admit(nbytes):
                active["now"] += 1
                active["peak"] = max(active["peak"], active["now"])
                await asyncio.sleep(0.002)
                active["now"] -= 1

        await asyncio.gather(*(op(100) for _ in range(10)))
        assert active["peak"] <= 2              # small-class window
        active["peak"] = 0
        await asyncio.gather(*(op(100) for _ in range(4)),
                             *(op(8 << 10) for _ in range(4)))
        assert active["peak"] <= 4              # namespace window
        assert ctl.waits > 0
    run(body())


# ---------------- fleet bench smoke ----------------

def test_fleet_bench_smoke():
    """The multi-process bench end-to-end at toy scale: 2 workers x 8
    sessions, write-behind A/B + GC phase, real TCP reconnects.  (The
    reference's twin is marked slow; the port's runs in a few seconds, its
    nodes' CRCs on the host backend by --cpu.)"""
    from t3fs_torch.benchmarks.kvcache_fleet_bench import parse_args, run_bench
    args = parse_args(["--procs", "2", "--sessions", "8", "--turns", "1",
                       "--prompts", "16", "--blocks", "4",
                       "--nodes", "3", "--replicas", "2", "--chains", "4",
                       "--cpu"])
    out = run(run_bench(args))
    assert out["fleet"]["on"]["sessions"] == 16
    assert out["fleet"]["on"]["puts"] > 0
    assert out["fleet"]["off"]["put_p50_ms"] > 0
    assert out["gc"]["within_budget"]
    assert out["gc"]["removed"] > 0


# ---------------- stats merge ----------------

def test_render_kvcache_stats_merges_processes():
    from t3fs_torch.kvcache import render_kvcache_stats
    snaps = [
        {"pid": 1, "tiers": [{"namespace": "ns", "puts": 10, "gets": 100,
                              "hits": 80, "misses": 20, "dirty_bytes": 512,
                              "ledger_live_keys": 5,
                              "ledger_live_bytes": 5000,
                              "gc": {"removed": 3, "fence_lost": 1}}]},
        {"pid": 2, "tiers": [{"namespace": "ns", "puts": 5, "gets": 50,
                              "hits": 25, "misses": 25,
                              "ledger_live_keys": 6,
                              "ledger_live_bytes": 6000, "gc": {}}]},
    ]
    out = render_kvcache_stats(snaps)
    assert "ns" in out and "70.0" in out        # 105 hits / 150 gets
    assert "6000" in out                        # max across views, not sum
    assert render_kvcache_stats([]) == "no kvcache stats"


# ---------------- background-loop resilience (t3fslint fixes) ----------------

def test_write_behind_survives_crashing_on_flushed_callback():
    """The ledger hook raising must not kill the flusher: the data IS
    durable, and a dead flusher wedges every later flush() barrier."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            store = KVCacheStore(sc, [fab.chain_id], namespace="cbx")
            fired = []

            def bad_hook(key, size, expiry, ver):
                fired.append(key)
                raise RuntimeError("ledger hook blew up")

            wb = WriteBehind(store,
                             WriteBehindConfig(flush_interval_s=0.002),
                             on_flushed=bad_hook)
            await wb.start()
            await wb.put(b"a", b"v1")
            # pre-fix this barrier hung forever (flusher task dead);
            # the timeout is the regression tripwire
            await asyncio.wait_for(wb.flush(), 5.0)
            assert fired == [b"a"]
            await wb.put(b"b", b"v2")
            await asyncio.wait_for(wb.flush(), 5.0)
            assert await store.get(b"b") == b"v2"
            assert sorted(fired) == [b"a", b"b"]
            await wb.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_eviction_loop_survives_crashing_pass():
    """One failed GC pass (transient store/ledger error) must not end
    eviction for the life of the process."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            store = KVCacheStore(sc, [fab.chain_id], namespace="gcx")
            writer = LedgerWriter(store, writer_id=9, lanes=2)
            await writer.attach()
            reader = LedgerReader(store, lanes=2)
            gc_ = EvictionWorker(store, reader, LedgerTable(), writer,
                                 EvictionConfig(interval_s=0.01))
            real_pass = gc_.run_pass
            crashes = []

            async def flaky_pass(now=None):
                if not crashes:
                    crashes.append(1)
                    raise RuntimeError("transient scan failure")
                return await real_pass(now)

            gc_.run_pass = flaky_pass
            await gc_.start()
            for _ in range(200):
                await asyncio.sleep(0.01)
                if gc_.stats["passes"] > 0:
                    break
            # the loop outlived the crash and completed a real pass
            assert crashes and gc_.stats["passes"] > 0
            assert not gc_._task.done()
            await gc_.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_puts_wedged_on_backpressure_do_not_starve_gets():
    """Interference regression (mixed-workload soak, crash fault): with
    the flusher wedged (dead chain analog) and the dirty buffer full,
    blocked puts must wait for buffer space OUTSIDE the admission window
    — get_many shares the namespace window and must keep serving.
    Before the reserve()-first fix, enough wedged puts occupied every
    namespace slot and reads starved behind writes they never needed."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=3)
        await fab.start()
        sc, tier = await _fabric_tier(
            fab, "starve", max_dirty_bytes=2048,
            admit_window=4, admit_class_windows=(4, 4, 4))
        try:
            unwedge = asyncio.Event()
            orig_put = tier.store.put

            async def wedged_put(key, value):
                await unwedge.wait()
                return await orig_put(key, value)

            tier.store.put = wedged_put
            # fill the dirty buffer past the cap (flusher is wedged, so
            # nothing drains), then pile up MORE puts than the namespace
            # window has slots
            for i in range(3):
                await tier.put(f"fill{i}".encode(), b"x" * 900)
            puts = [asyncio.create_task(
                tier.put(f"blocked{i}".encode(), b"y" * 900))
                for i in range(8)]
            await asyncio.sleep(0.1)
            assert all(not t.done() for t in puts)  # all wedged on space
            assert tier.wb.stats["backpressure_waits"] > 0

            # reads must still make progress (miss path goes to the store
            # via get_many, which needs the same namespace window)
            got = await asyncio.wait_for(
                tier.get_many([b"absent-a", b"absent-b"]), timeout=2.0)
            assert got == [None, None]

            # a cancelled waiter must not leak its reservation
            puts[-1].cancel()
            await asyncio.gather(puts[-1], return_exceptions=True)

            unwedge.set()
            await asyncio.gather(*puts[:-1])
            await tier.flush()
            assert tier.wb.reserved_bytes == 0
            assert tier.wb.dirty_bytes == 0
            assert await tier.get(b"blocked0") == b"y" * 900
        finally:
            await tier.stop()
            await sc.close()
            await fab.stop()
    run(body())



# ---------------- one tier scenario through both packages ----------------

def _pkg(root, fleet) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, kvc=root.kvcache, tier=root.kvcache.tier,
        ledger=root.kvcache.ledger, clocked=(
            root.kvcache.tier, root.kvcache.gc, root.kvcache.compact,
            root.kvcache.writebehind),
        sc=root.client.storage_client, fabric=root.testing.fabric,
        net=root.net.client, rdma=root.net.rdma, serde=root.utils.serde,
        thaw=fleet.thaw_routing, freeze=fleet.freeze_routing)


REF = _pkg(t3fs, benchmarks.kvcache_fleet_bench)
PORT = _pkg(t3fs_torch, t3fs_torch.benchmarks.kvcache_fleet_bench)
NS = "tier-diff"


class _Clock:
    """time.time() pinned to a value the scenario advances at its
    barriers; monotonic() steps 1 ms a read (it only paces the token
    buckets); perf_counter() stays real (it times, and nothing stores it)."""

    def __init__(self):
        self.now = 1_800_000_000.0
        self._mono = 0.0

    def time(self) -> float:
        return self.now

    def monotonic(self) -> float:
        self._mono += 1e-3
        return self._mono

    def perf_counter(self) -> float:
        return time.perf_counter()


def _pin(monkeypatch, p) -> _Clock:
    clock = _Clock()
    for mod in p.clocked:
        monkeypatch.setattr(mod, "time", clock)
    # the tier's writer_id defaults to os.getpid(): pinned, so both
    # packages' ledgers name one writer and lane
    monkeypatch.setattr(p.tier, "os", pytypes.SimpleNamespace(
        getpid=lambda: 4242, environ=os.environ))
    return clock


def _foreign_client(q, fabric):
    routing = q.thaw(q.freeze(fabric.routing))
    cli = q.net.Client()
    cli.add_service(q.rdma.BufferRegistry())
    return q.sc.StorageClient(lambda: routing, client=cli)


async def tier_scenario(p, clock: _Clock) -> dict:
    """Write-behind puts in three rounds (some with a TTL), gets over the
    dirty buffer before each flush() and after it, the TTLs lapsed and one
    GC pass, a forced compaction, stop(); then both packages' ledger
    readers replay the namespace (the other package's over the wire)."""
    fab = p.fabric.StorageFabric(num_nodes=3, replicas=2, num_chains=2)
    await fab.start()
    sc = p.sc.StorageClient(lambda: fab.routing, client=fab.client)
    cfg = p.tier.KVCacheTierConfig(
        lanes=2, hit_sample=2, ledger_flush_interval_s=3600.0,
        write_behind="on", flush_concurrency=1, flush_interval_s=0.005,
        compact_trigger_segments=2, compact_del_grace_s=0.0)
    tier = p.tier.KVCacheTier(sc, fab.chain_ids, namespace=NS, config=cfg)
    try:
        await tier.start()
        rng = np.random.default_rng(9)
        keys = [f"sess-{i}".encode() for i in range(16)]
        log = []
        for rnd in range(3):
            for i, k in enumerate(keys[4 * rnd:4 * rnd + 8]):
                value = rng.integers(0, 256, int(rng.integers(100, 20000)),
                                     dtype=np.uint8).tobytes()
                await tier.put(k, value, ttl_s=5.0 if i % 3 == 0 else None)
            log.append(("dirty", await tier.get_many(keys + [b"absent"])))
            await tier.flush()
            clock.now += 1.0
            log.append(("flushed", await tier.get_many(keys)))
        clock.now += 10.0                          # every TTL has lapsed
        log.append(("gc", await tier.run_gc_pass()))
        log.append(("after_gc", await tier.get_many(keys)))
        clock.now += 1.0
        log.append(("compact", await tier.run_compaction_pass(force=True)))
        st = tier.stats()
        log.append(("stats", {k: st[k] for k in (
            "puts", "gets", "hits", "misses", "ledger_segments_flushed",
            "ledger_live_keys", "ledger_live_bytes", "gc", "compaction")}))
        await tier.stop()
        replay = {}
        for q in (REF, PORT):
            qsc = sc if q is p else _foreign_client(q, fab)
            store = q.tier.KVCacheStore(qsc, fab.chain_ids, namespace=NS)
            table = q.kvc.LedgerTable()
            table.apply(await q.kvc.LedgerReader(store, lanes=2).scan())
            replay[q.name] = ({k: (e.size, e.put_ts, e.hit_ts, e.expiry)
                               for k, e in table.entries.items()},
                              table.live_bytes,
                              await store.get_many(keys))
            if q is not p:
                await qsc.close()
        ledger_inode = p.ledger.ledger_inode(NS)
        chunks, segments = {}, {}
        for node in fab.nodes:
            for tid, target in sorted(node.targets.items()):
                for m in sorted(target.engine.all_metas(),
                                key=lambda m: (m.chunk_id.inode,
                                               m.chunk_id.index)):
                    blob = bytes(target.engine.read(m.chunk_id))
                    chunks[(node.node_id, tid, m.chunk_id.inode,
                            m.chunk_id.index)] = (p.serde.dumps(m), blob)
                    if m.chunk_id.inode == ledger_inode:
                        segments[m.chunk_id.index] = blob
        return {"log": log, "replay": replay, "chunks": chunks,
                "segments": segments}
    finally:
        await sc.close()
        await fab.stop()


def test_tier_scenario_matches_reference_bit_for_bit(monkeypatch):
    """The same tier scenario through both packages, time.time(),
    time.monotonic() and the writer id pinned in both: every get, the GC
    and compaction passes' reports, the tier's counters, the ledger's
    segment and checkpoint bytes, every replica's chunks and ChunkMeta,
    and the replayed table are equal; each package replays the other's
    ledger to the same table."""
    out = {}
    for p in (REF, PORT):
        out[p.name] = run(tier_scenario(p, _pin(monkeypatch, p)))
    ref, port = out["t3fs"], out["t3fs_torch"]
    assert [name for name, _ in port["log"]] == [name for name, _ in ref["log"]]
    for (name, a), (_, b) in zip(ref["log"], port["log"]):
        assert a == b, name
    assert port["segments"] == ref["segments"]
    assert port["chunks"] == ref["chunks"]
    for o in (ref, port):
        assert o["replay"]["t3fs"] == o["replay"]["t3fs_torch"]
    assert port["replay"] == ref["replay"]
    # what the scenario must have reached
    log = dict(ref["log"])
    assert log["gc"]["ttl"] > 0 and log["gc"]["removed"] > 0
    assert log["compact"]
    assert any(v is None for v in log["after_gc"])
    assert any(v is not None for v in log["after_gc"])
    # the compaction folded the GC's tombstones: the checkpoint chunk and
    # re-emitted PUTs remain
    ckpt_index = REF.ledger.CKPT_LANE << 32
    assert REF.ledger.parse_checkpoint(
        ref["segments"][ckpt_index]).compactions == 1
    segs = [REF.ledger.parse_segment(b) for i, b in ref["segments"].items()
            if i != ckpt_index]
    assert OP_PUT in {r.op for seg in segs for r in seg}
