"""The port's ledger compaction (t3fs_torch/kvcache/compact.py): every case
of tests/test_kvcache_compact.py run on the port's fabric.

The invariants the compactor must never trade away:
- A compacted namespace replays to EXACTLY the table the uncompacted
  history replayed to — compaction changes cost, never content.
- A concurrent writer racing the pass loses nothing: records flushed
  during compaction land above every base the pass checkpoints.
- Dying at any stage (after re-emit, after checkpoint) resumes to the
  same converged state: re-emitted duplicates are ts-idempotent and
  orphaned segments below the base are swept on the next pass.
- A reader whose frontier fell below a compacted lane's base jumps
  forward and still sees every live key.
"""

import asyncio
import functools
import time

import pytest

from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.kvcache import (
    CompactionConfig, LedgerCheckpoint, LedgerCompactor, LedgerReader,
    LedgerTable, LedgerWriter, read_checkpoint,
)
from t3fs_torch.kvcache.compact import _InjectedCrash
from t3fs_torch.kvcache.ledger import (
    OP_DEL, OP_HIT, OP_PUT, pack_checkpoint, parse_checkpoint,
)
from t3fs_torch.lib.kvcache import KVCacheStore
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


def _cfg(**kw) -> CompactionConfig:
    kw.setdefault("trigger_segments", 4)
    kw.setdefault("remove_rate", 100000.0)
    kw.setdefault("remove_burst", 1024)
    return CompactionConfig(**kw)


async def _store(fab, namespace):
    sc = StorageClient(lambda: fab.routing, client=fab.client)
    return sc, KVCacheStore(sc, fab.chain_ids, namespace=namespace)


async def _churn(writer: LedgerWriter, keys: int, rounds: int,
                 t0: float = 1000.0) -> float:
    """PUT-overwrite churn: every key rewritten ``rounds`` times, plus
    HITs and a DEL/re-PUT cycle — history >> live set.  Returns the max
    ts used."""
    ts = t0
    for r in range(rounds):
        for i in range(keys):
            ts += 0.001
            writer.append(OP_PUT, f"sess-{i:04d}".encode(),
                          size=100 + r, ts=ts)
        await writer.flush()
    for i in range(0, keys, 3):
        ts += 0.001
        writer.append(OP_DEL, f"sess-{i:04d}".encode(), ts=ts)
    await writer.flush()
    for i in range(0, keys, 6):
        ts += 0.001
        writer.append(OP_PUT, f"sess-{i:04d}".encode(), size=500, ts=ts)
    await writer.flush()
    return ts


def _snapshot(table: LedgerTable) -> dict:
    return {k: (e.size, e.put_ts, e.hit_ts)
            for k, e in table.entries.items()}


# ---------------- checkpoint codec ----------------

def test_checkpoint_codec_and_torn_blobs():
    ckpt = LedgerCheckpoint(version=7, compactions=3,
                            bases={0: 12, 3: 5, 2: 0})
    blob = pack_checkpoint(ckpt)
    back = parse_checkpoint(blob)
    assert back == ckpt
    assert back.base(0) == 12 and back.base(1) == 0
    # torn/foreign blobs degrade to "nothing retired" — never a fault
    assert parse_checkpoint(blob[:-1]) == LedgerCheckpoint()
    assert parse_checkpoint(b"junk") == LedgerCheckpoint()
    assert parse_checkpoint(b"") == LedgerCheckpoint()


# ---------------- HIT coalescing (satellite) ----------------

def test_writer_coalesces_hits_within_flush_window():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "hits")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2)
            await w.attach()
            w.append(OP_PUT, b"hot", size=10, ts=1.0)
            for i in range(100):
                w.append(OP_HIT, b"hot", ts=2.0 + i)
            w.append(OP_HIT, b"warm", ts=50.0)
            # 100 HITs on one key collapse to one record at the max ts
            assert w.buffered == 3
            assert w.hits_coalesced == 99
            await w.flush()
            r = LedgerReader(store, lanes=2)
            recs = await r.scan()
            hits = [x for x in recs if x.op == OP_HIT]
            assert len(hits) == 2
            assert max(h.ts for h in hits if h.key == b"hot") == 101.0
            t = LedgerTable()
            t.apply(recs)
            assert t.entries[b"hot"].hit_ts == 101.0
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- the compaction pass ----------------

def test_compaction_bounds_replay_and_preserves_table():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "compact")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2,
                             segment_bytes=512)
            await w.attach()
            ts_max = await _churn(w, keys=40, rounds=6)

            before_reader = LedgerReader(store, lanes=2)
            before_recs = await before_reader.scan()
            before = LedgerTable()
            before.apply(before_recs)
            segs_before = before_reader.live_segments()
            assert segs_before >= 8             # real history to retire

            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(del_grace_s=0.0))
            out = await comp.run_pass(force=True, now=ts_max + 100.0)
            assert out["compacted"]
            assert out["retired"] == out["segments"]
            assert out["fence_lost"] == 0
            # replay cost collapsed: O(live keys), not O(history)
            assert out["records_out"] < out["records_in"] / 3

            after_reader = LedgerReader(store, lanes=2)
            after_recs = await after_reader.scan()
            after = LedgerTable()
            after.apply(after_recs)
            assert _snapshot(after) == _snapshot(before)
            assert len(after_recs) < len(before_recs) / 3
            assert after_reader.live_segments() < segs_before
            assert after_reader.last_checkpoint.compactions == 1

            # a restarted writer attaches past the compacted tail, and a
            # second forced pass is idempotent (re-reads only the tail)
            w2 = LedgerWriter(store, writer_id=1, lanes=2,
                              segment_bytes=512)
            assert await w2.attach() == w.seq
            out2 = await comp.run_pass(force=True, now=ts_max + 101.0)
            final = LedgerTable()
            final.apply(await LedgerReader(store, lanes=2).scan())
            assert _snapshot(final) == _snapshot(before)
            assert out2["records_in"] == out["records_out"]
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_compaction_below_trigger_skips():
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "trigger")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2)
            await w.attach()
            w.append(OP_PUT, b"k", size=1, ts=1.0)
            await w.flush()
            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(trigger_segments=64))
            out = await comp.run_pass()
            assert not out["compacted"] and out["segments"] == 1
            assert comp.stats["skipped"] == 1
            assert (await read_checkpoint(store)).compactions == 0
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_compaction_del_grace_keeps_recent_tombstones():
    """A DEL inside the grace window must survive compaction: it may
    still need to beat a laggy writer's in-flight PUT.  Older DELs are
    dropped — everything they could kill is already retired."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "grace")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2)
            await w.attach()
            w.append(OP_PUT, b"old", size=1, ts=100.0)
            w.append(OP_DEL, b"old", ts=200.0)       # ancient tombstone
            w.append(OP_PUT, b"new", size=1, ts=300.0)
            w.append(OP_DEL, b"new", ts=995.0)       # inside grace
            await w.flush()
            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(del_grace_s=10.0))
            await comp.run_pass(force=True, now=1000.0)
            recs = await LedgerReader(store, lanes=2).scan()
            dels = {r.key: r.ts for r in recs if r.op == OP_DEL}
            assert dels == {b"new": 995.0}
            # the recent DEL still wins against the laggy PUT it guards:
            # when that PUT's segment finally lands, a fresh replay sees
            # both and ts-orders the DEL after it
            from t3fs_torch.kvcache.ledger import LedgerRecord
            t = LedgerTable()
            t.apply(recs + [LedgerRecord(OP_PUT, b"new", 1, 0.0, 990.0)])
            assert b"new" not in t.entries
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_compaction_racing_live_writer_loses_nothing():
    """Traffic keeps flowing while the pass runs: every key written
    before or during compaction must be live in the final replay with
    its LAST value's size."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "race")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2,
                             segment_bytes=512)
            await w.attach()
            await _churn(w, keys=30, rounds=5)

            stop = asyncio.Event()
            wrote: dict[bytes, int] = {}

            async def traffic():
                ts = 5000.0
                i = 0
                while not stop.is_set():
                    key = f"live-{i % 20:03d}".encode()
                    ts += 0.001
                    i += 1
                    w.append(OP_PUT, key, size=i, ts=ts)
                    wrote[key] = i
                    if i % 7 == 0:
                        await w.flush()
                    await asyncio.sleep(0)

            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(del_grace_s=0.0))
            task = asyncio.create_task(traffic())
            for _ in range(3):
                await comp.run_pass(force=True, now=4000.0)
            stop.set()
            await task
            await w.flush()

            t = LedgerTable()
            t.apply(await LedgerReader(store, lanes=2).scan())
            for key, last in wrote.items():
                assert t.entries[key].size == last, key
            # churn survivors are still there too
            assert any(k.startswith(b"sess-") for k in t.entries)
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_compaction_folds_crashed_gc_tombstones():
    """A GC pass that removed blocks but crashed before flushing its
    tombstones converges through compaction exactly as through plain
    replay: the next GC pass probes, finds the blocks absent, and
    tombstones; compaction then drops the dead entries for good."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "gccrash")
        try:
            from t3fs_torch.kvcache.gc import EvictionConfig, EvictionWorker
            w = LedgerWriter(store, writer_id=1, lanes=2)
            await w.attach()
            now = time.time()
            for i in range(12):
                key = f"k{i}".encode()
                await store.put(key, b"v" * 32)
                # half the keys are already expired
                exp = now - 1.0 if i % 2 == 0 else now + 3600.0
                w.append(OP_PUT, key, size=32, expiry=exp, ts=now - 10 + i)
            await w.flush()
            # "crashed GC": blocks for two expired keys removed, no DELs
            await store.remove_keys([b"k0", b"k2"])

            reader = LedgerReader(store, lanes=2)
            table = LedgerTable()
            gc = EvictionWorker(store, reader, table, w, EvictionConfig())
            await gc.run_pass()
            assert all(f"k{i}".encode() not in table.entries
                       for i in range(0, 12, 2))

            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(del_grace_s=0.0))
            await comp.run_pass(force=True, now=now + 100.0)
            final = LedgerTable()
            final.apply(await LedgerReader(store, lanes=2).scan())
            assert set(final.entries) == {f"k{i}".encode()
                                          for i in range(1, 12, 2)}
            for key in final.entries:
                assert await store.get(key) == b"v" * 32
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# ---------------- crash resume ----------------

@pytest.mark.parametrize("crash_point", ["emitted", "checkpointed"])
def test_kill_and_restart_mid_compaction_resumes(crash_point):
    """Die right after re-emit (before the checkpoint moved) or right
    after the checkpoint (before retirement): a fresh compactor — as
    after a process restart — converges to the same table with no
    orphaned segments left below any base."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, f"crash-{crash_point}")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2,
                             segment_bytes=512)
            await w.attach()
            ts_max = await _churn(w, keys=30, rounds=5)
            before = LedgerTable()
            before.apply(await LedgerReader(store, lanes=2).scan())

            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(del_grace_s=0.0))
            comp.crash_point = crash_point
            with pytest.raises(_InjectedCrash):
                await comp.run_pass(force=True, now=ts_max + 100.0)

            # restart: fresh writer + compactor, as a new process would
            w2 = LedgerWriter(store, writer_id=1, lanes=2,
                              segment_bytes=512)
            await w2.attach()
            comp2 = LedgerCompactor(store, w2, lanes=2,
                                    config=_cfg(del_grace_s=0.0))
            out = await comp2.run_pass(force=True, now=ts_max + 101.0)
            assert out["compacted"]
            if crash_point == "checkpointed":
                # the first pass bumped bases but died before retiring:
                # the resume's orphan sweep must clean the stranded prefix
                assert out["orphans"] > 0

            after = LedgerTable()
            after.apply(await LedgerReader(store, lanes=2).scan())
            assert _snapshot(after) == _snapshot(before)

            # no orphans below any base anywhere
            comp3 = LedgerCompactor(store, w2, lanes=2)
            ckpt = await read_checkpoint(store)
            assert await comp3._sweep_orphans(ckpt) == 0
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_reader_frontier_jumps_over_retired_prefix():
    """A long-lived reader mid-history when compaction retires the
    prefix under it: its frontier jumps to the base and the union of
    what it read before and after still replays to the full live set."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc, store = await _store(fab, "jump")
        try:
            w = LedgerWriter(store, writer_id=1, lanes=2,
                             segment_bytes=512)
            await w.attach()
            ts_max = await _churn(w, keys=30, rounds=5)

            reader = LedgerReader(store, lanes=2)
            seen = list(await reader.scan())     # consumed pre-compaction

            ts = ts_max
            for i in range(30, 45):
                ts += 0.001
                w.append(OP_PUT, f"sess-{i:04d}".encode(), size=7, ts=ts)
            await w.flush()

            comp = LedgerCompactor(store, w, lanes=2,
                                   config=_cfg(del_grace_s=0.0))
            await comp.run_pass(force=True, now=ts + 100.0)

            seen.extend(await reader.scan())
            assert reader.frontier_jumps > 0
            t = LedgerTable()
            t.apply(seen)
            fresh = LedgerTable()
            fresh.apply(await LedgerReader(store, lanes=2).scan())
            # the long-lived reader knows everything the fresh one does
            # (it may additionally remember history; ts-LWW makes the
            # duplicates harmless)
            for k, e in fresh.entries.items():
                assert t.entries[k].size == e.size
        finally:
            await sc.close()
            await fab.stop()
    run(body())


def test_tier_end_to_end_compaction_with_readback():
    """Through the KVCacheTier facade: churn, force a pass, verify every
    live value byte-for-byte and the stats/gauge surfaces."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=2, num_chains=2)
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        try:
            from t3fs_torch.kvcache import KVCacheTier, KVCacheTierConfig
            tier = KVCacheTier(
                sc, fab.chain_ids, namespace="e2e",
                config=KVCacheTierConfig(
                    lanes=2, segment_bytes=512, hit_sample=1,
                    flush_interval_s=0.005,
                    ledger_flush_interval_s=0.05,
                    compact_trigger_segments=4,
                    compact_del_grace_s=0.0),
                writer_id=1)
            await tier.start()
            values = {}
            for r in range(4):
                for i in range(40):
                    key = f"s{i:03d}".encode()
                    values[key] = bytes([r * 40 + i & 0xFF]) * 64
                    await tier.put(key, values[key])
                await tier.flush()
            await tier.get_many(list(values))    # HIT records
            hot = next(iter(values))
            for _ in range(4):                   # hot-key HITs coalesce
                await tier.get(hot)
            await tier.flush()
            out = await tier.run_compaction_pass(force=True)
            assert out["compacted"] and out["retired"] > 0
            got = await tier.get_many(list(values))
            assert got == list(values.values())  # zero wrong bytes
            st = tier.stats()
            assert st["compaction"]["compactions"] == 1
            assert st["ledger_hits_coalesced"] > 0
            await tier.stop()
        finally:
            await sc.close()
            await fab.stop()
    run(body())
