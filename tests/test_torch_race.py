"""The port's concurrency sanitizers (t3fs_torch/testing/race.py — SURVEY
§5.2 TSan analog): every case of tests/test_race.py on the port, its
fabrics on the host CRC.  The detectors must catch planted bugs AND stay
silent on the real system.
"""

import asyncio
import time

import pytest

from t3fs_torch.testing.race import (
    CriticalSectionAuditor, LoopStallDetector, RaceError,
)


def run(coro):
    return asyncio.run(coro)


# --- LoopStallDetector ---

def test_stall_detector_catches_blocking_call():
    async def body():
        async with LoopStallDetector(threshold_s=0.05) as det:
            await asyncio.sleep(0.05)      # healthy baseline
            time.sleep(0.25)               # planted bug: sync sleep on loop
            await asyncio.sleep(0.05)
        assert det.stalls, "blocking call went undetected"
        assert det.stalls[0].duration_s >= 0.05
        assert "time.sleep" in det.report() or "body" in det.report()
    run(body())


def test_stall_detector_quiet_on_async_load():
    async def body():
        async with LoopStallDetector(threshold_s=0.2) as det:
            # heavy but well-behaved async activity
            async def worker(i):
                for _ in range(20):
                    await asyncio.sleep(0.001)
            await asyncio.gather(*(worker(i) for i in range(50)))
        assert not det.stalls, det.report()
    run(body())


# --- CriticalSectionAuditor ---

def test_auditor_catches_overlap_and_reports_both_stacks():
    async def body():
        audit = CriticalSectionAuditor()

        async def racer(who, delay):
            async with audit.section("res", who):
                await asyncio.sleep(delay)

        with pytest.raises(RaceError) as ei:
            await asyncio.gather(racer("first", 0.05), racer("second", 0.0))
        msg = str(ei.value)
        assert "first" in msg and "second" in msg and "racer" in msg
    run(body())


def test_auditor_allows_distinct_keys_and_reentry():
    async def body():
        audit = CriticalSectionAuditor(capture_stacks=False)
        async with audit.section("a"):
            async with audit.section("b"):     # distinct key: fine
                pass
        async with audit.section("a"):          # sequential re-entry: fine
            pass
        assert audit.entries == 3
    run(body())


# --- live system under the sanitizers ---

def test_storage_write_path_is_race_and_stall_clean(tmp_path):
    """Drive concurrent CRAQ writes (overlapping chunks) through the real
    service with BOTH sanitizers armed: the per-chunk lock must hold
    (auditor silent) and nothing may block the event loop (detector
    silent) — the reference's TSan-gated storage suites, in spirit."""
    async def body():
        from t3fs_torch.client.storage_client import StorageClient
        from t3fs_torch.storage.types import ChunkId
        from t3fs_torch.testing.fabric import StorageFabric

        fab = StorageFabric(num_nodes=3, replicas=3,
                                checksum_backend="cpu")
        await fab.start()
        audit = CriticalSectionAuditor(capture_stacks=False)
        for node in fab.nodes:
            node.audit = audit
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            async with LoopStallDetector(threshold_s=0.25) as det:
                async def writer(i):
                    # 8 writers x 8 writes over only 4 distinct chunks:
                    # heavy same-chunk contention
                    for j in range(8):
                        cid = ChunkId(7, (i + j) % 4)
                        await sc.write_chunk(
                            fab.chain_id, cid, 0,
                            bytes([i]) * 4096, chunk_size=4096)
                await asyncio.gather(*(writer(i) for i in range(8)))
            assert audit.entries >= 8 * 8 * 3      # every hop audited
            assert not det.stalls, det.report()
        finally:
            await fab.stop()
    run(body())


# --- race_audit: the tree-wide installer (T3FS_RACE_AUDIT=1 tier) ---

def test_race_audit_covers_fabric_and_restores_patches(tmp_path):
    """The conftest hook's contract: inside the context every fabric node
    is audited (entries accumulate on real writes), outside the context
    the classes are back to their originals."""
    async def body():
        from t3fs_torch.client.storage_client import StorageClient
        from t3fs_torch.storage.chunk_replica import ChunkReplica
        from t3fs_torch.storage.types import ChunkId
        from t3fs_torch.testing.fabric import StorageFabric
        from t3fs_torch.testing.race import race_audit

        orig_start = StorageFabric.start
        orig_apply = ChunkReplica.apply_update
        with race_audit() as auditor:
            assert StorageFabric.start is not orig_start
            assert ChunkReplica.apply_update is not orig_apply
            fab = StorageFabric(num_nodes=3, replicas=3,
                                checksum_backend="cpu")
            await fab.start()
            try:
                assert all(n.audit is auditor for n in fab.nodes)
                sc = StorageClient(lambda: fab.routing, client=fab.client)
                await sc.write_chunk(fab.chain_id, ChunkId(9, 0), 0,
                                     b"z" * 4096, chunk_size=4096)
                # one write -> replicas hops, each an audited section
                assert auditor.entries >= 3
            finally:
                await fab.stop()
        assert StorageFabric.start is orig_start
        assert ChunkReplica.apply_update is orig_apply
    run(body())


def test_race_audit_covers_craq_step_simulator():
    """ChunkReplica.apply_update is the funnel the CRAQ schedule explorer
    shares with the real service, so the simulator's interleavings run
    audited too — no separate hook needed."""
    from t3fs_torch.testing.craq_sim import run_schedules
    from t3fs_torch.testing.race import race_audit

    with race_audit() as auditor:
        failures = run_schedules(2, crashes=0)
    assert failures == {}
    assert auditor.entries > 0
