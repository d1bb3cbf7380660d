"""The port's ScrubScheduler on the port's LocalCluster against the JAX
package's: a twin of tests/test_scrub_scheduler.py's
test_scrub_detects_repairs_and_restart_is_idempotent, run through both
packages and compared field by field (RepairReport, scrub status(), the
mgmtd repair-status row, every shard's stored bytes).  The port runs
TorchECCodec and a CudaChecksumBackend on the CPU (their plain versions);
the reference its ECCodec with JAX on the CPU."""

import asyncio
import os

import pytest

from t3fs.utils.status import StatusCode

# RepairReport and status() fields that depend on the wall clock (the
# token bucket's waits), left out of the comparison
TIMED = ("paced_waits", "paced_wait_s")


async def scrub_drill(pkg: str) -> dict:
    """Lost shards (node-side removes) + a disk-corrupted shard flagged
    through CheckWorker's corrupt_sink: one scan tick repairs everything
    on the reduced path; a FRESH scheduler rescans from zero and finds
    nothing; mgmtd round-trips the health row.  Returns what the drill
    observed, for the comparison."""
    if pkg == "ref":
        from t3fs.client.ec_client import ECLayout, ECStorageClient
        from t3fs.mgmtd.service import RepairStatus, ReportRepairStatusReq
        from t3fs.storage.scrub_scheduler import ScrubScheduler
        from t3fs.storage.types import RemoveChunksReq
        from t3fs.testing.cluster import LocalCluster
        cluster = LocalCluster(num_nodes=4, replicas=1, num_chains=8)
    else:
        from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
        from t3fs_torch.client.ec_codec import TorchECCodec
        from t3fs_torch.mgmtd.service import RepairStatus, ReportRepairStatusReq
        from t3fs_torch.storage.codec_backend import CudaChecksumBackend
        from t3fs_torch.storage.scrub_scheduler import ScrubScheduler
        from t3fs_torch.storage.types import RemoveChunksReq
        from t3fs_torch.testing.cluster import LocalCluster
        cluster = LocalCluster(
            num_nodes=4, replicas=1, num_chains=8,
            checksum_backend=lambda: CudaChecksumBackend(device="cpu"))
    await cluster.start()
    out: dict = {}
    try:
        lay = ECLayout.create(k=4, m=2, chunk_size=2048, chains=list(range(1, 9)),
                              local_scheme="lrc-xor", local_group_size=3)
        ec = (ECStorageClient(cluster.sc) if pkg == "ref" else
              ECStorageClient(cluster.sc, codec=TorchECCodec(device="cpu")))
        data = {}
        for s in range(6):
            payload = bytes([65 + s]) * (4 * 2048 - s * 700)
            data[s] = payload
            res = await ec.write_stripe(lay, 77, s, payload)
            assert all(r.status.code == int(StatusCode.OK) for r in res), s
        stripe_lens = {s: len(data[s]) for s in range(6)}
        routing = cluster.mgmtd.state.routing()
        for s in range(6):
            cid = lay.shard_chunk(77, s, 2)
            chain_id = lay.shard_chain(s, 2)
            head = routing.chains[chain_id].head()
            await cluster.admin.call(
                routing.node_address(head.node_id), "Storage.remove_chunks",
                RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                                begin_index=cid.index, end_index=cid.index + 1))
        cor_cid = lay.shard_chunk(77, 1, 5)
        head = routing.chains[lay.shard_chain(1, 5)].head()
        target = cluster.storage[head.node_id].node.targets[head.target_id]
        fd, off, _n, _gen = target.engine.locate(cor_cid, 0, 2048)
        os.pwrite(fd, b"\xde\xad\xbe\xef" * 16, off)

        sched = ScrubScheduler(ec, repair_mode="subshard", budget_mbps=50.0)
        sched.add_target("file77", lay, 77, stripe_lens)
        cw = cluster.storage[head.node_id].check
        cw.corrupt_sink = sched.note_corrupt
        cw.verify_chunks_per_tick = 10_000
        await cw.check_once()
        out["check"] = (cw.corrupt_found, ("file77", 1) in sched._flagged)

        report = await sched.scan_once()
        out["report"] = {k: v for k, v in report.__dict__.items() if k not in TIMED}
        out["status"] = {k: v for k, v in sched.status().items() if k not in TIMED}
        out["read"] = [await ec.read_stripe(lay, 77, s, len(data[s]))
                       for s in range(6)]
        assert out["read"] == [data[s] for s in range(6)]
        shards = {}
        for s in range(6):
            for slot in range(lay.slots):
                t = routing.chains[lay.shard_chain(s, slot)].head()
                eng = cluster.storage[t.node_id].node.targets[t.target_id].engine
                cid = lay.shard_chunk(77, s, slot)
                meta = eng.get_meta(cid)
                shards[(s, slot)] = None if meta is None else (
                    meta.length, meta.checksum, meta.update_ver == meta.commit_ver,
                    eng.read(cid))
        out["shards"] = shards

        sched2 = ScrubScheduler(ec)
        sched2.add_target("file77", lay, 77, stripe_lens)
        rep2 = await sched2.scan_once()
        out["rescan"] = ({k: v for k, v in rep2.__dict__.items() if k not in TIMED},
                         {k: v for k, v in sched2.status().items() if k not in TIMED})

        await cluster.admin.call(
            cluster.mgmtd_rpc.address, "Mgmtd.report_repair_status",
            ReportRepairStatusReq(status=RepairStatus.from_status(
                "scrub-test", sched.status())))
        rsp, _ = await cluster.admin.call(
            cluster.mgmtd_rpc.address, "Mgmtd.repair_status", None)
        row = rsp.rows[0]
        assert row.ts > 0
        out["row"] = {k: v for k, v in row.__dict__.items()
                      if k not in ("ts",) + TIMED}
        if pkg == "port":
            await ec.close()
    finally:
        await cluster.stop()
    return out


@pytest.fixture(scope="module")
def drills():
    return {pkg: asyncio.run(scrub_drill(pkg)) for pkg in ("ref", "port")}


def test_scrub_detects_repairs_and_restart_is_idempotent(drills):
    """The port's drill repairs what the reference's does, as the
    reference's test asserts: 6 lost + 1 corrupt, 7 repaired on the reduced
    path, a fresh scheduler finds nothing, and the mgmtd row round-trips."""
    port = drills["port"]
    assert port["check"] == (1, True)
    st = port["status"]
    assert (st["shards_lost"], st["shards_corrupt"]) == (6, 1)
    rep = port["report"]
    assert (rep["repaired_shards"], rep["stripes_failed"], rep["reduced_shards"]) \
        == (7, 0, 7)
    rep2, st2 = port["rescan"]
    assert st2["stripes_scanned"] == 6 and st2["shards_lost"] == 0
    assert st2["shards_corrupt"] == 0 and rep2["repaired_shards"] == 0
    row = port["row"]
    assert row["source"] == "scrub-test" and row["repaired_shards"] == 7
    assert row["repair_mode"] == "subshard"


@pytest.mark.parametrize("part", ["check", "report", "status", "read", "shards",
                                  "rescan", "row"])
def test_scrub_drill_matches_reference(drills, part):
    assert drills["port"][part] == drills["ref"][part]
