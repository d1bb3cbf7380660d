"""End-to-end health plane smoke.

Monitor + mgmtd + 3 storage nodes under live reads; injects a 10 ms
straggler and asserts the freshness contract end to end:

1. the straggler shows up flagged in the scorecard (via the mgmtd pull
   path — the same one `admin cluster-health` and the GetRoutingInfoRsp
   piggyback read) within one rollup window of detection becoming
   mathematically possible (m_trigger buckets of over-the-bar data);
2. after the fault lifts, the flag clears within the symmetric bound.

Exit 0 on PASS; nonzero with a diagnostic on any missed bound.

    python -m t3fs_torch.benchmarks.health_smoke [--cpu]

The port of benchmarks/health_smoke.py, on the port's LocalCluster with
the monitor on.  Its nodes checksum on the CUDA backend by default (the
4 KiB chunk is below B1's cutoff, so its CRC runs on the host there too);
--cpu runs the host backend.  The nodes' backend warmups finish before
the timeline starts (the reference's nodes have none to wait for).  No
node is killed, so the cluster's heartbeat timeout is one test load cannot
reach (HEARTBEAT_TIMEOUT_S), not the 0.6 s a failover test needs.  measure() returns the two times and
their bounds.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from t3fs_torch.monitor.rollup import RollupConfig
from t3fs_torch.net.rpcstats import READ_STATS
from t3fs_torch.storage.types import ChunkId, ReadIO
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils import tracing
from t3fs_torch.utils.status import StatusCode
from t3fs_torch.utils.tracing import TraceConfig

BUCKET_S = 0.5
ROLLUP_PERIOD_S = 0.25
STRAGGLER_NODE = 2
STRAGGLER_S = 0.010
INODE = 0x54CE
HEARTBEAT_TIMEOUT_S = 60.0


def _straggler_addrs(cl: LocalCluster) -> set[str]:
    h = cl.mgmtd.state.health
    if h is None:
        return set()
    return {n.addr for n in h.nodes if n.straggler}


async def _drive_reads(cl: LocalCluster, stop: asyncio.Event) -> None:
    cid = ChunkId(INODE, 0)
    while not stop.is_set():
        await cl.sc.batch_read(
            [ReadIO(chain_id=1, chunk_id=cid, offset=0, length=4096)])
        await asyncio.sleep(0.005)


async def _wait(predicate, timeout_s: float) -> float:
    """Poll until predicate() or timeout; returns elapsed seconds."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        if predicate():
            return time.monotonic() - t0
        await asyncio.sleep(0.05)
    raise TimeoutError


async def measure(checksum_backend="cuda") -> dict:
    """Run the smoke; the times it took to flag and to clear (None where
    a bound was missed), their bounds, and ok."""
    tracing.reset_tracing()
    READ_STATS.clear()
    cl = LocalCluster(
        num_nodes=3, replicas=3, with_monitor=True,
        heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S,
        checksum_backend=checksum_backend,
        trace=TraceConfig(sample_rate=1.0, export="all"),
        rollup_cfg=RollupConfig(bucket_s=BUCKET_S, period_s=ROLLUP_PERIOD_S,
                                lag_s=0.1))
    try:
        await cl.start()
        # each node's checksum backend warms up in a thread (on the card:
        # the CUDA context, the tables, pinned staging); let it finish
        # before the timeline starts, or its first seconds stall the loop
        # the nodes, the monitor and mgmtd's puller all share
        for ss in cl.storage.values():
            warmup = getattr(ss, "_warmup_task", None)
            if warmup is not None:
                await warmup
    except BaseException:
        # a node that cannot start (no GPU for the CUDA backend) must not
        # leave the monitor and its reporter threads running
        await cl.stop()
        raise
    stop = asyncio.Event()
    readers = asyncio.create_task(_drive_reads(cl, stop))
    # detection bound: m_trigger(3) buckets of straggler data must exist
    # before the detector CAN fire; grant one extra rollup window + the
    # mgmtd pull period on top for the plumbing
    detect_bound = (3 + 1) * BUCKET_S + ROLLUP_PERIOD_S \
        + cl.mgmtd_cfg.health_pull_period_s + 1.0
    clear_bound = (3 + 1) * BUCKET_S + ROLLUP_PERIOD_S \
        + cl.mgmtd_cfg.health_pull_period_s + 1.0
    out = {"flagged_s": None, "detect_bound_s": detect_bound,
           "cleared_s": None, "clear_bound_s": clear_bound, "ok": False}
    try:
        cid = ChunkId(INODE, 0)
        res = await cl.sc.write_chunk(1, cid, 0, b"\x5a" * 4096, 4096)
        if res.status.code != int(StatusCode.OK):
            raise RuntimeError(f"health_smoke: the seed write failed: "
                               f"{res.status}")
        # healthy baseline first: straggler detection needs peers to
        # compare against, so let every node serve some reads
        await asyncio.sleep(2 * BUCKET_S)

        cl.set_read_delay(STRAGGLER_NODE, STRAGGLER_S)
        try:
            dt = await _wait(lambda: _straggler_addrs(cl), detect_bound)
        except TimeoutError:
            print(f"FAIL: straggler not flagged within {detect_bound:.1f}s")
            return out
        out["flagged_s"] = dt
        flagged = _straggler_addrs(cl)
        print(f"PASS: straggler flagged in {dt:.2f}s "
              f"(bound {detect_bound:.1f}s): {sorted(flagged)}")

        cl.set_read_delay(STRAGGLER_NODE, 0.0)
        try:
            dt = await _wait(lambda: not _straggler_addrs(cl), clear_bound)
        except TimeoutError:
            print(f"FAIL: flag did not clear within {clear_bound:.1f}s: "
                  f"{sorted(_straggler_addrs(cl))}")
            return out
        out["cleared_s"] = dt
        print(f"PASS: flag cleared in {dt:.2f}s (bound {clear_bound:.1f}s)")

        h = cl.mgmtd.state.health
        states = {n.addr: n.state for n in h.nodes} if h else {}
        print(f"final scorecard states: {states}")
        out["ok"] = True
        return out
    finally:
        stop.set()
        await asyncio.gather(readers, return_exceptions=True)
        await cl.stop()
        READ_STATS.clear()


async def amain(checksum_backend="cuda") -> int:
    return 0 if (await measure(checksum_backend))["ok"] else 1


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="health_smoke")
    ap.add_argument("--cpu", action="store_true",
                    help="checksum on the host backend (no GPU needed)")
    args = ap.parse_args(argv)
    return asyncio.run(amain("cpu" if args.cpu else "cuda"))


if __name__ == "__main__":
    sys.exit(main())
