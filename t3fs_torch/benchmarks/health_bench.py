"""Cluster health plane A/B: scorecard priors vs cold start.

Two cells:

1. **cold_first_read** — the headline: a 3-replica chain with one known
   10 ms straggler, scorecard warm in mgmtd.  Each trial simulates a
   brand-new client process (process-wide ReadStats cleared), refreshes
   routing once, and measures its FIRST adaptive read.  Priors OFF, the
   cold client knows nothing — adaptive selection tie-breaks randomly
   and eats the straggler's 10 ms in ~1/replicas of trials, so first-read
   p99 sits at the straggler's latency.  Priors ON, the scorecard
   piggybacked on GetRoutingInfoRsp seeds ReadStats before the first
   read, and selection routes around the known-slow node.  Target:
   >= 30% first-read p99 improvement.

2. **steady_state** — the overhead guard: identical warm read loops on a
   cluster with the health plane fully on (monitor + reporter + rollup
   timer + mgmtd pull + piggyback) vs fully off.  Target: read p50
   within 3% (the tracing bar).

    python -m t3fs_torch.benchmarks.health_bench --json
    python -m t3fs_torch.benchmarks.health_bench --cpu --json

The port of benchmarks/health_bench.py, with the same arguments, cells,
JSON keys and exit code; a failed seed write raises (the reference drops
its result).  Its clusters are the port's LocalCluster, every
node's CRCs on the CUDA checksum backend; --device is accepted and names
that default; --cpu runs the host CRC.  Each cluster's node backend
warmups finish before its first read.  Without a GPU and without --cpu
the bench raises.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time

from t3fs_torch import resolve_device
from t3fs_torch.client.mgmtd_client import MgmtdClient
from t3fs_torch.client.storage_client import (
    StorageClient, StorageClientConfig, TargetSelection,
)
from t3fs_torch.monitor.rollup import RollupConfig
from t3fs_torch.net.rpcstats import READ_STATS
from t3fs_torch.storage.types import ChunkId, ReadIO
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils import tracing
from t3fs_torch.utils.status import StatusCode
from t3fs_torch.utils.tracing import TraceConfig

INODE = 0x14EA17


def _pctl(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--straggler-ms", type=float, default=10.0)
    ap.add_argument("--trials", type=int, default=60,
                    help="cold-client trials per arm")
    ap.add_argument("--warm-reads", type=int, default=150,
                    help="reads that feed the scorecard before trials")
    ap.add_argument("--steady-reads", type=int, default=400)
    ap.add_argument("--steady-repeat", type=int, default=3,
                    help="interleaved off/on pairs; medians quoted")
    ap.add_argument("--read-size", type=int, default=4096)
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="every node's CRCs on the card (the default)")
    ap.add_argument("--cpu", action="store_true",
                    help="every node's CRCs on the host")
    return ap.parse_args(argv)


async def _make_cluster(args, with_monitor: bool,
                        trace: TraceConfig | None = None) -> LocalCluster:
    # cold cell default export="all": the rollup pass must see EVERY read
    # span, not just tail-promoted slow ones, or fast nodes would have no
    # rollup rows to score.  The steady cells pass the production tail
    # config instead — full span export is a bench warm-up device, not
    # the deployed overhead being measured.
    trace = trace or TraceConfig(sample_rate=1.0, export="all")
    tracing.reset_tracing()
    cl = LocalCluster(
        num_nodes=args.nodes, replicas=args.nodes, with_monitor=with_monitor,
        trace=trace,
        rollup_cfg=RollupConfig(bucket_s=0.5, period_s=0.25, lag_s=0.1),
        checksum_backend="cpu" if args.cpu else "cuda")
    try:
        await cl.start()
        # each node's checksum backend warms up in a thread (on the card:
        # the CUDA context, the tables, pinned staging); let it finish
        # before the first read
        for ss in cl.storage.values():
            warmup = getattr(ss, "_warmup_task", None)
            if warmup is not None:
                await warmup
    except BaseException:
        # a node that cannot start (no GPU for the CUDA backend) must not
        # leave the monitor and its reporter threads running
        await cl.stop()
        raise
    cid = ChunkId(INODE, 0)
    res = await cl.sc.write_chunk(1, cid, 0, b"\xab" * args.read_size,
                                  args.read_size)
    if res.status.code != int(StatusCode.OK):
        await cl.stop()
        raise RuntimeError(f"health_bench: the seed write failed: "
                           f"{res.status}")
    return cl


async def _warm_scorecard(cl: LocalCluster, args) -> None:
    """Drive reads until mgmtd's scorecard has flagged the straggler."""
    cid = ChunkId(INODE, 0)
    deadline = time.monotonic() + 60.0
    reads = 0
    while time.monotonic() < deadline:
        for _ in range(25):
            await cl.sc.batch_read(
                [ReadIO(chain_id=1, chunk_id=cid, offset=0,
                        length=args.read_size)])
            reads += 1
            await asyncio.sleep(0.002)
        h = cl.mgmtd.state.health
        if h is not None and reads >= args.warm_reads and any(
                n.straggler for n in h.nodes):
            return
    raise RuntimeError("scorecard never flagged the straggler")


async def _cold_trial(cl: LocalCluster, args, seed_priors: bool) -> float:
    """One simulated cold process: wiped ReadStats, fresh MgmtdClient
    (one refresh = the piggyback), fresh StorageClient, time the first
    adaptive read."""
    READ_STATS.clear()
    mc = MgmtdClient(cl.mgmtd_rpc.address, refresh_period_s=3600.0,
                     seed_read_priors=seed_priors)
    await mc.refresh()
    sc = StorageClient(
        mc.routing,
        config=StorageClientConfig(
            read_selection=TargetSelection.ADAPTIVE, retry_backoff_s=0.05))
    try:
        cid = ChunkId(INODE, 0)
        t0 = time.perf_counter()
        results, _ = await sc.batch_read(
            [ReadIO(chain_id=1, chunk_id=cid, offset=0,
                    length=args.read_size)])
        dt = time.perf_counter() - t0
        assert all(r.status.code == 0 for r in results)
        return dt
    finally:
        await sc.close()
        await mc.client.close()


async def run_cold_ab(args) -> dict:
    cl = await _make_cluster(args, with_monitor=True)
    try:
        straggler_node = 2
        cl.set_read_delay(straggler_node, args.straggler_ms / 1e3)
        await _warm_scorecard(cl, args)
        arms = {}
        for name, seed in (("priors_off", False), ("priors_on", True)):
            lats = []
            for _ in range(args.trials):
                lats.append(await _cold_trial(cl, args, seed))
            arms[name] = {
                "trials": len(lats),
                "first_read_p50_ms": round(_pctl(lats, 0.5) * 1e3, 3),
                "first_read_p99_ms": round(_pctl(lats, 0.99) * 1e3, 3),
            }
        off = arms["priors_off"]["first_read_p99_ms"]
        on = arms["priors_on"]["first_read_p99_ms"]
        return {
            "straggler_ms": args.straggler_ms,
            "nodes": args.nodes,
            **{f"{k}_{kk}": vv for k, v in arms.items()
               for kk, vv in v.items()},
            "p99_improvement_pct": round((1 - on / off) * 100, 1)
            if off else 0.0,
        }
    finally:
        await cl.stop()
        READ_STATS.clear()


async def run_steady_ab(args) -> dict:
    # interleaved median-of-N: single few-hundred-read cells on a shared
    # box swing several percent run to run, which would drown the <=3%
    # overhead bar in noise; alternating off/on also cancels slow drift
    steady_trace = TraceConfig(sample_rate=0.05, export="tail")
    runs: dict[str, list] = {"plane_off": [], "plane_on": []}
    for _ in range(args.steady_repeat):
        for name, with_monitor in (("plane_off", False),
                                   ("plane_on", True)):
            cl = await _make_cluster(args, with_monitor, trace=steady_trace)
            try:
                cid = ChunkId(INODE, 0)
                lats = []
                for _ in range(args.steady_reads):
                    t0 = time.perf_counter()
                    await cl.sc.batch_read(
                        [ReadIO(chain_id=1, chunk_id=cid, offset=0,
                                length=args.read_size)])
                    lats.append(time.perf_counter() - t0)
                runs[name].append((_pctl(lats, 0.5), _pctl(lats, 0.99)))
            finally:
                await cl.stop()
                READ_STATS.clear()
    out = {}
    for name, rs in runs.items():
        p50s = sorted(p50 for p50, _ in rs)
        p99s = sorted(p99 for _, p99 in rs)
        out[name] = {
            "reads": args.steady_reads, "runs": len(rs),
            "read_p50_ms": round(p50s[len(p50s) // 2] * 1e3, 4),
            "read_p99_ms": round(p99s[len(p99s) // 2] * 1e3, 4),
            "read_p50_ms_runs": [round(p * 1e3, 4) for p, _ in rs],
        }
    off = out["plane_off"]["read_p50_ms"]
    on = out["plane_on"]["read_p50_ms"]
    return {
        **{f"{k}_{kk}": vv for k, v in out.items() for kk, vv in v.items()},
        "p50_overhead_pct": round((on / off - 1) * 100, 2) if off else 0.0,
    }


async def amain(args) -> dict:
    cold = await run_cold_ab(args)
    steady = await run_steady_ab(args)
    return {"cold_first_read": cold, "steady_state": steady}


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the CPU: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    result = asyncio.run(amain(args))
    if args.json:
        print(json.dumps(result, indent=2))
    else:
        c, s = result["cold_first_read"], result["steady_state"]
        print(f"cold first-read p99: off {c['priors_off_first_read_p99_ms']}"
              f"ms -> on {c['priors_on_first_read_p99_ms']}ms "
              f"({c['p99_improvement_pct']}% better)")
        print(f"steady-state p50: off {s['plane_off_read_p50_ms']}ms, "
              f"on {s['plane_on_read_p50_ms']}ms "
              f"({s['p50_overhead_pct']:+.2f}%)")
    ok = (result["cold_first_read"]["p99_improvement_pct"] >= 30.0
          and result["steady_state"]["p50_overhead_pct"] <= 3.0)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
