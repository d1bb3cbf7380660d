"""Repair drill bench: kill one node under live first-k read
traffic, rebuild its shards, and account for every survivor byte the
rebuild pulled across the fabric.

The headline number is repair traffic per lost byte, A/B'd across repair
modes on IDENTICAL damage:

  full      — classic MDS repair: read k survivor chunks per lost chunk
              (read amplification ~k);
  subshard  — the reduced-read path: a lost shard rebuilds from its LRC
              local group (group_size survivor chunks, sub-range reads
              riding the packed batch-read wire), so amplification is
              ~group_size; the cross-mode ratio lands near group_size/k
              (3/8 with the defaults), under the 0.5x drill target.

With --layout pm-msr the same drill A/Bs the coupled-layer MSR code
instead: subshard mode reads every survivor's beta/alpha repair
projection (d*beta/alpha = 0.5625x of k full chunks) while full mode
reads k full survivor chunks — exactly what plain RS(8+2) pays — on the
SAME damage, at the SAME 1.25x storage (no extra parity chunks).

Foreground impact: reader tasks hammer first-k stripe reads throughout;
each repair cycle snapshots their latency samples, so the JSON carries
foreground p50/p99 per (mode, budget) cell — the paced cells show what
`storage.repair_budget_mbps` buys, with the token-bucket wait totals
alongside.

Damage is reapplied identically between cycles (the first cycle's loss
comes from a real fail-stop + empty-disk restart; later cycles re-remove
the same chunks), so every cell repairs the same byte population.

    python -m t3fs_torch.benchmarks.repair_drill_bench --json
    python -m t3fs_torch.benchmarks.repair_drill_bench --repair-mode subshard --json

The port of benchmarks/repair_drill_bench.py, with the same arguments,
defaults and JSON keys.  The cluster is the port's LocalCluster, every
node's CRCs on the CUDA checksum backend, and the ECStorageClient runs
TorchECCodec on the card (B4 + B1 on the subshard cells, B3 + B1 on the
full ones, the pm-msr layout's steps on its own).  --device is accepted and
names the default (the reference's flag for its device codec); --cpu runs
the nodes' CRCs on the host and the codec on its plain versions.  Without a
GPU and without --cpu the bench raises.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time

import numpy as np

from t3fs_torch import resolve_device
from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.client.repair import RepairDriver, RepairJob
from t3fs_torch.storage.types import RemoveChunksReq
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusCode

INODE = 0xD111


def _pctl(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--m", type=int, default=2)
    ap.add_argument("--chunk-size", type=int, default=65536)
    ap.add_argument("--stripes", type=int, default=12)
    ap.add_argument("--local-group-size", type=int, default=3)
    ap.add_argument("--layout", default="lrc-xor",
                    choices=["lrc-xor", "pm-msr"],
                    help="reduced-repair scheme under test: lrc-xor "
                         "trades 1.75x storage for group-size reads; "
                         "pm-msr keeps 1.25x storage and reads "
                         "sub-packetized projections from all survivors")
    # one chain per node so a node kill loses at most ONE slot per stripe
    # (the single-loss case the reduced path targets); chains > slots so
    # placement rotates across stripes
    ap.add_argument("--chains", type=int, default=16)
    ap.add_argument("--nodes", type=int, default=16)
    ap.add_argument("--repair-mode", default="both",
                    choices=["full", "subshard", "both"])
    ap.add_argument("--budget-mbps", type=float, default=2.0,
                    help="token-bucket rate for the paced cells (small "
                         "enough that the default-size drill actually "
                         "exhausts the burst and waits)")
    ap.add_argument("--concurrency", type=int, default=4)
    ap.add_argument("--readers", type=int, default=2,
                    help="background first-k read tasks")
    ap.add_argument("--warm-s", type=float, default=0.5,
                    help="healthy-read window for the baseline p99")
    ap.add_argument("--device", action="store_true",
                    help="run repair math on the card (the default)")
    ap.add_argument("--cpu", action="store_true",
                    help="the nodes' CRCs on the host, the codec on its "
                         "plain versions")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


async def run_bench(args) -> dict:
    cluster = LocalCluster(num_nodes=args.nodes, replicas=1,
                           num_chains=args.chains, heartbeat_timeout_s=0.6,
                           checksum_backend="cpu" if args.cpu else "cuda")
    await cluster.start()
    try:
        return await _run(args, cluster)
    finally:
        await cluster.stop()


async def _run(args, cluster: LocalCluster) -> dict:
    k, m, cs = args.k, args.m, args.chunk_size
    lay = ECLayout.create(k=k, m=m, chunk_size=cs,
                          chains=list(range(1, args.chains + 1)),
                          local_scheme=args.layout,
                          local_group_size=args.local_group_size)
    if lay.slots >= args.chains:
        raise SystemExit(f"need chains > slots={lay.slots} so placement "
                         f"rotates (got --chains {args.chains})")
    ec = ECStorageClient(cluster.sc, codec=TorchECCodec(
        device="cpu" if args.cpu else "cuda"))
    stripe_len = k * cs
    rng = np.random.default_rng(17)
    payloads = [rng.integers(0, 256, stripe_len, dtype=np.uint8).tobytes()
                for _ in range(4)]
    for s in range(args.stripes):
        res = await ec.write_stripe(lay, INODE, s, payloads[s % 4])
        assert all(r.status.code == int(StatusCode.OK) for r in res), s

    # --- background first-k readers: live traffic the drill must not starve
    lat: list[float] = []
    read_errors = 0
    stop = asyncio.Event()

    async def reader(seed: int) -> None:
        nonlocal read_errors
        r = random.Random(seed)
        while not stop.is_set():
            s = r.randrange(args.stripes)
            t0 = time.perf_counter()
            try:
                d = await ec.read_stripe(lay, INODE, s, stripe_len)
                lat.append(time.perf_counter() - t0)
                assert d == payloads[s % 4], f"reader: stripe {s} corrupt"
            except AssertionError:
                raise
            except Exception:
                read_errors += 1

    readers = [asyncio.create_task(reader(i)) for i in range(args.readers)]
    await asyncio.sleep(args.warm_s)
    healthy_p99_ms = round(_pctl(lat, 0.99) * 1e3, 3)
    healthy_samples = len(lat)

    # --- fail-stop the victim node, wait for the chains to notice
    victim = args.nodes
    lost_chains = [c.chain_id for c in
                   cluster.mgmtd.state.routing().chains.values()
                   if any(t.node_id == victim for t in c.targets)]
    await cluster.kill_storage_node(victim)
    for _ in range(200):
        routing = cluster.mgmtd.state.routing()
        if all(routing.chains[c].chain_ver >= 2 for c in lost_chains):
            break
        await asyncio.sleep(0.05)
    else:
        raise TimeoutError("chains never noticed the node kill")
    await cluster.mgmtd_client.refresh()

    losses = {}
    for s in range(args.stripes):
        lost = tuple(sl for sl in range(lay.slots)
                     if lay.shard_chain(s, sl) in lost_chains)
        if lost:
            losses[s] = lost
    n_lost = sum(len(v) for v in losses.values())
    lost_bytes = n_lost * cs
    assert losses, "victim held no shards — widen --stripes"

    # restart the node on an empty disk so repairs have a home
    import shutil
    shutil.rmtree(cluster.node_root(victim), ignore_errors=True)
    await cluster.start_storage_node(victim)
    for _ in range(300):
        routing = cluster.mgmtd.state.routing()
        if all(routing.chains[c].head() is not None for c in lost_chains):
            break
        await asyncio.sleep(0.05)
    else:
        raise TimeoutError("restarted node's chains never came back")
    await cluster.mgmtd_client.refresh()

    async def redamage() -> None:
        """Re-remove exactly the drill's lost chunks (later A/B cells)."""
        routing = cluster.mgmtd.state.routing()
        for s, lost in losses.items():
            for sl in lost:
                cid = lay.shard_chunk(INODE, s, sl)
                chain_id = lay.shard_chain(s, sl)
                head = routing.chains[chain_id].head()
                await cluster.admin.call(
                    routing.node_address(head.node_id),
                    "Storage.remove_chunks",
                    RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                                    begin_index=cid.index,
                                    end_index=cid.index + 1))

    modes = (["subshard", "full"] if args.repair_mode == "both"
             else [args.repair_mode])
    cells = [(mode, budget) for mode in modes
             for budget in (0.0, args.budget_mbps) if budget >= 0]
    results = []
    first = True
    for mode, budget in cells:
        if not first:
            await redamage()
        first = False
        lat.clear()
        driver = RepairDriver(ec, concurrency=args.concurrency,
                              repair_mode=mode, budget_mbps=budget)
        job = RepairJob(layout=lay, inode=INODE,
                        stripe_len_of={s: stripe_len for s in losses},
                        losses=dict(losses))
        t0 = time.perf_counter()
        report = await driver.run([job])
        t_repair = time.perf_counter() - t0
        window = list(lat)
        assert report.stripes_failed == 0, report.failed
        assert report.repaired_shards == n_lost, report
        for s in losses:
            d = await ec.read_stripe(lay, INODE, s, stripe_len)
            assert d == payloads[s % 4], f"post-repair stripe {s}"
        results.append({
            "mode": mode, "budget_mbps": budget,
            "bytes_read": report.bytes_read,
            "bytes_repaired": report.bytes_repaired,
            "read_amplification": round(
                report.bytes_read / max(report.bytes_repaired, 1), 3),
            "reduced_shards": report.reduced_shards,
            "fallback_shards": report.fallback_shards,
            "sub_reads": report.sub_reads,
            "repair_s": round(t_repair, 3),
            "repair_MB_s": round(
                report.bytes_repaired / t_repair / 1e6, 2),
            "paced_waits": report.paced_waits,
            "paced_wait_s": round(report.paced_wait_s, 3),
            "fg_p50_ms": round(_pctl(window, 0.5) * 1e3, 3),
            "fg_p99_ms": round(_pctl(window, 0.99) * 1e3, 3),
            "fg_samples": len(window),
        })

    stop.set()
    await asyncio.gather(*readers)
    codec_stats = None
    if ec.codec is not None:
        codec_stats = {"counts": dict(ec.codec.codec_counts)}
        await ec.close()

    def cell(mode: str, budget: float):
        for r in results:
            if r["mode"] == mode and r["budget_mbps"] == budget:
                return r
        return None

    sub, full = cell("subshard", 0.0), cell("full", 0.0)
    ratio = (round(sub["bytes_read"] / full["bytes_read"], 3)
             if sub and full and full["bytes_read"] else None)
    return {
        "k": k, "m": m, "chunk_size": cs, "stripes": args.stripes,
        "local_scheme": lay.local_scheme, "group_size": args.local_group_size,
        "slots": lay.slots, "chains": args.chains, "nodes": args.nodes,
        "codec": "cpu" if args.cpu else "cuda",
        "codec_stats": codec_stats,
        "lost_shards": n_lost, "lost_bytes": lost_bytes,
        "healthy_p99_ms": healthy_p99_ms,
        "healthy_samples": healthy_samples,
        "read_errors": read_errors,
        "cells": results,
        # the drill headline: survivor bytes moved, reduced vs full-k,
        # same damage — target < 0.5
        "repair_traffic_ratio": ratio,
        "verified": True,
    }


def main(argv=None) -> None:
    args = parse_args(argv)
    # the card unless asked for the CPU: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    res = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(res))
    else:
        json.dump(res, sys.stdout, indent=2)
        print()


if __name__ == "__main__":
    main()
