"""Rebalance drill bench: elastic membership under live traffic.

One drill cell runs the full membership storm against a cluster serving
foreground IO the whole time — write-pipeline file writes striped across
the CR chains plus first-k EC stripe reads:

  add    — an empty node joins; the rebalancer solves the new table and
           moves a fair share of chains onto it (paced by the byte
           token bucket);
  flap   — the NEW node fail-stops mid-move and restarts ~1 s later;
           in-flight jobs onto it fail *resumable* and the next plan
           tick re-drives them;
  drain  — one original node gets the `drain` tag and empties while it
           keeps serving (it is its own exodus's resync source).

The A/B baseline cell runs the identical foreground traffic with no
membership events and no rebalancer.  Gates (exit nonzero on any miss):

  * zero wrong bytes and zero foreground errors in BOTH cells;
  * drill-cell foreground p50 within 1.3x of the baseline cell;
  * rebalance bytes submitted within the token-bucket budget over the
    drill window (rate * elapsed + one burst);
  * convergence: the solver's own diff is empty for every table, the
    drained node is empty, every target SERVING, no duplicate targets.

    python -m t3fs_torch.benchmarks.rebalance_drill_bench --smoke --json

The port of benchmarks/rebalance_drill_bench.py, with the same arguments,
defaults, cells, gates and JSON keys.  The cluster is the port's
LocalCluster, every node's CRCs on the CUDA checksum backend (so every
chunk a move streams onto its destination as a resync REPLACE is checked
there by B1, for payloads at or above the backend's 64 KiB device cutoff),
and the ECStorageClient encodes its stripes with TorchECCodec on the card.
--device is accepted and names the default; --cpu runs the nodes' CRCs on
the host and the codec on its plain versions.  Without a GPU and without
--cpu the bench raises.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time

from t3fs_torch import resolve_device
from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.client.layout import FileLayout
from t3fs_torch.mgmtd.chain_table import diff_table, solve_for_routing
from t3fs_torch.mgmtd.service import NodeOpReq
from t3fs_torch.mgmtd.types import PublicTargetState
from t3fs_torch.migration.rebalancer import Rebalancer
from t3fs_torch.migration.service import ACTIVE_STATES, MigrationService
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusCode

CR_INODE = 0xB0B         # seeded read-only CR file
LOG_INODE = 0xB0C        # append-style write-pipeline traffic
EC_INODE = 0xB0D         # first-k stripe reads


def _pctl(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def _block(off: int, size: int) -> bytes:
    return (b"reb-%016x-" % off) * (size // 18 + 1)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--nodes", type=int, default=3,
                    help="starting storage nodes (the drill adds one)")
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--cr-chains", type=int, default=6)
    ap.add_argument("--ec-chains", type=int, default=4)
    ap.add_argument("--chunk-size", type=int, default=8192)
    ap.add_argument("--ec-k", type=int, default=2)
    ap.add_argument("--ec-m", type=int, default=1)
    ap.add_argument("--stripes", type=int, default=8)
    ap.add_argument("--budget-mbps", type=float, default=2.0,
                    help="rebalance token-bucket rate (small enough that "
                         "the default drill exhausts the burst and waits)")
    ap.add_argument("--writers", type=int, default=2)
    ap.add_argument("--readers", type=int, default=2)
    ap.add_argument("--write-size", type=int, default=16384)
    ap.add_argument("--warm-s", type=float, default=2.0)
    ap.add_argument("--baseline-s", type=float, default=10.0,
                    help="foreground window of the no-rebalance cell")
    ap.add_argument("--converge-s", type=float, default=180.0)
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized drill (~1 min)")
    ap.add_argument("--device", action="store_true",
                    help="the nodes' CRCs and the EC codec on the card "
                         "(the default)")
    ap.add_argument("--cpu", action="store_true",
                    help="the nodes' CRCs on the host, the codec on its "
                         "plain versions")
    ap.add_argument("--json", action="store_true")
    return ap.parse_args(argv)


class Foreground:
    """Write-pipeline writers + CR/EC readers; every read byte-compared."""

    def __init__(self, cluster: LocalCluster, ec: ECStorageClient,
                 cr_lay: FileLayout, ec_lay: ECLayout, args,
                 seeded_len: int, payloads: list[bytes]):
        self.cluster = cluster
        self.ec = ec
        self.cr_lay = cr_lay
        self.ec_lay = ec_lay
        self.args = args
        self.seeded_len = seeded_len
        self.payloads = payloads
        self.stripe_len = args.ec_k * args.chunk_size
        self.acked: dict[int, bytes] = {}     # log offset -> payload
        self.write_lat: list[float] = []
        self.read_lat: list[float] = []
        self.errors = 0
        self.wrong_bytes = 0
        self.next_off = 0
        self.stop = asyncio.Event()
        self._tasks: list[asyncio.Task] = []

    def start(self) -> None:
        self._tasks = [
            asyncio.create_task(self._writer(i))
            for i in range(self.args.writers)
        ] + [
            asyncio.create_task(self._reader(i))
            for i in range(self.args.readers)
        ]

    async def drain(self) -> None:
        self.stop.set()
        await asyncio.gather(*self._tasks, return_exceptions=True)

    def clear_window(self) -> None:
        self.write_lat.clear()
        self.read_lat.clear()

    async def _writer(self, seed: int) -> None:
        while not self.stop.is_set():
            off, self.next_off = self.next_off, \
                self.next_off + self.args.write_size
            data = _block(off, self.args.write_size)[:self.args.write_size]
            t0 = time.perf_counter()
            try:
                res = await self.cluster.sc.write_file_range(
                    self.cr_lay, LOG_INODE, off, data)
                if all(r.status.code == int(StatusCode.OK) for r in res):
                    self.write_lat.append(time.perf_counter() - t0)
                    self.acked[off] = data
                else:
                    self.errors += 1
            except Exception:
                self.errors += 1
            await asyncio.sleep(0.01)

    async def _reader(self, seed: int) -> None:
        r = random.Random(seed)
        while not self.stop.is_set():
            kind = r.randrange(3)
            t0 = time.perf_counter()
            try:
                if kind == 0:       # seeded CR file
                    got, _ = await self.cluster.sc.read_file_range(
                        self.cr_lay, CR_INODE, 0, self.seeded_len)
                    want = _block(0, self.seeded_len)[:self.seeded_len]
                elif kind == 1 and self.acked:   # an acked log block
                    off = r.choice(list(self.acked))
                    want = self.acked[off]
                    got, _ = await self.cluster.sc.read_file_range(
                        self.cr_lay, LOG_INODE, off, len(want))
                else:               # first-k EC stripe read
                    s = r.randrange(self.args.stripes)
                    want = self.payloads[s]
                    got = await self.ec.read_stripe(
                        self.ec_lay, EC_INODE, s, self.stripe_len)
                self.read_lat.append(time.perf_counter() - t0)
                if got != want:
                    self.wrong_bytes += 1
            except Exception:
                self.errors += 1
            await asyncio.sleep(0.005)

    async def verify_all(self) -> None:
        """Final read-back of every byte the drill wrote or seeded."""
        await self.cluster.mgmtd_client.refresh()
        got, _ = await self.cluster.sc.read_file_range(
            self.cr_lay, CR_INODE, 0, self.seeded_len)
        if got != _block(0, self.seeded_len)[:self.seeded_len]:
            self.wrong_bytes += 1
        for off, want in sorted(self.acked.items()):
            got, _ = await self.cluster.sc.read_file_range(
                self.cr_lay, LOG_INODE, off, len(want))
            if got != want:
                self.wrong_bytes += 1
        for s in range(self.args.stripes):
            got = await self.ec.read_stripe(
                self.ec_lay, EC_INODE, s, self.stripe_len)
            if got != self.payloads[s]:
                self.wrong_bytes += 1


async def _setup_cell(args) -> tuple[LocalCluster, Foreground]:
    cluster = LocalCluster(num_nodes=args.nodes, replicas=args.replicas,
                           num_chains=args.cr_chains,
                           ec_chains=args.ec_chains,
                           heartbeat_timeout_s=0.6,
                           checksum_backend="cpu" if args.cpu else "cuda")
    await cluster.start()
    cr_lay = FileLayout(chunk_size=args.chunk_size,
                        chains=list(range(1, args.cr_chains + 1)))
    ec_lay = ECLayout.create(
        k=args.ec_k, m=args.ec_m, chunk_size=args.chunk_size,
        chains=list(range(args.cr_chains + 1,
                          args.cr_chains + args.ec_chains + 1)))
    ec = ECStorageClient(cluster.sc, codec=TorchECCodec(
        device="cpu" if args.cpu else "cuda"))
    seeded_len = 8 * args.chunk_size
    res = await cluster.sc.write_file_range(
        cr_lay, CR_INODE, 0, _block(0, seeded_len)[:seeded_len])
    assert all(r.status.code == int(StatusCode.OK) for r in res)
    stripe_len = args.ec_k * args.chunk_size
    payloads = [_block(s + 1, stripe_len)[:stripe_len]
                for s in range(args.stripes)]
    for s in range(args.stripes):
        res = await ec.write_stripe(ec_lay, EC_INODE, s, payloads[s])
        assert all(r.status.code == int(StatusCode.OK) for r in res), s
    fg = Foreground(cluster, ec, cr_lay, ec_lay, args, seeded_len, payloads)
    return cluster, fg


def _fg_stats(fg: Foreground) -> dict:
    return {
        "fg_write_p50_ms": round(_pctl(fg.write_lat, 0.5) * 1e3, 3),
        "fg_read_p50_ms": round(_pctl(fg.read_lat, 0.5) * 1e3, 3),
        "fg_read_p99_ms": round(_pctl(fg.read_lat, 0.99) * 1e3, 3),
        "fg_writes": len(fg.write_lat),
        "fg_reads": len(fg.read_lat),
    }


async def run_baseline(args) -> dict:
    cluster, fg = await _setup_cell(args)
    try:
        fg.start()
        await asyncio.sleep(args.warm_s)
        fg.clear_window()
        await asyncio.sleep(args.baseline_s)
        out = _fg_stats(fg)
        await fg.drain()
        await fg.verify_all()
        out.update({"name": "no_rebalance", "fg_errors": fg.errors,
                    "wrong_bytes": fg.wrong_bytes})
        return out
    finally:
        await fg.ec.close()
        await cluster.stop()


async def run_drill(args) -> dict:
    cluster, fg = await _setup_cell(args)
    mig = reb = None
    try:
        fg.start()
        await asyncio.sleep(args.warm_s)
        fg.clear_window()

        # --- add: an empty node joins the cluster
        ss = await cluster.add_storage_node()
        new_node = ss.node_id
        for _ in range(100):
            if new_node in cluster.mgmtd.state.routing().nodes:
                break
            await asyncio.sleep(0.05)
        mig = MigrationService(cluster.mgmtd_rpc.address,
                               client=cluster.admin, poll_period_s=0.05,
                               sync_timeout_s=60.0, flap_timeout_s=1.0)
        reb = Rebalancer(mig, budget_mbps=args.budget_mbps, max_inflight=4)
        t_reb = time.perf_counter()

        # tick until moves onto the new node are actually in flight
        loop = asyncio.get_running_loop()
        deadline = loop.time() + args.converge_s
        while loop.time() < deadline:
            rsp = await reb.tick()
            if rsp.submitted or any(j.state in ACTIVE_STATES
                                    for j in mig.jobs.values()):
                break
            await asyncio.sleep(0.1)
        else:
            raise TimeoutError("rebalancer never submitted a move")

        # --- flap: the new node fail-stops mid-move and comes back; the
        # down window exceeds flap_timeout_s, so in-flight joins onto it
        # fail RESUMABLE and the next plan tick re-drives them
        await cluster.kill_storage_node(new_node)
        await asyncio.sleep(1.6)
        await cluster.restart_storage_node(new_node)
        for _ in range(100):
            rsp, _ = await cluster.admin.call(
                cluster.mgmtd_rpc.address, "Mgmtd.list_nodes", None)
            row = next(r for r in rsp.nodes if r.node.node_id == new_node)
            if row.alive:
                break
            await asyncio.sleep(0.1)
        flapped = True

        # --- drain: tag one original node; it empties while serving
        routing = cluster.mgmtd.state.routing()
        victim = max(range(1, args.nodes + 1), key=lambda n: sum(
            1 for c in routing.chains.values()
            for t in c.targets if t.node_id == n))
        await cluster.admin.call(
            cluster.mgmtd_rpc.address, "Mgmtd.set_node_tags",
            NodeOpReq(node_id=victim, tags=["drain"]))

        # --- converge: tick until the solver wants nothing more
        deadline = loop.time() + args.converge_s
        converged = False
        while loop.time() < deadline:
            rsp = await reb.tick()
            bad = [j for j in mig.jobs.values()
                   if j.state == "failed" and not j.resumable]
            if bad:
                raise AssertionError(
                    f"non-resumable failures: "
                    f"{[(j.job_id, j.error) for j in bad]}")
            active = [j for j in mig.jobs.values()
                      if j.state in ACTIVE_STATES]
            if rsp.planned == 0 and not active:
                converged = True
                break
            await asyncio.sleep(0.2)
        elapsed = time.perf_counter() - t_reb
        out = _fg_stats(fg)
        await fg.drain()

        # --- post-drill structural checks
        routing = cluster.mgmtd.state.routing()
        victim_targets = [t.target_id for c in routing.chains.values()
                          for t in c.targets if t.node_id == victim]
        new_targets = [t.target_id for c in routing.chains.values()
                       for t in c.targets if t.node_id == new_node]
        all_serving = dups = True
        for c in routing.chains.values():
            ids = [t.target_id for t in c.targets]
            dups = dups and (len(ids) == len(set(ids)))
            all_serving = all_serving and all(
                t.public_state == PublicTargetState.SERVING
                for t in c.targets)
        cands, _ = await reb._candidates()
        solver_diff = sum(
            len(diff_table(routing, solve_for_routing(routing, tid, cands)))
            for tid in sorted(routing.chain_tables))
        await fg.verify_all()

        moves = list(reb.moves.values())
        resumed = reb.resumed
        out.update({
            "name": "rebalance_drill",
            "fg_errors": fg.errors, "wrong_bytes": fg.wrong_bytes,
            "new_node": new_node, "drained_node": victim,
            "flapped": flapped, "converged": converged,
            "converge_s": round(elapsed, 2),
            "moves_done": sum(1 for m in moves if m.state == "done"),
            "moves_total": len(moves),
            "jobs_resumed": resumed,
            "bytes_submitted": reb.bytes_submitted,
            "paced_waits": reb.pacer.waits,
            "paced_wait_s": round(reb.pacer.waited_s, 3),
            "pacer_allowance_bytes": int(
                args.budget_mbps * 1e6 * elapsed + reb.pacer.capacity),
            "new_node_targets": len(new_targets),
            "drained_node_targets": len(victim_targets),
            "all_serving": all_serving, "no_duplicate_targets": dups,
            "solver_diff_remaining": solver_diff,
        })
        return out
    finally:
        if reb is not None:
            await reb.stop()
        if mig is not None:
            await mig.stop()
        await fg.ec.close()
        await cluster.stop()


async def run_bench(args) -> dict:
    if args.smoke:
        args.warm_s = min(args.warm_s, 1.0)
        args.baseline_s = min(args.baseline_s, 4.0)
        args.stripes = min(args.stripes, 6)
        args.converge_s = min(args.converge_s, 120.0)
    base = await run_baseline(args)
    drill = await run_drill(args)

    p50_base = base["fg_read_p50_ms"]
    p50_drill = drill["fg_read_p50_ms"]
    gates = {
        "zero_wrong_bytes":
            base["wrong_bytes"] == 0 and drill["wrong_bytes"] == 0,
        "zero_fg_errors":
            base["fg_errors"] == 0 and drill["fg_errors"] == 0,
        # +0.5 ms additive floor so sub-ms baselines don't gate on noise
        "fg_p50_within_1p3x": p50_drill <= p50_base * 1.3 + 0.5,
        "paced_within_budget": drill["bytes_submitted"]
            <= drill["pacer_allowance_bytes"] * 1.05,
        "converged": bool(drill["converged"])
            and drill["solver_diff_remaining"] == 0
            and drill["drained_node_targets"] == 0
            and drill["new_node_targets"] >= 1
            and drill["all_serving"] and drill["no_duplicate_targets"],
    }
    return {
        "nodes": args.nodes, "replicas": args.replicas,
        "cr_chains": args.cr_chains, "ec_chains": args.ec_chains,
        "chunk_size": args.chunk_size,
        "ec": f"{args.ec_k}+{args.ec_m}", "stripes": args.stripes,
        "budget_mbps": args.budget_mbps, "smoke": args.smoke,
        "cells": [base, drill],
        "fg_p50_ratio": round(p50_drill / p50_base, 3) if p50_base else None,
        "gates": gates,
        "verified": all(gates.values()),
    }


def main(argv=None) -> int:
    args = parse_args(argv)
    # the card unless asked for the CPU: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    res = asyncio.run(run_bench(args))
    if args.json:
        print(json.dumps(res))
    else:
        json.dump(res, sys.stdout, indent=2)
        print()
    if not res["verified"]:
        bad = [k for k, v in res["gates"].items() if not v]
        print(f"FAIL: gates missed: {bad}", file=sys.stderr)
        return 1
    print("PASS: all rebalance drill gates met", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
