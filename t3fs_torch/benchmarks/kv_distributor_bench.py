"""KV distributor bench: an mdtest-style metadata storm on one hot DENT
range, A/B'd over the data distributor.

The resource model (in-process sharding buys no CPU parallelism, since
every group shares one event loop): each KV group runs on its own
WalKVEngine with a per-volume WRITE-BANDWIDTH cap (`rate_mbps`, the
cloud-disk discipline — volumes meter MB/s, and you scale aggregate
bandwidth by adding volumes).  A hot range pinned to one group is capped
at one volume's budget; the distributor's split-at-traffic-median +
move-to-idle-group genuinely doubles the aggregate budget.

Cells (fresh engines each):
  static     whole keyspace pinned to group 0, no distributor — the
             throughput cliff;
  distributor same start, KVDistributor on: it must split the hot DENT
             range at the sampled median and move a half to the idle
             group, with the map version monotonic throughout;
  presplit   operator-perfect layout from t=0 (uncontended baseline for
             the p99 gate).

A kill/restart drill then crashes the distributor's move mid-copy and
proves a fresh distributor's start() heals the orphan intent.

Gates (full mode; exit nonzero on any miss):
  * distributor steady-state (last-third) throughput >= 1.5x static;
  * distributor steady-state p99 <= 1.2x presplit p99;
  * auto-split fired and every map version observed is monotonic;
  * ZERO lost/wrong/ghost rows in every cell: read-back of every acked
    write (and absence of every acked unlink) after the storm;
  * the drill converges: intent cleared, resumed >= 1, read-back clean.
`--smoke` runs the correctness cells/gates only (no throughput gates —
machines vary), sized for ~1 minute.

    python -m t3fs_torch.benchmarks.kv_distributor_bench --smoke --json

The port of benchmarks/kv_distributor_bench.py (host code; no device
work): the same cells, flags, gates and JSON keys.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import shutil
import sys
import tempfile
import time

from t3fs_torch.kv.distributor import KVDistributor
from t3fs_torch.kv.engine import with_transaction
from t3fs_torch.kv.service import KvService
from t3fs_torch.kv.shard import KEY_MAX, ShardMap, ShardRange, ShardedKVEngine
from t3fs_torch.kv.surgery import ShardAdmin
from t3fs_torch.kv.wal_engine import WalKVEngine
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.utils.status import StatusError


def _pctl(xs: list[float], q: float) -> float:
    if not xs:
        return 0.0
    ys = sorted(xs)
    return ys[min(len(ys) - 1, int(q * len(ys)))]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, default=2)
    ap.add_argument("--rate-mbps", type=float, default=0.4,
                    help="per-group WAL write-bandwidth cap (the volume "
                         "budget the distributor multiplies)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--names-per-worker", type=int, default=150,
                    help="hot-directory working set per worker")
    ap.add_argument("--value-bytes", type=int, default=2048,
                    help="inline inode blob per dirent (sets how hard "
                         "creates lean on the volume budget)")
    ap.add_argument("--duration", type=float, default=24.0,
                    help="seconds per cell")
    ap.add_argument("--smoke", action="store_true",
                    help="correctness gates only, ~1 minute")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--seed", type=int, default=7)
    return ap.parse_args(argv)


class _Cell:
    """One deployment: N KvService groups over bandwidth-capped WAL
    engines, map home group 0."""

    def __init__(self, args, root: str):
        self.args = args
        self.root = root
        self.ship = Client()
        self.servers: list[Server] = []
        self.services: list[KvService] = []
        self.addrs: list[list[str]] = []
        self.admin: ShardAdmin | None = None
        self.kv: ShardedKVEngine | None = None

    async def start(self, pre_split: bytes | None = None):
        for i in range(self.args.groups):
            eng = WalKVEngine(f"{self.root}/g{i}", sync="os",
                              rate_mbps=self.args.rate_mbps)
            svc = KvService(eng, client=self.ship, prepare_timeout_s=10.0)
            srv = Server()
            srv.add_service(svc)
            await srv.start()
            self.servers.append(srv)
            self.services.append(svc)
            self.addrs.append([srv.address])
        if pre_split is None:
            ranges = [ShardRange(b"", KEY_MAX, self.addrs[0])]
        else:
            ranges = [ShardRange(b"", pre_split, self.addrs[0]),
                      ShardRange(pre_split, KEY_MAX, self.addrs[1])]
        m = ShardMap(ranges=ranges, version=1)
        self.admin = ShardAdmin(self.addrs[0], client=self.ship)
        await self.admin.publish_map(m)
        self.kv = ShardedKVEngine(m, client=self.ship,
                                  map_home=self.addrs[0])

    async def stop(self):
        for s in self.servers:
            await s.stop()
        for svc in self.services:
            svc.engine.close()
        await self.ship.close()


class _Storm:
    """mdtest-style closed loop on one hot directory: ~20% create
    (dirent + inline inode blob), ~70% stat (read-verify), ~10% unlink.
    Worker i owns a private slice of the namespace, so every result is
    deterministically checkable — any mismatch is a WRONG RESULT, not a
    race."""

    def __init__(self, cell: _Cell, args):
        self.cell = cell
        self.args = args
        self.expected: list[dict[bytes, bytes]] = [
            {} for _ in range(args.workers)]
        self.lat: list[tuple[float, float]] = []    # (end stamp, seconds)
        self.wrong = 0
        self.errors = 0
        self._stop = False
        self._tasks: list[asyncio.Task] = []

    def _names(self, i: int) -> list[bytes]:
        return [b"DENT/hot/%03d-%05d" % (i, j)
                for j in range(self.args.names_per_worker)]

    async def _one(self, i: int, rng, names, counter: list[int]) -> None:
        name = names[rng.randrange(len(names))]
        live = self.expected[i].get(name)
        r = rng.random()
        if r < 0.2 or live is None:
            counter[0] += 1
            val = (b"ino|%s|%010d|" % (name, counter[0])).ljust(
                self.args.value_bytes, b"x")

            async def create(txn):
                txn.set(name, val)
            await with_transaction(self.cell.kv, create)
            self.expected[i][name] = val
        elif r < 0.9:
            async def stat(txn):
                got = await txn.get(name)
                if got != live:
                    self.wrong += 1
            await with_transaction(self.cell.kv, stat)
        else:
            async def unlink(txn):
                txn.clear(name)
            await with_transaction(self.cell.kv, unlink)
            del self.expected[i][name]

    async def _worker(self, i: int) -> None:
        rng = random.Random(self.args.seed * 1000 + i)
        names = self._names(i)
        counter = [0]
        while not self._stop:
            t0 = time.monotonic()
            try:
                await self._one(i, rng, names, counter)
            except StatusError:
                # surgery window (frozen range / map flip): retryable
                # backpressure, not an error — the op is retried next loop
                await asyncio.sleep(0.05)
                continue
            except Exception:
                self.errors += 1
                await asyncio.sleep(0.05)
                continue
            self.lat.append((time.monotonic(), time.monotonic() - t0))

    def start(self):
        self._tasks = [asyncio.create_task(self._worker(i))
                       for i in range(self.args.workers)]

    async def stop(self):
        self._stop = True
        await asyncio.gather(*self._tasks, return_exceptions=True)

    async def verify(self) -> dict:
        """Read back EVERY acked write and every acked unlink."""
        lost = wrong = ghost = 0
        for i in range(self.args.workers):
            for name in self._names(i):
                async def check(txn, name=name, i=i):
                    nonlocal lost, wrong, ghost
                    got = await txn.get(name, snapshot=True)
                    want = self.expected[i].get(name)
                    if want is None:
                        if got is not None:
                            ghost += 1
                    elif got is None:
                        lost += 1
                    elif got != want:
                        wrong += 1
                await with_transaction(self.cell.kv, check)
        return {"lost": lost, "wrong_readback": wrong, "ghost": ghost,
                "wrong_inline": self.wrong, "errors": self.errors}

    def windowed(self, t_start: float, t_end: float) -> dict:
        xs = [(t, d) for t, d in self.lat if t_start <= t <= t_end]
        dur = max(t_end - t_start, 1e-9)
        lats = [d for _, d in xs]
        return {"ops_s": len(xs) / dur,
                "p50_ms": _pctl(lats, 0.50) * 1e3,
                "p99_ms": _pctl(lats, 0.99) * 1e3,
                "ops": len(xs)}


async def run_cell(args, name: str, *, with_dist: bool,
                   pre_split: bytes | None = None) -> dict:
    root = tempfile.mkdtemp(prefix=f"t3fs-kvdist-{name}-")
    cell = _Cell(args, root)
    dist = None
    versions: list[int] = []
    try:
        await cell.start(pre_split=pre_split)
        storm = _Storm(cell, args)
        storm.start()
        if with_dist:
            dist = KVDistributor(
                cell.addrs[0], client=cell.ship,
                tick_period_s=0.5, split_ops_threshold=5.0,
                merge_ops_threshold=0.2, imbalance_ratio=1.5,
                cooldown_s=1.0, resume_after_s=30.0,
                known_groups=[list(a) for a in cell.addrs])
            await dist.start()

        t0 = time.monotonic()
        t_end = t0 + args.duration
        while time.monotonic() < t_end:
            await asyncio.sleep(0.25)
            if with_dist:
                m = await cell.admin.load_map()
                versions.append(m.version)
        await storm.stop()
        if dist:
            await dist.stop()

        out = {"cell": name,
               "steady": storm.windowed(t0 + 2 * args.duration / 3, t_end),
               "whole": storm.windowed(t0, t_end)}
        out.update(await storm.verify())
        if with_dist:
            out["map_versions"] = versions
            out["map_monotonic"] = all(
                a <= b for a, b in zip(versions, versions[1:]))
            out["splits"] = dist.splits
            out["moves"] = dist.moves
            out["dist_errors"] = dist.errors
            out["actions"] = list(dist.last_actions)
        return out
    finally:
        if dist:
            await dist.close()
        await cell.stop()
        shutil.rmtree(root, ignore_errors=True)


async def run_restart_drill(args) -> dict:
    """Kill the distributor at both acceptance kill-points — (1) DURING
    the move's snapshot copy, (2) AFTER the source dropped ownership but
    BEFORE the map publish — and prove a restarted distributor heals the
    orphan intent on start() with zero lost/duplicate rows."""
    root = tempfile.mkdtemp(prefix="t3fs-kvdist-drill-")
    cell = _Cell(args, root)
    try:
        await cell.start()
        storm = _Storm(cell, args)
        # seed a working set without the closed loop
        for i in range(args.workers):
            names = storm._names(i)
            for j in range(0, len(names), 25):
                async def seed(txn, i=i, lo=j, names=names):
                    for name in names[lo:lo + 25]:
                        val = (b"ino|%s|seed|" % name).ljust(
                            args.value_bytes, b"x")
                        txn.set(name, val)
                        storm.expected[i][name] = val
                await with_transaction(cell.kv, seed)

        d1 = KVDistributor(cell.addrs[0], client=cell.ship,
                           tick_period_s=999.0, split_ops_threshold=1.0,
                           merge_ops_threshold=0.01, imbalance_ratio=1.5,
                           cooldown_s=0.0,
                           known_groups=[list(a) for a in cell.addrs])
        d1.admin.page_rows = 64
        d1.admin.freeze_ttl_s = 0.5
        # tick 1: a lone whole-keyspace range never moves (no spread
        # improvement), so the split fires first
        await d1.tick()
        killed = False
        import t3fs_torch.kv.remote as remote_mod
        real_call = remote_mod.RemoteKVEngine._call
        calls = {"n": 0}

        async def dying_call(self_, method, req, **kw):
            if method == "Kv.shard_load":
                calls["n"] += 1
                if calls["n"] == 2:
                    raise RuntimeError("distributor killed mid-copy")
            return await real_call(self_, method, req, **kw)

        remote_mod.RemoteKVEngine._call = dying_call
        try:
            # tick 2: MOVE runs before SPLIT — the rebalance of a split
            # half onto the idle group launches and dies mid-copy
            await d1.tick()
        except RuntimeError:
            killed = True
        finally:
            remote_mod.RemoteKVEngine._call = real_call
        intent_left = await cell.admin._load_intent() is not None
        await d1.close()
        await asyncio.sleep(0.6)            # the freeze lapses

        d2 = KVDistributor(cell.addrs[0], client=cell.ship,
                           tick_period_s=999.0, split_ops_threshold=1e9,
                           known_groups=[list(a) for a in cell.addrs])
        await d2.start()
        healed = d2.resumed >= 1 \
            and await cell.admin._load_intent() is None
        m = await cell.admin.load_map()
        await d2.close()

        # kill-point 2: the harshest window — the source already refuses
        # the range, the map still names it, only the intent knows
        async def dying_publish(pm, base_version=None):
            raise RuntimeError("killed after ownership drop")
        real_publish = cell.admin.publish_map
        tgt = m.ranges[0]
        dst = (cell.addrs[1]
               if sorted(tgt.addresses) == sorted(cell.addrs[0])
               else cell.addrs[0])
        cell.admin.publish_map = dying_publish
        killed2 = False
        try:
            await cell.admin.move(tgt.begin, tgt.end, dst)
        except RuntimeError:
            killed2 = True
        finally:
            cell.admin.publish_map = real_publish
        intent_left2 = await cell.admin._load_intent() is not None
        d3 = KVDistributor(cell.addrs[0], client=cell.ship,
                           tick_period_s=999.0, split_ops_threshold=1e9,
                           known_groups=[list(a) for a in cell.addrs])
        await d3.start()
        healed2 = d3.resumed >= 1 \
            and await cell.admin._load_intent() is None
        m = await cell.admin.load_map()
        await d3.close()

        out = await storm.verify()
        out.update({"drill": "kill-restart-mid-copy+after-ownership-drop",
                    "split_fired": d1.splits >= 1, "killed": killed,
                    "intent_survived_kill": intent_left,
                    "healed_on_restart": healed,
                    "killed_after_drop": killed2,
                    "intent_survived_drop_kill": intent_left2,
                    "healed_after_drop": healed2,
                    "final_ranges": len(m.ranges),
                    "final_map_version": m.version})
        return out
    finally:
        await cell.stop()
        shutil.rmtree(root, ignore_errors=True)


async def main_async(args) -> int:
    if args.smoke:
        args.duration = min(args.duration, 12.0)
        args.names_per_worker = min(args.names_per_worker, 100)

    result: dict = {"bench": "kv_distributor", "config": {
        "groups": args.groups, "rate_mbps": args.rate_mbps,
        "workers": args.workers, "value_bytes": args.value_bytes,
        "duration_s": args.duration, "smoke": args.smoke}}

    cell_b = await run_cell(args, "distributor", with_dist=True)
    result["distributor"] = cell_b
    gates = {
        "auto_split_fired": cell_b["splits"] >= 1,
        "map_monotonic": cell_b["map_monotonic"],
        "zero_lost": cell_b["lost"] == 0,
        "zero_wrong": cell_b["wrong_readback"] == 0
        and cell_b["wrong_inline"] == 0 and cell_b["ghost"] == 0,
        "zero_errors": cell_b["errors"] == 0,
    }

    drill = await run_restart_drill(args)
    result["restart_drill"] = drill
    gates["restart_converges"] = (drill["split_fired"] and drill["killed"]
                                  and drill["intent_survived_kill"]
                                  and drill["healed_on_restart"]
                                  and drill["killed_after_drop"]
                                  and drill["intent_survived_drop_kill"]
                                  and drill["healed_after_drop"]
                                  and drill["lost"] == 0
                                  and drill["ghost"] == 0
                                  and drill["wrong_readback"] == 0)

    if not args.smoke:
        cell_a = await run_cell(args, "static", with_dist=False)
        result["static"] = cell_a
        # the operator-perfect layout: split at the namespace median
        mid = b"DENT/hot/%03d-%05d" % (args.workers // 2, 0)
        cell_c = await run_cell(args, "presplit", with_dist=False,
                                pre_split=mid)
        result["presplit"] = cell_c
        for c in (cell_a, cell_c):
            gates["zero_lost"] &= c["lost"] == 0
            gates["zero_wrong"] &= (c["wrong_readback"] == 0
                                    and c["wrong_inline"] == 0
                                    and c["ghost"] == 0)
        b, a, c = (cell_b["steady"]["ops_s"], cell_a["steady"]["ops_s"],
                   cell_c["steady"]["ops_s"])
        gates["throughput_1p5x"] = b >= 1.5 * a
        gates["p99_within_1p2x"] = (cell_b["steady"]["p99_ms"]
                                    <= 1.2 * cell_c["steady"]["p99_ms"])
        result["speedup_vs_static"] = round(b / max(a, 1e-9), 2)
        result["presplit_ops_s"] = round(c, 1)

    result["gates"] = gates
    result["ok"] = all(gates.values())
    if args.json:
        print(json.dumps(result, indent=2, default=str))
    else:
        for k, v in gates.items():
            print(f"  gate {k}: {'PASS' if v else 'FAIL'}")
        print(f"ok={result['ok']}")
    return 0 if result["ok"] else 1


def main(argv=None) -> int:
    return asyncio.run(main_async(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())
