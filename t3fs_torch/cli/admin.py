"""t3fs admin CLI: one-shot commands + interactive shell.

The port of t3fs/cli/admin.py.  Reference analog: src/client/cli/ +
src/client/bin/admin_cli.cc — the interactive admin shell with command
families for cluster management (ListNodes, UploadChainTable,
DumpChainTable), config (GetConfig/HotUpdateConfig/VerifyConfig), users,
file ops, chunk-meta dumps, checksums and a quick bench
(registerAdminCommands.cc).

The same 80 commands as the reference, under its names, help strings and
arguments.  One addition: the global `--cpu`.  Only `ckpt-verify` does
device work in the CLI's own process (the stripe codec of its
ECStorageClient): a `TorchECCodec` on the card by default, on its plain
versions with `--cpu`; without a GPU and without `--cpu` it raises before
it connects.  Every other command runs without a GPU, as the
reference's does.

Usage:
    python -m t3fs_torch.cli.admin --mgmtd 127.0.0.1:9000 list-nodes
    python -m t3fs_torch.cli.admin --mgmtd ... --meta ... ls /
    python -m t3fs_torch.cli.admin --mgmtd ... --meta ... ckpt-verify DIR
    python -m t3fs_torch.cli.admin --cpu --mgmtd ... --meta ... ckpt-verify DIR
    python -m t3fs_torch.cli.admin --mgmtd ...            # interactive shell
"""

from __future__ import annotations

import argparse
import asyncio
import json
import shlex
import sys
import time

from t3fs_torch.client.ec_client import SUPPORTED_LOCAL_SCHEMES
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.client.meta_client import MetaClient
from t3fs_torch.client.mgmtd_client import MgmtdClient
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.core.service import (
    EchoReq, GetConfigReq, HotUpdateConfigReq, RenderConfigReq, UserInfo,
    UserReq,
)
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.mgmtd.service import (
    ClusterHealthReq, GetConfigTemplateReq, SetChainsReq,
    SetConfigTemplateReq,
)
from t3fs_torch.mgmtd.types import (
    ChainInfo, ChainTable, ChainTargetInfo, PublicTargetState,
)
from t3fs_torch.monitor.service import (
    HealthReq, QueryMetricsReq, QuerySpansReq, SloReportReq,
)
from t3fs_torch.net.client import Client
from t3fs_torch.ops.codec import crc32c
from t3fs_torch.storage.types import SyncStartReq
from t3fs_torch.utils.status import StatusCode, StatusError

COMMANDS: dict[str, tuple] = {}    # name -> (configure_fn, handler, help)


def command(name: str, help_: str):
    def deco(fn):
        COMMANDS[name] = (getattr(fn, "_configure", lambda p: None), fn, help_)
        return fn
    return deco


def args_(*specs):
    """Attach positional/option specs: ("name", {kwargs})."""
    def deco(fn):
        def configure(p: argparse.ArgumentParser):
            for spec in specs:
                flag, kw = spec
                p.add_argument(flag, **kw)
        fn._configure = configure
        return fn
    return deco


class AdminContext:
    def __init__(self, mgmtd: str, meta: str = "", monitor: str = "",
                 token: str = "", migration: str = "",
                 device: str = "cuda"):
        self.mgmtd_address = mgmtd
        self.meta_address = meta
        self.monitor_address = monitor
        self.migration_address = migration
        self.token = token
        self.device = device        # ckpt-verify's stripe codec
        self.cli = Client()
        self._mgmtd_client: MgmtdClient | None = None
        self._fs: FileSystem | None = None
        self._sc: StorageClient | None = None
        self._codec: TorchECCodec | None = None

    async def mgmtd_client(self) -> MgmtdClient:
        if self._mgmtd_client is None:
            self._mgmtd_client = MgmtdClient(self.mgmtd_address,
                                             refresh_period_s=0.5)
            await self._mgmtd_client.start()
        return self._mgmtd_client

    async def storage_client(self) -> StorageClient:
        if self._sc is None:
            mg = await self.mgmtd_client()
            self._sc = StorageClient(mg.routing, config=StorageClientConfig(),
                                     refresh_routing=mg.refresh)
        return self._sc

    async def fs(self) -> FileSystem:
        if self._fs is None:
            if not self.meta_address:
                raise SystemExit("file commands need --meta ADDR")
            self._fs = FileSystem(MetaClient([self.meta_address]),
                                  await self.storage_client())
        return self._fs

    def ec_codec(self) -> TorchECCodec:
        """The one stripe codec of this context, built on first use: on the
        card unless the context was made with device="cpu".  A caller that
        holds the context reads its `codec_counts`."""
        if self._codec is None:
            self._codec = TorchECCodec(device=self.device)
        return self._codec

    async def close(self) -> None:
        if self._codec is not None:
            await self._codec.close()
        if self._fs is not None:
            await self._fs.meta.close_conn()
        if self._sc is not None:
            await self._sc.close()
        if self._mgmtd_client is not None:
            await self._mgmtd_client.stop()
        await self.cli.close()


def _fmt_table(rows: list[list], headers: list[str]) -> str:
    cols = [headers] + [[str(c) for c in r] for r in rows]
    widths = [max(len(r[i]) for r in cols) for i in range(len(headers))]
    out = ["  ".join(h.ljust(w) for h, w in zip(headers, widths))]
    for r in cols[1:]:
        out.append("  ".join(c.ljust(w) for c, w in zip(r, widths)))
    return "\n".join(out)


def _fmt_bytes(n: int) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{n}B"
        n /= 1024
    return f"{n}B"


# ---------------- cluster ----------------

@command("list-nodes", "registered nodes + liveness (ListNodes)")
async def list_nodes(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.list_nodes", None)
    rows = [[s.node.node_id, s.node.node_type, s.node.address,
             "up" if s.alive else "DOWN",
             f"{s.last_heartbeat_age_s:.1f}s" if s.last_heartbeat_age_s >= 0
             else "never"]
            for s in rsp.nodes]
    print(_fmt_table(rows, ["id", "type", "address", "state", "hb-age"]))


@command("repair-status", "scrub/repair health pushed by scrub schedulers")
async def repair_status(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.repair_status",
                                None)
    if not rsp.rows:
        print("no scrub schedulers have reported")
        return
    now = time.time()
    # survivor-bytes ratio: what each rebuilt byte cost the fabric.
    # full-k RS repair pays ~k/1, lrc-xor ~group_size/1, pm-msr 0.5625
    rows = [[r.source, f"{now - r.ts:.1f}s", r.repair_mode,
             f"{r.budget_mbps:g}" if r.budget_mbps else "off",
             r.stripes_scanned, r.shards_lost + r.shards_corrupt,
             r.repaired_shards, r.stripes_failed,
             _fmt_bytes(r.bytes_read), _fmt_bytes(r.bytes_repaired),
             (f"{r.bytes_read / r.bytes_repaired:.2f}x"
              if r.bytes_repaired else "-"),
             f"{r.paced_wait_s:.2f}s"]
            for r in rsp.rows]
    print(_fmt_table(rows, ["source", "age", "mode", "MB/s", "scanned",
                            "damaged", "repaired", "failed", "read",
                            "rebuilt", "amp", "paced"]))


@command("lease", "current mgmtd primary lease")
async def lease(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.get_lease", None)
    ttl = rsp.expires_at - time.time()
    print(f"primary=node{rsp.holder_node} addr={rsp.holder_address} "
          f"ttl={ttl:.1f}s")


@command("routing", "dump RoutingInfo (DumpChainTable analog)")
async def routing(ctx: AdminContext, args) -> None:
    mg = await ctx.mgmtd_client()
    info = await mg.refresh()
    print(f"version={info.version} bootstrapping={info.bootstrapping}")
    for table_id, table in sorted(info.chain_tables.items()):
        print(f"chain-table {table_id}: chains={table.chain_ids}")
    rows = []
    for chain in sorted(info.chains.values(), key=lambda c: c.chain_id):
        for t in chain.targets:
            rows.append([chain.chain_id, chain.chain_ver, t.target_id,
                         t.node_id, t.public_state.name])
    print(_fmt_table(rows, ["chain", "ver", "target", "node", "state"]))


def _require_meta(ctx: AdminContext) -> str:
    if not ctx.meta_address:
        raise SystemExit("this command needs --meta ADDR")
    return ctx.meta_address


def _print_chain(chain) -> None:
    print(f"chain {chain.chain_id} v{chain.chain_ver}: " + " -> ".join(
        f"t{t.target_id}@n{t.node_id}[{t.public_state.name}]"
        for t in chain.targets)
        + (f" preferred={chain.preferred_target_order}"
           if chain.preferred_target_order else ""))


@command("rotate-lastsrv", "rotate a chain's LASTSRV holder (RotateLastSrv)")
@args_(("chain_id", {"type": int}))
async def rotate_lastsrv(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import ChainOpReq
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.rotate_last_srv",
                                ChainOpReq(chain_id=args.chain_id))
    _print_chain(rsp.chain)


@command("update-chain", "add/remove a target on a chain (UpdateChain)")
@args_(("chain_id", {"type": int}), ("mode", {"choices": ["add", "remove"]}),
       ("target_id", {"type": int}),
       ("--node", {"type": int, "default": 0, "help": "node id (add mode)"}))
async def update_chain(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import ChainOpReq
    rsp, _ = await ctx.cli.call(
        ctx.mgmtd_address, "Mgmtd.update_chain",
        ChainOpReq(chain_id=args.chain_id, target_id=args.target_id,
                   node_id=args.node, mode=args.mode))
    _print_chain(rsp.chain)


@command("set-preferred-order", "set a chain's preferred target order")
@args_(("chain_id", {"type": int}),
       ("order", {"nargs": "+", "type": int}))
async def set_preferred_order(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import ChainOpReq
    rsp, _ = await ctx.cli.call(
        ctx.mgmtd_address, "Mgmtd.set_preferred_target_order",
        ChainOpReq(chain_id=args.chain_id, order=list(args.order)))
    _print_chain(rsp.chain)


@command("kv-status", "probe KV service nodes (role, replication seq)")
@args_(("addresses", {"nargs": "+", "help": "kv node addresses"}))
async def kv_status(ctx: AdminContext, args) -> None:
    import t3fs_torch.kv.service  # noqa: F401  (registers serde structs)
    for addr in args.addresses:
        try:
            rsp, _ = await ctx.cli.call(addr, "Kv.status", None, timeout=5.0)
            role = "primary" if rsp.ok else "follower"
            print(f"{addr}: {role} seq={rsp.seq}")
        except StatusError as e:
            print(f"{addr}: unreachable ({e.code.name})")


@command("trace-read", "print storage trace rows (Parquet event log)")
@args_(("paths", {"nargs": "+", "help": "trace files/dirs/globs"}),
       ("--limit", {"type": int, "default": 50}),
       ("--chain", {"type": int, "default": 0}),
       ("--node", {"type": int, "default": 0}),
       ("--errors-only", {"action": "store_true"}))
async def trace_read(ctx: AdminContext, args) -> None:
    from t3fs_torch.analytics.trace_query import iter_rows
    n = 0
    try:
        for row in iter_rows(list(args.paths), chain=args.chain,
                             node=args.node,
                             errors_only=args.errors_only):
            print(f"{row['ts']:.6f} node={row['node_id']} "
                  f"target={row['target_id']} chain={row['chain_id']} "
                  f"chunk={row['chunk_id']} {row['update_type']} "
                  f"len={row['length']} status={row['commit_status']} "
                  f"lat={row['latency_s'] * 1e3:.3f}ms")
            n += 1
            if args.limit and n >= args.limit:
                break
    except (OSError, FileNotFoundError) as e:
        print(f"trace read failed: {e}")
        return
    print(f"({n} rows)")


@command("trace-top", "latency/error breakdown from storage traces "
                      "(p50/p99 per node/target/chain/type)")
@args_(("paths", {"nargs": "+", "help": "trace files/dirs/globs"}),
       ("--by", {"choices": ["node", "target", "chain", "type", "status"],
                 "default": "target"}),
       ("--chain", {"type": int, "default": 0}),
       ("--node", {"type": int, "default": 0}))
async def trace_top(ctx: AdminContext, args) -> None:
    from t3fs_torch.analytics.trace_query import top
    try:
        stats = top(list(args.paths), by=args.by, chain=args.chain,
                    node=args.node)
    except (OSError, FileNotFoundError) as e:
        print(f"trace read failed: {e}")
        return
    if not stats:
        print("no rows")
        return
    rows = [[g.key, g.count, g.errors, f"{g.bytes / 1e6:.2f}",
             f"{g.p50_ms:.3f}", f"{g.p99_ms:.3f}", f"{g.max_ms:.3f}",
             f"{g.mean_ms:.3f}"] for g in stats]
    print(_fmt_table(rows, ["group", "count", "errors", "MB", "p50ms",
                            "p99ms", "maxms", "meanms"]))


@command("rpc-top", "RPC latency decomposition (queue/server/network "
                    "split per method, p50/p99) from T3FS_RPC_STATS "
                    "dumps or live nodes (--live)")
@args_(("paths", {"nargs": "+",
                  "help": "rpc-stats JSON files (one per process; set "
                          "T3FS_RPC_STATS=<path> on a bench/server run "
                          "to produce them) — or node addresses with "
                          "--live"}),
       ("--live", {"action": "store_true",
                   "help": "treat arguments as host:port node addresses "
                           "and pull Core.getRpcStats from each"}),
       ("--sort", {"default": "total_p99_ms",
                   "help": "column to sort by (default total_p99_ms)"}),
       ("--limit", {"type": int, "default": 30}))
async def rpc_top(ctx: AdminContext, args) -> None:
    import glob as _glob
    import json as _json
    from t3fs_torch.net.rpcstats import render_top
    snaps = []
    if args.live:
        for addr in args.paths:
            try:
                rsp, _ = await ctx.cli.call(addr, "Core.getRpcStats",
                                            timeout=10.0)
                snaps.append(_json.loads(rsp.stats_json))
            except StatusError as e:
                print(f"{addr}: unreachable ({e.code.name})")
            except (ValueError, OSError) as e:
                # bad address / undecodable stats: skip the node, keep
                # rendering the healthy ones (parity with the file path)
                print(f"{addr}: skipped ({e})")
    else:
        for pat in args.paths:
            for path in sorted(_glob.glob(pat)) or [pat]:
                try:
                    # t3fslint: allow(blocking-in-async) — single-shot CLI tool, no served traffic on this loop
                    with open(path) as f:
                        snaps.append(_json.load(f))
                except (OSError, ValueError) as e:
                    print(f"skipping {path}: {e}")
    if not any(snaps):
        print("no rpc stats found")
        return
    print(render_top(snaps, sort_by=args.sort, limit=args.limit))


@command("read-stats", "per-address read latency quantiles, in-flight "
                       "counts, and hedge fired/won/wasted counters from "
                       "T3FS_READ_STATS dumps (adaptive read path "
                       "observability)")
@args_(("paths", {"nargs": "+",
                  "help": "read-stats JSON files (one per process; set "
                          "T3FS_READ_STATS=<path> on a bench/client run "
                          "to produce them at exit)"}),
       ("--limit", {"type": int, "default": 40}))
async def read_stats(ctx: AdminContext, args) -> None:
    import glob as _glob
    import json as _json
    from t3fs_torch.net.rpcstats import render_read_stats
    snaps = []
    for pat in args.paths:
        for path in sorted(_glob.glob(pat)) or [pat]:
            try:
                # t3fslint: allow(blocking-in-async) — single-shot CLI tool
                with open(path) as f:
                    snaps.append(_json.load(f))
            except (OSError, ValueError) as e:
                print(f"skipping {path}: {e}")
    if not any(snaps):
        print("no read stats found")
        return
    print(render_read_stats(snaps, limit=args.limit))


@command("kvcache-stats", "per-namespace KVCache tier stats (hit-rate, "
                          "dirty bytes, eviction counters) merged from "
                          "T3FS_KVCACHE_STATS dump files")
@args_(("paths", {"nargs": "+",
                  "help": "kvcache-stats JSON files (one per process; "
                          "set T3FS_KVCACHE_STATS=<prefix> on a "
                          "fleet/bench run to produce them at exit)"}))
async def kvcache_stats(ctx: AdminContext, args) -> None:
    import glob as _glob
    import json as _json
    from t3fs_torch.kvcache import render_kvcache_stats
    snaps = []
    for pat in args.paths:
        for path in sorted(_glob.glob(pat)) or [pat]:
            try:
                # t3fslint: allow(blocking-in-async) — single-shot CLI tool
                with open(path) as f:
                    snaps.append(_json.load(f))
            except (OSError, ValueError) as e:
                print(f"skipping {path}: {e}")
    print(render_kvcache_stats(snaps))


@command("kv-publish-map", "bootstrap the versioned shard map from a "
                           "shards spec (group;hexsplit;group;...)")
@args_(("spec", {"help": "same grammar as the 'shards:' engine spec, "
                         "e.g. 'h1:1,h2:1;494e4f44;h3:1'"}))
async def kv_publish_map(ctx: AdminContext, args) -> None:
    from t3fs_torch.kv.shard import KEY_MAX, ShardMap, ShardRange
    from t3fs_torch.kv.surgery import ShardAdmin
    parts = args.spec.split(";")
    if len(parts) % 2 != 1:
        raise SystemExit("spec must alternate group;splitkey;group;...")
    groups = [p.split(",") for p in parts[0::2]]
    splits = [bytes.fromhex(p) for p in parts[1::2]]
    bounds = [b""] + splits + [KEY_MAX]
    m = ShardMap(ranges=[ShardRange(bounds[i], bounds[i + 1], groups[i])
                         for i in range(len(groups))], version=1)
    admin = ShardAdmin(groups[0], client=ctx.cli)
    try:
        cur = await admin.load_map()
        raise SystemExit(f"map already published (v{cur.version}); "
                         f"surgery commands evolve it from here")
    except StatusError as e:
        if e.code != StatusCode.NOT_FOUND:
            raise
    await admin.publish_map(m)
    print(f"published shard map v1: {len(m.ranges)} ranges "
          f"(map home {groups[0]})")


@command("kv-map", "show the published shard map with per-range load "
                   "and any in-flight surgery intent")
@args_(("map_home", {"nargs": "+", "help": "map-home group addresses"}),
       ("--no-load", {"action": "store_true",
                      "help": "skip the per-range Kv.range_stats pull"}))
async def kv_map(ctx: AdminContext, args) -> None:
    from t3fs_torch.kv.service import KvRangeStatsReq
    from t3fs_torch.kv.surgery import ShardAdmin
    admin = ShardAdmin(list(args.map_home), client=ctx.cli)
    m = await admin.load_map()
    print(f"shard map v{m.version}: {len(m.ranges)} ranges")
    loads: dict = {}
    if not args.no_load:
        # best-effort: a group that can't answer must not hide the map
        by_group: dict = {}
        for r in m.ranges:
            by_group.setdefault(tuple(r.addresses), []).append(r)
        for group, ranges in by_group.items():
            req = KvRangeStatsReq(begins=[r.begin for r in ranges],
                                  ends=[r.end for r in ranges])
            try:
                rsp = await admin._group(list(group))._call(
                    "Kv.range_stats", req)
            except (StatusError, OSError) as e:
                print(f"  ! range_stats from {','.join(group)} "
                      f"unavailable: {e}")
                continue
            for i in range(len(rsp.begins)):
                loads[(rsp.begins[i], rsp.ends[i])] = (
                    rsp.read_ops_s[i], rsp.write_ops_s[i],
                    rsp.read_bytes_s[i] + rsp.write_bytes_s[i],
                    rsp.rows[i], rsp.approx_bytes[i], rsp.split_keys[i])
    for r in m.ranges:
        line = f"  [{r.begin!r}, {r.end!r}) -> {', '.join(r.addresses)}"
        st = loads.get((r.begin, r.end))
        if st is not None:
            ro, wo, bs, rows, ab, sk = st
            line += (f"  {ro:.0f}r/s {wo:.0f}w/s {bs / 1e6:.2f}MB/s"
                     f" rows={rows} ~{ab / 1e6:.2f}MB")
            if sk:
                line += f" split@{sk!r}"
        print(line)
    intent = await admin._load_intent()
    if intent is not None:
        print(f"in-flight {intent.kind} intent: "
              f"[{intent.begin!r}, {intent.end!r}) "
              f"{','.join(intent.src)} -> {','.join(intent.dst)} "
              f"(kv-move-resume finishes it)")


@command("kv-split", "split the shard range containing KEY in place")
@args_(("key", {"help": "split key (becomes a range boundary)"}),
       ("map_home", {"nargs": "+", "help": "map-home group addresses"}))
async def kv_split(ctx: AdminContext, args) -> None:
    from t3fs_torch.kv.surgery import ShardAdmin
    admin = ShardAdmin(list(args.map_home), client=ctx.cli)
    m = await admin.split(args.key.encode())
    print(f"map v{m.version}: {len(m.ranges)} ranges")


@command("kv-move", "move the exact shard range [BEGIN,END) to a group")
@args_(("begin", {"help": "range begin (must be a map boundary)"}),
       ("end", {"help": "range end ('MAX' for keyspace end)"}),
       ("to", {"nargs": "+", "help": "target group addresses"}),
       ("--map-home", {"nargs": "+", "required": True,
                       "help": "map-home group addresses"}))
async def kv_move(ctx: AdminContext, args) -> None:
    from t3fs_torch.kv.shard import KEY_MAX
    from t3fs_torch.kv.surgery import ShardAdmin
    admin = ShardAdmin(list(args.map_home), client=ctx.cli)
    end = KEY_MAX if args.end == "MAX" else args.end.encode()
    m = await admin.move(args.begin.encode(), end, list(args.to))
    print(f"moved; map v{m.version}")


@command("kv-merge", "merge the adjacent shard ranges spanning exactly "
                     "[BEGIN,END) back into one")
@args_(("begin", {"help": "left range begin (a map boundary)"}),
       ("end", {"help": "right range end ('MAX' for keyspace end)"}),
       ("--map-home", {"nargs": "+", "required": True,
                       "help": "map-home group addresses"}),
       ("--move-first", {"action": "store_true",
                         "help": "if the halves live on different groups, "
                                 "move the right one onto the left's "
                                 "group first (full data move)"}))
async def kv_merge(ctx: AdminContext, args) -> None:
    from t3fs_torch.kv.shard import KEY_MAX
    from t3fs_torch.kv.surgery import ShardAdmin
    admin = ShardAdmin(list(args.map_home), client=ctx.cli)
    end = KEY_MAX if args.end == "MAX" else args.end.encode()
    m = await admin.merge(args.begin.encode(), end,
                          move_first=args.move_first)
    print(f"merged; map v{m.version}: {len(m.ranges)} ranges")


@command("kv-move-resume", "finish a shard move whose driver died")
@args_(("map_home", {"nargs": "+", "help": "map-home group addresses"}))
async def kv_move_resume(ctx: AdminContext, args) -> None:
    from t3fs_torch.kv.surgery import ShardAdmin
    admin = ShardAdmin(list(args.map_home), client=ctx.cli)
    m = await admin.resume()
    print(f"resumed; map v{m.version}" if m else "no pending move intent")


@command("enable-node", "re-enable an administratively disabled node")
@args_(("node_id", {"type": int}))
async def enable_node(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import NodeOpReq
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.enable_node",
                                NodeOpReq(node_id=args.node_id))
    print(f"node {rsp.node.node_id}: {rsp.node.status.name}")


@command("disable-node", "administratively drain a node (targets walk out)")
@args_(("node_id", {"type": int}))
async def disable_node(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import NodeOpReq
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.disable_node",
                                NodeOpReq(node_id=args.node_id))
    print(f"node {rsp.node.node_id}: {rsp.node.status.name}")


@command("unregister-node", "retire a node record (must be off all chains)")
@args_(("node_id", {"type": int}))
async def unregister_node(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import NodeOpReq
    await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.unregister_node",
                       NodeOpReq(node_id=args.node_id))
    print(f"node {args.node_id} unregistered")


@command("node-tags", "set a node's operator tags")
@args_(("node_id", {"type": int}), ("tags", {"nargs": "*"}))
async def node_tags(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import NodeOpReq
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.set_node_tags",
                                NodeOpReq(node_id=args.node_id,
                                          tags=list(args.tags)))
    print(f"node {rsp.node.node_id} tags: {rsp.node.tags}")


@command("universal-tags", "get or set cluster-wide tags")
@args_(("tags", {"nargs": "*", "help": "omit to get"}),
       ("--set", {"action": "store_true", "dest": "do_set"}))
async def universal_tags(ctx: AdminContext, args) -> None:
    if args.do_set or args.tags:
        from t3fs_torch.mgmtd.service import UniversalTagsReq
        await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.set_universal_tags",
                           UniversalTagsReq(tags=list(args.tags)))
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address,
                                "Mgmtd.get_universal_tags", None)
    print(f"universal tags: {rsp.tags}")


@command("orphan-targets", "heartbeated targets referenced by no chain")
async def orphan_targets(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address,
                                "Mgmtd.list_orphan_targets", None)
    if not rsp.targets:
        print("no orphan targets")
    for t in rsp.targets:
        print(f"target {t.target_id} on node {t.node_id} "
              f"({t.local_state.name})")


@command("config-versions", "distributed config template fingerprints")
async def config_versions(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address,
                                "Mgmtd.get_config_versions", None)
    if not rsp.versions:
        print("no templates")
    for ntype, ver in sorted(rsp.versions.items()):
        print(f"{ntype}: {ver:08x}")


@command("migrate", "move a target to another node (migration service job)")
@args_(("chain_id", {"type": int}), ("src_target_id", {"type": int}),
       ("dst_target_id", {"type": int}), ("dst_node_id", {"type": int}),
       ("dst_root", {}),
       )
async def migrate(ctx: AdminContext, args) -> None:
    if not ctx.migration_address:
        raise StatusError(StatusCode.INVALID_ARG,
                          "--migration <addr> required")
    from t3fs_torch.migration.service import SubmitMigrationReq
    rsp, _ = await ctx.cli.call(
        ctx.migration_address, "Migration.submit",
        SubmitMigrationReq(chain_id=args.chain_id,
                           src_target_id=args.src_target_id,
                           dst_target_id=args.dst_target_id,
                           dst_node_id=args.dst_node_id,
                           dst_root=args.dst_root))
    print(f"job {rsp.job_id} submitted")


@command("migrate-status", "list migration jobs and their states")
async def migrate_status(ctx: AdminContext, args) -> None:
    if not ctx.migration_address:
        raise StatusError(StatusCode.INVALID_ARG,
                          "--migration <addr> required")
    import t3fs_torch.migration.service  # noqa: F401  (registers serde structs)
    rsp, _ = await ctx.cli.call(ctx.migration_address, "Migration.status",
                                None)
    if not rsp.jobs:
        print("no jobs")
    for j in rsp.jobs:
        print(f"job {j.job_id}: chain {j.chain_id} "
              f"{j.src_target_id}->{j.dst_target_id}@{j.dst_node_id} "
              f"state={j.state} error={j.error!r}")


@command("rebalance-status", "online rebalancer: planned/active/settled "
         "chain moves, pacing counters")
async def rebalance_status(ctx: AdminContext, args) -> None:
    if not ctx.migration_address:
        raise StatusError(StatusCode.INVALID_ARG,
                          "--migration <addr> required (migration_main "
                          "hosts the Rebalance service)")
    import t3fs_torch.migration.rebalancer  # noqa: F401  (registers serde structs)
    rsp, _ = await ctx.cli.call(ctx.migration_address, "Rebalance.status",
                                None)
    print(f"rebalancer: {'running' if rsp.enabled else 'stopped'} "
          f"budget={rsp.budget_mbps:g}MB/s ticks={rsp.ticks} "
          f"resumed={rsp.resumed}")
    print(f"moves: planned={rsp.planned} submitted={rsp.submitted} "
          f"deferred={rsp.deferred} done={rsp.done} failed={rsp.failed}")
    print(f"pacing: {rsp.bytes_submitted} bytes submitted, "
          f"{rsp.paced_waits} waits ({rsp.paced_wait_s:.2f}s)")
    rows = [[m.table_id, m.chain_id,
             f"t{m.src_target_id}@n{m.src_node_id}",
             f"t{m.dst_target_id}@n{m.dst_node_id}",
             m.state, m.job_id or "-", m.reason]
            for m in rsp.moves]
    if rows:
        print(_fmt_table(rows, ["table", "chain", "src", "dst", "state",
                                "job", "reason"]))


@command("rotate-preferred", "one rotation step toward the preferred order")
@args_(("chain_id", {"type": int}))
async def rotate_preferred(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.service import ChainOpReq
    rsp, _ = await ctx.cli.call(
        ctx.mgmtd_address, "Mgmtd.rotate_as_preferred_order",
        ChainOpReq(chain_id=args.chain_id))
    _print_chain(rsp.chain)


@command("client-sessions", "registered client sessions (ListClientSessions)")
async def client_sessions(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address,
                                "Mgmtd.list_client_sessions", None)
    now = time.time()
    rows = [[s.client_id, s.description,
             f"{now - s.start:.0f}s" if s.start else "-",
             f"{now - s.last_extend:.1f}s"] for s in rsp.sessions]
    print(_fmt_table(rows, ["client", "description", "age", "extend-age"]))


@command("gen-chains", "generate + optionally install a chain table "
         "(CR replicated / EC single-replica shard chains)")
@args_(("--nodes", {"required": True,
                    "help": "comma-separated storage node ids"}),
       ("--replicas", {"type": int, "default": 3}),
       ("--chains", {"type": int, "default": 1}),
       ("--table-type", {"choices": ("cr", "ec"), "default": "cr",
                         "help": "cr = replicated chains (BIBD recovery-"
                                 "balanced), ec = single-replica shard "
                                 "chains (rendezvous-placed) serving "
                                 "ECLayout stripes (local_scheme one of "
                                 f"{SUPPORTED_LOCAL_SCHEMES})"}),
       ("--table-id", {"type": int, "default": 0,
                       "help": "chain table id (default: 1 for cr, 2 "
                               "for ec — the LocalCluster convention)"}),
       ("--start-chain", {"type": int, "default": 1,
                          "help": "first chain id (EC tables usually "
                                  "follow the CR chains)"}),
       ("--apply", {"action": "store_true",
                    "help": "install via Mgmtd.set_chains"}))
async def gen_chains(ctx: AdminContext, args) -> None:
    from t3fs_torch.mgmtd.placement import (
        build_chain_table, recovery_imbalance, target_id,
    )
    node_ids = [int(x) for x in args.nodes.split(",")]
    table_id = args.table_id or (1 if args.table_type == "cr" else 2)
    chains = []
    if args.table_type == "cr":
        # recovery-traffic-balanced assignment (BIBD objective; reference
        # deploy/data_placement -type CR): rows are node INDICES 1..N
        table = build_chain_table(len(node_ids), args.chains, args.replicas)
        for c, row in enumerate(table):
            targets = [
                ChainTargetInfo(target_id(node_ids[idx - 1], c),
                                node_ids[idx - 1],
                                PublicTargetState.SERVING)
                for idx in row]
            chains.append(ChainInfo(chain_id=args.start_chain + c,
                                    chain_ver=1, targets=targets))
        balance = (f"recovery imbalance: "
                   f"{recovery_imbalance(table, len(node_ids)):.3f} "
                   f"(1.0 = perfectly balanced reconstruction load)")
    else:
        # EC shard chains: single-replica, rendezvous-placed (reference
        # -type EC) — membership change later moves minimally, which is
        # what the online rebalancer banks on
        from t3fs_torch.mgmtd.chain_table import solve_chain_table
        from t3fs_torch.mgmtd.types import NodeInfo
        chain_ids = [args.start_chain + j for j in range(args.chains)]
        solved = solve_chain_table(
            chain_ids, [NodeInfo(node_id=n) for n in node_ids],
            replicas=1, table_type="ec")
        for j, cid in enumerate(chain_ids):
            nid = solved.nodes_of(cid)[0]
            chains.append(ChainInfo(
                chain_id=cid, chain_ver=1,
                targets=[ChainTargetInfo(
                    target_id(nid, args.start_chain - 1 + j), nid,
                    PublicTargetState.SERVING)]))
        load: dict[int, int] = {}
        for c in chains:
            load[c.targets[0].node_id] = load.get(c.targets[0].node_id,
                                                  0) + 1
        balance = (f"per-node shard chains: "
                   + " ".join(f"n{n}={load.get(n, 0)}"
                              for n in sorted(node_ids))
                   + f" (capacity moves: {solved.capacity_moves})")
    for chain in chains:
        print(f"chain {chain.chain_id}: " + " -> ".join(
            f"t{t.target_id}@n{t.node_id}" for t in chain.targets))
    print(balance)
    if args.apply:
        await ctx.cli.call(
            ctx.mgmtd_address, "Mgmtd.set_chains",
            SetChainsReq(chains=chains,
                         tables=[ChainTable(
                             table_id, [c.chain_id for c in chains],
                             table_type=args.table_type,
                             replicas=(args.replicas
                                       if args.table_type == "cr" else 1))]))
        print(f"installed table {table_id} ({args.table_type})")


@command("set-config-template", "store a node-type config template in mgmtd")
@args_(("node_type", {}), ("file", {"help": "TOML file"}))
async def set_config_template(ctx: AdminContext, args) -> None:
    # t3fslint: allow(blocking-in-async) — single-shot CLI tool
    with open(args.file) as f:
        toml_text = f.read()
    await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.set_config_template",
                       SetConfigTemplateReq(args.node_type, toml_text))
    print(f"template[{args.node_type}] = {len(toml_text)} bytes")


@command("get-config-template", "fetch a node-type config template")
@args_(("node_type", {}))
async def get_config_template(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.get_config_template",
                                GetConfigTemplateReq(args.node_type))
    print(rsp.toml if rsp.found else f"(no template for {args.node_type})")


# ---------------- per-server config/app ----------------

@command("app-info", "identity/uptime of any server")
@args_(("addr", {}))
async def app_info(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(args.addr, "Core.getAppInfo", None)
    i = rsp.info
    print(f"{i.node_type} node={i.node_id} addr={i.address} pid={i.pid} "
          f"version={i.version} uptime={rsp.uptime_s:.1f}s")


@command("echo", "round-trip check against any server")
@args_(("addr", {}), ("message", {"nargs": "?", "default": "ping"}))
async def echo(ctx: AdminContext, args) -> None:
    t0 = time.perf_counter()
    rsp, _ = await ctx.cli.call(args.addr, "Core.echo", EchoReq(args.message))
    print(f"{rsp.message}  ({(time.perf_counter() - t0) * 1e3:.2f} ms)")


@command("get-config", "render a server's live config (GetConfig)")
@args_(("addr", {}))
async def get_config(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(args.addr, "Core.getConfig", GetConfigReq())
    print(rsp.toml, end="")


def _parse_kv(pairs: list[str]) -> dict:
    # one K=V parser for the whole system (binaries' --set and this CLI)
    from t3fs_torch.app.base import parse_overrides
    return parse_overrides(pairs)


@command("verify-config", "dry-run config overrides (VerifyConfig/RenderConfig)")
@args_(("addr", {}), ("overrides", {"nargs": "+", "metavar": "K=V"}))
async def verify_config(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(
        args.addr, "Core.renderConfig",
        RenderConfigReq(_parse_kv(args.overrides), admin_token=ctx.token))
    print(f"would update: {rsp.updated_keys}")


@command("hot-update-config", "apply hot config overrides (HotUpdateConfig)")
@args_(("addr", {}), ("overrides", {"nargs": "+", "metavar": "K=V"}))
async def hot_update_config(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(
        args.addr, "Core.hotUpdateConfig",
        HotUpdateConfigReq(_parse_kv(args.overrides), ctx.token))
    print(f"updated: {rsp.updated_keys}")


# ---------------- users ----------------

@command("user-add", "create a user (token auto-generated)")
@args_(("uid", {"type": int}), ("name", {}),
       ("--admin", {"action": "store_true"}))
async def user_add(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(
        ctx.mgmtd_address, "Core.userAdd",
        UserReq(ctx.token, UserInfo(args.uid, args.name,
                                    is_admin=args.admin)))
    u = rsp.users[0]
    print(f"uid={u.uid} name={u.name} admin={u.is_admin} token={u.token}")


@command("user-list", "list users")
async def user_list(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Core.userList",
                                UserReq(ctx.token))
    rows = [[u.uid, u.name, u.is_admin] for u in rsp.users]
    print(_fmt_table(rows, ["uid", "name", "admin"]))


@command("user-remove", "delete a user")
@args_(("uid", {"type": int}))
async def user_remove(ctx: AdminContext, args) -> None:
    await ctx.cli.call(ctx.mgmtd_address, "Core.userRemove",
                       UserReq(ctx.token, UserInfo(args.uid)))
    print("removed")


# ---------------- file system ----------------

@command("mkdir", "create directories recursively")
@args_(("path", {}))
async def mkdir(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    await fs.mkdirs(args.path)
    print(f"created {args.path}")


@command("ls", "list a directory")
@args_(("path", {"nargs": "?", "default": "/"}))
async def ls(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    rows = []
    for e in await fs.readdir(args.path):
        rows.append([e.name, e.itype.name.lower(), e.inode_id])
    print(_fmt_table(rows, ["name", "type", "inode"]))


@command("chmod", "change a path's permissions")
@args_(("path", {}), ("mode", {"type": lambda s: int(s, 8),
                               "help": "octal, e.g. 640"}))
async def chmod(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    ino = await fs.stat(args.path)
    ino = await fs.meta.set_attr_inode(ino.inode_id, perm=args.mode)
    print(f"{args.path}: perm={oct(ino.perm)}")


@command("chown", "change a path's owner/group")
@args_(("path", {}), ("uid", {"type": int}), ("gid", {"type": int}))
async def chown(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    ino = await fs.stat(args.path)
    ino = await fs.meta.set_attr_inode(ino.inode_id,
                                       uid=args.uid, gid=args.gid)
    print(f"{args.path}: uid={ino.uid} gid={ino.gid}")


@command("stat", "stat a path")
@args_(("path", {}))
async def stat(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    ino = await fs.stat(args.path)
    length = await fs.file_length(ino) if ino.layout is not None else 0
    print(f"inode={ino.inode_id} type={ino.itype.name.lower()} "
          f"perm={oct(ino.perm)} length={length}")
    if ino.layout is not None:
        print(f"layout: chunk_size={ino.layout.chunk_size} "
              f"chains={ino.layout.chains}")


@command("rm", "remove a path")
@args_(("path", {}), ("-r", {"action": "store_true", "dest": "recursive"}))
async def rm(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    await fs.unlink(args.path, recursive=args.recursive)
    print(f"removed {args.path}")


@command("mv", "rename a path")
@args_(("src", {}), ("dst", {}))
async def mv(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    await fs.rename(args.src, args.dst)
    print(f"{args.src} -> {args.dst}")


@command("put", "upload a local file")
@args_(("local", {}), ("remote", {}),
       ("--chunk-size", {"type": int, "default": 0}))
async def put(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    # t3fslint: allow(blocking-in-async) — single-shot CLI tool
    with open(args.local, "rb") as f:
        data = f.read()
    await fs.write_file(args.remote, data, chunk_size=args.chunk_size)
    print(f"wrote {len(data)} bytes to {args.remote}")


@command("get", "download a file")
@args_(("remote", {}), ("local", {}))
async def get(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    data = await fs.read_file(args.remote)
    # t3fslint: allow(blocking-in-async) — single-shot CLI tool
    with open(args.local, "wb") as f:
        f.write(data)
    print(f"read {len(data)} bytes from {args.remote}")


@command("cat", "print file contents")
@args_(("path", {}))
async def cat(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    sys.stdout.buffer.write(await fs.read_file(args.path))


@command("checksum", "CRC32C of a file's contents (Checksum command)")
@args_(("path", {}))
async def checksum(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    data = await fs.read_file(args.path)
    print(f"crc32c={crc32c(data):#010x} length={len(data)}")


@command("truncate", "truncate a file")
@args_(("path", {}), ("length", {"type": int}))
async def truncate(ctx: AdminContext, args) -> None:
    fs = await ctx.fs()
    await fs.truncate(args.path, args.length)
    print(f"truncated {args.path} to {args.length}")


@command("trash-put", "move a path into timestamped trash instead of rm")
@args_(("path", {}), ("--ttl", {"default": "3d",
                                "help": "1h|3h|8h|1d|3d|7d"}))
async def trash_put(ctx: AdminContext, args) -> None:
    from t3fs_torch.utils.trash import Trash
    fs = await ctx.fs()
    dest = await Trash(fs).put(args.path, args.ttl)
    print(f"{args.path} -> {dest}")


@command("trash-ls", "list trash slots and their expiries")
async def trash_ls(ctx: AdminContext, args) -> None:
    from t3fs_torch.utils.trash import Trash
    fs = await ctx.fs()
    rows = []
    for slot, expiry, entries in await Trash(fs).list():
        rows.append([slot, expiry.strftime("%Y-%m-%d %H:%M"), len(entries)])
    print(_fmt_table(rows, ["slot", "expires", "entries"]))


@command("trash-clean", "delete expired trash slots (trash_cleaner)")
async def trash_clean(ctx: AdminContext, args) -> None:
    from t3fs_torch.utils.trash import TrashCleaner
    fs = await ctx.fs()
    removed = await TrashCleaner(fs).clean_once()
    print(f"removed {len(removed)}: {removed}")


# ---------------- checkpoints ----------------

async def _ckpt_store(ctx: AdminContext, directory: str):
    from t3fs_torch.ckpt import CheckpointStore
    fs = await ctx.fs()
    return fs, CheckpointStore(fs, directory)


@command("ckpt-list", "committed checkpoint steps in a directory")
@args_(("directory", {}))
async def ckpt_list(ctx: AdminContext, args) -> None:
    _, store = await _ckpt_store(ctx, args.directory)
    rows = []
    for step in await store.list_steps():
        man = await store.load(step)
        rows.append([step, len(man.leaves), man.total_bytes(),
                     time.strftime("%Y-%m-%d %H:%M:%S",
                                   time.localtime(man.created_at))])
    print(_fmt_table(rows, ["step", "leaves", "bytes", "created"]))


@command("ckpt-stat", "one checkpoint's manifest: layout + per-leaf shard map")
@args_(("directory", {}),
       ("--step", {"type": int, "default": None,
                   "help": "default: latest committed"}))
async def ckpt_stat(ctx: AdminContext, args) -> None:
    _, store = await _ckpt_store(ctx, args.directory)
    man = await store.load(args.step)
    lay = man.layout
    print(f"step={man.step} leaves={len(man.leaves)} "
          f"bytes={man.total_bytes()} "
          f"rs=({lay.k}+{lay.m}) chunk_size={lay.chunk_size} "
          f"chains={lay.chains}")
    rows = [[lf.path, lf.dtype, "x".join(map(str, lf.shape)) or "-",
             lf.nbytes, lf.num_stripes, f"{lf.inode:#x}"]
            for lf in man.leaves]
    print(_fmt_table(rows, ["path", "dtype", "shape", "bytes", "stripes",
                            "inode"]))


@command("ckpt-verify", "scrub a checkpoint's shards against manifest CRCs")
@args_(("directory", {}),
       ("--step", {"type": int, "default": None}),
       ("--repair", {"action": "store_true",
                     "help": "re-encode lost/corrupt shards in place"}))
async def ckpt_verify(ctx: AdminContext, args) -> None:
    from t3fs_torch.ckpt import CheckpointReader
    from t3fs_torch.client.ec_client import ECStorageClient
    codec = ctx.ec_codec()      # no GPU and no --cpu: raises before connecting
    fs = await ctx.fs()
    # the codec is the context's: it closes with the context, not here
    ec = ECStorageClient(await ctx.storage_client(), codec=codec)
    reader = CheckpointReader(ec, fs, args.directory)
    rep = await reader.scrub(args.step, repair=args.repair)
    print(f"checked={rep.shards_checked} missing={rep.shards_missing} "
          f"corrupt={rep.shards_corrupt} repaired={rep.shards_repaired} "
          f"unrecoverable={rep.stripes_unrecoverable}")
    if rep.stripes_unrecoverable:
        raise SystemExit(1)


@command("ckpt-gc", "keep the newest N checkpoints, reclaim the rest")
@args_(("directory", {}),
       ("--keep", {"type": int, "required": True, "metavar": "N"}))
async def ckpt_gc(ctx: AdminContext, args) -> None:
    _, store = await _ckpt_store(ctx, args.directory)
    rep = await store.gc(await ctx.storage_client(), args.keep)
    print(f"kept={rep.steps_kept} removed={rep.steps_removed} "
          f"leaves={rep.leaves_removed} bytes={rep.bytes_removed}")


# ---------------- storage ----------------

@command("space-info", "capacity/used/free of a storage node")
@args_(("addr", {}))
async def space_info(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(args.addr, "Storage.space_info", None)
    print(f"capacity={rsp.capacity} used={rsp.used} free={rsp.free}")


@command("dump-inodes", "raw inode table scan (DumpInodes)")
@args_(("--limit", {"type": int, "default": 50}))
async def dump_inodes(ctx: AdminContext, args) -> None:
    from t3fs_torch.meta.service import EntryReq
    rsp, _ = await ctx.cli.call(_require_meta(ctx), "Meta.list_inodes",
                                EntryReq(limit=args.limit))
    rows = [[i.inode_id, i.itype.name, oct(i.perm), i.nlink, i.length,
             len(i.layout.chains) if i.layout else "-"]
            for i in rsp.inodes if i]
    print(_fmt_table(rows, ["inode", "type", "perm", "nlink", "len", "chains"]))


@command("dump-dirents", "raw dirent table scan (DumpDirEntries)")
@args_(("--limit", {"type": int, "default": 50}))
async def dump_dirents(ctx: AdminContext, args) -> None:
    from t3fs_torch.meta.service import EntryReq
    rsp, _ = await ctx.cli.call(_require_meta(ctx), "Meta.list_dirents",
                                EntryReq(limit=args.limit))
    rows = [[e.parent, e.name, e.inode_id, e.itype.name] for e in rsp.entries]
    print(_fmt_table(rows, ["parent", "name", "inode", "type"]))


@command("find-orphaned-chunks",
         "chunks on storage whose inode has no meta record (FindOrphanedChunks)")
async def find_orphaned_chunks(ctx: AdminContext, args) -> None:
    from t3fs_torch.client.ec_client import PARITY_NS
    from t3fs_torch.meta.service import EntryReq

    _require_meta(ctx)
    # full inode-id set from meta (paged raw scan)
    known: set[int] = set()
    cursor = 0
    while True:
        rsp, _ = await ctx.cli.call(ctx.meta_address, "Meta.list_inodes",
                                    EntryReq(inode_id=cursor, limit=1000))
        inodes = [i for i in rsp.inodes if i]
        if not inodes:
            break
        known |= {i.inode_id for i in inodes}
        cursor = max(i.inode_id for i in inodes)
        if len(inodes) < 1000:
            break
    mg = await ctx.mgmtd_client()
    info = await mg.refresh()
    orphans = 0
    for chain in info.chains.values():
        head = chain.head()
        if head is None:
            continue
        rsp, _ = await ctx.cli.call(info.node_address(head.node_id),
                                    "Storage.sync_start",
                                    SyncStartReq(chain_id=chain.chain_id))
        for m in rsp.metas:
            ino = m.chunk_id.inode & ~PARITY_NS
            if ino not in known:
                orphans += 1
                print(f"orphan: chain {chain.chain_id} chunk {m.chunk_id} "
                      f"len={m.length}")
    print(f"{orphans} orphaned chunks "
          f"({len(known)} live inodes checked)")


@command("checksum-sweep",
         "read-verify every chunk of a chain against stored CRCs (Checksum)")
@args_(("chain_id", {"type": int}))
async def checksum_sweep(ctx: AdminContext, args) -> None:
    from t3fs_torch.storage.types import BatchReadReq, ReadIO
    mg = await ctx.mgmtd_client()
    info = await mg.refresh()
    chain = info.chains.get(args.chain_id)
    if chain is None or chain.head() is None:
        print("chain not found / headless")
        return
    addr = info.node_address(chain.head().node_id)
    rsp, _ = await ctx.cli.call(addr, "Storage.sync_start",
                                SyncStartReq(chain_id=args.chain_id))
    bad = ok = skipped = errors = 0
    for i in range(0, len(rsp.metas), 16):
        batch = rsp.metas[i:i + 16]
        req = BatchReadReq(ios=[ReadIO(chunk_id=m.chunk_id,
                                       chain_id=args.chain_id,
                                       verify_checksum=True,
                                       no_payload=True)
                                for m in batch])
        rrsp, _ = await ctx.cli.call(addr, "Storage.batch_read", req)
        for m, r in zip(batch, rrsp.results):
            if r.status.code == 0:
                ok += 1
            elif r.status.code == int(StatusCode.CHECKSUM_MISMATCH):
                bad += 1
                print(f"BAD {m.chunk_id}: {r.status.message}")
            elif r.status.code == int(StatusCode.CHUNK_BUSY):
                # DIRTY/racing-write chunks are not corruption — an
                # active-write sweep must not report false positives
                skipped += 1
            else:
                # anything else (missing chunk, IO error) is a real finding
                errors += 1
                print(f"ERR {m.chunk_id}: [{r.status.code}] {r.status.message}")
    print(f"checksum sweep of chain {args.chain_id}: {ok} ok, {bad} bad, "
          f"{errors} errors, {skipped} skipped (busy/uncommitted)")


@command("fill-zero", "overwrite a chunk range with zeros (FillZero repair)")
@args_(("chain_id", {"type": int}), ("inode", {"type": int}),
       ("begin", {"type": int}), ("end", {"type": int}),
       ("--chunk-size", {"type": int, "default": 1 << 20}))
async def fill_zero(ctx: AdminContext, args) -> None:
    from t3fs_torch.storage.types import ChunkId, UpdateType
    sc = await ctx.storage_client()
    for idx in range(args.begin, args.end):
        r = await sc.write_chunk(args.chain_id, ChunkId(args.inode, idx), 0,
                                 b"\x00" * args.chunk_size,
                                 chunk_size=args.chunk_size,
                                 update_type=UpdateType.REPLACE)
        print(f"chunk {args.inode}.{idx}: {r.status.code}")


@command("create-target", "provision a new target dir on a storage node")
@args_(("addr", {}), ("target_id", {"type": int}), ("root", {}),
       ("--engine", {"default": "native"}))
async def create_target(ctx: AdminContext, args) -> None:
    from t3fs_torch.storage.types import TargetOpReq
    rsp, _ = await ctx.cli.call(args.addr, "Storage.create_target",
                                TargetOpReq(target_id=args.target_id,
                                            root=args.root,
                                            engine_backend=args.engine))
    print(f"target {rsp.target_id} created (state={rsp.state})")


@command("offline-target", "mark a target OFFLINE on its node")
@args_(("addr", {}), ("target_id", {"type": int}))
async def offline_target(ctx: AdminContext, args) -> None:
    from t3fs_torch.storage.types import TargetOpReq
    rsp, _ = await ctx.cli.call(args.addr, "Storage.offline_target",
                                TargetOpReq(target_id=args.target_id))
    print(f"target {rsp.target_id} offlined")


@command("remove-target", "drop an OFFLINE target from its node")
@args_(("addr", {}), ("target_id", {"type": int}))
async def remove_target(ctx: AdminContext, args) -> None:
    from t3fs_torch.storage.types import TargetOpReq
    rsp, _ = await ctx.cli.call(args.addr, "Storage.remove_target",
                                TargetOpReq(target_id=args.target_id))
    print(f"target {rsp.target_id} removed")


@command("query-chunk", "one chunk's metadata on a storage node")
@args_(("addr", {}), ("chain_id", {"type": int}), ("inode", {"type": int}),
       ("index", {"type": int}))
async def query_chunk(ctx: AdminContext, args) -> None:
    from t3fs_torch.storage.types import ChunkId, QueryChunkReq
    rsp, _ = await ctx.cli.call(
        args.addr, "Storage.query_chunk",
        QueryChunkReq(chain_id=args.chain_id,
                      chunk_id=ChunkId(args.inode, args.index)))
    if not rsp.found:
        print("not found")
        return
    m = rsp.meta
    print(f"{m.chunk_id}: len={m.length} update_ver={m.update_ver} "
          f"commit_ver={m.commit_ver} chain_ver={m.chain_ver} "
          f"crc={m.checksum:#010x} state={m.state}")


@command("dump-chunkmeta", "chunk metadata of a chain on a storage node")
@args_(("addr", {}), ("chain_id", {"type": int}))
async def dump_chunkmeta(ctx: AdminContext, args) -> None:
    rsp, _ = await ctx.cli.call(args.addr, "Storage.sync_start",
                                SyncStartReq(chain_id=args.chain_id))
    rows = [[m.chunk_id, m.commit_ver, m.chain_ver, m.length,
             f"{m.checksum:#010x}"] for m in rsp.metas]
    print(_fmt_table(rows, ["chunk", "commit_ver", "chain_ver", "len",
                            "crc32c"]))


# ---------------- metrics / bench ----------------

@command("metrics", "query the monitor collector")
@args_(("prefix", {"nargs": "?", "default": ""}),
       ("--since", {"type": float, "default": 0.0}),
       ("--limit", {"type": int, "default": 50}))
async def metrics(ctx: AdminContext, args) -> None:
    if not ctx.monitor_address:
        raise SystemExit("metrics needs --monitor ADDR")
    rsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.query",
                                QueryMetricsReq(args.prefix, args.since,
                                                args.limit))
    for s in rsp.samples:
        print(json.dumps(s, default=str))


@command("buf-stats", "registered-memory plane: BufferPool hits/misses/live "
                      "and batched one-sided transport counters (doorbells, "
                      "ops-per-doorbell, batched vs fallback ops) per node, "
                      "from the monitor collector")
@args_(("--since", {"type": float, "default": 0.0}),
       ("--limit", {"type": int, "default": 500}))
async def buf_stats(ctx: AdminContext, args) -> None:
    if not ctx.monitor_address:
        raise SystemExit("buf-stats needs --monitor ADDR")
    rsp, _ = await ctx.cli.call(
        ctx.monitor_address, "Monitor.query",
        QueryMetricsReq("rdma.", args.since, args.limit))
    # query returns newest-first: keep the latest sample per (metric, node)
    latest: dict[tuple, dict] = {}
    for s in rsp.samples:
        latest.setdefault((s.get("name", ""), s.get("node_id", 0)), s)
    if not latest:
        print("no rdma.* samples at the collector (yet)")
        return
    rows = [[name, node, f"{s.get('value', 0):g}",
             time.strftime("%H:%M:%S", time.localtime(s.get("ts", 0)))]
            for (name, node), s in sorted(latest.items())]
    print(_fmt_table(rows, ["metric", "node", "value", "at"]))


def render_trace(spans: list[dict]) -> str:
    """Render one trace's spans (Monitor.query_spans rows) as an indented
    cross-node tree: per hop the serving node, offset from the trace
    start, duration, status, the wire/queue decomposition tags the server
    span carries, and the span's events.  Spans whose parent was never
    exported (tail-dropped on another node) root at top level."""
    if not spans:
        return "(no spans)"
    by_id = {s["span_id"]: s for s in spans}
    kids: dict[int, list[dict]] = {}
    roots: list[dict] = []
    for s in spans:
        if s.get("parent_id") and s["parent_id"] in by_id:
            kids.setdefault(s["parent_id"], []).append(s)
        else:
            roots.append(s)
    t_min = min(s["t0"] for s in spans)
    out: list[str] = [f"trace {spans[0]['trace_id']:#x} "
                      f"({len(spans)} spans)"]

    def fmt(s: dict) -> str:
        tags = s.get("tags") or {}
        bits = [f"{s['name']} [{s.get('kind', '?')}]"]
        where = tags.get("addr") or f"node{s.get('node_id', '?')}"
        bits.append(f"@{where}")
        bits.append(f"+{(s['t0'] - t_min) * 1e3:.2f}ms")
        bits.append(f"{s['dur_s'] * 1e3:.2f}ms")
        if s.get("status"):
            bits.append(f"status={s['status']}")
        for k in ("wire_s", "queue_s", "apply_s", "forward_s"):
            if k in tags:
                bits.append(f"{k[:-2]}={tags[k] * 1e3:.2f}ms")
        return "  ".join(bits)

    def walk(s: dict, depth: int) -> None:
        out.append("  " * depth + fmt(s))
        for rel, event, detail in s.get("events") or []:
            out.append("  " * (depth + 1)
                       + f". +{rel * 1e3:.2f}ms {event}"
                       + (f" {detail}" if detail else ""))
        for c in sorted(kids.get(s["span_id"], []), key=lambda x: x["t0"]):
            walk(c, depth + 1)

    for r in sorted(roots, key=lambda x: x["t0"]):
        walk(r, 0)
    return "\n".join(out)


@command("trace-show", "cross-node span tree for one trace_id "
                       "(wire/queue/apply/forward decomposition)")
@args_(("trace_id", {"help": "trace id (decimal or 0x hex)"}),
       ("--limit", {"type": int, "default": 1000}))
async def trace_show(ctx: AdminContext, args) -> None:
    if not ctx.monitor_address:
        raise SystemExit("trace-show needs --monitor ADDR")
    tid = int(args.trace_id, 0)
    rsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.query_spans",
                                QuerySpansReq(trace_id=tid,
                                              limit=args.limit))
    print(render_trace(rsp.spans))


@command("soak-status", "live per-workload counters from a running soak")
@args_(("--since", {"type": float, "default": 0.0}),
       ("--limit", {"type": int, "default": 500}))
async def soak_status(ctx: AdminContext, args) -> None:
    """A running SoakRunner publishes soak.<workload>.{ops,errors,p50_ms}
    rows to its MonitorCollectorServer once a second (the address is in
    the runner's progress output); this renders the latest row per
    workload so a minutes-long soak can be watched from another
    terminal."""
    if not ctx.monitor_address:
        raise SystemExit("soak-status needs --monitor ADDR")
    rsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.query",
                                QueryMetricsReq("soak.", args.since,
                                                args.limit))
    latest: dict[str, dict] = {}
    for s in rsp.samples:            # newest row per metric name wins
        name = s.get("name", "")
        if name not in latest or s.get("ts", 0) >= latest[name].get("ts", 0):
            latest[name] = s
    per_wl: dict[str, dict] = {}
    for name, s in latest.items():
        _, wl, field = name.split(".", 2)
        per_wl.setdefault(wl, {})[field] = s.get("value")
    rows = [[wl, f"{v.get('ops', 0):.0f}", f"{v.get('errors', 0):.0f}",
             f"{v.get('p50_ms', 0.0):.2f}"]
            for wl, v in sorted(per_wl.items())]
    if not rows:
        print("(no soak.* metrics — is a soak running against "
              "this monitor?)")
        return
    print(_fmt_table(rows, ["workload", "ops", "errors", "p50_ms"]))
    # per-node health from the same monitor's scorecard: shows which
    # node the fault schedule is currently hurting
    try:
        hrsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.health",
                                     HealthReq())
    except StatusError:
        return   # pre-health monitor: workload table alone is still useful
    if hrsp.health is not None and hrsp.health.nodes:
        nrows = [[n.addr, n.state,
                  f"{n.read_p99_s * 1e3:.2f}{_TREND.get(n.trend, '')}"
                  if n.count else "-"]
                 for n in hrsp.health.nodes]
        print(_fmt_table(nrows, ["node", "health", "p99_ms"]))


@command("trace-slow", "top-N slow exported traces (local roots) per method")
@args_(("--method", {"default": "", "help": "span name prefix filter"}),
       ("--min-ms", {"type": float, "default": 0.0}),
       ("--since", {"type": float, "default": 0.0,
                    "help": "only spans that ARRIVED in the last N "
                            "seconds (0 = no bound)"}),
       ("--limit", {"type": int, "default": 20}))
async def trace_slow(ctx: AdminContext, args) -> None:
    if not ctx.monitor_address:
        raise SystemExit("trace-slow needs --monitor ADDR")
    ts_min = (time.time() - args.since) if args.since > 0 else 0.0
    rsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.query_spans",
                                QuerySpansReq(name_prefix=args.method,
                                              min_dur_s=args.min_ms / 1e3,
                                              roots_only=True,
                                              limit=args.limit,
                                              ts_min=ts_min))
    rows = [[f"{s['trace_id']:#x}", s["name"],
             s.get("tags", {}).get("addr") or f"node{s.get('node_id', '?')}",
             f"{s['dur_s'] * 1e3:.2f}", s.get("status", 0)]
            for s in rsp.spans]
    print(_fmt_table(rows, ["trace", "root", "node", "ms", "status"]))


_TREND = {1: "↗", 0: "→", -1: "↘"}   # ↗ → ↘


def render_cluster_health(health) -> str:
    """Scorecard table (monitor/health.py ClusterHealth): per-node state,
    p50/p99 with trend arrow, straggler/stale flags, and the worst slow
    trace id so `trace-show` can drill straight into the tail."""
    if health is None or not health.nodes:
        return "(no scorecard — monitor has no rollups yet?)"
    rows = []
    for n in health.nodes:
        rows.append([
            n.addr or "?", str(n.node_id or "?"), n.state,
            f"{n.read_p50_s * 1e3:.2f}" if n.count else "-",
            (f"{n.read_p99_s * 1e3:.2f}{_TREND.get(n.trend, '')}"
             if n.count else "-"),
            f"{n.err_rate * 100:.2f}%" if n.count else "-",
            str(n.count),
            f"{n.worst_trace_id:#x}" if n.worst_trace_id else "-",
        ])
    head = (f"cluster p99 {health.cluster_read_p99_s * 1e3:.2f}ms, "
            f"window {health.window_s:.0f}s, "
            f"freshness bound {health.freshness_s:.1f}s")
    return head + "\n" + _fmt_table(
        rows, ["addr", "node", "state", "p50_ms", "p99_ms", "err",
               "reads", "worst_trace"])


@command("cluster-health", "per-node scorecard (rollup-derived: state, "
                           "p50/p99 trend, straggler/stale flags)")
@args_(("--window", {"type": float, "default": 0.0,
                     "help": "scorecard window seconds (0 = server "
                             "default)"}),)
async def cluster_health(ctx: AdminContext, args) -> None:
    """Prefers the monitor (fresh: runs a rollup pass on query); falls
    back to mgmtd's cached copy — the same compact scorecard it
    piggybacks on GetRoutingInfoRsp."""
    if ctx.monitor_address:
        rsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.health",
                                    HealthReq(window_s=args.window))
        print(render_cluster_health(rsp.health))
        return
    rsp, _ = await ctx.cli.call(ctx.mgmtd_address, "Mgmtd.cluster_health",
                                ClusterHealthReq())
    print(render_cluster_health(rsp.health))
    if rsp.health is not None:
        print(f"(mgmtd cache, version {rsp.health_version})")


@command("slo-report", "per-method availability + latency objectives "
                       "over the rollup window")
@args_(("--window", {"type": float, "default": 0.0}),)
async def slo_report(ctx: AdminContext, args) -> None:
    if not ctx.monitor_address:
        raise SystemExit("slo-report needs --monitor ADDR")
    rsp, _ = await ctx.cli.call(ctx.monitor_address, "Monitor.slo_report",
                                SloReportReq(window_s=args.window))
    rep = rsp.report
    if rep is None or not rep.methods:
        return print("(no rollups in window)")
    rows = [[m.method, str(m.count), str(m.errors),
             f"{m.availability * 100:.3f}%", f"{m.avail_target * 100:.1f}%",
             f"{m.p50_s * 1e3:.2f}", f"{m.p99_s * 1e3:.2f}",
             (f"{m.p99_target_s * 1e3:.1f}" if m.p99_target_s else "-"),
             "PASS" if m.ok else "FAIL"]
            for m in rep.methods]
    print(_fmt_table(rows, ["method", "count", "errors", "avail",
                            "target", "p50_ms", "p99_ms", "p99_tgt",
                            "slo"]))
    print(f"window {rep.window_s:.0f}s: "
          f"{'ALL PASS' if rep.ok else 'VIOLATIONS'}")


@command("bench", "quick write+read bench through meta+storage")
@args_(("--dir", {"default": "/_bench", "dest": "bench_dir"}),
       ("--files", {"type": int, "default": 4}),
       ("--size", {"type": int, "default": 1 << 20}),
       ("--chunk-size", {"type": int, "default": 0}),
       ("--keep", {"action": "store_true"}))
async def bench(ctx: AdminContext, args) -> None:
    import os
    fs = await ctx.fs()
    await fs.mkdirs(args.bench_dir)
    payloads = [os.urandom(args.size) for _ in range(args.files)]
    t0 = time.perf_counter()
    await asyncio.gather(*[
        fs.write_file(f"{args.bench_dir}/f{i}", p,
                      chunk_size=args.chunk_size)
        for i, p in enumerate(payloads)])
    tw = time.perf_counter() - t0
    t0 = time.perf_counter()
    reads = await asyncio.gather(*[
        fs.read_file(f"{args.bench_dir}/f{i}") for i in range(args.files)])
    tr = time.perf_counter() - t0
    assert all(r == p for r, p in zip(reads, payloads)), "readback mismatch"
    total = args.files * args.size
    print(f"write: {total / tw / 1e6:.1f} MB/s  read: {total / tr / 1e6:.1f} "
          f"MB/s  ({args.files} x {args.size} B)")
    if not args.keep:
        await fs.unlink(args.bench_dir, recursive=True)


# ---------------- driver ----------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="t3fs-admin")
    ap.add_argument("--mgmtd", default="127.0.0.1:9000")
    ap.add_argument("--meta", default="")
    ap.add_argument("--monitor", default="")
    ap.add_argument("--migration", default="",
                    help="migration service address (migrate commands)")
    ap.add_argument("--token", default="")
    ap.add_argument("--cpu", action="store_true",
                    help="ckpt-verify's stripe codec on its plain versions "
                         "on the host (default: the card)")
    sub = ap.add_subparsers(dest="command")
    for name, (configure, _fn, help_) in sorted(COMMANDS.items()):
        p = sub.add_parser(name, help=help_)
        configure(p)
    return ap


async def dispatch(ctx: AdminContext, args, *, in_repl: bool = False) -> int:
    _, fn, _ = COMMANDS[args.command]
    try:
        await fn(ctx, args)
        return 0
    except StatusError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1
    except SystemExit as e:
        # bad arguments (e.g. malformed K=V): fatal one-shot, recoverable
        # inside the shell
        if not in_repl:
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


async def repl(ctx: AdminContext, parser: argparse.ArgumentParser) -> None:
    print("t3fs admin shell — 'help' lists commands, 'quit' exits")
    loop = asyncio.get_running_loop()
    while True:
        try:
            line = await loop.run_in_executor(None, input, "t3fs> ")
        except (EOFError, KeyboardInterrupt):
            break
        line = line.strip()
        if not line:
            continue
        if line in ("quit", "exit"):
            break
        if line == "help":
            for name, (_c, _f, help_) in sorted(COMMANDS.items()):
                print(f"  {name:22s} {help_}")
            continue
        try:
            args = parser.parse_args(shlex.split(line))
        except SystemExit:
            continue  # argparse already printed the error
        if args.command:
            await dispatch(ctx, args, in_repl=True)


def main(argv: list[str] | None = None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    ctx = AdminContext(args.mgmtd, args.meta, args.monitor, args.token,
                       migration=args.migration,
                       device="cpu" if args.cpu else "cuda")

    async def run():
        try:
            if args.command:
                return await dispatch(ctx, args)
            await repl(ctx, parser)
            return 0
        finally:
            await ctx.close()

    return asyncio.run(run())


if __name__ == "__main__":
    sys.exit(main())
