"""t3fs admin CLI: one-shot commands + interactive shell.

The port of t3fs/cli/admin.py.  Reference analog: src/client/cli/ +
src/client/bin/admin_cli.cc -- the interactive admin shell with command
families for cluster management, config, users, file ops, chunk-meta
dumps, checksums and a quick bench (registerAdminCommands.cc).

This module holds the CLI's spine: the command registry (`command`,
`args_`), `AdminContext`, the formatters, `build_parser`, `dispatch`,
`repl` and `main`, under the same program name and registry shape as the
reference, and the commands the soak harness and its operator use:
`render_trace` (imported by t3fs_torch/soak/harvest.py), `trace-show`
and `soak-status`.  The reference's other 78 commands are still to
come:
    list-nodes, repair-status, lease, routing, rotate-lastsrv,
    update-chain, set-preferred-order, kv-status, trace-read,
    trace-top, rpc-top, read-stats, kvcache-stats, kv-publish-map,
    kv-map, kv-split, kv-move, kv-merge, kv-move-resume, enable-node,
    disable-node, unregister-node, node-tags, universal-tags,
    orphan-targets, config-versions, migrate, migrate-status,
    rebalance-status, rotate-preferred, client-sessions, gen-chains,
    set-config-template, get-config-template, app-info, echo,
    get-config, verify-config, hot-update-config, user-add, user-list,
    user-remove, mkdir, ls, chmod, chown, stat, rm, mv, put, get, cat,
    checksum, truncate, trash-put, trash-ls, trash-clean, ckpt-list,
    ckpt-stat, ckpt-verify, ckpt-gc, space-info, dump-inodes,
    dump-dirents, find-orphaned-chunks, checksum-sweep, fill-zero,
    create-target, offline-target, remove-target, query-chunk,
    dump-chunkmeta, metrics, buf-stats, trace-slow, cluster-health,
    slo-report, bench

Usage:
    python -m t3fs_torch.cli.admin --monitor ADDR soak-status
    python -m t3fs_torch.cli.admin --monitor ADDR trace-show 0x1f
    python -m t3fs_torch.cli.admin --mgmtd ...      # interactive shell
"""

from __future__ import annotations

import argparse
import asyncio
import shlex
import sys

from t3fs_torch.client.meta_client import MetaClient
from t3fs_torch.client.mgmtd_client import MgmtdClient
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.fuse.vfs import FileSystem
from t3fs_torch.monitor.service import HealthReq, QueryMetricsReq, QuerySpansReq
from t3fs_torch.net.client import Client
from t3fs_torch.utils.status import StatusError

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
                 token: str = "", migration: str = ""):
        self.mgmtd_address = mgmtd
        self.meta_address = meta
        self.monitor_address = monitor
        self.migration_address = migration
        self.token = token
        self.cli = Client()
        self._mgmtd_client: MgmtdClient | None = None
        self._fs: FileSystem | None = None
        self._sc: StorageClient | None = None

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

    async def close(self) -> None:
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


_TREND = {1: "↗", 0: "→", -1: "↘"}   # ↗ → ↘


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


# ---------------- driver ----------------

def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="t3fs-admin")
    ap.add_argument("--mgmtd", default="127.0.0.1:9000")
    ap.add_argument("--meta", default="")
    ap.add_argument("--monitor", default="")
    ap.add_argument("--migration", default="",
                    help="migration service address (migrate commands)")
    ap.add_argument("--token", default="")
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
                       migration=args.migration)

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
