"""The admin CLI's spine in the port (t3fs_torch/cli/admin.py) against the
reference's (t3fs/cli/admin.py) on the CPU: `render_trace` on seeded span
sets (orphans, events, the wire/queue/apply/forward tags, missing keys),
`soak-status` over each package's monitor from the same Monitor.query rows,
`trace-show` through `main` against a monitor serving in another thread,
the parser's commands and options, and the shell.  Every comparison is
exact string equality; span sets come from numpy seeds 0-7."""

import asyncio
import threading
from argparse import Namespace

import numpy as np
import pytest

import t3fs.cli.admin as ref_admin
import t3fs.monitor.service as ref_mon
import t3fs_torch.cli.admin as port_admin
import t3fs_torch.monitor.service as port_mon

PACKAGES = [(ref_admin, ref_mon), (port_admin, port_mon)]


def seeded_spans(seed: int) -> list[dict]:
    """One trace's spans as Monitor.query_spans returns them: some parents
    never exported (orphans that root at top level), some spans without a
    kind or a node, server tags and events on some."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 24))
    ids = [int(x) for x in rng.choice(np.arange(1, 1 << 20), n, replace=False)]
    trace_id = int(rng.integers(1, 1 << 62))
    spans = []
    for i, sid in enumerate(ids):
        if i == 0:
            parent = 0
        elif rng.random() < 0.75:
            parent = ids[int(rng.integers(0, i))]
        else:
            parent = int(rng.integers(1 << 20, 1 << 21))     # never exported
        tags = {}
        if rng.random() < 0.5:
            tags["addr"] = f"127.0.0.1:{int(rng.integers(1024, 65535))}"
        for k in ("wire_s", "queue_s", "apply_s", "forward_s", "other_s"):
            if rng.random() < 0.4:
                tags[k] = float(rng.random() * 0.02)
        events = [(float(rng.random() * 0.01), f"event{j}",
                   "" if rng.random() < 0.5 else f"detail {j}")
                  for j in range(int(rng.integers(0, 3)))]
        s = {"trace_id": trace_id, "span_id": sid, "parent_id": parent,
             "name": f"Storage.m{int(rng.integers(0, 5))}",
             "kind": str(rng.choice(["client", "server", "internal"])),
             "node_id": int(rng.integers(0, 6)),
             "t0": 1700000000.0 + float(rng.random()),
             "dur_s": float(rng.random() * 0.05),
             "status": 0 if rng.random() < 0.7 else int(rng.integers(1, 9000)),
             "tags": tags if rng.random() < 0.9 else None,
             "events": events}
        for key in ("kind", "node_id", "status", "events"):
            if rng.random() < 0.1:
                del s[key]
        spans.append(s)
    return spans


@pytest.mark.parametrize("seed", range(8))
def test_render_trace_equal_across_packages(seed):
    spans = seeded_spans(seed)
    got = port_admin.render_trace(spans)
    assert got == ref_admin.render_trace(spans)
    assert got.splitlines()[0].endswith(f"({len(spans)} spans)")


def test_render_trace_empty():
    assert port_admin.render_trace([]) == ref_admin.render_trace([]) \
        == "(no spans)"


def _soak_rows(db) -> None:
    db.insert(0, "soak", 100.0, [
        {"name": "soak.loader.ops", "value": 10},
        {"name": "soak.loader.errors", "value": 0},
        {"name": "soak.loader.p50_ms", "value": 2.5}])
    db.insert(0, "soak", 101.0, [
        {"name": "soak.loader.ops", "value": 25},
        {"name": "soak.loader.errors", "value": 1},
        {"name": "soak.loader.p50_ms", "value": 3.5},
        {"name": "soak.ckpt.ops", "value": 4},
        {"name": "soak.ckpt.errors", "value": 0},
        {"name": "soak.ckpt.p50_ms", "value": 150.0}])


@pytest.mark.parametrize("cli_pkg,mon_pkg", [(1, 1), (0, 0), (1, 0)],
                         ids=["port-port", "ref-ref", "port-ref"])
def test_soak_status_renders_latest_rows(cli_pkg, mon_pkg, capsys):
    """Twin of the reference's soak-status test: the newest row per
    workload, over the same Monitor.query RPC; the port's rendering equals
    the reference CLI's over the reference's monitor, whichever package's
    CLI or monitor serves it."""
    admin, mon_mod = PACKAGES[cli_pkg][0], PACKAGES[mon_pkg][1]

    async def render(admin, mon_mod):
        mon = mon_mod.MonitorCollectorServer()
        await mon.start()
        ctx = admin.AdminContext("", monitor=mon.server.address)
        try:
            _soak_rows(mon.db)
            await admin.soak_status(ctx, Namespace(since=0.0, limit=500))
        finally:
            await ctx.close()
            await mon.stop()

    asyncio.run(render(ref_admin, ref_mon))
    want = capsys.readouterr().out
    asyncio.run(render(admin, mon_mod))
    out = capsys.readouterr().out
    assert out == want
    lines = [ln for ln in out.splitlines() if ln.strip()]
    loader = next(ln for ln in lines if "loader" in ln)
    assert "25" in loader and "3.50" in loader     # newest row wins
    assert any("ckpt" in ln for ln in lines)


def test_soak_status_without_rows_and_without_monitor(capsys):
    async def body(admin, mon_mod):
        mon = mon_mod.MonitorCollectorServer()
        await mon.start()
        ctx = admin.AdminContext("", monitor=mon.server.address)
        try:
            await admin.soak_status(ctx, Namespace(since=0.0, limit=500))
        finally:
            await ctx.close()
            await mon.stop()

    outs = []
    for admin, mon_mod in PACKAGES:
        asyncio.run(body(admin, mon_mod))
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and "no soak.* metrics" in outs[1]
    with pytest.raises(SystemExit, match="needs --monitor"):
        asyncio.run(port_admin.soak_status(
            port_admin.AdminContext(""), Namespace(since=0.0, limit=500)))


class MonitorThread:
    """A package's MonitorCollectorServer on its own event loop in a
    thread, so `main` (which runs asyncio.run) can call it."""

    def __init__(self, mon_mod):
        self.loop = asyncio.new_event_loop()
        self.thread = threading.Thread(target=self.loop.run_forever,
                                       daemon=True)
        self.thread.start()
        self.mon = mon_mod.MonitorCollectorServer()
        self._call(self.mon.start())

    def _call(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self.loop).result(30)

    def stop(self):
        self._call(self.mon.stop())
        self.loop.call_soon_threadsafe(self.loop.stop)
        self.thread.join(10)
        self.loop.close()


@pytest.mark.parametrize("seed", [3, 5])
def test_trace_show_through_main_equal_across_packages(seed, capsys):
    """`main(["--monitor", ADDR, "trace-show", TID])` in both packages over
    one monitor holding a seeded trace (and another trace beside it)."""
    spans = seeded_spans(seed)
    other = seeded_spans(seed + 100)
    srv = MonitorThread(port_mon)
    try:
        srv.mon.db.insert_spans(1, "storage", 100.0, spans + other)
        addr = srv.mon.server.address
        tid = hex(spans[0]["trace_id"])
        outs = []
        for admin in (ref_admin, port_admin):
            assert admin.main(["--monitor", addr, "trace-show", tid]) == 0
            outs.append(capsys.readouterr().out)
        rows = srv.mon.db.query_spans(trace_id=spans[0]["trace_id"],
                                      limit=1000)
    finally:
        srv.stop()
    assert outs[0] == outs[1] == port_admin.render_trace(rows) + "\n"
    assert f"({len(spans)} spans)" in outs[1]


def test_parser_lists_exactly_the_ported_commands():
    """The port's registry holds the reference's 80 commands in its order,
    each with the reference's help and options; the program name is the
    reference's, and the global options are the reference's plus `--cpu`
    (ckpt-verify's codec on the host).  An unknown name stays refused."""
    assert list(port_admin.COMMANDS) == list(ref_admin.COMMANDS)
    assert len(port_admin.COMMANDS) == 80
    ref_p, port_p = ref_admin.build_parser(), port_admin.build_parser()
    assert port_p.prog == ref_p.prog == "t3fs-admin"

    def type_key(t):
        # chmod's mode is a lambda in both packages: held by what it parses
        return (t.__name__, t("640")) if getattr(
            t, "__name__", "") == "<lambda>" else t

    def opts(p):
        return [(a.dest, a.option_strings, a.default, type_key(a.type),
                 a.help)
                for a in p._actions if a.dest not in ("help", "command")]

    extra = [o for o in opts(port_p) if o not in opts(ref_p)]
    assert [o for o in opts(port_p) if o[0] != "cpu"] == opts(ref_p)
    assert [(d, o, default) for d, o, default, _t, _h in extra] == [
        ("cpu", ["--cpu"], False)]
    sub = {a.dest: a for a in port_p._actions}["command"]
    ref_sub = {a.dest: a for a in ref_p._actions}["command"]
    assert sorted(sub.choices) == sorted(ref_sub.choices)
    assert len(sub.choices) == 80

    def sub_opts(p):
        return [(a.dest, a.option_strings, a.default, a.nargs, a.const,
                 a.choices, a.required, a.metavar, a.help,
                 type(a).__name__) for a in p._actions]

    for name, p in sub.choices.items():
        assert opts(p) == opts(ref_sub.choices[name]), name
        assert sub_opts(p) == sub_opts(ref_sub.choices[name]), name
        assert port_admin.COMMANDS[name][2] == ref_admin.COMMANDS[name][2]
    args = port_p.parse_args(["--monitor", "h:1", "trace-show", "0x1f",
                              "--limit", "7"])
    assert (args.command, args.trace_id, args.limit, args.monitor) == (
        "trace-show", "0x1f", 7, "h:1")
    assert not args.cpu
    assert port_p.parse_args(["--cpu", "ckpt-verify", "/c"]).cpu
    with pytest.raises(SystemExit):
        port_p.parse_args(["no-such-command"])


def test_repl_lists_commands_and_recovers(monkeypatch, capsys):
    """The shell: `help` lists the registry, a command missing its
    --monitor is an error it survives, `quit` leaves."""
    lines = iter(["help", "", "soak-status", "bogus-command", "quit"])
    monkeypatch.setattr("builtins.input", lambda prompt="": next(lines))
    assert port_admin.main([]) == 0
    cap = capsys.readouterr()
    assert "soak-status" in cap.out and "trace-show" in cap.out
    assert "soak-status needs --monitor ADDR" in cap.err


def test_fmt_helpers_equal_across_packages():
    rows = [["a", 1, 2.5], ["longer-name", 22, "x"]]
    assert port_admin._fmt_table(rows, ["n", "v", "w"]) == \
        ref_admin._fmt_table(rows, ["n", "v", "w"])
    for n in (0, 1, 1023, 1024, 5 << 20, 7 << 30, 9 << 40):
        assert port_admin._fmt_bytes(n) == ref_admin._fmt_bytes(n)
