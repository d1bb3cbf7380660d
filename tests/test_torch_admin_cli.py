"""The port's admin CLI (t3fs_torch/cli/admin.py) against the reference's
(t3fs/cli/admin.py) on the CPU: every one of the 80 commands is parsed
and dispatched by both packages' `build_parser` and `dispatch`, in the
test's own loop, and the two outputs (return code, stdout, stderr) must be
equal as strings after the masks below.

- Read-only commands run on one port `LocalCluster(with_meta=True,
  with_monitor=True)`, the reference's clients talking to the port's
  servers over the wire (as tests/test_torch_rebalancer.py does).
- Mutating commands run on two clusters built the same way, one per
  package's CLI, in lockstep; the state after them is read back by `ls`,
  `stat`, `routing` and `dump-chunkmeta` through each CLI and compared.
- The monitor commands run against one port monitor holding seeded rows;
  the stats-file commands on the same JSON and Parquet files; the
  migration commands against one port Migration/Rebalance server; the
  `kv-*` commands live in tests/test_torch_kv_surgery.py.

`time.time` and `time.localtime` are pinned in both CLI modules (and in
the checkpoint writer when the two clusters save) by monkeypatch, and
`user-add`'s token generator in both packages' core service, as
tests/torch_kv_diff.py pins its clocks.  The port's CLI runs with
`device="cpu"` (ckpt-verify's codec on its plain versions), the servers
with `checksum_backend="cpu"`, and the reference's checkpoint codec in
Pallas interpret mode.  `CASES` maps each command to the test that runs
it, and each test checks that it ran exactly its commands.
"""

import asyncio
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import time as _time

import numpy as np
import pytest

import t3fs.ckpt.writer
import t3fs.cli.admin as ref_admin
import t3fs.core.service
import t3fs_torch.ckpt.writer
import t3fs_torch.cli.admin as port_admin
import t3fs_torch.core.service

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T0 = 1_700_000_000.0
CKPT = "/ckpts/run"
KV_CASE = "tests/test_torch_kv_surgery.py::test_kv_cli_commands_equal_across_packages"

# --- masks: (pattern, replacement); each names why the value is not the
# CLI's own.  A masked cell can change a table column's width, so a masked
# output has its runs of spaces collapsed as well.
MASKS = {
    # two clusters listen on ports of their own; a live node's address
    "port": (r"127\.0\.0\.1:\d+", "127.0.0.1:<port>"),
    # app-info's uptime: the server's own clock between the two calls
    "uptime": (r"uptime=\d+\.\ds", "uptime=<s>"),
    # bench's rates: wall-clock throughput of each package's run
    "mbps": (r"\d+\.\d MB/s", "<MB/s>"),
    # echo's round trip, timed on the host's clock
    "echo_ms": (r"\(\d+\.\d\d ms\)", "(<ms>)"),
    # list-nodes' heartbeat age: mgmtd's clock against the node's latest
    # heartbeat, which lands between the two calls
    "hb_age": (r"(up|DOWN)(\s+)\d+\.\ds", r"\1\2<age>"),
    # lease's ttl: mgmtd's expiry (extended every second) against the
    # pinned clock
    "ttl": (r"ttl=-?\d+\.\ds", "ttl=<s>"),
    # client-sessions' ages: the sessions' real start and extend times
    # against the pinned clock; the sessions extend between the calls
    "session_age": (r"-?\d+(\.\d)?s\b", "<s>"),
}

# command -> the test that dispatches it through both CLIs
CASES = {name: "test_read_only_commands_equal_on_one_cluster" for name in (
    "list-nodes", "repair-status", "lease", "routing", "orphan-targets",
    "config-versions", "client-sessions", "gen-chains",
    "get-config-template", "app-info", "echo", "get-config",
    "verify-config", "user-list", "ls", "stat", "get", "cat", "checksum",
    "trash-ls", "ckpt-list", "ckpt-stat", "ckpt-verify", "space-info",
    "dump-inodes", "dump-dirents", "find-orphaned-chunks", "checksum-sweep",
    "query-chunk", "dump-chunkmeta", "cluster-health")}
CASES.update({name: "test_mutating_commands_equal_on_two_clusters"
              for name in (
    "rotate-lastsrv", "update-chain", "set-preferred-order",
    "rotate-preferred", "enable-node", "disable-node", "unregister-node",
    "node-tags", "universal-tags", "set-config-template",
    "hot-update-config", "user-add", "user-remove", "mkdir", "chmod",
    "chown", "rm", "mv", "put", "truncate", "trash-put", "trash-clean",
    "ckpt-gc", "fill-zero", "create-target", "offline-target",
    "remove-target", "bench")})
CASES.update({name: "test_monitor_commands_equal_on_one_monitor"
              for name in ("metrics", "buf-stats", "trace-slow",
                           "slo-report", "trace-show", "soak-status")})
CASES.update({name: "test_stats_file_commands_equal"
              for name in ("rpc-top", "read-stats", "kvcache-stats")})
CASES.update({name: "test_trace_file_commands_equal"
              for name in ("trace-read", "trace-top")})
CASES.update({name: "test_migration_commands_equal"
              for name in ("migrate", "migrate-status", "rebalance-status")})
CASES.update({name: KV_CASE for name in (
    "kv-status", "kv-publish-map", "kv-map", "kv-split", "kv-move",
    "kv-merge", "kv-move-resume")})


def cases_of(test: str) -> set:
    return {name for name, t in CASES.items() if t == test}


def test_command_table_covers_every_reference_command():
    assert set(CASES) == set(ref_admin.COMMANDS) == set(port_admin.COMMANDS)
    assert len(CASES) == 80
    here = sys.modules[__name__]
    for test in set(CASES.values()):
        if "::" in test:
            path, fn = test.split("::")
            with open(os.path.join(REPO, path)) as f:
                assert f"def {fn}(" in f.read(), test
        else:
            assert callable(getattr(here, test, None)), test


# --- running one command through a package's CLI

class PinnedTime:
    """A CLI module's `time`: time() and localtime() pinned (localtime as
    UTC), everything else the real module's."""

    def time(self) -> float:
        return T0

    def localtime(self, secs=None):
        return _time.gmtime(T0 if secs is None else secs)

    def __getattr__(self, name):
        return getattr(_time, name)


class PinnedSecrets:
    """The core service's `secrets`: a fixed user token."""

    def token_hex(self, nbytes: int = 32) -> str:
        return "5e" * nbytes

    def __getattr__(self, name):
        import secrets
        return getattr(secrets, name)


@pytest.fixture
def pinned(monkeypatch):
    for mod in (ref_admin, port_admin, t3fs.ckpt.writer,
                t3fs_torch.ckpt.writer):
        monkeypatch.setattr(mod, "time", PinnedTime())
    for core in (t3fs.core.service, t3fs_torch.core.service):
        monkeypatch.setattr(core, "secrets", PinnedSecrets())
    # the reference's checkpoint codec: its Pallas kernels interpreted
    monkeypatch.setenv("T3FS_FORCE_PALLAS_INTERPRET", "1")


class Session:
    """One package's CLI over one AdminContext: each command parsed by
    the package's own parser and dispatched in the caller's loop, its
    stdout (text and bytes) and stderr captured."""

    def __init__(self, admin, **addrs):
        self.admin = admin
        self.parser = admin.build_parser()
        kw = {"device": "cpu"} if admin is port_admin else {}
        self.ctx = admin.AdminContext(
            addrs.get("mgmtd", ""), addrs.get("meta", ""),
            addrs.get("monitor", ""), addrs.get("token", ""),
            migration=addrs.get("migration", ""), **kw)
        self.ran: list[str] = []

    async def run(self, *argv: str) -> tuple:
        args = self.parser.parse_args([str(a) for a in argv])
        self.ran.append(args.command)
        raw = io.BytesIO()
        out = io.TextIOWrapper(raw, encoding="utf-8", write_through=True)
        err = io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            try:
                rc = await self.admin.dispatch(self.ctx, args)
            except SystemExit as e:
                rc = f"exit {e.code}"
            except ValueError as e:       # what dispatch lets through
                rc = f"raised {type(e).__name__}: {e}"
        out.flush()
        text = raw.getvalue().decode("utf-8", "replace")
        out.detach()
        return rc, text, err.getvalue()

    async def close(self) -> None:
        await self.ctx.close()


def masked(result: tuple, masks: tuple) -> tuple:
    if not masks:
        return result
    rc, out, err = result
    for name in masks:
        pat, rep = MASKS[name]
        out, err = re.sub(pat, rep, out), re.sub(pat, rep, err)
    return rc, re.sub(r" +", " ", out), re.sub(r" +", " ", err)


async def both(ref: Session, port: Session, *argv, masks=(), ok=True):
    """The command through the reference's CLI, then the port's; their
    masked results must be equal.  Returns the port's."""
    r = masked(await ref.run(*argv), masks)
    p = masked(await port.run(*argv), masks)
    assert p == r, (argv, r, p)
    if ok:
        assert p[0] == 0, (argv, p)
    return p


def sessions(**addrs) -> tuple[Session, Session]:
    return Session(ref_admin, **addrs), Session(port_admin, **addrs)


# --- the cluster both CLIs talk to

def make_cluster():
    from t3fs_torch.testing.cluster import LocalCluster
    # 2 replicated chains of 3 (table 1) for files, 4 one-replica chains
    # (table 2, ids 3-6) for the RS(2+2) checkpoint; a heartbeat timeout
    # test load cannot reach
    return LocalCluster(num_nodes=4, replicas=3, num_chains=2, ec_chains=4,
                        with_meta=True, with_monitor=True,
                        checksum_backend="cpu", heartbeat_timeout_s=60.0)


def addrs_of(cluster) -> dict:
    return {"mgmtd": cluster.mgmtd_rpc.address,
            "meta": cluster.meta_rpc.address, "token": "local-admin"}


def storage_addr(cluster, node_id: int) -> str:
    return cluster.storage[node_id].server.address


async def freeze_health(cluster) -> None:
    """mgmtd's cached scorecard, pulled once and then held: the CLI's
    mgmtd fallback of cluster-health reads the same copy twice."""
    for _ in range(100):
        if cluster.mgmtd.state.health is not None:
            break
        await asyncio.sleep(0.05)
    cluster.mgmtd.cfg.health_pull_period_s = 3600.0
    await asyncio.sleep(0.3)        # a pull already under way lands


async def save_ckpts(cluster) -> None:
    """Steps 10 and 20 at the reference test's layout: RS(2+2), 2048-byte
    chunks, over the one-replica chains, by the port's writer."""
    from t3fs_torch.ckpt import CheckpointWriter
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.fuse.vfs import FileSystem
    fs = FileSystem(cluster.mc, cluster.sc)
    lay = ECLayout.create(k=2, m=2, chunk_size=2048, chains=[3, 4, 5, 6])
    ec = ECStorageClient(cluster.sc, codec=TorchECCodec(device="cpu"))
    rng = np.random.default_rng(9)
    w = CheckpointWriter(ec, fs, lay, CKPT)
    for step in (10, 20):
        await w.save(step, {
            "w": rng.standard_normal(2000).astype(np.float32),
            "b": rng.standard_normal(100).astype(np.float64)})
    await ec.close()


async def seed_files(cluster, local_dir: str) -> bytes:
    """A small tree through the port's FileSystem: /d/blob (3 chunks and
    a tail of 4096-byte chunks), /d/sub/tiny, an empty /d/empty."""
    from t3fs_torch.fuse.vfs import FileSystem
    fs = FileSystem(cluster.mc, cluster.sc)
    blob = np.random.default_rng(5).integers(
        0, 256, 3 * 4096 + 777, dtype=np.uint8).tobytes()
    await fs.mkdirs("/d/sub")
    await fs.write_file("/d/blob", blob)
    await fs.write_file("/d/sub/tiny", b"tiny\n")
    await fs.write_file("/d/empty", b"")
    with open(os.path.join(local_dir, "blob.bin"), "wb") as f:
        f.write(blob)
    return blob


# --- read-only commands on one cluster

def test_read_only_commands_equal_on_one_cluster(pinned, tmp_path):
    async def body():
        cluster = make_cluster()
        await cluster.start()
        ref = port = None
        try:
            blob = await seed_files(cluster, str(tmp_path))
            await save_ckpts(cluster)
            await freeze_health(cluster)
            ref, port = sessions(**addrs_of(cluster))
            s1 = storage_addr(cluster, 1)
            # cluster and mgmtd
            await both(ref, port, "list-nodes", masks=("hb_age",))
            await both(ref, port, "repair-status")
            await both(ref, port, "lease", masks=("ttl",))
            out = await both(ref, port, "routing")
            assert "chain-table 2: chains=[3, 4, 5, 6]" in out[1]
            await both(ref, port, "orphan-targets")
            await both(ref, port, "config-versions")
            await both(ref, port, "client-sessions", masks=("session_age",))
            await both(ref, port, "gen-chains", "--nodes", "1,2,3,4",
                       "--chains", "6")
            await both(ref, port, "gen-chains", "--nodes", "1,2,3,4",
                       "--table-type", "ec", "--chains", "8",
                       "--start-chain", "7")
            await both(ref, port, "get-config-template", "storage")
            await both(ref, port, "cluster-health")
            # one server's config and identity
            await both(ref, port, "app-info", s1, masks=("uptime",))
            await both(ref, port, "echo", s1, "hello", masks=("echo_ms",))
            await both(ref, port, "get-config", s1)
            await both(ref, port, "verify-config", s1,
                       "resync_period_s=0.5", "heartbeat_period_s=0.4")
            await both(ref, port, "verify-config", s1, "no_such_key=1",
                       ok=False)
            await both(ref, port, "user-list")
            # files
            await both(ref, port, "ls", "/")
            await both(ref, port, "ls", "/d")
            out = await both(ref, port, "stat", "/d/blob")
            assert f"length={len(blob)}" in out[1]
            await both(ref, port, "stat", "/d")
            await both(ref, port, "stat", "/nope", ok=False)
            for admin, sess in (("ref", ref), ("port", port)):
                local = str(tmp_path / f"got-{admin}.bin")
                rc, out, _ = await sess.run("get", "/d/blob", local)
                assert rc == 0 and out == f"read {len(blob)} bytes from /d/blob\n"
                assert open(local, "rb").read() == blob
            out = await both(ref, port, "cat", "/d/sub/tiny")
            assert out[1] == "tiny\n"
            await both(ref, port, "cat", "/d/blob")
            out = await both(ref, port, "checksum", "/d/blob")
            from t3fs_torch.ops.codec import crc32c
            assert f"crc32c={crc32c(blob):#010x}" in out[1]
            await both(ref, port, "trash-ls")
            # checkpoints
            out = await both(ref, port, "ckpt-list", CKPT)
            assert "10" in out[1] and "20" in out[1]
            out = await both(ref, port, "ckpt-stat", CKPT, "--step", "10")
            assert "rs=(2+2)" in out[1] and "float32" in out[1]
            await both(ref, port, "ckpt-stat", CKPT)
            out = await both(ref, port, "ckpt-verify", CKPT)
            assert "missing=0 corrupt=0 repaired=0" in out[1]
            assert "unrecoverable=0" in out[1]
            await both(ref, port, "ckpt-verify", CKPT, "--step", "10")
            # storage
            await both(ref, port, "space-info", s1)
            await both(ref, port, "dump-inodes")
            await both(ref, port, "dump-inodes", "--limit", "3")
            await both(ref, port, "dump-dirents")
            # the checkpoint's shards live under inodes of their own, which
            # meta does not hold: both CLIs list them
            out = await both(ref, port, "find-orphaned-chunks")
            assert "orphaned chunks (" in out[1]
            for chain in (1, 2, 3, 99):
                out = await both(ref, port, "checksum-sweep", chain)
            out = await both(ref, port, "checksum-sweep", 1)
            assert ", 0 bad, 0 errors" in out[1]
            ino = (await cluster.mc.stat("/d/blob")).inode_id
            await both(ref, port, "dump-chunkmeta", s1, 2, ok=False)
            for chain in (1, 2):          # chain c starts on node c
                head = storage_addr(cluster, chain)
                await both(ref, port, "dump-chunkmeta", head, chain)
                for idx in range(5):
                    await both(ref, port, "query-chunk", head, chain, ino,
                               idx)
            assert set(port.ran) == set(ref.ran) == cases_of(
                "test_read_only_commands_equal_on_one_cluster")
        finally:
            for s in (ref, port):
                if s is not None:
                    await s.close()
            await cluster.stop()
    asyncio.run(body())


# --- mutating commands on two clusters, one per package's CLI

class TrashClock:
    """Both trash modules' `datetime`, now() read from a clock the test
    moves (slot names and the cleaner's expiry follow it)."""

    def __init__(self, monkeypatch):
        from datetime import datetime, timezone
        self.now = datetime.fromtimestamp(T0, timezone.utc)
        clock = self

        class Pinned(datetime):
            @classmethod
            def now(cls, tz=None):
                return clock.now.astimezone(tz) if tz else clock.now

        import t3fs.utils.trash
        import t3fs_torch.utils.trash
        for mod in (t3fs.utils.trash, t3fs_torch.utils.trash):
            monkeypatch.setattr(mod, "datetime", Pinned)


async def remove_first_shard(cluster, chain_id: int) -> str:
    """REMOVE the lowest chunk id on a one-replica checkpoint chain, through
    the cluster's storage client; returns its id."""
    from t3fs_torch.storage.types import SyncStartReq, UpdateType
    node = cluster.mgmtd.state.routing().chains[chain_id].targets[0].node_id
    rsp, _ = await cluster.admin.call(storage_addr(cluster, node),
                                      "Storage.sync_start",
                                      SyncStartReq(chain_id=chain_id))
    cid = min((m.chunk_id for m in rsp.metas),
              key=lambda c: (c.inode, c.index))
    r = await cluster.sc.write_chunk(chain_id, cid, 0, b"", 2048,
                                     update_type=UpdateType.REMOVE)
    assert r.status.code == 0, r
    return str(cid)


async def state_of(sess: Session, cluster) -> list:
    """What the test reads back after the mutations, through one CLI."""
    out = []
    for argv in (("ls", "/"), ("ls", "/ops"), ("ls", "/d"),
                 ("stat", "/ops/blob2"), ("stat", "/ops/big"),
                 ("stat", "/d/blob"), ("checksum", "/d/blob"),
                 ("checksum", "/ops/big"), ("routing",),
                 ("universal-tags",), ("user-list",),
                 ("get-config-template", "storage"), ("trash-ls",),
                 ("ckpt-list", CKPT)):
        out.append(masked(await sess.run(*argv), ("port",)))
    for chain in (1, 2):
        out.append(masked(await sess.run(
            "dump-chunkmeta", storage_addr(cluster, chain), chain),
            ("port",)))
    return out


def test_mutating_commands_equal_on_two_clusters(pinned, monkeypatch,
                                                 tmp_path):
    clock = TrashClock(monkeypatch)
    template = tmp_path / "storage.toml"
    template.write_text("[service]\nresync_period_s = 0.25\n")
    big = np.random.default_rng(6).integers(
        0, 256, 5 * 8192 + 5, dtype=np.uint8).tobytes()
    (tmp_path / "big.bin").write_bytes(big)

    async def body():
        clusters = [make_cluster(), make_cluster()]
        sess: list[Session] = []
        try:
            for c in clusters:
                await c.start()
                await seed_files(c, str(tmp_path))
                await save_ckpts(c)
            ref = Session(ref_admin, **addrs_of(clusters[0]))
            port = Session(port_admin, **addrs_of(clusters[1]))
            sess += [ref, port]

            async def step(*argv, ok=True, masks=("port",), per_cluster=None):
                results = []
                for s, c in zip(sess, clusters):
                    a = per_cluster(c) if per_cluster else ()
                    results.append(masked(await s.run(*argv, *a), masks))
                assert results[1] == results[0], (argv, results)
                if ok:
                    assert results[1][0] == 0, (argv, results[1])
                return results[1]

            def node(n):
                return lambda c: (storage_addr(c, n),)

            # mgmtd: tags, templates, users
            out = await step("universal-tags", "fleet:dev", "--set")
            assert "fleet:dev" in out[1]
            await step("node-tags", 2, "rack:r1", "zone:z")
            await step("node-tags", 99, "x", ok=False)
            await step("set-config-template", "storage", str(template))
            await step("get-config-template", "storage")
            out = await step("user-add", 7, "alice")
            assert out[1] == f"uid=7 name=alice admin=False token={'5e' * 16}\n"
            await step("user-add", 8, "bob", "--admin")
            await step("user-add", 7, "again")        # replaces uid 7
            await step("user-remove", 7)
            await step("user-remove", 7)
            # one server's live config
            out = await step("hot-update-config", per_cluster=lambda c: (
                storage_addr(c, 1), "resync_period_s=0.123"))
            assert "resync_period_s" in out[1]
            await step("get-config", per_cluster=node(1))
            await step("hot-update-config", per_cluster=lambda c: (
                storage_addr(c, 1), "no_such_key=1"), ok=False)
            # chains: preferred order, rotations, surgery, a new table
            await step("set-preferred-order", 1, 201, 101, 301)
            await step("rotate-preferred", 1)
            await step("rotate-lastsrv", 1, ok=False)
            await step("rotate-lastsrv", 99, ok=False)
            # a SERVING target is refused: only OFFLINE ones leave a chain
            out = await step("update-chain", 2, "remove", 402, ok=False)
            assert "only OFFLINE targets" in out[2]
            await step("update-chain", 2, "remove", 999, ok=False)
            await step("gen-chains", "--nodes", "1,2,3", "--chains", "2",
                       "--start-chain", "20", "--table-id", "3", "--apply")
            # nodes: drain and undrain, retire refused while on chains
            await step("disable-node", 4)
            await step("enable-node", 4)
            await step("unregister-node", 4, ok=False)
            await step("unregister-node", 77, ok=False)
            await step("orphan-targets")
            # targets on a node: provision, offline, drop
            roots = [tmp_path / "tgt-a", tmp_path / "tgt-b"]
            out = await step("create-target", per_cluster=lambda c: (
                storage_addr(c, 3), 9001,
                str(roots[clusters.index(c)])))
            assert "target 9001 created" in out[1]
            await step("offline-target", per_cluster=lambda c: (
                storage_addr(c, 3), 9001))
            await step("remove-target", per_cluster=lambda c: (
                storage_addr(c, 3), 9001))
            await step("remove-target", per_cluster=lambda c: (
                storage_addr(c, 3), 9001), ok=False)
            # files
            await step("mkdir", "/ops/sub")
            await step("put", tmp_path / "blob.bin", "/ops/blob")
            await step("put", tmp_path / "big.bin", "/ops/big",
                       "--chunk-size", 8192)
            out = await step("chmod", "/ops/blob", "640")
            assert "perm=0o640" in out[1]
            out = await step("chown", "/ops/blob", 7, 8)
            assert "uid=7 gid=8" in out[1]
            await step("truncate", "/ops/blob", 5000)
            await step("mv", "/ops/blob", "/ops/blob2")
            await step("mv", "/ops/nope", "/ops/x", ok=False)
            await step("rm", "/ops/sub")
            await step("rm", "/ops/sub", ok=False)
            ino = (await clusters[1].mc.stat("/ops/big")).inode_id
            assert ino == (await clusters[0].mc.stat("/ops/big")).inode_id
            lay = (await clusters[1].mc.stat("/ops/big")).layout
            out = await step("fill-zero", lay.chains[0], ino, 0, 1,
                             "--chunk-size", 8192)
            assert out[1] == f"chunk {ino}.0: 0\n"
            # trash: two slots, then the 1h one past its expiry
            await step("trash-put", "/d/sub", "--ttl", "1h")
            await step("trash-put", "/d/empty")
            await step("trash-put", "/d/blob", "--ttl", "99y", ok=False)
            await step("trash-ls")
            from datetime import timedelta
            clock.now += timedelta(hours=2)
            out = await step("trash-clean")
            assert out[1].startswith("removed 1: ['1h-")
            # checkpoints: a lost shard repaired, then the older step gone
            lost = [await remove_first_shard(c, 3) for c in clusters]
            assert lost[0] == lost[1]
            out = await step("ckpt-verify", CKPT, "--step", "20",
                             "--repair")
            assert "missing=1" in out[1] and "repaired=1" in out[1]
            out = await step("ckpt-verify", CKPT, "--step", "20")
            assert "missing=0" in out[1]
            out = await step("ckpt-gc", CKPT, "--keep", "1")
            assert "removed=[10]" in out[1] and "kept=[20]" in out[1]
            await step("ckpt-stat", CKPT, "--step", "10", ok=False)
            # the quick bench (rates masked), kept and then removed
            out = await step("bench", "--files", "2", "--size", "65536",
                             masks=("port", "mbps"))
            assert out[1].startswith("write: <MB/s> read: <MB/s>")
            # --keep leaves its file in the state read back below: its
            # payload (os.urandom) is seeded, the same for both clusters
            kept = []
            for s in sess:
                with monkeypatch.context() as mp:
                    mp.setattr(os, "urandom", np.random.default_rng(3).bytes)
                    kept.append(masked(await s.run(
                        "bench", "--files", "1", "--size", "4096", "--dir",
                        "/_kept", "--keep"), ("port", "mbps")))
            assert kept[1] == kept[0] and kept[1][0] == 0
            # the state both CLIs read back afterwards
            await asyncio.sleep(0.5)       # routing settles on both
            states = [await state_of(s, c) for s, c in zip(sess, clusters)]
            assert states[1] == states[0]
            assert all(rc == 0 for rc, _o, _e in states[1]), states[1]
            assert cases_of("test_mutating_commands_equal_on_two_clusters") \
                <= set(port.ran) == set(ref.ran)
        finally:
            for s in sess:
                await s.close()
            for c in clusters:
                await c.stop()
    asyncio.run(body())


# --- the monitor's commands on one monitor holding seeded rows

def _server_span(name, addr, dur_s, trace_id, status=0, root=True, **tags):
    return {"trace_id": trace_id, "span_id": trace_id * 10 + 1,
            "parent_id": 0, "name": name, "kind": "server", "root": root,
            "t0": 1_700_000_000.0 + trace_id * 1e-3, "dur_s": dur_s,
            "status": status, "node_id": 1 + trace_id % 3,
            "tags": {"addr": addr, **tags}}


def seed_monitor(db) -> list[dict]:
    """Metrics, registered-memory counters, soak rows and server spans: all
    the monitor commands read.  Span arrival times sit in the monitor's
    live window (its rollups age rows against the real clock)."""
    db.insert(1, "storage", T0 + 1, [
        {"name": "storage.write.bytes", "value": 4096, "type": "counter"},
        {"name": "storage.read.ops", "value": 3}])
    db.insert(2, "storage", T0 + 2, [
        {"name": "storage.write.bytes", "value": 8192.5}])
    db.insert(1, "storage", T0 + 3, [
        {"name": "rdma.pool.hits", "value": 10},
        {"name": "rdma.pool.misses", "value": 2}])
    db.insert(1, "storage", T0 + 4, [{"name": "rdma.pool.hits", "value": 12}])
    db.insert(2, "storage", T0 + 4, [
        {"name": "rdma.doorbells", "value": 7.25}])
    db.insert(0, "soak", T0 + 5, [
        {"name": "soak.loader.ops", "value": 25},
        {"name": "soak.loader.errors", "value": 1},
        {"name": "soak.loader.p50_ms", "value": 3.5}])
    rng = np.random.default_rng(17)
    spans = []
    for i in range(60):
        addr = f"10.0.0.{1 + i % 3}:9000"
        name = ("Storage.batch_read", "Storage.write", "Meta.stat")[i % 3]
        spans.append(_server_span(
            name, addr, float(rng.uniform(0.0005, 0.004)) * (1 + i % 3),
            trace_id=100 + i, status=9 if i % 17 == 0 else 0,
            wire_s=0.0001, queue_s=0.0002))
    spans.append(_server_span("Storage.batch_read", "10.0.0.2:9000", 0.25,
                              trace_id=777))
    base = (_time.time() // 1.0) * 1.0 - 10.0
    db.insert_spans(7, "storage", base + 0.5, spans)
    return spans


def test_monitor_commands_equal_on_one_monitor(pinned):
    async def body():
        from t3fs_torch.monitor.service import MonitorCollectorServer
        mon = MonitorCollectorServer()
        await mon.start()
        ref, port = sessions(monitor=mon.address)
        bare = sessions()
        try:
            spans = seed_monitor(mon.db)
            mon.rollup.rollup_once()
            for argv in (("metrics",), ("metrics", "storage."),
                         ("metrics", "storage.write", "--limit", "1"),
                         ("metrics", "--since", str(T0 + 2)),
                         ("buf-stats",), ("buf-stats", "--limit", "2"),
                         ("trace-slow",), ("trace-slow", "--method",
                                           "Storage.", "--min-ms", "2"),
                         ("trace-slow", "--since", "60", "--limit", "3"),
                         ("cluster-health",),
                         ("cluster-health", "--window", "120"),
                         ("slo-report",), ("slo-report", "--window", "120"),
                         ("trace-show", "0x309"), ("trace-show", "777"),
                         ("soak-status",)):
                out = await both(ref, port, *argv)
                assert out[1].strip(), argv
            out = await both(ref, port, "cluster-health")
            assert "10.0.0.2:9000" in out[1] and "0x309" in out[1]
            out = await both(ref, port, "trace-slow", "--limit", "1")
            assert "0x309" in out[1] and "250.00" in out[1]
            assert len(spans) == 61
            # without --monitor each refuses before any call
            for argv in (("metrics",), ("buf-stats",), ("trace-slow",),
                         ("slo-report",), ("trace-show", "1"),
                         ("soak-status",)):
                r = await bare[0].run(*argv)
                assert await bare[1].run(*argv) == r
                assert r[0] == "exit " + f"{argv[0]} needs --monitor ADDR"
            assert set(port.ran) == set(ref.ran) == cases_of(
                "test_monitor_commands_equal_on_one_monitor") | {
                    "cluster-health"}
        finally:
            for s in (ref, port, *bare):
                await s.close()
            await mon.stop()
    asyncio.run(body())


# --- commands over stats files

def seeded_rpc_stats(pkg_rpcstats):
    st = pkg_rpcstats.RpcStats()
    rng = np.random.default_rng(4)
    for i in range(200):
        m = ("Storage.batch_read", "Storage.write", "Mgmtd.heartbeat")[i % 3]
        server = float(rng.uniform(0.0001, 0.003))
        squeue = float(rng.uniform(0.0, 0.0005))
        net = float(rng.uniform(0.00005, 0.001))
        st.record(m, server + squeue + net, squeue, server, net,
                  ok=i % 23 != 0)
    return st


def seeded_read_stats(pkg_rpcstats):
    rs = pkg_rpcstats.ReadStats()
    rng = np.random.default_rng(8)
    for i in range(300):
        addr = f"10.0.0.{1 + i % 4}:9000"
        rs.begin(addr)
        rs.end(addr, "Storage.batch_read", float(rng.uniform(0.001, 0.02)),
               True)
    rs.begin("10.0.0.1:9000")            # one still in flight
    rs.hedge("10.0.0.2:9000", fired=5, won=3, wasted=2)
    return rs


KVCACHE_SNAPS = [
    {"pid": 1, "tiers": [{"namespace": "ns", "puts": 10, "gets": 100,
                          "hits": 80, "misses": 20, "dirty_bytes": 512,
                          "ledger_live_keys": 5, "ledger_live_bytes": 5000,
                          "gc": {"removed": 3, "fence_lost": 1}}]},
    {"pid": 2, "tiers": [{"namespace": "ns", "puts": 5, "gets": 50,
                          "hits": 25, "misses": 25, "ledger_live_keys": 6,
                          "ledger_live_bytes": 6000, "gc": {}},
                         {"namespace": "other", "puts": 1, "gets": 3,
                          "hits": 3, "misses": 0, "gc": {}}]},
]


def test_stats_file_commands_equal(pinned, tmp_path):
    """rpc-top (files and --live), read-stats and kvcache-stats on the same
    files, as tests/test_net.py and tests/test_kvcache_tier.py drive the
    reference's."""
    import t3fs_torch.net.rpcstats as port_rpcstats
    st = seeded_rpc_stats(port_rpcstats)
    st.dump(str(tmp_path / "rpc.1.json"))
    (tmp_path / "rpc.2.json").write_text(json.dumps(
        {"Storage.write": st.snapshot()["Storage.write"]}))
    (tmp_path / "rpc.bad.json").write_text("{not json")
    seeded_read_stats(port_rpcstats).dump(str(tmp_path / "read.1.json"))
    for i, snap in enumerate(KVCACHE_SNAPS):
        (tmp_path / f"kv.{i}.json").write_text(json.dumps(snap))
    rpc, read, kv = (str(tmp_path / "rpc.*.json"),
                     str(tmp_path / "read.*.json"),
                     str(tmp_path / "kv.*.json"))

    async def body():
        from t3fs_torch.core.service import AppInfo, CoreService
        from t3fs_torch.net.server import Server
        srv = Server()
        srv.add_service(CoreService(AppInfo(3, "demo", "")))
        await srv.start()
        ref, port = sessions()
        try:
            for argv in (("rpc-top", str(tmp_path / "rpc.1.json")),
                         ("rpc-top", rpc), ("rpc-top", rpc, "--limit", "2"),
                         ("rpc-top", rpc, "--sort", "server_p50_ms"),
                         ("rpc-top", str(tmp_path / "missing.json")),
                         ("read-stats", read),
                         ("read-stats", read, "--limit", "2"),
                         ("read-stats", str(tmp_path / "none.json")),
                         ("kvcache-stats", kv),
                         ("kvcache-stats", str(tmp_path / "kv.0.json")),
                         ("kvcache-stats", str(tmp_path / "none.json"))):
                await both(ref, port, *argv)
            out = await both(ref, port, "rpc-top", rpc)
            assert "Storage.batch_read" in out[1] and "srv50" in out[1]
            out = await both(ref, port, "kvcache-stats", kv)
            assert "70.0" in out[1] and "6000" in out[1]
            # --live: each call pulls the server's registry as seeded
            # just before it (the calls themselves add rows to it)
            results = []
            for s in (ref, port):
                port_rpcstats.RPC_STATS.clear()
                for m, sample in (("Core.echo", 0.002), ("Core.echo", 0.004),
                                  ("Storage.write", 0.01)):
                    port_rpcstats.RPC_STATS.record(m, sample, 0.0005,
                                                   sample / 2, sample / 4)
                results.append(await s.run(
                    "rpc-top", "--live", srv.address, "127.0.0.1:1"))
            assert results[1] == results[0] and results[1][0] == 0
            assert "Core.echo" in results[1][1]
            assert "127.0.0.1:1: unreachable" in results[1][1]
            assert set(port.ran) == set(ref.ran) == cases_of(
                "test_stats_file_commands_equal")
        finally:
            port_rpcstats.RPC_STATS.clear()
            for s in (ref, port):
                await s.close()
            await srv.stop()
    asyncio.run(body())


def test_trace_file_commands_equal(pinned, tmp_path):
    """trace-read and trace-top on one Parquet storage trace, as
    tests/test_analytics.py drives the reference's."""
    pytest.importorskip("pyarrow")
    from t3fs_torch.analytics.trace_log import (
        StorageEventTrace, StructuredTraceLog)
    path = str(tmp_path / "ev.parquet")
    tl = StructuredTraceLog(StorageEventTrace, path, flush_interval_s=0.05)
    for i in range(60):
        tl.append(StorageEventTrace(
            ts=float(i), node_id=1 + i % 3, target_id=101 + i % 3,
            chain_id=1 + i % 2, chunk_id=f"7.{i}", update_type="write",
            length=4096, commit_status=0 if i % 10 else 5016,
            latency_s=0.001 * (1 + i % 3)))
    tl.close()

    async def body():
        ref, port = sessions()
        try:
            for argv in (("trace-read", path, "--limit", "5"),
                         ("trace-read", path, "--limit", "0"),
                         ("trace-read", str(tmp_path), "--node", "2",
                          "--errors-only"),
                         ("trace-read", path, "--chain", "2", "--limit",
                          "7"),
                         ("trace-read", str(tmp_path / "none.parquet")),
                         ("trace-top", path),
                         ("trace-top", path, "--by", "node"),
                         ("trace-top", path, "--by", "chain", "--node", "3"),
                         ("trace-top", path, "--by", "status"),
                         ("trace-top", path, "--by", "type", "--chain", "1"),
                         ("trace-top", str(tmp_path / "none.parquet"))):
                await both(ref, port, *argv)
            out = await both(ref, port, "trace-read", path, "--limit", "5")
            assert "chunk=7.0" in out[1] and "(5 rows)" in out[1]
            out = await both(ref, port, "trace-top", path, "--by", "node")
            assert out[1].splitlines()[1].startswith("node 3")
            assert set(port.ran) == set(ref.ran) == cases_of(
                "test_trace_file_commands_equal")
        finally:
            for s in (ref, port):
                await s.close()
    asyncio.run(body())


# --- the migration service's commands, one job per package's cluster

def test_migration_commands_equal(pinned):
    """migrate, migrate-status and rebalance-status against each cluster's
    Migration and Rebalance services (tests/test_migration.py's live move:
    node 3's replica of chain 1 to a new target on node 4)."""
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.migration.rebalancer import RebalanceMove, Rebalancer
    from t3fs_torch.migration.service import MigrationService
    from t3fs_torch.net.server import Server
    from t3fs_torch.testing.cluster import LocalCluster

    async def body():
        clusters, servers, migs = [], [], []
        sess: list[Session] = []
        try:
            for _ in range(2):
                c = LocalCluster(num_nodes=4, replicas=3,
                                 checksum_backend="cpu",
                                 heartbeat_timeout_s=60.0)
                await c.start()
                clusters.append(c)
                await c.sc.write_file_range(
                    FileLayout(chunk_size=4096, chains=[1]), 9, 0,
                    b"pre-migration" * 400)
                mig = MigrationService(c.mgmtd_rpc.address, client=c.admin,
                                       poll_period_s=0.05,
                                       sync_timeout_s=30.0)
                reb = Rebalancer(mig, budget_mbps=64.0)
                srv = Server()
                srv.add_service(mig)
                srv.add_service(reb)
                await srv.start()
                servers.append(srv)
                migs.append((mig, reb))
            bare = sessions()
            sess += bare
            for argv in (("migrate", 1, 301, 9400, 4, "/x"),
                         ("migrate-status",), ("rebalance-status",)):
                r = await bare[0].run(*argv)
                assert await bare[1].run(*argv) == r
                assert r[0] == 1 and "--migration <addr> required" in r[2]
            ref = Session(ref_admin, migration=servers[0].address)
            port = Session(port_admin, migration=servers[1].address)
            sess += [ref, port]

            async def step(*argv, per_cluster=None):
                results = []
                for s, c in zip((ref, port), clusters):
                    a = per_cluster(c) if per_cluster else ()
                    results.append(await s.run(*argv, *a))
                assert results[1] == results[0], (argv, results)
                assert results[1][0] == 0, results[1]
                return results[1]

            assert (await step("migrate-status"))[1] == "no jobs\n"
            await step("rebalance-status")
            out = await step("migrate", 1, 301, 9400, 4, per_cluster=lambda c:
                             (c.node_root(4) + "/mig",))
            assert out[1] == "job 1 submitted\n"
            for mig, _reb in migs:
                for _ in range(300):
                    job = mig.jobs.get(1)
                    if job is not None and job.state in ("done", "failed"):
                        break
                    await asyncio.sleep(0.1)
                assert job.state == "done", (job.state, job.error)
            out = await step("migrate-status")
            assert "job 1: chain 1 301->9400@4 state=done" in out[1]
            for _mig, reb in migs:       # the move ledger rebalance-status shows
                reb.ticks, reb.bytes_submitted = 3, 1 << 20
                reb.moves[(1, 1, 301)] = RebalanceMove(
                    1, 1, 301, 3, 9400, 4, state="done", job_id=1,
                    bytes_est=5200)
                reb.moves[(1, 1, 201)] = RebalanceMove(
                    1, 1, 201, 2, 9401, 4, state="deferred",
                    reason="chain busy")
            out = await step("rebalance-status")
            assert "done=1" in out[1] and "chain busy" in out[1]
            assert cases_of("test_migration_commands_equal") <= set(port.ran)
        finally:
            for s in sess:
                await s.close()
            for (mig, reb), srv in zip(migs, servers):
                await mig.stop()
                await srv.stop()
            for c in clusters:
                await c.stop()
    asyncio.run(body())


# --- the whole CLI through its entry point (twins of tests/test_admin_cli.py)

def run_cli(cluster, *argv: str) -> str:
    cmd = [sys.executable, "-m", "t3fs_torch.cli.admin", "--cpu",
           "--mgmtd", cluster.mgmtd_address]
    if cluster.meta_address:
        cmd += ["--meta", cluster.meta_address]
    cmd += list(argv)
    out = subprocess.run(
        cmd, capture_output=True, text=True, timeout=120,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(
            filter(None, [REPO, os.environ.get("PYTHONPATH", "")]))})
    assert out.returncode == 0, f"{argv}: {out.stdout}\n{out.stderr}"
    return out.stdout


@pytest.mark.slow
def test_admin_cli_families(tmp_path):
    from t3fs_torch.app.dev_cluster import DevCluster
    d = str(tmp_path)
    cluster = DevCluster(d, num_storage=2, replicas=2, num_chains=1,
                         with_meta=True, durable=False, chunk_size=64 * 1024,
                         checksum_backend="cpu")
    asyncio.run(cluster.start())
    try:
        out = run_cli(cluster, "list-nodes")
        assert "storage" in out and "up" in out
        out = run_cli(cluster, "lease")
        assert "primary=node1" in out
        out = run_cli(cluster, "routing")
        assert "chain-table 1" in out and "SERVING" in out
        out = run_cli(cluster, "universal-tags", "fleet:dev", "--set")
        assert "fleet:dev" in out
        out = run_cli(cluster, "universal-tags")
        assert "fleet:dev" in out
        out = run_cli(cluster, "orphan-targets")
        assert "orphan" in out or "target" in out
        out = run_cli(cluster, "config-versions")
        assert out.strip()
        nodes_out = run_cli(cluster, "list-nodes")
        node_id = next(line.split()[0] for line in
                       nodes_out.splitlines()[1:] if line.strip())
        out = run_cli(cluster, "node-tags", node_id, "rack:r1")
        assert "rack:r1" in out

        with open(os.path.join(d, "storage1.port")) as f:
            storage_addr = f"127.0.0.1:{f.read().strip()}"
        out = run_cli(cluster, "app-info", storage_addr)
        assert "storage" in out and "uptime" in out
        out = run_cli(cluster, "get-config", storage_addr)
        assert "heartbeat_period_s" in out
        out = run_cli(cluster, "hot-update-config", storage_addr,
                      "resync_period_s=0.123")
        assert "resync_period_s" in out
        out = run_cli(cluster, "get-config", storage_addr)
        assert "0.123" in out
        out = run_cli(cluster, "verify-config", storage_addr,
                      "resync_period_s=0.5")
        assert "would update" in out

        run_cli(cluster, "mkdir", "/cli")
        local = os.path.join(d, "local.bin")
        data = np.random.default_rng(1).integers(
            0, 256, 200_000, dtype=np.uint8).tobytes()
        with open(local, "wb") as f:
            f.write(data)
        run_cli(cluster, "put", local, "/cli/blob")
        out = run_cli(cluster, "ls", "/cli")
        assert "blob" in out
        out = run_cli(cluster, "stat", "/cli/blob")
        assert "length=200000" in out
        out = run_cli(cluster, "chmod", "/cli/blob", "640")
        assert "perm=0o640" in out
        out = run_cli(cluster, "chown", "/cli/blob", "7", "8")
        assert "uid=7 gid=8" in out
        fetched = os.path.join(d, "fetched.bin")
        run_cli(cluster, "get", "/cli/blob", fetched)
        with open(fetched, "rb") as f:
            assert f.read() == data
        out = run_cli(cluster, "checksum", "/cli/blob")
        from t3fs_torch.ops.codec import crc32c
        assert f"crc32c={crc32c(data):#010x}" in out
        run_cli(cluster, "mv", "/cli/blob", "/cli/blob2")
        out = run_cli(cluster, "ls", "/cli")
        names = {line.split()[0] for line in out.splitlines()[1:] if line}
        assert "blob2" in names and "blob" not in names
        run_cli(cluster, "rm", "/cli/blob2")

        out = run_cli(cluster, "space-info", storage_addr)
        assert "capacity=" in out
        out = run_cli(cluster, "dump-chunkmeta", storage_addr, "1")
        assert "commit_ver" in out
        out = run_cli(cluster, "bench", "--files", "2", "--size", "131072")
        assert "write:" in out and "read:" in out
    finally:
        asyncio.run(cluster.stop())


@pytest.mark.slow
def test_admin_cli_ckpt_family(tmp_path):
    """ckpt-list/stat/verify/gc through `python -m t3fs_torch.cli.admin
    --cpu` against the port's multi-process cluster: the checkpoint is
    written in-process by the port's writer, then inspected and reclaimed
    through the CLI."""
    from t3fs_torch.app.dev_cluster import DevCluster
    from t3fs_torch.ckpt import CheckpointWriter
    from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.client.meta_client import MetaClient
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.client.storage_client import (
        StorageClient, StorageClientConfig)
    from t3fs_torch.fuse.vfs import FileSystem

    async def save(cluster):
        mgmtd = MgmtdClient(cluster.mgmtd_address, refresh_period_s=0.2)
        await mgmtd.start()
        sc = StorageClient(mgmtd.routing,
                           config=StorageClientConfig(retry_backoff_s=0.1),
                           refresh_routing=mgmtd.refresh)
        meta = MetaClient([cluster.meta_address])
        fs = FileSystem(meta, sc)
        lay = ECLayout.create(k=2, m=2, chunk_size=2048, chains=[1, 2, 3, 4])
        ec = ECStorageClient(sc, codec=TorchECCodec(device="cpu"))
        rng = np.random.default_rng(9)
        w = CheckpointWriter(ec, fs, lay, CKPT)
        for step in (10, 20):
            await w.save(step, {
                "w": rng.standard_normal(2000).astype(np.float32),
                "b": rng.standard_normal(100).astype(np.float64)})
        await ec.close()
        await meta.close_conn()
        await sc.close()
        await mgmtd.stop()

    cluster = DevCluster(str(tmp_path), num_storage=2, replicas=1,
                         num_chains=4, with_meta=True, durable=False,
                         chunk_size=64 * 1024, checksum_backend="cpu")
    asyncio.run(cluster.start())
    try:
        asyncio.run(save(cluster))
        out = run_cli(cluster, "ckpt-list", CKPT)
        assert "10" in out and "20" in out
        out = run_cli(cluster, "ckpt-stat", CKPT, "--step", "10")
        assert "rs=(2+2)" in out and "float32" in out
        assert "w" in out and "b" in out
        out = run_cli(cluster, "ckpt-verify", CKPT)
        assert "missing=0" in out and "corrupt=0" in out
        assert "unrecoverable=0" in out
        out = run_cli(cluster, "ckpt-gc", CKPT, "--keep", "1")
        assert "removed=[10]" in out and "kept=[20]" in out
        out = run_cli(cluster, "ckpt-list", CKPT)
        assert "20" in out and " 10 " not in out
    finally:
        asyncio.run(cluster.stop())
