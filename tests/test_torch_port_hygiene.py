"""The port stands alone: t3fs_torch and chip_smoke import neither jax nor
the JAX package, every entry point defaults to CUDA and refuses to run on
the CPU unasked, and chip_smoke fails without a GPU."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch
from torch_fuse_mounts import needs_fuse
from torch_net_refused import refuse_pump

ROOT = Path(__file__).resolve().parent.parent
SMOKE = str(ROOT / "configs" / "soak_smoke.toml")

IMPORT_ALL = """
import pkgutil, sys
import t3fs_torch
mods = [m.name for m in pkgutil.walk_packages(t3fs_torch.__path__, "t3fs_torch.")]
for name in mods:
    __import__(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith(("jax.", "jaxlib")) or m == "t3fs"
             or m.startswith("t3fs.") or m == "benchmarks"
             or m.startswith("benchmarks."))
print(len(mods), bad)
assert not bad, bad
for pkg in ("net", "mgmtd", "storage", "client", "testing", "utils", "kv",
            "monitor", "core", "meta", "fuse", "ckpt", "lib", "usrbio",
            "kvcache", "app", "analytics", "migration", "analysis", "cli",
            "soak"):
    assert f"t3fs_torch.{pkg}" in mods, pkg
for mod in ("lib.usrbio", "usrbio.ring_client", "usrbio.slots", "fuse.ring_worker",
            "benchmarks.usrbio_bench", "benchmarks.kvcache_scale_bench",
            "benchmarks.storage_bench", "benchmarks.codec_economics",
            "benchmarks.repair_drill_bench", "benchmarks.ec_recovery_bench",
            "benchmarks.health_smoke", "app.base", "app.mgmtd_main",
            "app.storage_main", "app.meta_main", "app.monitor_main",
            "app.dev_cluster", "kv.wal_engine", "mgmtd.placement",
            "monitor.service", "monitor.rollup", "monitor.reporter",
            "monitor.clickhouse", "analytics.trace_log",
            "analytics.trace_query", "utils.mem", "kv.service", "kv.remote",
            "kv.shard", "kv.surgery", "kv.distributor", "app.kv_main",
            "benchmarks.meta_bench", "benchmarks.kv_distributor_bench",
            "mgmtd.chain_table", "migration.service", "migration.rebalancer",
            "app.migration_main", "benchmarks.rebalance_drill_bench",
            "testing.craq_sim", "testing.conn_sim", "testing.race",
            "analysis", "analysis.engine", "analysis.rules", "cli.admin",
            "soak.spec", "soak.drivers", "soak.faults", "soak.harvest",
            "soak.runner", "benchmarks.soak_bench", "benchmarks.health_bench",
            "utils.trash", "client.storage_client_inmem", "fuse.kernel",
            "fuse.user_config", "app.fuse_main", "net.native_conn"):
    assert f"t3fs_torch.{mod}" in mods, mod
"""


def test_port_imports_no_jax_and_no_t3fs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[0]) >= 50      # every module was imported


def test_port_sources_name_no_jax_or_t3fs_module():
    for path in [*ROOT.glob("t3fs_torch/**/*.py"), ROOT / "chip_smoke.py"]:
        for line in path.read_text().splitlines():
            s = line.strip()
            if s.startswith(("import ", "from ")):
                mod = s.split()[1]
                assert mod.split(".")[0] not in ("jax", "jaxlib", "t3fs",
                                                 "benchmarks"), \
                    f"{path}: {s}"


async def _default_cluster(with_meta: bool = False):
    """The port's LocalCluster on the defaults (with its meta service, if
    asked): every StorageServer's checksum backend is the CUDA one, so
    start() raises."""
    from t3fs_torch.testing.cluster import LocalCluster

    cluster = LocalCluster(num_nodes=1, replicas=1, with_meta=with_meta)
    try:
        await cluster.start()
    finally:
        await cluster.stop()


async def _default_fabric(client_writes: bool = False):
    """A storage fabric (and a client writing through it) on the defaults:
    its nodes' checksum backend is the CUDA one, so start() raises."""
    from t3fs_torch.client.layout import FileLayout
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.testing.fabric import StorageFabric

    fabric = StorageFabric(num_nodes=1, replicas=1)
    try:
        await fabric.start()
        if client_writes:
            sc = StorageClient(lambda: fabric.routing, client=fabric.client)
            await sc.write_file_range(
                FileLayout(chunk_size=1 << 20, chains=[fabric.chain_id]),
                inode=1, offset=0, data=b"x" * (1 << 20))
    finally:
        await fabric.stop()


def _entry_points():
    import asyncio

    from t3fs_torch import bench, graft_entry, resolve_device
    from t3fs_torch.benchmarks import (
        ckpt_bench, codec_economics, devbench, health_bench, kvcache_bench,
        kvcache_fleet_bench, kvcache_scale_bench, meta_bench,
        rebalance_drill_bench, repair_drill_bench, health_smoke, soak_bench,
        sort_bench, storage_bench, usrbio_bench)
    from t3fs_torch.benchmarks import ec_recovery_bench as ecb
    from t3fs_torch.cli import admin
    from t3fs_torch.client.ec_client import ECStorageClient
    from t3fs_torch.client.ec_codec import TorchECCodec
    from t3fs_torch.ops import (
        cuda_codec, device_sort, msr_codec, tables, torch_codec)
    from t3fs_torch.ops.msr import default_msr
    from t3fs_torch.ops.repair_program import xor_program
    from t3fs_torch.parallel import codec_mesh
    from t3fs_torch.soak import SoakRunner, load_spec
    from t3fs_torch.storage.codec_backend import (
        CudaChecksumBackend, make_checksum_backend)
    from t3fs_torch.storage.server import StorageServer
    from t3fs_torch.storage.service import StorageNode

    return [
        resolve_device,
        cuda_codec.make_crc_seg_words,
        lambda: cuda_codec.make_crc32c_words_raw(128),
        lambda: cuda_codec.make_crc32c_words(128),
        cuda_codec.make_rs_encode_words,
        lambda: cuda_codec.make_stripe_encode_step_words(128),
        tables.codec_tables,
        lambda: tables.load_codec_tables(tables.build_codec_tables()),
        lambda: torch_codec.make_crc32c_raw(512),
        lambda: torch_codec.make_crc32c_batch(10),
        torch_codec.make_rs_encode,
        torch_codec.make_rs_encode_matmul,
        lambda: torch_codec.make_stripe_encode_step(512),
        CudaChecksumBackend,
        lambda: make_checksum_backend("tpu"),
        TorchECCodec,
        # the read side
        lambda: cuda_codec.make_rs_reconstruct_words(tuple(range(8)), (8,)),
        lambda: cuda_codec.make_stripe_decode_step_words(
            128, tuple(range(8)), (8, 9)),
        lambda: cuda_codec.make_repair_subshard_words(xor_program(3)),
        lambda: cuda_codec.make_repair_step_words(128, xor_program(3)),
        lambda: cuda_codec.make_rs_reconstruct_bytes(tuple(range(8)), (9,)),
        cuda_codec.make_rs_encode_bytes,
        lambda: torch_codec.make_rs_reconstruct(tuple(range(8)), (9,)),
        lambda: tables.decode_tables(tuple(range(8)), (9,)),
        tables.encode_map_tables,
        lambda: tables.load_gfmap_tables(tables.build_encode_arrays()),
        # the byte path (B6) and pm-msr
        cuda_codec.make_crc_seg_bytes,
        lambda: cuda_codec.make_crc32c_raw_fast(512),
        lambda: cuda_codec.make_crc32c_bytes(10),
        lambda: cuda_codec.make_crc32c_rows(512),
        lambda: cuda_codec.make_stripe_encode_step_fast(512),
        lambda: cuda_codec.make_stripe_encode_step_bytes(1000),
        lambda: cuda_codec.make_stripe_decode_step_bytes(1000, tuple(range(8)), (9,)),
        lambda: cuda_codec.make_repair_step_bytes(1000, xor_program(3)),
        tables.crc_bytes_tables,
        lambda: tables.load_crc_bytes_tables(tables.build_crc_bytes_arrays()),
        lambda: msr_codec.make_msr_encode_step(default_msr(), 2048),
        lambda: msr_codec.make_msr_repair_step(default_msr(), 0, 2048),
        lambda: msr_codec.make_msr_decode_step(default_msr(), tuple(range(8)),
                                               (8, 9), 2048),
        # the bench path
        lambda: devbench.make_copy3d(devbench.bench_words((1, 1, 4))),
        devbench.main,
        lambda: bench.measure(quick=True),
        lambda: ecb.decode_ops(8, 2, 4096, 1),
        lambda: ecb.decode_microbench(ecb.parse_args([])),
        # the device sort, the codec mesh and the graft entry
        device_sort.make_device_sorter,
        lambda: sort_bench.main(["--quick"]),
        graft_entry.entry,
        lambda: graft_entry.dryrun_multichip(4),
        codec_mesh.make_mesh,
        # the CRAQ chain: storage node, fabric, and a client writing to it
        lambda: StorageNode(1, lambda: None, None),
        lambda: asyncio.run(_default_fabric()),
        lambda: asyncio.run(_default_fabric(client_writes=True)),
        # the EC client: its default codec is TorchECCodec() on "cuda"
        lambda: ECStorageClient(None),
        # the storage cluster under mgmtd: a storage server, and the
        # cluster that starts one a node
        lambda: StorageServer(1, "127.0.0.1:1"),
        lambda: asyncio.run(_default_cluster()),
        # the file system and the checkpoint engine: a cluster with its
        # meta service, and the checkpoint bench without --cpu
        lambda: asyncio.run(_default_cluster(with_meta=True)),
        lambda: ckpt_bench.main(["--runs", "1"]),
        # the sort job through storage and the KVCache benches, without --cpu
        lambda: sort_bench.main(["--mb", "1"]),
        lambda: kvcache_bench.main(["--blocks", "1"]),
        lambda: kvcache_fleet_bench.main(["--procs", "1"]),
        # the usrbio ring benches, without --cpu
        lambda: usrbio_bench.main(["--file-size", "65536", "--seconds", "0.1"]),
        lambda: kvcache_scale_bench.main(["--smoke"]),
        # the BASELINE.json harness, without --cpu: storage_bench's timed
        # loop and fixed-op probes, codec_economics' batching run and card
        # measurements, the EC recovery bench's cluster phases (also with
        # --device, the default's name) and the repair drill
        lambda: storage_bench.main(["--seconds", "0.1"]),
        lambda: storage_bench.main(["--write-ab", "--num-ops", "1"]),
        lambda: storage_bench.run_write_bench(65536, 1),
        lambda: codec_economics.main(["--seconds", "0.1"]),
        lambda: codec_economics.measure_card(65536, 1.0),
        codec_economics.measure_h2d,
        lambda: ecb.run(ecb.parse_args(["--stripes", "1"])),
        lambda: ecb.run(ecb.parse_args(["--device"])),
        lambda: repair_drill_bench.main(["--stripes", "2"]),
        # the health plane's smoke on LocalCluster(with_monitor=True)
        lambda: asyncio.run(health_smoke.measure()),
        # the rebalance drill without --cpu, by its CLI and by run_bench
        # (its cells' LocalCluster on the CUDA backend)
        lambda: rebalance_drill_bench.main(["--smoke"]),
        lambda: asyncio.run(rebalance_drill_bench.run_bench(
            rebalance_drill_bench.parse_args(["--smoke"]))),
        # the mixed-workload soak: the runner (its cluster and EC codecs on
        # the card), soak_bench's cell runner and CLI, and health_bench's
        # CLI and cold cell (its LocalCluster on the CUDA backend)
        lambda: SoakRunner(load_spec(SMOKE)),
        lambda: asyncio.run(soak_bench.run_cell(load_spec(SMOKE), True, 1, False)),
        lambda: soak_bench.main(["--config", SMOKE, "--duration", "1"]),
        lambda: health_bench.main(["--trials", "1"]),
        lambda: asyncio.run(health_bench.run_cold_ab(
            health_bench.parse_args(["--trials", "1"]))),
        # the admin CLI's ckpt-verify: its context's stripe codec, and the
        # command through main without --cpu (no address is ever dialled)
        lambda: admin.AdminContext("127.0.0.1:1").ec_codec(),
        lambda: admin.main(["--meta", "127.0.0.1:1", "ckpt-verify", "/c"]),
        # meta_bench --fuse without --cpu: its in-process cluster's storage
        # node on the CUDA backend (raises before any mount)
        lambda: asyncio.run(meta_bench.run_bench(meta_bench.parse_args(
            ["--fuse"]))),
    ]


@pytest.mark.parametrize("i", range(82))
def test_entry_points_default_to_cuda_and_raise_without_gpu(i, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    entries = _entry_points()
    assert len(entries) == 82
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entries[i]()


def test_cluster_entry_points_name_cuda_by_default():
    """StorageConfig, StorageServer and LocalCluster default to the CUDA
    checksum backend; the config accepts every name make_checksum_backend
    maps, and a backend instance reaches the node as it is."""
    import inspect

    from t3fs_torch.app.dev_cluster import DevCluster
    from t3fs_torch.app.storage_main import StorageMainConfig
    from t3fs_torch.storage.codec_backend import CpuChecksumBackend
    from t3fs_torch.storage.server import StorageConfig, StorageServer
    from t3fs_torch.testing.cluster import LocalCluster
    from t3fs_torch.utils.config import ConfigError

    assert StorageConfig().checksum_backend == "cuda"
    assert StorageMainConfig().service.checksum_backend == "cuda"
    for fn in (StorageServer.__init__, LocalCluster.__init__,
               DevCluster.__init__):
        assert inspect.signature(fn).parameters[
            "checksum_backend"].default == "cuda"
    cfg = StorageConfig()
    for name in ("gpu", "device", "tpu", "cpu", "null", "cuda"):
        cfg.update({"checksum_backend": name}, hot_only=False)
    with pytest.raises(ConfigError):
        cfg.update({"checksum_backend": "fpga"}, hot_only=False)
    backend = CpuChecksumBackend()
    ss = StorageServer(1, "127.0.0.1:1", checksum_backend=backend)
    assert ss.node.codec is backend and ss.cfg.checksum_backend == "cpu"
    ss = StorageServer(1, "127.0.0.1:1", checksum_backend=CpuChecksumBackend)
    assert isinstance(ss.node.codec, CpuChecksumBackend)


def test_chip_smoke_fails_without_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: chip_smoke would run for real")
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    # alone in a directory, without the package, it fails as well
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


@pytest.mark.parametrize("cmd,key", [
    (["-m", "t3fs_torch.bench"], "metric"),
    (["-m", "t3fs_torch.benchmarks.ec_recovery_bench", "--decode-ab"], "decode_metric"),
    (["-m", "t3fs_torch.benchmarks.ec_recovery_bench"], "decode_metric"),
    (["-m", "t3fs_torch.benchmarks.b1_probe"], "card")])
def test_benches_fail_without_gpu_with_an_error_line(cmd, key):
    """Without a GPU a bench prints its result line with an error and exits
    non-zero; it never measures the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the bench would run for real")
    r = subprocess.run([sys.executable, *cmd], cwd=ROOT, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode != 0
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert key in line and "device='cpu'" in line["error"]
    if key == "metric":
        assert line["metric"] == "rs8+2_crc32c_stripe_encode" and line["value"] == 0


def test_sort_bench_cli_fails_without_gpu():
    """Without a GPU `python -m ...sort_bench` exits non-zero before any
    work and prints no result; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command would run for real")
    r = subprocess.run([sys.executable, "-m", "t3fs_torch.benchmarks.sort_bench",
                        "--quick"], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr and "{" not in r.stdout


@pytest.mark.parametrize("name,argv", [
    ("storage_bench", ["--seconds", "0.1"]),
    ("storage_bench", ["--write-ab", "--num-ops", "1"]),
    ("codec_economics", ["--seconds", "0.1"]),
    ("repair_drill_bench", ["--stripes", "2"]),
    ("rebalance_drill_bench", ["--smoke"]),
    ("soak_bench", ["--config", SMOKE, "--duration", "1"]),
    ("health_bench", ["--trials", "1"])])
def test_baseline_harness_cli_fails_without_gpu(name, argv):
    """Without a GPU `python -m t3fs_torch.benchmarks.<name>` exits non-zero
    before any work and prints no result; it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the command would run for real")
    r = subprocess.run([sys.executable, "-m", f"t3fs_torch.benchmarks.{name}",
                        *argv], cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert "device='cpu'" in r.stderr and "{" not in r.stdout


def test_admin_cli_main_needs_no_gpu(monkeypatch, capsys):
    """The admin CLI's main does no device work for any command but
    ckpt-verify: without a GPU it parses, dispatches and reports, as the
    reference's does, and an unknown command is refused by the parser.
    ckpt-verify without a GPU and without --cpu raises the port's no-GPU
    error before it opens any connection."""
    from t3fs_torch.cli import admin

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="soak-status needs --monitor"):
        admin.main(["soak-status"])
    with pytest.raises(SystemExit, match="metrics needs --monitor"):
        admin.main(["metrics"])
    with pytest.raises(SystemExit):
        admin.main(["no-such-command"])
    assert "invalid choice" in capsys.readouterr().err

    def no_connection(*a, **k):
        raise AssertionError("ckpt-verify connected before its codec")

    monkeypatch.setattr(admin.AdminContext, "mgmtd_client", no_connection)
    monkeypatch.setattr(admin, "MetaClient", no_connection)
    monkeypatch.setattr(admin.Client, "call", no_connection)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        admin.main(["--meta", "127.0.0.1:1", "ckpt-verify", "/ckpts/run"])
    # with --cpu the codec is built on the host; the command then dials
    ctx = admin.AdminContext("127.0.0.1:1", device="cpu")
    assert ctx.ec_codec() is ctx.ec_codec()
    assert ctx.ec_codec().device.type == "cpu"
    with pytest.raises(AssertionError, match="connected before its codec"):
        admin.main(["--cpu", "--meta", "127.0.0.1:1", "ckpt-verify", "/c"])


def test_port_refuses_what_it_has_not_ported(monkeypatch):
    """What the port cannot run raises, never runs something else.
    T3FS_NATIVE_NET=1 is read per connection, as the reference reads it
    (t3fs/net/native_conn.py native_enabled): a connection made before the
    switch stays on asyncio, a fresh one rides the io_uring pump
    (net/native_conn.py).  Where the pump cannot be made (io_uring_setup
    refused, as on a host whose seccomp profile blocks it), Server.start
    raises OSError before it listens and a client connect raises
    RPC_CONNECT_FAILED, as in the reference; with the switch off the same
    client then connects on asyncio.  The ring data plane is ported:
    asking for it builds a client on that plane.  (The kernel FUSE mount
    is ported too: tests/test_torch_meta_bench.py runs meta_bench --fuse,
    tests/test_torch_fuse_*.py the mount and fuse_main.)"""
    import asyncio

    from t3fs_torch.client.storage_client import (
        StorageClient, StorageClientConfig)
    from t3fs_torch.core.service import AppInfo, CoreService
    from t3fs_torch.kv.engine import MemKVEngine
    from t3fs_torch.net.client import Client
    from t3fs_torch.net.conn import Connection
    from t3fs_torch.net.native_conn import NativeConnection
    from t3fs_torch.net.server import Server
    from t3fs_torch.utils.status import StatusCode, StatusError

    async def serving():
        monkeypatch.setenv("T3FS_NATIVE_NET", "0")
        srv = Server()
        srv.add_service(CoreService(AppInfo(1, "core", ""), kv=MemKVEngine()))
        await srv.start()
        return srv

    async def per_connection():
        srv = await serving()
        cli = Client()
        try:
            await cli.call(srv.address, "Core.getAppInfo")
            monkeypatch.setenv("T3FS_NATIVE_NET", "1")
            # a connection made before the switch stays as it was
            await cli.call(srv.address, "Core.getAppInfo")
            assert type(cli._conns[srv.address]) is Connection
            fresh = Client()
            await fresh.call(srv.address, "Core.getAppInfo")
            assert isinstance(fresh._conns[srv.address], NativeConnection)
            await fresh.close()
        finally:
            await cli.close()
            await srv.stop()

    async def refused():
        srv = await serving()
        try:
            monkeypatch.setenv("T3FS_NATIVE_NET", "1")
            native = Server()
            with pytest.raises(OSError, match="t3fs_pump_create failed"):
                await native.start()
            assert native._lsock is None and native._accept_task is None
            assert native._server is None and native.port == 0
            fresh = Client()
            with pytest.raises(StatusError) as ei:
                await fresh.call(srv.address, "Core.getAppInfo")
            assert ei.value.code == StatusCode.RPC_CONNECT_FAILED
            assert not fresh._conns and fresh.epoch(srv.address) == 1
            monkeypatch.setenv("T3FS_NATIVE_NET", "0")
            await fresh.call(srv.address, "Core.getAppInfo")
            assert type(fresh._conns[srv.address]) is Connection
            await fresh.close()
        finally:
            await srv.stop()

    asyncio.run(per_connection())
    refuse_pump(monkeypatch)
    asyncio.run(refused())
    sc = StorageClient(lambda: None,
                       config=StorageClientConfig(data_plane="ring"))
    assert sc.cfg.data_plane == "ring" and sc._ring_state == {
        "ring": None, "failed": False}


@needs_fuse
def test_fuse_main_and_mount_do_no_cuda_work(tmp_path, monkeypatch):
    """fuse_main is a client process, as the reference's is: its config, its
    mgmtd, meta and storage clients, the group resolver and the kernel
    mount, mounted and answering POSIX calls, never touch torch.cuda (each
    entry to it raises here, after the cluster under the mount started)."""
    import asyncio

    from t3fs_torch.app import fuse_main
    from t3fs_torch.app.base import parse_overrides
    from t3fs_torch.client.meta_client import MetaClient
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.fuse.kernel import FuseKernelMount, registry_group_resolver
    from t3fs_torch.fuse.user_config import MountUserConfig
    from t3fs_torch.testing.cluster import LocalCluster

    mnt = tmp_path / "mnt"
    mnt.mkdir()

    def no_cuda(*a, **k):
        raise AssertionError("torch.cuda touched")

    async def body():
        c = LocalCluster(num_nodes=1, replicas=1, with_meta=True,
                         heartbeat_timeout_s=60.0, checksum_backend="cpu")
        await c.start()
        try:
            for name in ("is_available", "_lazy_init", "init", "device_count",
                         "current_device", "synchronize"):
                monkeypatch.setattr(torch.cuda, name, no_cuda)
            cfg = fuse_main.FuseMainConfig()
            cfg.update(parse_overrides([
                f"mgmtd_address={c.mgmtd_rpc.address}",
                f"mountpoint={mnt}"]), hot_only=False)
            cfg.validate()
            mgmtd = MgmtdClient(cfg.mgmtd_address, client_id="fuse-hyg")
            await mgmtd.start()
            sc = StorageClient(mgmtd.routing,
                               config=cfg.storage.client_config(),
                               refresh_routing=mgmtd.refresh)
            mc = MetaClient([c.meta_rpc.address], client_id="fuse-hyg")
            fuse = FuseKernelMount(
                mc, sc, str(mnt), client_id="fuse-hyg",
                max_write=cfg.max_write,
                group_resolver=registry_group_resolver(cfg.mgmtd_address,
                                                       mgmtd.client),
                user_config=MountUserConfig(attr_timeout=cfg.attr_timeout))
            try:
                await fuse.mount()

                def posix():
                    with open(mnt / "f", "wb") as f:
                        f.write(b"z" * 100_000)
                    return (mnt / "f").read_bytes(), os.listdir(mnt)
                data, names = await asyncio.to_thread(posix)
                assert data == b"z" * 100_000 and names == ["f"]
            finally:
                await fuse.unmount()
                await sc.close()
                await mc.close_conn()
                await mgmtd.stop()
        finally:
            monkeypatch.undo()
            await c.stop()

    asyncio.run(body())
    assert not os.path.ismount(mnt)


def _imported_modules(out_path: Path) -> set[str]:
    """The modules a child started with PYTHONPROFILEIMPORTTIME=1 imported,
    from the import-time lines in its output."""
    mods = set()
    for line in out_path.read_text().splitlines():
        if line.startswith("import time:") and line.count("|") == 2:
            mods.add(line.rsplit("|", 1)[1].strip())
    return mods


def test_spawned_mains_import_no_jax_and_no_t3fs(tmp_path, monkeypatch):
    """Every *_main child the port's DevCluster spawns (monitor, mgmtd,
    storage, the two kv_main shards, and meta over them), run through a
    file write and a clean stop, imports neither jax nor the JAX package:
    each child reports its imports (PYTHONPROFILEIMPORTTIME) into its
    <name>.out.  The kv_main children run with no GPU visible, so they
    cannot open a CUDA context."""
    import asyncio

    from t3fs_torch.app.dev_cluster import DevCluster
    from t3fs_torch.client.meta_client import MetaClient
    from t3fs_torch.client.mgmtd_client import MgmtdClient
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.fuse.vfs import FileSystem

    monkeypatch.setenv("PYTHONPROFILEIMPORTTIME", "1")
    monkeypatch.delenv("PYTHONPATH", raising=False)
    c = DevCluster(str(tmp_path / "run"), num_storage=1, replicas=1,
                   with_monitor=True, chunk_size=64 << 10,
                   heartbeat_timeout_s=60.0, checksum_backend="cpu",
                   kv_shards=2)

    async def body():
        try:
            await asyncio.wait_for(c.start(), 240)
            names = sorted(c.procs)
            for kv in ("kv1", "kv2"):
                env = Path(f"/proc/{c.procs[kv].pid}/environ").read_bytes()
                assert b"\0CUDA_VISIBLE_DEVICES=\0" in b"\0" + env, kv
            mgmtd = MgmtdClient(c.mgmtd_address)
            await mgmtd.start()
            sc = StorageClient(mgmtd.routing, refresh_routing=mgmtd.refresh)
            meta = MetaClient([c.meta_address])
            try:
                fs = FileSystem(meta, sc)
                await fs.write_file("/f", b"y" * (200 << 10))
                assert await fs.read_file("/f") == b"y" * (200 << 10)
            finally:
                await meta.close_conn()
                await sc.close()
                await mgmtd.stop()
            return names
        finally:
            await c.stop()

    names = asyncio.run(asyncio.wait_for(body(), 300))
    assert names == ["kv1", "kv2", "meta", "mgmtd", "monitor", "storage1"]
    for name in names:
        mods = _imported_modules(tmp_path / "run" / f"{name}.out")
        # the *_main module itself runs as __main__; every one imports base
        assert "t3fs_torch.app.base" in mods, name
        bad = sorted(m for m in mods
                     if m.split(".")[0] in ("jax", "jaxlib", "t3fs",
                                            "benchmarks"))
        assert not bad, (name, bad)


NATIVE_FROM_PORT = """
import sys
from pathlib import Path
from t3fs_torch.storage.aio import AioReadWorker
from t3fs_torch.storage.native_engine import make_engine, native_lib
from t3fs_torch.testing.fabric import StorageFabric
e = make_engine(sys.argv[1], backend="native")
print(type(e).__name__)
e.close()
lib = Path(native_lib()._name).resolve()
assert lib.parent == Path("t3fs_torch/_build").resolve(), lib
assert lib.name.startswith("libnative_storage-"), lib
AioReadWorker.available()
fab = StorageFabric(num_nodes=1, replicas=1, aio_read=True)
from t3fs_torch.lib.usrbio import IoRing, IoVec, _lib
iov = IoVec(f"hyg-{sys.argv[2]}", 4096)
ring = IoRing(f"hyg-ring-{sys.argv[2]}", entries=4, iov=iov)
ring.close()
iov.close()
assert Path(_lib()._name).resolve() == lib
assert (StorageFabric.default_engine_backend, StorageFabric.default_aio_read,
        fab.aio_read) == ("native", True, True)
maps = Path("/proc/self/maps").read_text() if Path("/proc/self/maps").exists() else ""
assert "libt3fs_native" not in maps
assert not [m for m in sys.modules if m == "t3fs" or m.startswith("t3fs.")]
"""


def test_port_native_engine_and_aio_come_from_the_port(tmp_path):
    """The native chunk engine, the io_uring reader and the usrbio shm rings
    are the port's own: built from t3fs_torch/csrc into t3fs_torch/_build,
    loaded without the reference's library, and the fabric's defaults as in
    the reference."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", NATIVE_FROM_PORT,
                        str(tmp_path / "root"), str(os.getpid())], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["NativeChunkEngine"]
