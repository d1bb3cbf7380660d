"""The port's metadata and KV-distributor benches
(t3fs_torch.benchmarks.{meta_bench,kv_distributor_bench}) on the CPU:
meta_bench in-process in both packages at the same small size, with the
same phases, op counts and JSON keys (its rates are timings and are not
compared), over the meta RPC client and, with --fuse, as POSIX syscalls
through each package's kernel mount (where /dev/fuse and root allow a
mount), --fuse --mgmtd refused in both; and kv_distributor_bench --smoke
at reduced counts, with every correctness gate passing."""

import asyncio
import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmarks import meta_bench as ref_mb
from t3fs_torch.benchmarks import meta_bench as port_mb
from torch_fuse_mounts import needs_fuse

ROOT = Path(__file__).resolve().parent.parent
ARGV = ["--dirs", "2", "--files", "8", "--concurrency", "4"]
PHASES = ("mkdir", "create", "stat", "batch_stat", "list", "rename",
          "remove")
FUSE_PHASES = ("mkdir", "create", "stat", "list", "rename", "remove")


def _shape(result: dict) -> dict:
    """Everything of a meta_bench result but its timings."""
    return {k: ({kk: vv for kk, vv in v.items()
                 if kk not in ("wall_s", "ops_s", "inodes_s")}
                if isinstance(v, dict) else v)
            for k, v in result.items()}


def test_meta_bench_phases_match_reference():
    ref = asyncio.run(ref_mb.run_bench(ref_mb.parse_args(ARGV)))
    port = asyncio.run(port_mb.run_bench(port_mb.parse_args(ARGV + ["--cpu"])))
    assert _shape(port) == _shape(ref)
    assert set(port) == set(ref)
    assert [port[p]["ops"] for p in PHASES] == [2, 16, 16, 2, 2, 16, 16]
    for p in PHASES:
        assert port[p]["ops_s"] > 0 and port[p]["wall_s"] > 0
    assert port["batch_stat"]["inodes_s"] == pytest.approx(
        port["batch_stat"]["ops_s"] * 8, rel=1e-3)


def test_meta_bench_cli_json():
    r = subprocess.run([sys.executable, "-m",
                        "t3fs_torch.benchmarks.meta_bench", *ARGV, "--cpu",
                        "--json"], cwd=ROOT, capture_output=True, text=True,
                       timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["total_files"] == 16 and out["create"]["ops"] == 16


def _steady(monkeypatch):
    """Each package's LocalCluster, as run_fuse_bench imports it, with a
    heartbeat timeout test load cannot reach (the bench kills no node)."""
    import t3fs.testing.cluster as ref_cluster
    import t3fs_torch.testing.cluster as port_cluster

    for mod in (ref_cluster, port_cluster):
        base = mod.LocalCluster

        class Steady(base):
            def __init__(self, *a, **kw):
                kw["heartbeat_timeout_s"] = 60.0
                super().__init__(*a, **kw)
        monkeypatch.setattr(mod, "LocalCluster", Steady)


@needs_fuse
def test_meta_bench_fuse_mode_not_ported(monkeypatch):
    """--fuse, ported: the phases as POSIX syscalls through each package's
    kernel mount, with the reference's keys and op counts; --fuse with
    --mgmtd refused in both, in the reference's words."""
    for mb in (ref_mb, port_mb):
        with pytest.raises(SystemExit, match="would silently measure the "
                           "wrong cluster"):
            asyncio.run(mb.run_bench(mb.parse_args(
                ["--fuse", "--mgmtd", "127.0.0.1:1"])))
    _steady(monkeypatch)
    ref = asyncio.run(ref_mb.run_bench(ref_mb.parse_args(ARGV + ["--fuse"])))
    port = asyncio.run(port_mb.run_bench(port_mb.parse_args(
        ARGV + ["--fuse", "--cpu"])))
    assert _shape(port) == _shape(ref)
    assert list(port) == list(ref)
    assert port["path"] == "fuse-kernel-mount" and port["total_files"] == 16
    assert [port[p]["ops"] for p in FUSE_PHASES] == [2, 16, 16, 2, 16, 16]
    for p in FUSE_PHASES:
        assert port[p]["ops_s"] > 0 and port[p]["wall_s"] > 0


@needs_fuse
def test_meta_bench_fuse_cli_json():
    r = subprocess.run([sys.executable, "-m",
                        "t3fs_torch.benchmarks.meta_bench", *ARGV, "--fuse",
                        "--cpu", "--json"], cwd=ROOT, capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 0, r.stderr[-2000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    assert out["path"] == "fuse-kernel-mount" and out["total_files"] == 16
    assert [out[p]["ops"] for p in FUSE_PHASES] == [2, 16, 16, 2, 16, 16]


def test_kv_distributor_bench_smoke():
    """--smoke at reduced counts: the distributor cell splits and keeps
    its map monotonic with no row lost, wrong or ghosted, and the
    kill/restart drill heals both orphaned intents."""
    from t3fs_torch.benchmarks import kv_distributor_bench as kdb

    args = kdb.parse_args(["--smoke", "--duration", "6", "--workers", "4",
                           "--names-per-worker", "40"])
    assert asyncio.run(kdb.main_async(args)) == 0
