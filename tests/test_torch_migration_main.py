"""The port's migration_main (t3fs_torch/app/migration_main.py) as a process
of its own against a port LocalCluster's mgmtd: it boots from a TOML file
and --set overrides, writes its port file, serves Migration (and, with
rebalance=true, Rebalance), drives one submitted move to DONE through its
JSON job store, and stops cleanly on SIGTERM.  The cluster runs its nodes'
CRCs on the host with a heartbeat timeout test load cannot reach."""

import asyncio
import json
import os
import signal
import sys
from pathlib import Path

from t3fs_torch.client.layout import FileLayout
from t3fs_torch.migration.rebalancer import RebalanceStatusRsp
from t3fs_torch.migration.service import SubmitMigrationReq
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils.status import StatusCode

ROOT = Path(__file__).resolve().parent.parent


async def _spawn(tmp: Path, cluster, *sets: str):
    """migration_main with a TOML config and --set overrides, reporting its
    imports (PYTHONPROFILEIMPORTTIME) on stderr; returns the process and
    the address it wrote to its port file."""
    cfg = tmp / "migration.toml"
    cfg.write_text(f'mgmtd_address = "{cluster.mgmtd_rpc.address}"\n'
                   f'store_path = "{tmp / "jobs.json"}"\n'
                   'sync_timeout_s = 60.0\n'
                   '[log]\nlevel = "INFO"\n'
                   f'file = "{tmp / "migration.log"}"\n')
    port_file = tmp / "migration.port"
    proc = await asyncio.create_subprocess_exec(
        sys.executable, "-m", "t3fs_torch.app.migration_main",
        "--config", str(cfg), "--set", f"port_file={port_file}",
        "--set", "flap_timeout_s=5", *sets, cwd=ROOT,
        env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        | {"PYTHONPROFILEIMPORTTIME": "1"},
        stdout=asyncio.subprocess.DEVNULL, stderr=asyncio.subprocess.PIPE)
    for _ in range(600):
        if port_file.exists() and port_file.read_text().strip():
            return proc, f"127.0.0.1:{int(port_file.read_text())}"
        if proc.returncode is not None:
            break
        await asyncio.sleep(0.1)
    proc.kill()
    err = (await proc.communicate())[1].decode()
    raise AssertionError(f"migration_main never wrote its port: {err[-2000:]}")


async def _stop(proc) -> None:
    """SIGTERM, a clean exit, and no jax or JAX-package module imported."""
    proc.send_signal(signal.SIGTERM)
    _, err = await asyncio.wait_for(proc.communicate(), 60)
    text = err.decode()
    assert proc.returncode == 0, text[-2000:]
    mods = {ln.rsplit("|", 1)[1].strip() for ln in text.splitlines()
            if ln.startswith("import time:") and ln.count("|") == 2}
    assert "t3fs_torch.migration.service" in mods
    assert not [m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "t3fs")]


def test_migration_main_moves_a_target_and_stops_cleanly(tmp_path):
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=3, num_chains=1,
                               heartbeat_timeout_s=30.0,
                               checksum_backend="cpu")
        await cluster.start()
        proc = None
        try:
            lay = FileLayout(chunk_size=4096, chains=[1])
            data = b"migration-main" * 700
            res = await cluster.sc.write_file_range(lay, 9, 0, data)
            assert all(r.status.code == int(StatusCode.OK) for r in res)

            proc, addr = await _spawn(tmp_path, cluster)
            src = cluster.target_id(3, 0)
            rsp, _ = await cluster.admin.call(
                addr, "Migration.submit",
                SubmitMigrationReq(chain_id=1, src_target_id=src,
                                   dst_target_id=9400, dst_node_id=4))
            for _ in range(600):
                st, _ = await cluster.admin.call(addr, "Migration.status",
                                                 None)
                job = next(j for j in st.jobs if j.job_id == rsp.job_id)
                if job.state in ("done", "failed"):
                    break
                await asyncio.sleep(0.1)
            assert job.state == "done", (job.state, job.error)
            ids = [t.target_id for t in cluster.chain().targets]
            assert 9400 in ids and src not in ids
            await cluster.mgmtd_client.refresh()
            got, _ = await cluster.sc.read_file_range(lay, 9, 0, len(data))
            assert got == data
            await _stop(proc)
            proc = None
            blob = json.loads((tmp_path / "jobs.json").read_text())
            assert [(j["job_id"], j["state"]) for j in blob["jobs"]] == \
                [(rsp.job_id, "done")]
            assert "migration up" in (tmp_path / "migration.log").read_text()
        finally:
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
            await cluster.stop()
    asyncio.run(body())


def test_migration_main_hosts_the_rebalancer(tmp_path):
    """rebalance=true serves Rebalance beside Migration on one listener;
    its planner ticks against mgmtd and, on an already balanced cluster
    with a solver-shaped table, plans nothing."""
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=3, num_chains=1,
                               heartbeat_timeout_s=30.0,
                               checksum_backend="cpu")
        await cluster.start()
        proc = None
        try:
            proc, addr = await _spawn(
                tmp_path, cluster, "--set", "rebalance=true",
                "--set", "rebalance_period_s=0.2",
                "--set", "rebalance_budget_mbps=8")
            for _ in range(100):
                st, _ = await cluster.admin.call(addr, "Rebalance.status",
                                                 None)
                if st.ticks >= 2:
                    break
                await asyncio.sleep(0.1)
            assert isinstance(st, RebalanceStatusRsp)
            assert st.enabled and st.ticks >= 2 and st.budget_mbps == 8.0
            assert st.planned == st.submitted == st.failed == 0
            rsp, _ = await cluster.admin.call(addr, "Migration.status", None)
            assert rsp.implemented and rsp.jobs == []
            await _stop(proc)
            proc = None
        finally:
            if proc is not None and proc.returncode is None:
                proc.kill()
                await proc.wait()
            await cluster.stop()
    asyncio.run(body())
