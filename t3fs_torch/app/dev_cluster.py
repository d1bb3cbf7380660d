"""DevCluster: a REAL multi-process cluster on localhost.

Reference analog: testing_configs/ — launch_cluster.sh starts mgmtd + meta +
5 storage nodes as separate processes on local ports, generates a chain
table and uploads it via admin_cli (testing_configs/README.md,
config_chain.sh:9-20).  Here the launcher writes per-binary TOML configs
into a run dir, spawns `python -m t3fs_torch.app.*_main` subprocesses, installs
chains through the admin RPC, and supports kill/restart of individual nodes
(for failover experiments).

Also runnable standalone:
    python -m t3fs_torch.app.dev_cluster --nodes 3 --replicas 3 --run-dir /tmp/t3fs

The port of t3fs/app/dev_cluster.py.  Every storage process checksums on
the backend named by checksum_backend, the CUDA one by default (B1 on the
card; pass "cpu" where no GPU is present, as the tests do); a "cuda"
process without a GPU dies at startup and start() raises with its log tail.
The parent builds the host library, and for "cuda" the kernels, before it
spawns anything, so the children load them and none compiles.  Each
process logs to <run_dir>/<name>.log and its stdout and stderr go to
<run_dir>/<name>.out.  With kv_shards > 0 meta runs over a range-sharded
KV of that many kv_main processes, each on its own WAL, which never touch
the card (they are spawned with no GPU visible); restart_kv_node respawns
one from its TOML on the port it first bound.  meta_event_trace=False
starts meta without its Parquet event trace (which needs pyarrow).
read_replicas (not in the reference) reads every replica of every chunk
back over the storage RPCs, for checks that span processes.
"""

from __future__ import annotations

import asyncio
import os
import signal
import subprocess
import sys
import time

import torch

import t3fs_torch.core.service  # noqa: F401  (registers Core wire structs for decode)
from t3fs_torch.app.base import LogConfig
from t3fs_torch.app.meta_main import MetaMainConfig
from t3fs_torch.app.mgmtd_main import MgmtdMainConfig
from t3fs_torch.app.monitor_main import MonitorMainConfig
from t3fs_torch.app.storage_main import StorageMainConfig
from t3fs_torch.mgmtd.service import MgmtdConfig, SetChainsReq
from t3fs_torch.mgmtd.types import (
    ChainInfo, ChainTable, ChainTargetInfo, PublicTargetState,
)
from t3fs_torch.net.client import Client
from t3fs_torch.storage.server import StorageConfig
from t3fs_torch.storage.types import (
    BatchReadReq, ReadIO, TargetOpReq,
)
from t3fs_torch.utils.config import to_toml
from t3fs_torch.utils.status import StatusError


class DevCluster:
    def __init__(self, run_dir: str, num_storage: int = 3, replicas: int = 3,
                 num_chains: int = 1, with_meta: bool = True,
                 with_monitor: bool = False, durable: bool = True,
                 chunk_size: int = 1 << 20,
                 heartbeat_timeout_s: float = 2.0,
                 kv_shards: int = 0,
                 checksum_backend: str = "cuda",
                 meta_event_trace: bool = True):
        self.run_dir = os.path.abspath(run_dir)
        self.num_storage = num_storage
        self.replicas = replicas
        self.num_chains = num_chains
        self.with_meta = with_meta
        self.with_monitor = with_monitor
        self.durable = durable
        self.chunk_size = chunk_size
        self.heartbeat_timeout_s = heartbeat_timeout_s
        # >0: run meta over a range-sharded KV deployment of this many
        # standalone kv_main processes (split at KeyPrefix boundaries;
        # see t3fs_torch/kv/shard.py)
        self.kv_shards = kv_shards
        self.kv_addresses: list[str] = []
        # every storage process's [service] checksum_backend
        self.checksum_backend = checksum_backend
        self.meta_event_trace = meta_event_trace
        self.procs: dict[str, subprocess.Popen] = {}
        self.mgmtd_address = ""
        self.meta_address = ""
        self.monitor_address = ""
        self.admin = Client()

    # --- layout helpers (same scheme as testing LocalCluster) ---

    def target_id(self, node_id: int, chain_idx: int = 0) -> int:
        from t3fs_torch.mgmtd.placement import target_id
        return target_id(node_id, chain_idx)

    def _kv_spec(self, name: str) -> str:
        if not self.durable:
            return "mem"
        return f"wal:{self.run_dir}/{name}-kv?sync=os"

    def _path(self, *parts: str) -> str:
        return os.path.join(self.run_dir, *parts)

    def _write_config(self, name: str, cfg) -> str:
        path = self._path(f"{name}.toml")
        with open(path, "w") as f:
            f.write(to_toml(cfg.to_dict()))
        return path

    def _spawn(self, name: str, module: str, cfg,
               env: dict | None = None) -> subprocess.Popen:
        cfg_path = self._write_config(name, cfg)
        logf = open(self._path(f"{name}.out"), "w")
        proc = subprocess.Popen(
            [sys.executable, "-m", module, "--config", cfg_path],
            stdout=logf, stderr=subprocess.STDOUT,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [
                os.path.dirname(os.path.dirname(os.path.dirname(
                    os.path.abspath(__file__)))),
                os.environ.get("PYTHONPATH", "")])), **(env or {})},
            cwd=self.run_dir)
        self.procs[name] = proc
        return proc

    async def _wait_port(self, name: str, timeout_s: float = 120.0,
                         probe: str = "Core.getAppInfo") -> str:
        """Wait for the port file, then for the probe RPC to answer
        (kv_main hosts only the Kv service -> probe="Kv.status").

        The deadline is a HANG detector, not a performance assertion: a
        child that died fails fast via poll() above it, so a generous
        timeout costs nothing in the good case (the loop exits the
        moment the file appears): interpreter start and imports for
        several children under a loaded test suite take many seconds."""
        port_path = self._path(f"{name}.port")
        deadline = time.time() + timeout_s
        # t3fslint: allow(blocking-in-async) — startup poll of tiny local port files, loop serves nothing yet
        while not os.path.exists(port_path) or not open(port_path).read():
            proc = self.procs.get(name)
            if proc is not None and proc.poll() is not None:
                # t3fslint: allow(blocking-in-async) — reading a dead child's log tail while failing startup
                out = open(self._path(f"{name}.out")).read()[-2000:]
                raise RuntimeError(f"{name} died at startup:\n{out}")
            if time.time() > deadline:
                raise TimeoutError(f"{name} did not write {port_path}")
            await asyncio.sleep(0.05)
        # t3fslint: allow(blocking-in-async) — startup poll of tiny local port files
        address = f"127.0.0.1:{open(port_path).read().strip()}"
        while True:
            try:
                await self.admin.call(address, probe, None, timeout=2.0)
                return address
            except Exception:
                if time.time() > deadline:
                    raise
                await asyncio.sleep(0.1)

    # --- lifecycle ---

    def _kv_prefixes(self) -> list[bytes]:
        from t3fs_torch.kv.prefixes import KeyPrefix
        prefixes = sorted(p.value for p in KeyPrefix)
        if self.kv_shards > len(prefixes):
            raise ValueError(
                f"kv_shards={self.kv_shards} exceeds the "
                f"{len(prefixes)} KeyPrefix split points")
        return prefixes

    async def start(self) -> None:
        if self.kv_shards > 0 and self.with_meta:
            self._kv_prefixes()      # refuse before any process is spawned
        os.makedirs(self.run_dir, exist_ok=True)
        # build once here: children racing to build the same libraries
        # would each pay the compile
        from t3fs_torch.ops import _build
        _build.host_library()
        if self.checksum_backend not in ("cpu", "null") and \
                torch.cuda.is_available():
            _build.build_all()

        # monitor first: every other service pushes its metrics there
        if self.with_monitor:
            self._spawn("monitor", "t3fs_torch.app.monitor_main",
                        MonitorMainConfig(
                db_path=self._path("metrics.sqlite"),
                port_file=self._path("monitor.port"),
                log=LogConfig(file=self._path("monitor.log"))))
            self.monitor_address = await self._wait_port("monitor")

        self._spawn("mgmtd", "t3fs_torch.app.mgmtd_main", MgmtdMainConfig(
            node_id=1, kv=self._kv_spec("mgmtd"),
            port_file=self._path("mgmtd.port"),
            monitor_address=self.monitor_address,
            metrics_period_s=2.0,
            service=MgmtdConfig(
                heartbeat_timeout_s=self.heartbeat_timeout_s,
                chains_update_period_s=0.25,
                lease_ttl_s=10.0, lease_extend_period_s=1.0),
            log=LogConfig(file=self._path("mgmtd.log"))))
        self.mgmtd_address = await self._wait_port("mgmtd")

        for i in range(1, self.num_storage + 1):
            self.start_storage_node(i)
        for i in range(1, self.num_storage + 1):
            await self._wait_port(f"storage{i}")

        await self._install_chains()

        meta_kv = self._kv_spec("meta")
        if self.kv_shards > 0 and self.with_meta:
            for i in range(1, self.kv_shards + 1):
                self._spawn_kv(i, self._kv_config(i))
            self.kv_addresses = [await self._wait_port(f"kv{i}", probe="Kv.status")
                                 for i in range(1, self.kv_shards + 1)]
            # split at KeyPrefix boundaries (all user keys carry 4-byte
            # printable prefixes — an even byte-split would land everything
            # in one shard): N groups get N contiguous runs of prefixes
            prefixes = self._kv_prefixes()
            parts = []
            for i, addr in enumerate(self.kv_addresses):
                if i:
                    split = prefixes[len(prefixes) * i // self.kv_shards]
                    parts.append(split.hex())
                parts.append(addr)
            meta_kv = "shards:" + ";".join(parts)

        if self.with_meta:
            self._spawn("meta", "t3fs_torch.app.meta_main", MetaMainConfig(
                node_id=100, mgmtd_address=self.mgmtd_address,
                kv=meta_kv,
                default_chunk_size=self.chunk_size,
                port_file=self._path("meta.port"),
                event_trace_path=(self._path("meta_events.parquet")
                                  if self.meta_event_trace else ""),
                monitor_address=self.monitor_address,
                metrics_period_s=2.0,
                log=LogConfig(file=self._path("meta.log"))))
            self.meta_address = await self._wait_port("meta")

    def _kv_config(self, i: int, listen_port: int = 0):
        from t3fs_torch.app.kv_main import KvMainConfig
        return KvMainConfig(
            node_id=200 + i, kv=self._kv_spec(f"kv{i}"),
            listen_port=listen_port,
            port_file=self._path(f"kv{i}.port"),
            monitor_address=self.monitor_address,
            metrics_period_s=2.0,
            log=LogConfig(file=self._path(f"kv{i}.log")))

    def _spawn_kv(self, i: int, cfg) -> subprocess.Popen:
        # the KV holds no chunk and runs no kernel: with no GPU visible it
        # cannot open a CUDA context by accident
        return self._spawn(f"kv{i}", "t3fs_torch.app.kv_main", cfg,
                           env={"CUDA_VISIBLE_DEVICES": ""})

    async def restart_kv_node(self, i: int) -> str:
        """Respawn kv{i} (1-based) over its WAL on the port it first bound,
        so meta's shard map still names it; returns its address once it
        answers Kv.status.  The caller kills it first (kill_node)."""
        port = int(self.kv_addresses[i - 1].rsplit(":", 1)[1])
        port_path = self._path(f"kv{i}.port")
        if os.path.exists(port_path):
            os.unlink(port_path)
        self._spawn_kv(i, self._kv_config(i, listen_port=port))
        return await self._wait_port(f"kv{i}", probe="Kv.status")

    def start_storage_node(self, node_id: int) -> None:
        name = f"storage{node_id}"
        port_path = self._path(f"{name}.port")
        if os.path.exists(port_path):
            os.unlink(port_path)
        self._spawn(name, "t3fs_torch.app.storage_main", StorageMainConfig(
            node_id=node_id, mgmtd_address=self.mgmtd_address,
            data_dir=self._path(f"storage{node_id}-data"),
            target_ids=[self.target_id(node_id, c)
                        for c in range(self.num_chains)],
            port_file=port_path,
            monitor_address=self.monitor_address,
            metrics_period_s=2.0,
            service=StorageConfig(heartbeat_period_s=0.3,
                                  resync_period_s=0.3,
                                  checksum_backend=self.checksum_backend),
            log=LogConfig(file=self._path(f"{name}.log"))))

    async def _install_chains(self) -> None:
        chains = []
        for c in range(self.num_chains):
            targets = []
            for r in range(self.replicas):
                node_id = (c + r) % self.num_storage + 1
                targets.append(ChainTargetInfo(
                    self.target_id(node_id, c), node_id,
                    PublicTargetState.SERVING))
            chains.append(ChainInfo(chain_id=c + 1, chain_ver=1,
                                    targets=targets))
        await self.admin.call(
            self.mgmtd_address, "Mgmtd.set_chains",
            SetChainsReq(chains=chains,
                         tables=[ChainTable(1, [c.chain_id for c in chains],
                                            table_type="cr",
                                            replicas=self.replicas)]))

    async def kill_node(self, name: str, *, hard: bool = True) -> None:
        """hard: SIGKILL (fail-stop); soft: SIGTERM (clean shutdown)."""
        proc = self.procs.pop(name, None)
        if proc is None or proc.poll() is not None:
            return
        proc.send_signal(signal.SIGKILL if hard else signal.SIGTERM)
        await asyncio.get_running_loop().run_in_executor(None, proc.wait)

    async def stop(self) -> None:
        await self.admin.close()
        procs = list(self.procs.items())
        self.procs.clear()
        for _, proc in procs:
            if proc.poll() is None:
                proc.send_signal(signal.SIGTERM)
        loop = asyncio.get_running_loop()
        for name, proc in procs:
            try:
                await asyncio.wait_for(
                    loop.run_in_executor(None, proc.wait), timeout=10)
            except asyncio.TimeoutError:
                proc.kill()
                await loop.run_in_executor(None, proc.wait)


async def read_replicas(client: Client, routing, batch: int = 16) -> dict:
    """Every chunk of every target in routing, read over the wire from the
    node that holds it: {(chain_id, target_id): {(inode, index): (ChunkMeta,
    bytes)}}.  Raises on any read that fails."""
    out = {}
    for chain_id, chain in sorted(routing.chains.items()):
        for t in chain.targets:
            addr = routing.node_address(t.node_id)
            rsp, _ = await client.call(addr, "Storage.get_all_chunk_metadata",
                                       TargetOpReq(target_id=t.target_id))
            metas = sorted(rsp.metas, key=lambda m: (m.chunk_id.inode,
                                                     m.chunk_id.index))
            chunks = {}
            for i in range(0, len(metas), batch):
                group = metas[i:i + batch]
                r, payload = await client.call(
                    addr, "Storage.batch_read", BatchReadReq(ios=[
                        ReadIO(chunk_id=m.chunk_id, chain_id=chain_id,
                               offset=0, length=m.length) for m in group]))
                pos = 0
                for m, res in zip(group, r.results):
                    if res.status.code:
                        raise StatusError(res.status.code,
                                          f"read {m.chunk_id} on target "
                                          f"{t.target_id}: {res.status}")
                    key = (m.chunk_id.inode, m.chunk_id.index)
                    chunks[key] = (m, bytes(payload[pos:pos + res.length]))
                    pos += res.length
            out[(chain_id, t.target_id)] = chunks
    return out


async def _main(args) -> None:
    cluster = DevCluster(args.run_dir, num_storage=args.nodes,
                         replicas=args.replicas, num_chains=args.chains,
                         with_meta=True, with_monitor=args.monitor,
                         kv_shards=args.kv_shards,
                         checksum_backend=args.checksum_backend)
    await cluster.start()
    print(f"cluster up: mgmtd={cluster.mgmtd_address} "
          f"meta={cluster.meta_address} run_dir={cluster.run_dir}")
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    await stop.wait()
    await cluster.stop()


def main(argv: list[str] | None = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="t3fs-dev-cluster")
    ap.add_argument("--run-dir", default="/tmp/t3fs-dev")
    ap.add_argument("--nodes", type=int, default=3)
    ap.add_argument("--replicas", type=int, default=3)
    ap.add_argument("--chains", type=int, default=2)
    ap.add_argument("--monitor", action="store_true")
    ap.add_argument("--kv-shards", type=int, default=0,
                    help=">0: run meta over a range-sharded KV deployment "
                         "of this many kv_main processes (2PC across "
                         "shard groups)")
    ap.add_argument("--checksum-backend", default="cuda",
                    help="every storage node's checksum backend: cuda (B1 "
                         "on the card) or cpu (the host CRC)")
    asyncio.run(_main(ap.parse_args(argv)))


if __name__ == "__main__":
    main()
