"""LocalCluster: real mgmtd + N storage nodes in one process.

Reference analog: testing_configs/ single-host cluster launcher (mgmtd + 5
storage nodes with a generated chain table, testing_configs/README.md) —
here in-process for tests, with fast failure-detection knobs.

The port of t3fs/testing/cluster.py, storage-only: mgmtd over a MemKVEngine
plus StorageServers, each node's payload CRCs on the CUDA checksum backend
unless the caller asks for another one (checksum_backend: a name, or a
factory called once per node start, e.g. a CudaChecksumBackend on
device="cpu").  Every node runs in this one process.  The meta service,
the monitor and the sharded KV are not ported: with_meta, with_monitor,
kv_shards and with_kv_distributor raise NotImplementedError.
"""

from __future__ import annotations

import asyncio
import os
import shutil
import tempfile

from t3fs_torch.client.mgmtd_client import MgmtdClient
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.kv.engine import MemKVEngine
from t3fs_torch.mgmtd.service import MgmtdConfig, MgmtdServer, SetChainsReq
from t3fs_torch.mgmtd.types import ChainInfo, ChainTable, ChainTargetInfo, PublicTargetState
from t3fs_torch.net.client import Client
from t3fs_torch.net.server import Server
from t3fs_torch.storage.server import StorageServer


class LocalCluster:
    """mgmtd + N storage nodes + storage client, fast knobs for tests."""

    def __init__(self, num_nodes: int = 3, replicas: int = 3,
                 num_chains: int = 1,
                 heartbeat_timeout_s: float = 0.6,
                 with_meta: bool = False,
                 write_pipeline: str = "off",
                 stream_threshold: int | None = None,
                 ec_chains: int = 0,
                 trace=None,
                 with_monitor: bool = False,
                 seed_read_priors: bool = True,
                 kv_shards: int = 0,
                 with_kv_distributor: bool = False,
                 checksum_backend="cuda"):
        unported = [name for name, on in (
            ("with_meta", with_meta), ("with_monitor", with_monitor),
            ("kv_shards", kv_shards), ("with_kv_distributor",
                                       with_kv_distributor)) if on]
        if unported:
            raise NotImplementedError(
                f"LocalCluster({', '.join(unported)}): the meta service, the "
                "monitor and the sharded KV are not ported yet (ROADMAP A12g)")
        self.num_nodes = num_nodes
        self.replicas = replicas
        self.num_chains = num_chains
        # single-replica chains for EC shard placement (reference: separate
        # CR vs EC chain-table types).  They live in chain table 2 so the
        # meta ChainAllocator (table 1) never places replicated files on
        # them; chain ids follow the replicated ones, each homed on one
        # node round-robin.  A node crash loses its EC shards outright —
        # exactly the damage the scrub/repair path exists to heal.
        self.ec_chains = ec_chains
        # write-pipeline mode for every storage node (tests parameterize
        # resync/fault suites over it); stream_threshold lets small-chunk
        # tests exercise the fragment path
        self.write_pipeline = write_pipeline
        self.stream_threshold = stream_threshold
        # TraceConfig every storage node installs on (re)start.  Without
        # this, StorageServer.start()'s process-wide configure_tracing
        # resets sampling to the zero default — including on a mid-test
        # restart, which would silently kill tracing for a caller (the
        # soak harness) that configured it before building the cluster.
        self.trace = trace
        self.seed_read_priors = seed_read_priors
        # every StorageServer's checksum backend: a name or a factory
        self.checksum_backend = checksum_backend
        self.kv = MemKVEngine()
        self.mgmtd_cfg = MgmtdConfig(
            heartbeat_timeout_s=heartbeat_timeout_s,
            chains_update_period_s=0.1,
            lease_ttl_s=5.0, lease_extend_period_s=1.0)
        self.mgmtd_rpc = Server()
        self.mgmtd: MgmtdServer | None = None
        self.storage: dict[int, StorageServer] = {}
        self._tmp = tempfile.TemporaryDirectory(prefix="t3fs-cluster-")
        self.admin = Client()
        self.mgmtd_client: MgmtdClient | None = None
        self.sc: StorageClient | None = None

    def target_id(self, node_id: int, chain_idx: int = 0) -> int:
        return node_id * 100 + chain_idx + 1

    def node_root(self, node_id: int) -> str:
        return f"{self._tmp.name}/node{node_id}"

    async def start(self) -> None:
        self.mgmtd = MgmtdServer(self.kv, 1, "", self.mgmtd_cfg,
                                 admin_token="local-admin")
        for svc in self.mgmtd.services:
            self.mgmtd_rpc.add_service(svc)
        await self.mgmtd_rpc.start()
        await self.mgmtd.start()

        for i in range(self.num_nodes):
            await self.start_storage_node(i + 1)

        # install chains: chain c uses nodes (c, c+1, ... c+replicas-1) mod N
        chains = []
        for c in range(self.num_chains):
            targets = []
            for r in range(self.replicas):
                node_id = (c + r) % self.num_nodes + 1
                targets.append(ChainTargetInfo(
                    self.target_id(node_id, c), node_id,
                    PublicTargetState.SERVING))
            chains.append(ChainInfo(chain_id=c + 1, chain_ver=1, targets=targets))
        tables = [ChainTable(1, [c.chain_id for c in chains],
                             table_type="cr", replicas=self.replicas)]
        if self.ec_chains:
            ec = []
            for j in range(self.ec_chains):
                node_id = j % self.num_nodes + 1
                cid = self.num_chains + j + 1
                ec.append(ChainInfo(
                    chain_id=cid, chain_ver=1,
                    targets=[ChainTargetInfo(
                        self.target_id(node_id, self.num_chains + j),
                        node_id, PublicTargetState.SERVING)]))
            tables.append(ChainTable(2, [c.chain_id for c in ec],
                                     table_type="ec", replicas=1))
            chains += ec
        await self.admin.call(
            self.mgmtd_rpc.address, "Mgmtd.set_chains",
            SetChainsReq(chains=chains, tables=tables))

        # wait until every storage node has pulled the installed chains so
        # first writes don't race routing propagation
        want = self.mgmtd.state.routing().version
        for _ in range(100):
            if all(ss.mgmtd.routing().version >= want
                   for ss in self.storage.values()):
                break
            await asyncio.sleep(0.05)

        self.mgmtd_client = MgmtdClient(
            self.mgmtd_rpc.address, refresh_period_s=0.1,
            seed_read_priors=self.seed_read_priors)
        await self.mgmtd_client.start()
        self.sc = StorageClient(
            self.mgmtd_client.routing,
            config=StorageClientConfig(retry_backoff_s=0.05, max_retries=12),
            refresh_routing=self.mgmtd_client.refresh)

    async def start_storage_node(self, node_id: int,
                                 with_targets: bool = True) -> StorageServer:
        # heartbeat at timeout/6: the lease/2 self-fence then has ~3
        # heartbeat periods of margin (the production ratio) — one stalled
        # loop iteration must not spuriously fence every node in a test
        ss = StorageServer(node_id, self.mgmtd_rpc.address,
                           heartbeat_period_s=min(
                               0.15, self.mgmtd_cfg.heartbeat_timeout_s / 6),
                           resync_period_s=0.1,
                           write_pipeline=self.write_pipeline,
                           checksum_backend=self.checksum_backend,
                           default_root=self.node_root(node_id),
                           discover_targets=True)
        if self.stream_threshold is not None:
            ss.node.stream_threshold = self.stream_threshold
            ss.node.stream_frag_bytes = max(1, self.stream_threshold // 2)
        if self.trace is not None:
            ss.cfg.trace = self.trace
        try:
            # chunk dirs are named t{target_id} (matching create_target's
            # default-root derivation) so a restart re-adopts migrated-in
            # targets via StorageServer._discover_targets
            for c in range(self.num_chains) if with_targets else ():
                # every node pre-creates targets for chains it may serve
                tid = self.target_id(node_id, c)
                ss.add_target(tid, f"{self.node_root(node_id)}/t{tid}")
            for j in range(self.ec_chains) if with_targets else ():
                # EC chains are single-replica: only the home node hosts one
                if j % self.num_nodes + 1 == node_id:
                    tid = self.target_id(node_id, self.num_chains + j)
                    ss.add_target(tid, f"{self.node_root(node_id)}/t{tid}")
            await ss.start()
        except BaseException:
            # a partial start (bound listener, open engines) must not leak:
            # a caller retry would otherwise double-open the chunk dirs
            try:
                await ss.stop()
            except Exception:
                pass
            raise
        self.storage[node_id] = ss
        return ss

    async def add_storage_node(self, node_id: int = 0) -> StorageServer:
        """Elastic membership: bring up a brand-new empty node.
        No pre-created targets — the rebalancer migrates chains onto it
        via Storage.create_target (empty root → node derives the path
        under its default_root).  Returns the started server; the node
        registers with mgmtd via its first heartbeat."""
        if node_id == 0:
            node_id = max(self.storage, default=0) + 1
        if node_id in self.storage:
            raise ValueError(f"node {node_id} already running")
        return await self.start_storage_node(node_id, with_targets=False)

    async def kill_mgmtd(self) -> None:
        """Fail-stop mgmtd: listener down, lease left in the KV.  Every
        in-flight admin op (chain surgery, routing fetch) fails with a
        transient RPC error until restart_mgmtd brings it back."""
        self._mgmtd_addr = (self.mgmtd_rpc.host, self.mgmtd_rpc.port)
        await self.mgmtd.stop()
        await self.mgmtd_rpc.stop()
        self.mgmtd = None

    async def restart_mgmtd(self) -> None:
        """(Kill +) restart mgmtd on the SAME port over the SAME KV: state
        (chains, nodes, tables) reloads from the transactional store, the
        restarted instance re-acquires the lease (same holder node id),
        and every client/server reconnects on its next call.  Mid-flight
        admin ops fail with a transient RPC error — exactly the window
        the migration service's resumable-job path must survive."""
        if self.mgmtd is not None:
            await self.kill_mgmtd()
        host, port = self._mgmtd_addr
        self.mgmtd_rpc = Server(host, port)
        self.mgmtd = MgmtdServer(self.kv, 1, "", self.mgmtd_cfg,
                                 admin_token="local-admin")
        for svc in self.mgmtd.services:
            self.mgmtd_rpc.add_service(svc)
        await self.mgmtd_rpc.start()
        await self.mgmtd.start()
        # lease re-acquire is immediate (same holder node), but wait until
        # the instance answers as primary so callers can resume at once
        for _ in range(100):
            if await self.mgmtd.state.is_primary():
                break
            await asyncio.sleep(0.05)

    async def restart_storage_node(self, node_id: int) -> StorageServer:
        """Flap: fail-stop the node (if up) and restart it on the SAME
        disk.  No pre-created targets — _discover_targets re-adopts every
        t{target_id} dir it finds, including ones migrated in before the
        crash."""
        if node_id in self.storage:
            await self.kill_storage_node(node_id)
        return await self.start_storage_node(node_id, with_targets=False)

    async def kill_storage_node(self, node_id: int) -> None:
        """Fail-stop: the node vanishes (no clean goodbye)."""
        ss = self.storage.pop(node_id)
        try:
            await ss.stop()
        except BaseException:
            # keep tracking a half-stopped server so teardown still stops
            # it (and its root dirs aren't deleted under a live engine)
            self.storage[node_id] = ss
            raise

    # ---------------------------------------------------- fault hooks
    # (soak harness + chaos tests, docs/soak.md: straggler / crash +
    # empty-disk restart / disk bit-rot)

    def set_read_delay(self, node_id: int, delay_s: float) -> None:
        """Straggler: every read served by this node sleeps first."""
        self.storage[node_id].node.read_delay_s = delay_s

    def corrupt_chunk_on_disk(self, chain_id: int, chunk_id,
                              nbytes: int = 64) -> bool:
        """Bit-rot: scribble a chunk's on-disk bytes behind the CRC, so
        only a disk-verify (CheckWorker) or scrub probe can see it.
        Returns False if the chunk is not on disk (deleted, or its node
        was wiped by a crash fault) — callers picking targets under live
        traffic must tolerate the pick going stale."""
        head = self.mgmtd.state.routing().chains[chain_id].head()
        target = self.storage[head.node_id].node.targets[head.target_id]
        loc = target.engine.locate(chunk_id, 0, nbytes)
        if loc is None:
            return False
        fd, off, _n, _gen = loc
        os.pwrite(fd, b"\xde\xad\xbe\xef" * ((nbytes + 3) // 4), off)
        return True

    async def restart_storage_node_empty(self, node_id: int,
                                         timeout_s: float = 30.0) -> None:
        """Crash + empty-disk restart: fail-stop the node (if still up),
        wait for mgmtd to bump the affected chains, wipe the node's disk,
        restart it, and wait until every affected chain has a head again.
        Replicated chains refill via CRAQ resync; single-replica EC
        chains come back empty — scrub/repair's job to heal."""
        routing = self.mgmtd.state.routing()
        affected = {c.chain_id: c.chain_ver
                    for c in routing.chains.values()
                    if any(t.node_id == node_id for t in c.targets)}
        if node_id in self.storage:
            await self.kill_storage_node(node_id)
        steps = max(1, int(timeout_s / 0.05))
        for _ in range(steps):
            routing = self.mgmtd.state.routing()
            if all(routing.chains[c].chain_ver > v
                   for c, v in affected.items()):
                break
            await asyncio.sleep(0.05)
        else:
            raise TimeoutError("chains never noticed the node kill")
        shutil.rmtree(self.node_root(node_id), ignore_errors=True)
        await self.start_storage_node(node_id)
        for _ in range(steps):
            routing = self.mgmtd.state.routing()
            if all(routing.chains[c].head() is not None for c in affected):
                break
            await asyncio.sleep(0.05)
        else:
            raise TimeoutError("restarted node's chains never came back")
        if self.mgmtd_client:
            await self.mgmtd_client.refresh()

    def chain(self, chain_id: int = 1) -> ChainInfo:
        return self.mgmtd.state.routing().chains[chain_id]

    async def stop(self) -> None:
        if self.sc:
            await self.sc.close()
        if self.mgmtd_client:
            await self.mgmtd_client.stop()
        await self.admin.close()
        for node_id in list(self.storage):
            try:
                await self.kill_storage_node(node_id)
            except Exception:
                # best-effort teardown: a node wedged by an earlier failed
                # stop must not abort the rest of the cluster's shutdown
                self.storage.pop(node_id, None)
        if self.mgmtd:
            await self.mgmtd.stop()
        await self.mgmtd_rpc.stop()
        self._tmp.cleanup()
