"""In-process multi-node storage cluster for tests.

Reference analog: tests/lib/UnitTestFabric.h — N real StorageServers in one
process wired to a hand-built RoutingInfo and a fake mgmtd; tests parameterize
replica count / node count (SystemSetupConfig, :86-163).

The port of t3fs/testing/fabric.py: each node's payload CRCs run on the
CUDA checksum backend unless the caller asks for another one (the tests
pass "cpu" or a CudaChecksumBackend on device="cpu"); as in the reference,
targets default to the native chunk engine and large reads to the io_uring
worker where the kernel allows it (else the thread-pool path).
"""

from __future__ import annotations

import tempfile

from t3fs_torch.mgmtd.types import (
    ChainInfo, ChainTargetInfo, ChainTable, NodeInfo, PublicTargetState,
    RoutingInfo,
)
from t3fs_torch.net.client import Client
from t3fs_torch.net.rdma import BufferRegistry
from t3fs_torch.net.server import Server
from t3fs_torch.storage.service import StorageNode, StorageService


class StorageFabric:
    """N storage nodes, `num_chains` chains of `replicas` targets each.

    num_chains=1 (the default) keeps the historical single-chain shape:
    every node hosts a target, the chain spans the first `replicas` nodes.
    num_chains>1 rotates chain c's replica r onto node (c+r) % num_nodes —
    EC tests get one chain per node (replicas=1) so each shard has an
    independently delayable/killable home."""

    # class-level defaults so suites can parameterize every test at once
    # (UnitTestFabric SystemSetupConfig analog, tests/lib/UnitTestFabric.h:86)
    default_checksum_backend: str = "cuda"
    default_engine_backend: str = "native"
    default_aio_read: bool = True
    default_write_pipeline: str = "off"
    default_stream_threshold: int | None = None

    def __init__(self, num_nodes: int = 3, replicas: int = 3, chain_id: int = 1,
                 checksum_backend=None, engine_backend: str | None = None,
                 aio_read: bool | None = None,
                 write_pipeline: str | None = None,
                 stream_threshold: int | None = None,
                 num_chains: int = 1):
        assert replicas <= num_nodes
        self.num_nodes = num_nodes
        self.replicas = replicas
        self.chain_id = chain_id
        self.num_chains = num_chains
        self.aio_read = (aio_read if aio_read is not None
                         else self.default_aio_read)
        self.checksum_backend = (checksum_backend if checksum_backend is not None
                                 else self.default_checksum_backend)
        self.engine_backend = engine_backend or self.default_engine_backend
        self.write_pipeline = write_pipeline or self.default_write_pipeline
        # tests lower the threshold so small payloads exercise streaming
        self.stream_threshold = (stream_threshold if stream_threshold
                                 is not None else self.default_stream_threshold)
        self.routing = RoutingInfo(version=1)
        self.servers: list[Server] = []
        self.nodes: list[StorageNode] = []
        self.client = Client()
        self.bufs = BufferRegistry()
        self.client.add_service(self.bufs)
        self._tmp = tempfile.TemporaryDirectory(prefix="t3fs-fabric-")

    def target_id(self, node_idx: int, chain: int = 0) -> int:
        return (node_idx + 1) * 100 + chain + 1

    @property
    def chain_ids(self) -> list[int]:
        return [self.chain_id + c for c in range(self.num_chains)]

    async def start(self) -> None:
        for i in range(self.num_nodes):
            node_id = i + 1
            node = StorageNode(node_id, lambda: self.routing, Client(),
                               checksum_backend=self.checksum_backend,
                               write_pipeline=self.write_pipeline)
            if self.stream_threshold is not None:
                node.stream_threshold = self.stream_threshold
                node.stream_frag_bytes = max(1, self.stream_threshold // 2)
            if self.aio_read:
                from t3fs_torch.storage.aio import AioReadWorker
                if AioReadWorker.available():
                    node.aio = AioReadWorker()
                    node.aio.start()
            node.client.add_service(BufferRegistry())  # forwarding conns
            if self.num_chains == 1:
                node.add_target(self.target_id(i),
                                f"{self._tmp.name}/n{node_id}",
                                engine_backend=self.engine_backend)
            server = Server()
            server.add_service(StorageService(node))
            await server.start()
            self.routing.nodes[node_id] = NodeInfo(node_id, server.address)
            self.servers.append(server)
            self.nodes.append(node)
        if self.num_chains == 1:
            self.routing.chains[self.chain_id] = ChainInfo(
                chain_id=self.chain_id, chain_ver=1,
                targets=[ChainTargetInfo(self.target_id(i), i + 1,
                                         PublicTargetState.SERVING)
                         for i in range(self.replicas)])
        else:
            # chain c replica r -> node (c+r) % num_nodes: chains spread
            # round-robin so shard homes are independent
            for c in range(self.num_chains):
                cid = self.chain_id + c
                targets = []
                for r in range(self.replicas):
                    idx = (c + r) % self.num_nodes
                    tid = self.target_id(idx, c)
                    self.nodes[idx].add_target(
                        tid, f"{self._tmp.name}/n{idx + 1}c{cid}",
                        engine_backend=self.engine_backend)
                    targets.append(ChainTargetInfo(tid, idx + 1,
                                                   PublicTargetState.SERVING))
                self.routing.chains[cid] = ChainInfo(
                    chain_id=cid, chain_ver=1, targets=targets)
        self.routing.chain_tables[1] = ChainTable(1, self.chain_ids)

    def chain(self) -> ChainInfo:
        return self.routing.chains[self.chain_id]

    def head_address(self) -> str:
        head = self.chain().head()
        return self.routing.node_address(head.node_id)

    def address_of_target(self, target_id: int) -> str:
        for t in self.chain().targets:
            if t.target_id == target_id:
                return self.routing.node_address(t.node_id)
        raise KeyError(target_id)

    def bump_chain(self, new_targets: list[ChainTargetInfo]) -> None:
        """Simulate an mgmtd chain update (version bump)."""
        c = self.chain()
        self.routing.chains[self.chain_id] = ChainInfo(
            c.chain_id, c.chain_ver + 1, new_targets)
        self.routing.version += 1

    async def stop(self) -> None:
        await self.client.close()
        for node in self.nodes:
            await node.client.close()
            await node.codec.close()
        for server in self.servers:
            await server.stop()
        for node in self.nodes:
            # after the RPC servers: in-flight reads may hold node.aio
            if node.aio is not None:
                await node.aio.close()
                node.aio = None
        for node in self.nodes:
            for t in node.targets.values():
                t.close()
        self._tmp.cleanup()
