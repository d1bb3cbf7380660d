"""The port's ECStorageClient over the port's LocalCluster: the cases of
tests/test_ec_client.py (BASELINE configs #3 and #4), with the nodes' CRCs
on the host and TorchECCodec on its plain versions (device="cpu").

Where a case kills a node, the cluster's heartbeat timeout is one that test
load cannot reach, so no live node fences or has its chains reshaped by a
stalled loop; the killed node's death is declared by aging its last
heartbeat in mgmtd.  The mid-stream kill comes after a count of acked
stripes, not at a wall-clock offset.  The reference's CPU-dispatch case
(its XLA route) has no counterpart in the port; in its place, a CPU
TorchECCodec runs the plain versions (no kernel launch) and, on the card, a
CUDA one launches the kernels."""

import asyncio
import random

import numpy as np
import pytest
import torch

from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.client.storage_client import StorageClient, StorageClientConfig
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.storage.types import QueryChunkReq, RemoveChunksReq
from t3fs_torch.testing.cluster import LocalCluster
from t3fs_torch.utils import serde
from t3fs_torch.utils.status import StatusCode, StatusError

# beyond any loop stall of a loaded test run: nodes self-fence at half of it
HEARTBEAT_TIMEOUT_S = 30.0


def ec_cluster() -> LocalCluster:
    return LocalCluster(num_nodes=3, replicas=1, num_chains=6,
                        heartbeat_timeout_s=HEARTBEAT_TIMEOUT_S,
                        checksum_backend="cpu")


def ec_client(sc) -> ECStorageClient:
    return ECStorageClient(sc, codec=TorchECCodec(device="cpu"))


async def wait_reshaped(cluster, node_id: int, timeout: float = 15.0) -> None:
    """Declare the killed node dead (its last heartbeat aged past the
    timeout) until mgmtd has bumped every chain it held, then refresh the
    cluster client's routing."""
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while True:
        cluster.mgmtd.state.last_heartbeat[node_id] = 0.0
        if all(c.chain_ver >= 2 for c in
               cluster.mgmtd.state.routing().chains.values()
               if any(t.node_id == node_id for t in c.targets)):
            break
        assert loop.time() < deadline, "chains never noticed the node kill"
        await asyncio.sleep(0.02)
    await cluster.mgmtd_client.refresh()


async def remove_chunk(cluster, chain_id: int, cid) -> None:
    routing = cluster.mgmtd.state.routing()
    head = routing.chains[chain_id].head()
    await cluster.admin.call(
        routing.node_address(head.node_id), "Storage.remove_chunks",
        RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                        begin_index=cid.index, end_index=cid.index + 1))


def ok(results) -> bool:
    return all(r.status.code == int(StatusCode.OK) for r in results)


def test_ec_layout_addressing():
    lay = ECLayout.create(k=4, m=2, chunk_size=100, chains=[1, 2, 3, 4, 5, 6])
    # all shards of one stripe land on distinct chains
    chains = [lay.shard_chain(0, s) for s in range(6)]
    assert len(set(chains)) == 6
    # rotation: stripe 1 starts at a different chain
    assert lay.shard_chain(1, 0) == lay.shard_chain(0, 0)  # 6 % 6 == 0 rotation
    lay7 = ECLayout.create(k=4, m=2, chunk_size=100, chains=[1, 2, 3, 4, 5, 6, 7])
    assert lay7.shard_chain(1, 0) != lay7.shard_chain(0, 0)


def test_ec_legacy_layout_refuses_current_decoder():
    """A layout serialized before code_id existed must not be decoded with
    the current generator matrix."""
    lay = ECLayout.create(k=4, m=2, chunk_size=100, chains=[1, 2, 3, 4, 5, 6])
    lay2 = serde.loads(serde.dumps(lay))
    lay2.check_code(default_rs(4, 2))
    legacy = ECLayout(k=4, m=2, chunk_size=100, chains=[1, 2, 3, 4, 5, 6])
    assert legacy.code_id == "rrvand-11d"
    with pytest.raises(StatusError) as ei:
        legacy.check_code(default_rs(4, 2))
    assert ei.value.status.code == int(StatusCode.EC_FORMAT_MISMATCH)


def test_ec_write_read_roundtrip_and_reconstruct():
    async def body():
        cluster = ec_cluster()
        await cluster.start()
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=2048,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ec_client(cluster.sc)
            data = bytes(range(256)) * 32  # 8192 = exactly one 4-chunk stripe
            assert ok(await ec.write_stripe(lay, 9, 0, data))
            assert await ec.read_stripe(lay, 9, 0, len(data)) == data
            # fail-stop node 2 (its chains lose their only target)
            await cluster.kill_storage_node(2)
            await wait_reshaped(cluster, 2)
            got = await ec.read_stripe(lay, 9, 0, len(data))
            assert got == data, "EC reconstruction must mask the lost node"
            # the fused word encode+CRC route for the write, the fused word
            # decode+verify route for the degraded read, never the byte plane
            counts = ec.codec.codec_counts
            assert counts.get("cuda-encode-words", 0) >= 1, counts
            assert counts.get("cuda-decode-words", 0) >= 1, counts
            assert "cuda-bitmatmul" not in counts, counts
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_ec_codec_micro_batches_concurrent_stripes():
    """Concurrent write_stripe calls share one launch per shape."""
    async def body():
        cluster = ec_cluster()
        await cluster.start()
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=2048,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ec_client(cluster.sc)
            data = bytes(range(256)) * 32
            n = 8
            results = await asyncio.gather(
                *(ec.write_stripe(lay, 9, s, data) for s in range(n)))
            assert all(ok(rs_) for rs_ in results)
            assert ec.codec.batched_items == n
            assert ec.codec.batches < n, (ec.codec.batches,
                                          ec.codec.batched_items)
            for s in range(n):
                assert await ec.read_stripe(lay, 9, s, len(data)) == data
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_ec_short_stripe_and_repair():
    async def body():
        cluster = ec_cluster()
        await cluster.start()
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ec_client(cluster.sc)
            data = b"short stripe!" * 100  # 1300B: chunk0 full, chunk1 partial
            await ec.write_stripe(lay, 10, 0, data)
            assert await ec.read_stripe(lay, 10, 0, len(data)) == data
            # delete one data shard, then repair it from parity
            await remove_chunk(cluster, lay.shard_chain(0, 0),
                               lay.data_chunk(10, 0, 0))
            r = await ec.repair_chunk(lay, 10, 0, 0, stripe_len=len(data))
            assert r.status.code == int(StatusCode.OK)
            assert await ec.read_stripe(lay, 10, 0, len(data)) == data
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_ec_node_killed_mid_stripe_writes():
    """A storage node dies while a stream of stripe writes is in flight,
    right after the fifth acked stripe: every acked stripe reads back
    exactly, by reconstruction where the lost node's shards are gone."""
    async def body():
        cluster = ec_cluster()
        await cluster.start()
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=[1, 2, 3, 4, 5, 6])
            # fast-fail writer client: single-replica chains on the dead
            # node never recover, so long retry tails would stall the test
            wsc = StorageClient(
                cluster.mgmtd_client.routing,
                config=StorageClientConfig(max_retries=3, retry_backoff_s=0.02),
                refresh_routing=cluster.mgmtd_client.refresh)
            ec_w = ec_client(wsc)
            ec = ec_client(cluster.sc)
            stripe_len = 4 * 1024
            acked: dict[int, bytes] = {}
            enough = asyncio.Event()

            warm = b"w" * stripe_len
            assert ok(await ec_w.write_stripe(lay, 19, 0, warm))
            acked[19] = warm

            async def writer():
                rng = random.Random(3)
                for i in range(30):
                    data = bytes([rng.randrange(256)]) * stripe_len
                    try:
                        results = await ec_w.write_stripe(lay, 20 + i, 0, data)
                    except Exception:
                        continue  # mid-kill failures are allowed (unacked)
                    if ok(results):
                        acked[20 + i] = data
                        if len(acked) >= 5:
                            enough.set()
                    await asyncio.sleep(0.01)

            killed_at = []

            async def killer():
                await enough.wait()
                killed_at.append(len(acked))
                await cluster.kill_storage_node(2)

            await asyncio.gather(writer(), killer())
            assert killed_at == [5]
            assert len(acked) >= 5
            await wait_reshaped(cluster, 2)
            for inode, data in acked.items():
                got = await ec.read_stripe(lay, inode, 0, stripe_len)
                assert got == data, f"stripe {inode} lost after mid-write kill"
            await ec_w.close()
            await ec.close()
            await wsc.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_ec_repair_stripe_double_loss_one_pass():
    """repair_stripe rebuilds both lost shards of a stripe from one
    survivor read and one decode."""
    async def body():
        cluster = ec_cluster()
        await cluster.start()
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ec_client(cluster.sc)
            data = bytes(range(256)) * 16  # 4096 = one full stripe
            await ec.write_stripe(lay, 30, 0, data)
            # wipe shard 1 (data) and shard 5 (parity): a double loss
            for shard in (1, 5):
                cid = (lay.data_chunk(30, 0, shard) if shard < 4
                       else lay.parity_chunk(30, 0, shard - 4))
                await remove_chunk(cluster, lay.shard_chain(0, shard), cid)
            res = await ec.repair_stripe(lay, 30, 0, (1, 5),
                                         stripe_len=len(data))
            assert ok(res)
            assert await ec.read_stripe(lay, 30, 0, len(data)) == data
            # the repaired parity is byte-correct, not just readable: wipe a
            # different data shard and decode through shard 5
            await remove_chunk(cluster, lay.shard_chain(0, 2),
                               lay.data_chunk(30, 0, 2))
            assert await ec.read_stripe(lay, 30, 0, len(data)) == data
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_ec_repair_stripe_zero_hole_stays_absent():
    """Repairing a short stripe's zero-hole data shard must not materialize
    an empty chunk: absent == zeros is the decode contract."""
    async def body():
        cluster = ec_cluster()
        await cluster.start()
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ec_client(cluster.sc)
            data = b"z" * 1500   # shards 0,1 hold data; shards 2,3 are holes
            await ec.write_stripe(lay, 40, 0, data)
            res = await ec.repair_stripe(lay, 40, 0, (1, 3),
                                         stripe_len=len(data))
            assert ok(res)
            assert await ec.read_stripe(lay, 40, 0, len(data)) == data
            cid = lay.data_chunk(40, 0, 3)
            chain_id = lay.shard_chain(0, 3)
            routing = cluster.mgmtd.state.routing()
            head = routing.chains[chain_id].head()
            rsp, _ = await cluster.admin.call(
                routing.node_address(head.node_id), "Storage.query_chunk",
                QueryChunkReq(chain_id=chain_id, chunk_id=cid))
            assert not rsp.found, "phantom empty chunk for a zero-hole shard"
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


async def encode_and_decode(codec: TorchECCodec, data: np.ndarray):
    parity = await codec.encode(data, 4, 2)
    shards = np.concatenate([data, parity])
    present = (0, 2, 3, 4)
    got = await codec.reconstruct(shards[list(present)], present, (1,), 4, 2)
    return parity, got


def test_ec_codec_cpu_runs_the_plain_versions():
    """A TorchECCodec on the CPU runs the plain versions: the word routes,
    right against RSCode, and not one kernel launch counted."""
    async def body():
        codec = TorchECCodec(device="cpu")
        try:
            data = np.random.default_rng(7).integers(0, 256, (4, 2048),
                                                     dtype=np.uint8)
            cc.reset_launches()
            parity, got = await encode_and_decode(codec, data)
            assert codec.codec_counts == {"cuda-words": 1, "cuda-rec-words": 1}
            assert not any(cc.launches.values()), cc.launches
            np.testing.assert_array_equal(parity, default_rs(4, 2).encode_ref(data))
            np.testing.assert_array_equal(got[0], data[1])
        finally:
            await codec.close()
    asyncio.run(body())


@pytest.mark.cuda
def test_ec_codec_cuda_launches_the_kernels():
    """On the card the same calls launch B2 and B3, with the same bytes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")

    async def body():
        codec = TorchECCodec()
        try:
            data = np.random.default_rng(7).integers(0, 256, (4, 2048),
                                                     dtype=np.uint8)
            cc.reset_launches()
            parity, got = await encode_and_decode(codec, data)
            assert cc.launches["rs_raid6_words"] >= 1, cc.launches
            assert cc.launches["rs_reconstruct_words"] >= 1, cc.launches
            np.testing.assert_array_equal(parity, default_rs(4, 2).encode_ref(data))
            np.testing.assert_array_equal(got[0], data[1])
        finally:
            await codec.close()
    asyncio.run(body())
