"""The JAX package's ECStorageClient over the port's codec: stripes written
through TorchECCodec (device="cpu", so the kernels' plain versions run) on a
live LocalCluster read back degraded after a node loss and repair on the
reduced-read path, on a plain RS(4+2) layout, an lrc-xor layout, a pm-msr
layout and an RS(6+3) layout.

Modelled on tests/test_ec_client.py.  The bytes, the CRCs the client hands
to storage and the codec's routes are all checked."""

import asyncio

import numpy as np
import pytest

from t3fs.client.ec_client import ECLayout, ECStorageClient, RepairIOStats
from t3fs.ops.crc32c import crc32c_ref
from t3fs.storage.types import RemoveChunksReq
from t3fs.testing.cluster import LocalCluster
from t3fs.utils.status import StatusCode
from t3fs_torch.client.ec_codec import TorchECCodec

rng = np.random.default_rng(37)
CS = 2048                     # chunk size: four 512-byte sub-shards


async def _remove_shard(cluster, lay: ECLayout, inode: int, stripe: int,
                        slot: int) -> None:
    routing = cluster.mgmtd.state.routing()
    chain_id = lay.shard_chain(stripe, slot)
    cid = lay.shard_chunk(inode, stripe, slot)
    head = routing.chains[chain_id].head()
    await cluster.admin.call(
        routing.node_address(head.node_id), "Storage.remove_chunks",
        RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                        begin_index=cid.index, end_index=cid.index + 1))


def _ok(results) -> bool:
    return all(r.status.code == int(StatusCode.OK) for r in results)


def test_degraded_read_and_repair_over_port_codec():
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=1, num_chains=6,
                               heartbeat_timeout_s=0.6)
        await cluster.start()
        codec = TorchECCodec(device="cpu")
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=CS,
                                  chains=[1, 2, 3, 4, 5, 6])
            ec = ECStorageClient(cluster.sc, codec=codec)
            data = {s: rng.integers(0, 256, 4 * CS, dtype=np.uint8).tobytes()
                    for s in range(2)}
            for s, d in data.items():
                assert _ok(await ec.write_stripe(lay, 9, s, d))
            assert codec.codec_counts.get("cuda-encode-words", 0) >= 1

            # reduced-read repair: one lost data shard, rebuilt from k
            # survivors as 4 sub-shards of 512 bytes, CRCs stitched
            await _remove_shard(cluster, lay, 9, 0, 1)
            res = await ec.repair_stripe(lay, 9, 0, (1,), stripe_len=4 * CS)
            assert _ok(res)
            got, crcs = await ec.read_stripe_with_crcs(lay, 9, 0, 4 * CS)
            assert got == data[0]
            assert crcs[1] == crc32c_ref(data[0][CS:2 * CS])
            assert codec.codec_counts.get("cuda-repair-words", 0) >= 1

            # node loss: reads of both stripes decode what the node held
            await cluster.kill_storage_node(2)
            for _ in range(100):
                if all(c.chain_ver >= 2 for c in
                       cluster.mgmtd.state.routing().chains.values()
                       if any(t.node_id == 2 for t in c.targets)):
                    break
                await asyncio.sleep(0.1)
            await cluster.mgmtd_client.refresh()
            for s, d in data.items():
                got, crcs = await ec.read_stripe_with_crcs(lay, 9, s, 4 * CS)
                assert got == d, f"stripe {s} must decode around the lost node"
                assert crcs == [crc32c_ref(d[j * CS:(j + 1) * CS]) for j in range(4)]
            assert codec.codec_counts.get("cuda-decode-words", 0) >= 1
            assert "torch-bitmatmul" not in codec.codec_counts
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_lrc_xor_write_and_group_repair_over_port_codec():
    async def body():
        cluster = LocalCluster(num_nodes=4, replicas=1, num_chains=8)
        await cluster.start()
        codec = TorchECCodec(device="cpu")
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=CS,
                                  chains=list(range(1, 9)),
                                  local_scheme="lrc-xor", local_group_size=3)
            assert lay.local_groups() == [(0, 1, 2), (3, 4, 5)]
            ec = ECStorageClient(cluster.sc, codec=codec)
            data = rng.integers(0, 256, 4 * CS, dtype=np.uint8).tobytes()
            assert _ok(await ec.write_stripe(lay, 77, 0, data))
            # the local XOR parities ran as all-ones repair programs
            assert codec.codec_counts.get("cuda-repair-words", 0) >= 1

            before = dict(codec.codec_counts)
            for slot in (2, 6):                 # a data shard, a local parity
                await _remove_shard(cluster, lay, 77, 0, slot)
                assert _ok(await ec.repair_stripe(lay, 77, 0, (slot,),
                                                  stripe_len=len(data)))
            got, crcs = await ec.read_stripe_with_crcs(lay, 77, 0, len(data))
            assert got == data
            assert crcs[2] == crc32c_ref(data[2 * CS:3 * CS])
            assert codec.codec_counts["cuda-repair-words"] > before["cuda-repair-words"]

            # the rebuilt local parity is right: lose a member of its group
            # and rebuild it from the group alone
            await _remove_shard(cluster, lay, 77, 0, 0)
            assert _ok(await ec.repair_stripe(lay, 77, 0, (0,), stripe_len=len(data)))
            assert await ec.read_stripe(lay, 77, 0, len(data)) == data
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


@pytest.mark.parametrize("cs", [2048, 4064])
def test_pm_msr_write_repair_and_degraded_read_over_port_codec(cs):
    """A pm-msr layout end to end on the port's codec: the coupled write,
    a single-loss projection repair (reading 9/16 of the full-k bytes),
    and a two-loss degraded read through the dense decode, at a chunk
    size of whole words (2048) and one whose sub-chunks are odd (4064)."""
    async def body():
        cluster = LocalCluster(num_nodes=5, replicas=1, num_chains=10)
        await cluster.start()
        codec = TorchECCodec(device="cpu")
        try:
            lay = ECLayout.create(k=8, m=2, chunk_size=cs, chains=list(range(1, 11)),
                                  local_scheme="pm-msr")
            ec = ECStorageClient(cluster.sc, codec=codec)
            data = rng.integers(0, 256, 8 * cs, dtype=np.uint8).tobytes()
            assert _ok(await ec.write_stripe(lay, 9, 0, data))
            assert await ec.read_stripe(lay, 9, 0, len(data)) == data
            assert codec.codec_counts.get("cuda-msr-encode", 0) >= 1

            await _remove_shard(cluster, lay, 9, 0, 3)
            stats = RepairIOStats()
            assert _ok(await ec.repair_stripe(lay, 9, 0, (3,), len(data), stats=stats))
            assert stats.reduced_shards == 1 and stats.bytes_read * 16 == 9 * 8 * cs
            got, crcs = await ec.read_stripe_with_crcs(lay, 9, 0, len(data))
            assert got == data and crcs[3] == crc32c_ref(data[3 * cs:4 * cs])
            assert codec.codec_counts.get("cuda-msr-repair", 0) >= 1

            for slot in (1, 8):
                await _remove_shard(cluster, lay, 9, 0, slot)
            got, crcs = await ec.read_stripe_with_crcs(lay, 9, 0, len(data))
            assert got == data
            assert crcs == [crc32c_ref(data[j * cs:(j + 1) * cs]) for j in range(8)]
            assert codec.codec_counts.get("cuda-msr-decode", 0) >= 1
            assert set(codec.codec_counts) <= {"cuda-msr-encode", "cuda-msr-repair",
                                               "cuda-msr-decode"}
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())


def test_rs63_write_repair_and_degraded_read_over_port_codec():
    """An RS(6+3) layout (HDFS's RS-6-3 policy) end to end on the port's
    codec: the byte-path write (B5 + B6), a repair, and a degraded read
    losing three shards (B5 + B6)."""
    async def body():
        cluster = LocalCluster(num_nodes=3, replicas=1, num_chains=9)
        await cluster.start()
        codec = TorchECCodec(device="cpu")
        try:
            lay = ECLayout.create(k=6, m=3, chunk_size=CS, chains=list(range(1, 10)))
            ec = ECStorageClient(cluster.sc, codec=codec)
            data = rng.integers(0, 256, 6 * CS, dtype=np.uint8).tobytes()
            assert _ok(await ec.write_stripe(lay, 5, 0, data))
            assert codec.codec_counts.get("cuda-encode-bytes", 0) >= 1

            await _remove_shard(cluster, lay, 5, 0, 2)
            assert _ok(await ec.repair_stripe(lay, 5, 0, (2,), stripe_len=len(data)))
            got, crcs = await ec.read_stripe_with_crcs(lay, 5, 0, len(data))
            assert got == data and crcs[2] == crc32c_ref(data[2 * CS:3 * CS])

            for slot in (0, 4, 7):
                await _remove_shard(cluster, lay, 5, 0, slot)
            got, crcs = await ec.read_stripe_with_crcs(lay, 5, 0, len(data))
            assert got == data
            assert crcs == [crc32c_ref(data[j * CS:(j + 1) * CS]) for j in range(6)]
            assert set(codec.codec_counts) == {"cuda-encode-bytes", "cuda-repair-words",
                                               "cuda-decode-bytes"}
            await ec.close()
        finally:
            await cluster.stop()
    asyncio.run(body())
