"""The port's EC read and repair paths on the port's storage fabric: the
twins of the four first-k stripe-read tests of tests/test_read_adaptive.py
and of tests/test_repair_driver.py (the planner, and the end-to-end drill,
which here runs on the port's StorageFabric rather than LocalCluster),
then a `cuda`-marked RS(8+2) write, degraded read and repair on the card.

The first-k tests run the numpy oracle codec (use_device_codec=False), as
the reference's do; the drill runs TorchECCodec(device="cpu")."""

import asyncio
import time
from collections import defaultdict

import numpy as np
import pytest
import torch

from t3fs_torch.client.ec_client import ECLayout, ECStorageClient
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.client.repair import RepairDriver, RepairJob
from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.ops.codec import crc32c
from t3fs_torch.storage.types import RemoveChunksReq
from t3fs_torch.testing.fabric import StorageFabric
from t3fs_torch.utils.status import StatusCode


def run(coro):
    return asyncio.run(coro)


def _ok(results) -> bool:
    return all(r.status.code == int(StatusCode.OK) for r in results)


# --- first-k EC stripe reads (tests/test_read_adaptive.py) -------------------

def _ec_env():
    """6 chains x 1 replica, one chain per node: every shard of an
    EC(4+2) stripe has an independently delayable/killable home."""
    return StorageFabric(num_nodes=6, replicas=1, num_chains=6,
                         checksum_backend="cpu")


def _node_of_chain(fab: StorageFabric, chain_id: int) -> int:
    """Index into fab.nodes of the chain's single serving node."""
    return fab.routing.chains[chain_id].targets[0].node_id - 1


def test_first_k_stripe_read_with_straggling_shard():
    """A data shard delayed INDEFINITELY (30s >> any timeout) must not
    stall read_stripe — parity beats the straggler through the decode,
    returning CRC-verified bytes fast."""
    async def body():
        fab = _ec_env()
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = ECLayout.create(k=4, m=2, chunk_size=2048,
                                  chains=fab.chain_ids)
            ec = ECStorageClient(sc, use_device_codec=False)
            data = bytes((7 * i) % 256 for i in range(4 * 2048))
            res = await ec.write_stripe(lay, 31, 0, data)
            assert _ok(res)
            lagger = _node_of_chain(fab, lay.shard_chain(0, 0))
            fab.nodes[lagger].read_delay_s = 30.0
            t0 = time.perf_counter()
            got, crcs = await ec.read_stripe_with_crcs(lay, 31, 0, len(data))
            elapsed = time.perf_counter() - t0
            assert got == data
            assert elapsed < 10.0, "first-k must not wait out the straggler"
            # every directly read shard reports its stored CRC; the oracle
            # codec has no fused CRC, so shard 0 reports None
            for j in range(1, 4):
                assert crcs[j] == crc32c(data[j * 2048:(j + 1) * 2048])
        finally:
            for node in fab.nodes:
                node.read_delay_s = 0.0
            await fab.stop()
    run(body())


def test_first_k_stripe_read_with_two_straggling_shards():
    async def body():
        fab = _ec_env()
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=fab.chain_ids)
            ec = ECStorageClient(sc, use_device_codec=False)
            data = bytes((3 * i + 1) % 256 for i in range(4 * 1024))
            await ec.write_stripe(lay, 32, 0, data)
            for j in (1, 2):   # m=2 covers exactly two erasures
                fab.nodes[_node_of_chain(fab, lay.shard_chain(0, j))] \
                    .read_delay_s = 30.0
            t0 = time.perf_counter()
            got = await ec.read_stripe(lay, 32, 0, len(data))
            assert got == data
            assert time.perf_counter() - t0 < 10.0
        finally:
            for node in fab.nodes:
                node.read_delay_s = 0.0
            await fab.stop()
    run(body())


def test_first_k_stripe_read_with_killed_shards():
    """Two shard homes hard-stopped (connects fail, routing unchanged):
    the fan-out collects the surviving k and decodes — no patient-retry
    stall, no TARGET_OFFLINE."""
    async def body():
        fab = _ec_env()
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=fab.chain_ids)
            ec = ECStorageClient(sc, use_device_codec=False,
                                 fast_read_retries=1)
            data = bytes((5 * i + 2) % 256 for i in range(4 * 1024))
            await ec.write_stripe(lay, 33, 0, data)
            for j in (0, 3):
                await fab.servers[
                    _node_of_chain(fab, lay.shard_chain(0, j))].stop()
            got = await ec.read_stripe(lay, 33, 0, len(data))
            assert got == data
        finally:
            await fab.stop()
    run(body())


def test_first_k_short_stripe_holes_count_free():
    """A short stripe's zero holes need no IO: with one live data shard
    straggling, holes + parity still reach k without reading them."""
    async def body():
        fab = _ec_env()
        await fab.start()
        try:
            sc = StorageClient(lambda: fab.routing, client=fab.client)
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=fab.chain_ids)
            ec = ECStorageClient(sc, use_device_codec=False)
            data = b"z" * 1500   # shards 0-1 live, 2-3 are zero holes
            await ec.write_stripe(lay, 34, 0, data)
            fab.nodes[_node_of_chain(fab, lay.shard_chain(0, 1))] \
                .read_delay_s = 30.0
            t0 = time.perf_counter()
            got = await ec.read_stripe(lay, 34, 0, len(data))
            assert got == data
            assert time.perf_counter() - t0 < 10.0
        finally:
            for node in fab.nodes:
                node.read_delay_s = 0.0
            await fab.stop()
    run(body())


# --- RepairDriver (tests/test_repair_driver.py) ------------------------------

def test_plan_balances_survivor_reads():
    """The plan picks, per stripe, WHICH k survivors to read (decode needs
    exactly k) and keeps per-chain read load in a tight band; with
    initial_load (the solver's exact placement weights), pre-loaded
    chains are steered around."""
    lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                          chains=list(range(1, 13)))
    driver = RepairDriver(ec=None)
    job = RepairJob(layout=lay, inode=1, stripe_len_of={},
                    losses={s: (s % 6,) for s in range(24)})
    ordered, unrepairable = driver.plan([job])
    assert unrepairable == []
    assert len(ordered) == 24
    assert sorted(s for _, s, _sv in ordered) == list(range(24))
    # exactly k survivors chosen per stripe, never a lost one
    for jb, s, shards in ordered:
        assert len(shards) == lay.k
        assert set(shards).isdisjoint(jb.losses[s])

    # a stripe with every shard lost is reported, not planned
    dead = RepairJob(layout=lay, inode=2, stripe_len_of={},
                     losses={0: tuple(range(6))})
    ordered2, unrepairable2 = driver.plan([dead])
    assert ordered2 == [] and unrepairable2 == [(2, 0)]

    def chain_loads(seq):
        load = defaultdict(int)
        for jb, s, shards in seq:
            for sh in shards:
                load[jb.layout.shard_chain(s, sh)] += 1
        return load

    load = chain_loads(ordered)
    assert max(load.values()) - min(load[c] for c in range(1, 13)) <= 2, \
        dict(load)

    # initial_load steers the pick away from pre-loaded chains
    seeded = RepairDriver(ec=None, initial_load={1: 1000})
    ordered3, _ = seeded.plan([job])
    load3 = chain_loads(ordered3)
    assert load3[1] <= min(load3[c] for c in range(2, 13)), dict(load3)


def test_plan_equals_reference():
    """The port's planner orders the same stripes and picks the same
    survivors as the reference's, with and without initial_load."""
    from t3fs.client.ec_client import ECLayout as RefLayout
    from t3fs.client.repair import RepairDriver as RefDriver
    from t3fs.client.repair import RepairJob as RefJob

    rng = np.random.default_rng(17)
    losses = {s: tuple(sorted(rng.choice(6, int(rng.integers(1, 3)),
                                         replace=False).tolist()))
              for s in range(40)}
    for load in (None, {1: 5, 7: 3}):
        port = RepairDriver(ec=None, initial_load=load).plan([RepairJob(
            ECLayout.create(k=4, m=2, chunk_size=1024,
                            chains=list(range(1, 13))), 1, {}, losses)])
        ref = RefDriver(ec=None, initial_load=load).plan([RefJob(
            RefLayout.create(k=4, m=2, chunk_size=1024,
                             chains=list(range(1, 13))), 1, {}, losses)])
        assert [(s, sv) for _j, s, sv in port[0]] == \
            [(s, sv) for _j, s, sv in ref[0]]
        assert port[1] == ref[1]


async def _wipe_chains(fab, lay, inode: int, stripes: int,
                       chains: tuple[int, ...]) -> dict:
    """Remove every chunk of `chains` ("failed disks") through
    Storage.remove_chunks at each chain's head; returns the losses."""
    losses = {}
    for s in range(stripes):
        lost = tuple(sh for sh in range(lay.k + lay.m)
                     if lay.shard_chain(s, sh) in chains)
        losses[s] = lost
        for sh in lost:
            cid = lay.shard_chunk(inode, s, sh)
            chain_id = lay.shard_chain(s, sh)
            head = fab.routing.chains[chain_id].head()
            await fab.client.call(
                fab.routing.node_address(head.node_id),
                "Storage.remove_chunks",
                RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                                begin_index=cid.index,
                                end_index=cid.index + 1))
    return losses


def test_repair_driver_end_to_end():
    """Lose one "disk"'s shards (chains 2 and 5) across many stripes; the
    driver rebuilds all of them and reports balanced chain reads."""
    async def body():
        fab = StorageFabric(num_nodes=3, replicas=1, num_chains=6,
                            checksum_backend="cpu")
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        codec = TorchECCodec(device="cpu")
        try:
            lay = ECLayout.create(k=4, m=2, chunk_size=1024,
                                  chains=fab.chain_ids)
            ec = ECStorageClient(sc, codec=codec)
            data = {}
            for s in range(8):
                payload = bytes([65 + s]) * (4 * 1024)
                data[s] = payload
                assert _ok(await ec.write_stripe(lay, 77, s, payload))
            losses = await _wipe_chains(fab, lay, 77, 8, (2, 5))

            driver = RepairDriver(ec, concurrency=4)
            job = RepairJob(layout=lay, inode=77,
                            stripe_len_of={s: 4 * 1024 for s in range(8)},
                            losses=losses)
            report = await driver.run([job])
            assert not report.failed, report.failed
            assert report.repaired_stripes == 8
            assert report.repaired_shards == sum(len(v) for v in
                                                 losses.values())
            assert report.max_chain_reads >= report.min_chain_reads > 0
            # two losses a stripe: every shard took the full-k decode
            assert report.fallback_shards == report.repaired_shards
            assert report.reduced_shards + report.fallback_shards == \
                report.repaired_shards
            for s in range(8):
                assert await ec.read_stripe(lay, 77, s, 4 * 1024) == data[s], s
            await ec.close()
        finally:
            await sc.close()
            await fab.stop()
    run(body())


# --- on the card ------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA codec and checksum backend)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_rs82_write_degraded_read_and_repair_on_card(cuda_device):
    """RS(8+2) at 1 MiB chunks on the port's fabric with the card's codec
    and checksum backends: 4 stripes written (B2 + B1), a lost chain read
    degraded (B3 + B1) and repaired on the sub-shard path (B4 + B1)."""
    from t3fs_torch.ops import cuda_codec
    from t3fs_torch.storage.codec_backend import CudaChecksumBackend

    async def body():
        fab = StorageFabric(num_nodes=5, replicas=1, num_chains=10,
                            checksum_backend=lambda: CudaChecksumBackend())
        await fab.start()
        sc = StorageClient(lambda: fab.routing, client=fab.client)
        codec = TorchECCodec()
        try:
            cs = 1 << 20
            lay = ECLayout.create(k=8, m=2, chunk_size=cs, chains=fab.chain_ids)
            ec = ECStorageClient(sc, codec=codec)
            rng = np.random.default_rng(11)
            data = {s: rng.bytes(8 * cs) for s in range(4)}
            res = await asyncio.gather(*(ec.write_stripe(lay, 3, s, d)
                                         for s, d in data.items()))
            assert all(_ok(r) for r in res)
            losses = await _wipe_chains(fab, lay, 3, 4, (fab.chain_ids[0],))
            for s, d in data.items():
                got, crcs = await ec.read_stripe_with_crcs(lay, 3, s, len(d))
                assert got == d
            launches_before = dict(cuda_codec.launches)
            report = await RepairDriver(ec, concurrency=4).run([RepairJob(
                lay, 3, {s: 8 * cs for s in data}, losses)])
            assert not report.failed and report.fallback_shards == 0
            assert report.reduced_shards == sum(map(len, losses.values()))
            assert cuda_codec.launches["repair_words"] > \
                launches_before.get("repair_words", 0)
            for s, d in data.items():
                got, crcs = await ec.read_stripe_with_crcs(lay, 3, s, len(d))
                assert got == d
                assert crcs == [crc32c(d[j * cs:(j + 1) * cs])
                                for j in range(8)]
            assert {"cuda-encode-words", "cuda-decode-words",
                    "cuda-repair-words"} <= set(codec.codec_counts)
            await ec.close()
        finally:
            await sc.close()
            await fab.stop()
    run(body())
