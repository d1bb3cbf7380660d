"""The port's ECStorageClient and RepairDriver (t3fs_torch.client.ec_client,
t3fs_torch.client.repair) over the port's storage fabric, held against the
reference's over the reference's fabric.

Each package runs the same scenario on the same seeded stripes (numpy
seeds): the port with TorchECCodec(device="cpu") (the kernels' plain
versions), the reference with its JAX ECCodec on the CPU as
tests/test_ec_client.py runs it; both fabrics on the cpu checksum backend
and their defaults (the native chunk engine, io_uring reads).  The
scenario writes full stripes and one short stripe (a trimmed tail shard
and zero holes), reads them healthy, removes a shard and reads degraded,
repairs it on the sub-shard path, removes another and repairs it on the
full-k path (RepairIOStats of each), loses every chunk of one chain and
runs RepairDriver over those losses (its RepairReport), then records every
stored chunk's bytes and ChunkMeta on every chain.  The two records must
be equal, exactly, on RS(4+2) and RS(6+3) at 2048-byte chunks, lrc-xor and
pm-msr.

The first-k fan-out decides by timing which shards a read decodes, so a
read's CRC of a trimmed tail shard (the stored CRC when read, None when
rebuilt) is not recorded; every other returned CRC is.  Last, each
package's ECStorageClient runs against the other package's fabric, and
must leave the same record as the fabric's own package.
"""

import asyncio
import types as pytypes

import numpy as np
import pytest

import t3fs.client.ec_client
import t3fs.client.repair
import t3fs.client.storage_client
import t3fs.mgmtd.types
import t3fs.storage.types
import t3fs.testing.fabric
import t3fs_torch.client.ec_client
import t3fs_torch.client.repair
import t3fs_torch.client.storage_client
import t3fs_torch.mgmtd.types
import t3fs_torch.storage.types
import t3fs_torch.testing.fabric


def _pkg(root, codec) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, ec=root.client.ec_client, repair=root.client.repair,
        client=root.client.storage_client, mgmtd=root.mgmtd.types,
        st=root.storage.types, fabric=root.testing.fabric, codec=codec)


def _ref_codec():
    from t3fs.client.ec_codec import ECCodec
    return ECCodec()


def _port_codec():
    from t3fs_torch.client.ec_codec import TorchECCodec
    return TorchECCodec(device="cpu")


REF = _pkg(t3fs, _ref_codec)
PORT = _pkg(t3fs_torch, _port_codec)

# layout name -> (ECLayout.create kwargs, storage nodes)
LAYOUTS = {
    "rs4+2": (dict(k=4, m=2, chunk_size=2048), 3),
    "rs6+3": (dict(k=6, m=3, chunk_size=2048), 3),
    "lrc-xor": (dict(k=4, m=2, chunk_size=2048, local_scheme="lrc-xor",
                     local_group_size=3), 4),
    "pm-msr": (dict(k=8, m=2, chunk_size=2048, local_scheme="pm-msr"), 5),
}
INODE = 41
FULL_STRIPES = 3


def _routing_as(routing, mgmtd):
    """The server's routing as the client package's types."""
    return mgmtd.RoutingInfo(
        version=routing.version,
        nodes={k: mgmtd.NodeInfo(n.node_id, n.address)
               for k, n in routing.nodes.items()},
        chains={k: mgmtd.ChainInfo(c.chain_id, c.chain_ver, [
            mgmtd.ChainTargetInfo(t.target_id, t.node_id,
                                  mgmtd.PublicTargetState(int(t.public_state)))
            for t in c.targets]) for k, c in routing.chains.items()})


def _stripe_data(lay, seed: int) -> dict[int, bytes]:
    """FULL_STRIPES whole stripes, then one short stripe: one and a half
    chunks and 7 bytes (a trimmed tail shard, then zero holes)."""
    rng = np.random.default_rng(seed)
    cs, k = lay.chunk_size, lay.k
    data = {s: rng.integers(0, 256, k * cs, dtype=np.uint8).tobytes()
            for s in range(FULL_STRIPES)}
    data[FULL_STRIPES] = rng.integers(0, 256, cs + cs // 2 + 7,
                                      dtype=np.uint8).tobytes()
    return data


def _io(r) -> tuple:
    return (r.status.code, r.length, r.update_ver, r.commit_ver,
            r.commit_chain_ver, r.checksum)


def _stats(st) -> tuple:
    return (st.bytes_read, st.bytes_repaired, st.sub_reads,
            st.reduced_shards, st.fallback_shards)


def _stored(fab) -> list:
    """Every chunk on every target: (target, chunk id, ChunkMeta fields,
    bytes), in target and chunk order."""
    out = []
    for node in fab.nodes:
        for tid in sorted(node.targets):
            engine = node.targets[tid].engine
            for meta in sorted(engine.all_metas(),
                               key=lambda m: m.chunk_id.encode()):
                out.append((tid, meta.chunk_id.encode(), meta.length,
                            meta.update_ver, meta.commit_ver, meta.chain_ver,
                            meta.checksum, int(meta.state),
                            engine.read(meta.chunk_id)))
    return out


async def _remove(fab, server, lay, stripe: int, slot: int) -> None:
    """Remove one shard's chunk at its chain's head (RemoveChunksReq in
    the fabric's own types), as tests/test_torch_ec_client.py does."""
    chain_id = lay.shard_chain(stripe, slot)
    cid = lay.shard_chunk(INODE, stripe, slot)
    head = fab.routing.chains[chain_id].head()
    await fab.client.call(
        fab.routing.node_address(head.node_id), "Storage.remove_chunks",
        server.st.RemoveChunksReq(chain_id=chain_id, inode=cid.inode,
                                  begin_index=cid.index,
                                  end_index=cid.index + 1))


async def scenario(client, server, layout: str, seed: int) -> dict:
    """The EC scenario with `client`'s ECStorageClient over `server`'s
    fabric; returns everything observable, in plain values."""
    kwargs, nodes = LAYOUTS[layout]
    probe = client.ec.ECLayout.create(
        **kwargs, chains=list(range(1, 1 + kwargs["k"] + kwargs["m"] + 8)))
    fab = server.fabric.StorageFabric(num_nodes=nodes, replicas=1,
                                      num_chains=probe.slots,
                                      checksum_backend="cpu")
    await fab.start()
    sc = client.client.StorageClient(
        lambda: _routing_as(fab.routing, client.mgmtd), client=None)
    ec = client.ec.ECStorageClient(sc, codec=client.codec())
    rec: dict = {}
    try:
        lay = client.ec.ECLayout.create(**kwargs, chains=fab.chain_ids)
        cs, k = lay.chunk_size, lay.k
        data = _stripe_data(lay, seed)
        lens = {s: len(d) for s, d in data.items()}

        def crcs_kept(stripe, crcs):
            # a trimmed tail's CRC depends on whether the first-k read
            # decoded it (None) or read it (the stored CRC)
            n = lens[stripe]
            return [c if (j + 1) * cs <= n or j * cs >= n else "tail"
                    for j, c in enumerate(crcs)]

        writes = await asyncio.gather(*(
            ec.write_stripe(lay, INODE, s, d) for s, d in data.items()))
        rec["writes"] = [[_io(r) for r in rs] for rs in writes]

        async def read_all():
            out = []
            for s, d in data.items():
                got, crcs = await ec.read_stripe_with_crcs(lay, INODE, s,
                                                           lens[s])
                assert got == d, (layout, s)
                out.append((got, crcs_kept(s, crcs)))
            return out

        rec["healthy"] = await read_all()

        # one lost data shard: degraded read, then the sub-shard repair
        await _remove(fab, server, lay, 0, 1)
        got, crcs = await ec.read_stripe_with_crcs(lay, INODE, 0, lens[0])
        rec["degraded"] = (got, crcs_kept(0, crcs))
        st = client.ec.RepairIOStats()
        res = await ec.repair_stripe(lay, INODE, 0, (1,), lens[0],
                                     mode="subshard", stats=st)
        rec["subshard"] = ([_io(r) for r in res], _stats(st))

        # a lost parity shard (the last slot): the full-k repair
        last = lay.slots - 1
        await _remove(fab, server, lay, 1, last)
        st = client.ec.RepairIOStats()
        res = await ec.repair_stripe(lay, INODE, 1, (last,), lens[1],
                                     mode="full", stats=st)
        rec["full"] = ([_io(r) for r in res], _stats(st))

        # every chunk of one chain lost: RepairDriver over the losses
        dead = fab.chain_ids[1]
        losses = {}
        for s in data:
            lost = tuple(sl for sl in range(lay.slots)
                         if lay.shard_chain(s, sl) == dead
                         and (sl >= k or sl * cs < lens[s]))
            for sl in lost:
                await _remove(fab, server, lay, s, sl)
            losses[s] = lost
        driver = client.repair.RepairDriver(ec, concurrency=4)
        report = await driver.run([client.repair.RepairJob(
            layout=lay, inode=INODE, stripe_len_of=lens, losses=losses)])
        rec["driver"] = (report.repaired_stripes, report.repaired_shards,
                         sorted(report.failed), report.max_chain_reads,
                         report.min_chain_reads, report.bytes_read,
                         report.bytes_repaired, report.stripes_failed,
                         report.reduced_shards, report.fallback_shards,
                         report.sub_reads)
        assert report.repaired_shards == sum(map(len, losses.values()))
        rec["after"] = await read_all()
        rec["stored"] = _stored(fab)
    finally:
        await ec.close()
        await sc.close()
        await fab.stop()
    return rec


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_port_ec_client_equals_reference(layout):
    ref = asyncio.run(scenario(REF, REF, layout, seed=7))
    port = asyncio.run(scenario(PORT, PORT, layout, seed=7))
    for key in ref:
        assert port[key] == ref[key], (layout, key)
    # every stored checksum is the CRC of the stored bytes
    from t3fs_torch.ops.crc32c import crc32c_ref
    assert all(c[6] == crc32c_ref(c[8]) for c in port["stored"])
    # the repaired chunks were committed
    assert all(c[3] == c[4] for c in port["stored"])


@pytest.mark.parametrize("client,server", [(PORT, REF), (REF, PORT)],
                         ids=["port-client-ref-fabric", "ref-client-port-fabric"])
def test_ec_client_against_the_other_package_fabric(client, server):
    own = asyncio.run(scenario(server, server, "rs4+2", seed=8))
    cross = asyncio.run(scenario(client, server, "rs4+2", seed=8))
    for key in own:
        assert cross[key] == own[key], key
