"""The port's GraySort-analog (t3fs_torch/benchmarks/sort_bench.py): every
case of tests/test_sort_bench.py run on the port, then one seeded job
through both packages' `_run_job`, each over its own fabric, held bit for
bit.

The port's job runs with --cpu: its nodes' CRCs on the host backend and
its device sorter on the CPU (the plain PyTorch version of the card's
sort).  The reference runs its JAX sorter on the CPU, as
tests/test_sort_bench.py does."""

import asyncio
import types as pytypes

import numpy as np
import pytest

import benchmarks.kvcache_fleet_bench
import benchmarks.sort_bench
import t3fs.client.layout
import t3fs.client.storage_client
import t3fs.net.client
import t3fs.net.rdma
import t3fs_torch.benchmarks.kvcache_fleet_bench
import t3fs_torch.benchmarks.sort_bench
import t3fs_torch.client.layout
import t3fs_torch.client.storage_client
import t3fs_torch.net.client
import t3fs_torch.net.rdma
from t3fs_torch.ops.device_sort import (
    REC_LEN, key_columns, lexsort_rows, make_device_sorter,
)


def _rows(n, seed=0):
    return np.random.default_rng(seed).integers(
        0, 256, (n, REC_LEN), dtype=np.uint8)


# ---------------- the cases of tests/test_sort_bench.py ----------------

def test_key_columns_lexicographic():
    rows = np.zeros((2, REC_LEN), dtype=np.uint8)
    rows[0, :10] = [0, 0, 0, 1, 0, 0, 0, 0, 0, 0]
    rows[1, :10] = [0, 0, 0, 0, 255, 255, 255, 255, 255, 255]
    k0, _, _ = key_columns(rows)
    assert k0[0] > k0[1]  # big-endian: earlier byte dominates
    perm = lexsort_rows(rows)
    assert list(perm) == [1, 0]


def test_lexsort_rows_matches_python_sort():
    rows = _rows(500, seed=3)
    perm = lexsort_rows(rows)
    got = [rows[i, :10].tobytes() for i in perm]
    assert got == sorted(rows[i, :10].tobytes() for i in range(500))


def test_device_sorter_matches_oracle_all_bucket_shapes():
    # the device sorter's plain version on the CPU; the reference's bucket
    # edges, though the port pads nothing
    sort_perm = make_device_sorter("cpu")
    for n in (1, 7, 1023, 1024, 1025, 5000):
        rows = _rows(n, seed=n)
        perm = sort_perm(rows)
        assert sorted(perm.tolist()) == list(range(n))
        assert np.array_equal(rows[perm][:, :10],
                              rows[lexsort_rows(rows)][:, :10]), n


def test_device_sorter_all_ff_tie_with_padding():
    # real rows whose key equals the reference's 0xFF pad sentinel
    sort_perm = make_device_sorter("cpu")
    rows = _rows(100, seed=9)
    rows[13, :10] = 0xFF
    rows[57, :10] = 0xFF
    perm = sort_perm(rows)
    assert sorted(perm.tolist()) == list(range(100))
    assert perm[-2:].tolist() == [13, 57]  # stable: ties keep row order


def test_partition_of_range_split():
    from t3fs_torch.benchmarks.sort_bench import _partition_of
    rows = _rows(4096, seed=1)
    p = _partition_of(rows, 8)
    assert p.min() >= 0 and p.max() <= 7
    # partition id must be monotone in key order
    order = lexsort_rows(rows)
    assert (np.diff(p[order]) >= 0).all()
    assert (_partition_of(rows, 1) == 0).all()


def test_sort_job_end_to_end_tiny():
    from t3fs_torch.benchmarks.sort_bench import parse_args, run_bench
    args = parse_args(["--mb", "1", "--workers", "2", "--partitions", "4",
                       "--nodes", "1", "--replicas", "1",
                       "--chunk-size", str(64 << 10), "--cpu"])
    result = asyncio.run(run_bench(args))
    assert result["verified"] is True
    assert result["records"] == (1 << 20) // REC_LEN // 2 * 2


def test_sort_job_device_backend_tiny():
    # the device sorter that the card runs, on the CPU here
    from t3fs_torch.benchmarks.sort_bench import parse_args, run_bench
    args = parse_args(["--mb", "1", "--workers", "2", "--partitions", "2",
                       "--nodes", "1", "--replicas", "1",
                       "--chunk-size", str(64 << 10),
                       "--sort-backend", "device", "--cpu"])
    result = asyncio.run(run_bench(args))
    assert result["verified"] is True


# ---------------- the port against the JAX package, bit for bit ----------------

def _pkg(root, bench, fleet) -> pytypes.SimpleNamespace:
    return pytypes.SimpleNamespace(
        name=root.__name__, bench=bench, layout=root.client.layout,
        sc=root.client.storage_client, net=root.net.client, rdma=root.net.rdma,
        thaw=fleet.thaw_routing, freeze=fleet.freeze_routing)


REF = _pkg(t3fs, benchmarks.sort_bench, benchmarks.kvcache_fleet_bench)
PORT = _pkg(t3fs_torch, t3fs_torch.benchmarks.sort_bench,
            t3fs_torch.benchmarks.kvcache_fleet_bench)
JOB = ["--mb", "3", "--workers", "4", "--partitions", "8", "--nodes", "3",
       "--replicas", "2", "--chunk-size", str(64 << 10),
       "--sort-backend", "device", "--seed", "77"]
WALLS = ("phase1_s", "phase2_s", "sort_wall_s", "sort_MB_s")


def _job_inodes(bench, args) -> dict:
    return {
        **{("in", w): bench.IN_INODE + w for w in range(args.workers)},
        **{("run", w, p): bench.RUN_INODE + (w << 16 | p)
           for w in range(args.workers) for p in range(args.partitions)},
        **{("out", p): bench.OUT_INODE + p for p in range(args.partitions)}}


async def _read_files(sc, lay, inodes: dict) -> dict:
    out = {}
    for name, inode in inodes.items():
        n = await sc.query_last_chunk(lay, inode)
        out[name] = (await sc.read_file_range(lay, inode, 0, n))[0] if n else b""
    return out


async def _foreign_read(q, sc, chains, chunk_size, inodes) -> dict:
    """Package q's client reads the job's files over the wire from the
    fabric that `sc` (the other package's client) talks to."""
    routing = q.thaw(q.freeze(sc._routing()))
    cli = q.net.Client()
    cli.add_service(q.rdma.BufferRegistry())
    qsc = q.sc.StorageClient(lambda: routing, client=cli)
    try:
        lay = q.layout.FileLayout(chunk_size=chunk_size, chains=chains)
        return await _read_files(qsc, lay, inodes)
    finally:
        await qsc.close()


def run_job(p, monkeypatch, extra: list[str]) -> tuple[dict, dict, dict]:
    """Package p's sort job on its own fabric; before the job's last
    cleanup, every IN, RUN and OUT file is read back by p's client and by
    the other package's."""
    args = p.bench.parse_args(JOB + extra + (["--cpu"] if p is PORT else []))
    files: dict = {}
    cleanups = []
    orig = p.bench._cleanup_job_files

    async def snapshot_then_clean(args, sc, lay):
        if cleanups:
            inodes = _job_inodes(p.bench, args)
            files["own"] = await _read_files(sc, lay, inodes)
            other = REF if p is PORT else PORT
            files["other"] = await _foreign_read(other, sc, list(lay.chains),
                                                 lay.chunk_size, inodes)
        cleanups.append(1)
        await orig(args, sc, lay)

    monkeypatch.setattr(p.bench, "_cleanup_job_files", snapshot_then_clean)
    result = asyncio.run(p.bench.run_bench(args))
    return result, files["own"], files["other"]


@pytest.mark.parametrize("aio", ["aio", "no-aio"])
def test_sort_job_matches_reference_bit_for_bit(aio, monkeypatch):
    """One seeded job (3 MiB, 4 workers, 8 partitions, 64 KiB chunks,
    3 nodes of 2 replicas) through both packages' `_run_job`: the same
    result (walls excepted) and the same bytes in every IN, RUN and OUT
    file, as each package's client reads them from either fabric."""
    extra = [] if aio == "aio" else ["--no-aio"]
    ref, ref_own, ref_other = run_job(REF, monkeypatch, extra)
    port, port_own, port_other = run_job(PORT, monkeypatch, extra)
    assert ref["verified"] and port["verified"]
    assert {k: v for k, v in port.items() if k not in WALLS} == \
        {k: v for k, v in ref.items() if k not in WALLS}
    assert set(port) == set(ref)
    assert ref_own == ref_other == port_own == port_other
    outs = [port_own[("out", p)] for p in range(8)]
    rows = np.frombuffer(b"".join(outs), np.uint8).reshape(-1, REC_LEN)
    assert len(rows) == ref["records"] and len(rows) > 30_000
    assert np.array_equal(lexsort_rows(rows), np.arange(len(rows)))
    assert sum(len(port_own[("run", w, p)]) for w in range(4)
               for p in range(8)) == ref["bytes"]


@pytest.mark.cuda
def test_sort_job_on_the_card():
    """The job on the port's defaults on the card: every node's CRC on the
    CUDA backend (B1 on each 64 KiB-and-up chunk write) and each partition
    sorted by the device sorter."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    from t3fs_torch.benchmarks.sort_bench import parse_args, run_bench
    from t3fs_torch.ops import cuda_codec

    cuda_codec.reset_launches()
    result = asyncio.run(run_bench(parse_args(
        ["--mb", "8", "--workers", "2", "--partitions", "4",
         "--sort-backend", "device"])))
    assert result["verified"] is True and result["sort_backend"] == "device"
    assert cuda_codec.launches["crc_words"] > 0
