"""The port's CUDA checksum backend inside the REFERENCE storage service:
the reference's StorageFabric with each node's codec seam given a
t3fs_torch CudaChecksumBackend (on its plain version here, on the card in
the `cuda` twin), once with the default 64 KiB device cutoff and once with
every payload through the batching path, each on the SQLite engine with
thread-pool reads and on the native engine with io_uring reads.  Every stored checksum must equal
the table oracle's CRC of the stored bytes and a `cpu`-backend fabric's.

The reference's make_checksum_backend knows only its own backends, so the
tests hand it the port's instance through a pass-through wrapper."""

import asyncio

import numpy as np
import pytest
import torch

from t3fs.storage import codec_backend as ref_codec_backend
from t3fs.storage.types import ChunkId, UpdateIO, UpdateType, WriteReq
from t3fs.testing.fabric import StorageFabric
from t3fs_torch.ops.codec import crc32c
from t3fs_torch.ops.crc32c import crc32c_ref
from t3fs_torch.storage.codec_backend import (
    ChecksumBackend, CudaChecksumBackend)

CHUNK = 4 << 20


@pytest.fixture
def port_seam(monkeypatch):
    """Let the reference node take a t3fs_torch backend factory."""
    ref_make = ref_codec_backend.make_checksum_backend

    def make(name, **kw):
        if callable(name) and not isinstance(name, str):
            backend = name()
            if isinstance(backend, ChecksumBackend):
                return backend
        return ref_make(name, **kw)

    monkeypatch.setattr(ref_codec_backend, "make_checksum_backend", make)


def _traffic(seed: int) -> list[tuple[int, int, bytes]]:
    """(chunk index, offset, payload): whole 4 MiB chunks, then partial and
    overlapping updates and appends at sizes around the 64 KiB cutoff."""
    rng = np.random.default_rng(seed)

    def data(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    ops = [(i, 0, data(CHUNK)) for i in range(2)]
    ops += [(0, 1000, data(65535)), (0, 50_000, data(65536)),
            (1, 60_000, data(65537)), (1, 0, data(100_000)),
            (0, 1 << 20, data(1 << 20)), (1, 1 << 20, data(300_000))]
    ops += [(2, 0, data(40_000)), (2, 40_000, data(70_000)),
            (2, 110_000, data(65536)), (2, 30_000, data(64 << 10 | 1))]
    return ops


# engine -> the reference fabric's (engine_backend, aio_read)
STORAGE = {"py": ("py", False), "native": ("native", True)}


async def _run(backend, seed: int = 9, engine: str = "py") -> list:
    engine_backend, aio_read = STORAGE[engine]
    fabric = StorageFabric(num_nodes=3, replicas=3, checksum_backend=backend,
                           engine_backend=engine_backend, aio_read=aio_read)
    await fabric.start()
    try:
        for seq, (idx, off, payload) in enumerate(_traffic(seed), start=1):
            req = WriteReq(io=UpdateIO(
                chunk_id=ChunkId(8, idx), chain_id=fabric.chain_id,
                chain_ver=fabric.chain().chain_ver,
                update_type=UpdateType.WRITE, offset=off,
                length=len(payload), chunk_size=CHUNK,
                checksum=crc32c(payload),
                channel=1, channel_seq=seq, client_id="seam", inline=True))
            rsp, _ = await fabric.client.call(fabric.head_address(),
                                              "Storage.write", req,
                                              payload=payload)
            assert rsp.result.status.code == 0, rsp.result.status
        stored = []
        for idx in range(3):
            replicas = []
            for i, node in enumerate(fabric.nodes):
                engine = node.targets[fabric.target_id(i)].engine
                meta = engine.get_meta(ChunkId(8, idx))
                replicas.append((meta.length, meta.checksum, meta.commit_ver,
                                 engine.read(ChunkId(8, idx))))
            assert replicas.count(replicas[0]) == 3
            stored.append(replicas[0])
        return stored, [getattr(n.codec, "batched_items", 0)
                        for n in fabric.nodes]
    finally:
        await fabric.stop()


@pytest.mark.parametrize("engine", ["py", "native"])
@pytest.mark.parametrize("min_device_bytes", [64 << 10, 0])
def test_port_backend_in_reference_service(port_seam, min_device_bytes, engine):
    def port():
        return CudaChecksumBackend(device="cpu", max_wait_us=200,
                                   min_device_bytes=min_device_bytes)

    got, batched = asyncio.run(_run(port, engine=engine))
    want, _ = asyncio.run(_run("cpu", engine=engine))
    assert got == want
    for _length, checksum, _ver, data in got:
        assert checksum == crc32c_ref(data)
    # device-size payloads went through the batching path on every node
    assert all(b >= 6 for b in batched), batched


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA checksum backend)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_port_backend_in_reference_service_on_card(port_seam, cuda_device):
    got, batched = asyncio.run(_run(lambda: CudaChecksumBackend()))
    want, _ = asyncio.run(_run("cpu"))
    assert got == want and all(b >= 6 for b in batched), batched
    for _length, checksum, _ver, data in got:
        assert checksum == crc32c_ref(data)
