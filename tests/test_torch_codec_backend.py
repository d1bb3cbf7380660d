"""The port's checksum backend seam (t3fs_torch.storage.codec_backend) on the
CPU, modelled on tests/test_codec_backend.py; CRCs are held against the JAX
package's DeviceChecksumBackend and the scalar oracle."""

import asyncio

import numpy as np
import pytest

from t3fs.ops.crc32c import crc32c_combine_ref, crc32c_ref
from t3fs.storage.codec_backend import DeviceChecksumBackend
from t3fs_torch.storage.codec_backend import (
    CpuChecksumBackend, CudaChecksumBackend, NullChecksumBackend,
    make_checksum_backend,
)
from t3fs_torch.utils.status import StatusError

rng = np.random.default_rng(11)


def run(coro):
    return asyncio.run(coro)


def test_cpu_backend_matches_oracle():
    async def body():
        b = CpuChecksumBackend()
        for n in (0, 1, 511, 512, 513, 3000):
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            assert await b.payload_crc(data) == crc32c_ref(data)
    run(body())


def test_null_backend():
    async def body():
        b = NullChecksumBackend()
        assert await b.payload_crc(b"anything") == 0
        assert b.combine(1, 2, 3) == 0
        assert not b.verify_enabled
    run(body())


def test_combine_matches_reference():
    a, b = rng.bytes(1000), rng.bytes(777)
    ca, cb = crc32c_ref(a), crc32c_ref(b)
    got = CudaChecksumBackend(device="cpu").combine(ca, cb, len(b))
    assert got == crc32c_combine_ref(ca, cb, len(b)) == crc32c_ref(a + b)


def test_cuda_backend_batches_concurrent_payloads():
    """Mixed lengths -> several buckets in one flush, non-segment-multiple
    lengths (front padding); every CRC equals the JAX backend's."""
    lengths = (100, 512, 700, 2048, 4096, 5000, 100, 3333)
    datas = [rng.integers(0, 256, n, dtype=np.uint8).tobytes() for n in lengths]

    async def body():
        port = CudaChecksumBackend(min_device_bytes=0, max_wait_us=2000,
                                   max_batch=16, device="cpu")
        ref = DeviceChecksumBackend(min_device_bytes=0, max_wait_us=2000,
                                    max_batch=16)
        try:
            got = await asyncio.gather(*(port.payload_crc(d) for d in datas))
            want = await asyncio.gather(*(ref.payload_crc(d) for d in datas))
            assert got == want == [crc32c_ref(d) for d in datas]
            assert port.batched_items == len(datas)
            assert port.batches >= 1
        finally:
            await port.close()
            await ref.close()
    run(body())


def test_cuda_backend_double_buffered_batches():
    """More payloads than one batch holds: batch n+1 is packed and launched
    before batch n is resolved, on alternating staging buffers."""
    datas = [rng.bytes(int(n)) for n in rng.integers(600, 9000, 23)]

    async def body():
        b = CudaChecksumBackend(min_device_bytes=0, max_wait_us=500,
                                max_batch=4, device="cpu")
        try:
            got = await asyncio.gather(*(b.payload_crc(d) for d in datas))
            assert got == [crc32c_ref(d) for d in datas]
            assert b.batched_items == len(datas)
            assert b.batches >= 6
            assert all(s is not None for s in b._staging)
        finally:
            await b.close()
    run(body())


def test_cuda_backend_small_payload_host_path():
    async def body():
        b = CudaChecksumBackend(device="cpu")  # default threshold: small stays on host
        assert await b.payload_crc(b"123456789") == 0xE3069283
        assert b.batched_items == 0
        await b.close()
    run(body())


def test_warmup_builds_tables_and_staging():
    b = CudaChecksumBackend(max_batch=2, device="cpu")
    b.warmup([70_000, 4096])
    assert set(b._fns) == {256 * 128, 8 * 128}
    assert all(s is not None and s.numel() >= 2 * 256 * 512 for s in b._staging)
    run(b.close())
    b.warmup([70_000])                    # closed: a no-op, not an error


def test_close_fails_inflight_futures():
    async def body():
        # huge wait window so items sit in the batch when close() lands
        b = CudaChecksumBackend(min_device_bytes=0, max_wait_us=10_000_000,
                                device="cpu")
        task = asyncio.ensure_future(b.payload_crc(rng.bytes(1024)))
        await asyncio.sleep(0.05)  # worker collects the item, waits for more
        await b.close()
        with pytest.raises(StatusError, match="closed"):
            await asyncio.wait_for(task, timeout=2)
    run(body())


def test_payload_crc_after_close_fails_fast():
    async def body():
        b = CudaChecksumBackend(min_device_bytes=0, device="cpu")
        await b.close()
        with pytest.raises(StatusError, match="closed"):
            await b.payload_crc(b"x" * 1024)
        with pytest.raises(StatusError, match="closed"):
            await b.payload_crc(b"tiny")      # small-payload path too
        assert b._worker is None              # close() killed it; not revived
    run(body())


@pytest.mark.parametrize("name", ["cuda", "gpu", "device", "tpu"])
def test_factory_device_names(name):
    b = make_checksum_backend(name, device="cpu")
    assert isinstance(b, CudaChecksumBackend) and b.name == "cuda"
    run(b.close())


def test_factory():
    assert make_checksum_backend("cpu").name == "cpu"
    assert make_checksum_backend("").name == "cpu"
    assert make_checksum_backend("null").name == "null"
    inst = NullChecksumBackend()
    assert make_checksum_backend(inst) is inst
    assert make_checksum_backend(lambda: NullChecksumBackend()).name == "null"
    with pytest.raises(ValueError):
        make_checksum_backend("bogus")
