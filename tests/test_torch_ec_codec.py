"""TorchECCodec (device="cpu") against the JAX package's ECCodec on the same
stripes: the RAID-6 word route, the fused encode+CRC route and the plain
bit-matmul route for codes that are not RAID-6."""

import asyncio

import numpy as np
import pytest

from t3fs.client.ec_codec import ECCodec
from t3fs.ops.crc32c import crc32c_ref
from t3fs.ops.rs import RSCode
from t3fs_torch.client.ec_codec import NOT_PORTED, TorchECCodec

rng = np.random.default_rng(13)


def _stripes(k: int, L: int, n: int = 3) -> list[np.ndarray]:
    return [rng.integers(0, 256, (k, L), dtype=np.uint8) for _ in range(n)]


async def _both(method: str, stripes, k, m):
    port, ref = TorchECCodec(max_wait_us=2000, device="cpu"), ECCodec(max_wait_us=2000)
    try:
        got = await asyncio.gather(*(getattr(port, method)(s, k, m) for s in stripes))
        want = await asyncio.gather(*(getattr(ref, method)(s, k, m) for s in stripes))
        return port, got, want
    finally:
        await port.close()
        await ref.close()


@pytest.mark.parametrize("k,m,L,codec", [
    (8, 2, 2048, "cuda-words"),          # RAID-6 word kernel route
    (8, 2, 1002, "torch-bitmatmul"),     # RAID-6, L % 4 != 0
    (4, 3, 1000, "torch-bitmatmul"),     # not RAID-6
])
def test_encode_matches_reference(k, m, L, codec):
    stripes = _stripes(k, L)
    port, got, want = asyncio.run(_both("encode", stripes, k, m))
    rs = RSCode(k, m)
    for s, g, w in zip(stripes, got, want):
        assert np.array_equal(g, w)
        assert np.array_equal(g, rs.encode_ref(s))
    assert port.codec_counts == {codec: port.batches}
    assert port.last_codec == codec
    assert port.batched_items == len(stripes)


@pytest.mark.parametrize("k,m,L,codec", [
    (8, 2, 2048, "cuda-encode-words"),   # fused stripe step route
    (8, 2, 1000, "torch-bitmatmul"),     # RAID-6, L % 512 != 0
    (4, 3, 512, "torch-bitmatmul"),      # not RAID-6
])
def test_encode_verified_matches_reference(k, m, L, codec):
    stripes = _stripes(k, L)
    port, got, want = asyncio.run(_both("encode_verified", stripes, k, m))
    for s, (gp, gc), (wp, wc) in zip(stripes, got, want):
        assert np.array_equal(gp, wp)
        assert gc.dtype == np.uint32 and np.array_equal(gc, wc)
        full = np.concatenate([s, gp], axis=0)
        assert [int(c) for c in gc] == [crc32c_ref(r.tobytes()) for r in full]
    assert port.codec_counts.get(codec, 0) >= 1


@pytest.mark.parametrize("method,args,key", [
    ("reconstruct", (None, (), (), 8, 2), "rec"),
    ("reconstruct_verified", (None, (), (), 8, 2), "recv"),
    ("repair", (None, ()), "rep"),
    ("msr_encode_verified", (None, 8, 2), "mencv"),
    ("msr_repair", (None, 0), "mrep"),
    ("msr_decode_verified", (None, (), (), 8, 2), "mdecv"),
])
def test_read_side_keys_not_ported(method, args, key):
    codec = TorchECCodec(device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue A item"):
        asyncio.run(getattr(codec, method)(*args))
    assert "ROADMAP.md" in NOT_PORTED[key]
    for warm in ("warmup_decode", "warmup_repair", "warmup_msr"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            getattr(codec, warm)([], 512)
    asyncio.run(codec.close())


def test_submit_after_close_raises():
    async def body():
        codec = TorchECCodec(device="cpu")
        await codec.close()
        with pytest.raises(RuntimeError, match="closed"):
            await codec.encode(np.zeros((8, 512), np.uint8), 8, 2)
    asyncio.run(body())
