"""TorchECCodec (device="cpu") against the JAX package's ECCodec on the same
stripes: encode (the RAID-6 word route, the fused encode+CRC route and the
byte routes on B5 and B6 for codes that are not RAID-6 and for other
lengths), reconstruct, reconstruct_verified and repair on every route, the
pm-msr keys, the warmups, and the batching of mixed patterns in one flush.
ECCodec runs its Pallas kernels in interpret mode where the reads compare
with the port's kernel routes."""

import asyncio

import numpy as np
import pytest

from t3fs.client.ec_codec import ECCodec
from t3fs.ops.crc32c import crc32c_ref
from t3fs.ops.rs import RSCode
from t3fs.ops.msr import default_msr as ref_default_msr
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.ops.repair_program import single_row_program
from t3fs_torch.ops.rs import default_rs

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
    (8, 2, 1002, "cuda-bitmatmul"),      # RAID-6, L % 4 != 0: B5
    (4, 3, 1000, "cuda-bitmatmul"),      # not RAID-6: B5
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
    (8, 2, 1000, "cuda-encode-bytes"),   # RAID-6, L % 512 != 0: B2 + B6
    (4, 3, 512, "cuda-encode-bytes"),    # not RAID-6: B5 + B6
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


def test_submit_after_close_raises():
    async def body():
        codec = TorchECCodec(device="cpu")
        await codec.close()
        with pytest.raises(RuntimeError, match="closed"):
            await codec.encode(np.zeros((8, 512), np.uint8), 8, 2)
    asyncio.run(body())


@pytest.fixture
def interpret_env(monkeypatch):
    monkeypatch.setenv("T3FS_FORCE_PALLAS_INTERPRET", "1")


def _full(k: int, m: int, L: int, n: int = 3) -> list[np.ndarray]:
    """n stripes of k+m shards each (data, then parity)."""
    rs = default_rs(k, m)
    return [np.concatenate([s, rs.encode_ref(s)]) for s in _stripes(k, L, n)]


async def _both_calls(calls):
    """Run the same (method, args) calls, all at once, on the port's codec
    and on the reference's."""
    port, ref = TorchECCodec(max_wait_us=2000, device="cpu"), ECCodec(max_wait_us=2000)
    try:
        got = await asyncio.gather(*(getattr(port, f)(*a) for f, a in calls))
        want = await asyncio.gather(*(getattr(ref, f)(*a) for f, a in calls))
        return port, got, want
    finally:
        await port.close()
        await ref.close()


def _lose(full: np.ndarray, lost, k: int):
    present = tuple(i for i in range(full.shape[0]) if i not in lost)[:k]
    return np.ascontiguousarray(full[list(present)]), present, tuple(lost)


@pytest.mark.parametrize("k,m,L,lost,codec", [
    (8, 2, 2048, (0, 9), "cuda-rec-words"),     # RAID-6 word decode (B3)
    (8, 2, 1002, (3,), "cuda-bitmatmul"),       # RAID-6, L % 4 != 0: B5
    (4, 3, 1000, (0, 4, 6), "cuda-bitmatmul"),  # not RAID-6: B5
    (6, 3, 512, (2, 7), "cuda-bitmatmul"),
])
def test_reconstruct_matches_reference(k, m, L, lost, codec, interpret_env):
    stripes = _full(k, m, L)
    calls = [("reconstruct", (*_lose(f, lost, k), k, m)) for f in stripes]
    port, got, want = asyncio.run(_both_calls(calls))
    for f, g, w in zip(stripes, got, want):
        assert np.array_equal(g, np.asarray(w))
        assert np.array_equal(g, f[list(lost)])
    assert port.codec_counts == {codec: port.batches}


@pytest.mark.parametrize("k,m,L,lost,codec", [
    (8, 2, 2048, (0, 9), "cuda-decode-words"),  # fused decode step (B3 + B1)
    (8, 2, 2048, (5,), "cuda-decode-words"),
    (8, 2, 1000, (1, 2), "cuda-decode-bytes"),  # RAID-6, L % 512 != 0: B5 + B6
    (4, 3, 512, (0, 5, 6), "cuda-decode-bytes"),  # not RAID-6
])
def test_reconstruct_verified_matches_reference(k, m, L, lost, codec, interpret_env):
    stripes = _full(k, m, L)
    calls = [("reconstruct_verified", (*_lose(f, lost, k), k, m)) for f in stripes]
    port, got, want = asyncio.run(_both_calls(calls))
    for f, (gr, gc), (wr, wc) in zip(stripes, got, want):
        assert np.array_equal(gr, np.asarray(wr))
        assert gc.dtype == np.uint32 and np.array_equal(gc, np.asarray(wc))
        present = _lose(f, lost, k)[1]
        assert [int(c) for c in gc] == [crc32c_ref(f[s].tobytes())
                                        for s in (*present, *lost)]
    assert port.codec_counts.get(codec, 0) >= 1


def test_reconstruct_verified_all_masks_match_oracle():
    """All 55 single and double erasures of RS(8+2), concurrently: one group
    per pattern in one flush, every rebuilt shard against the JAX package's
    RSCode.decode_ref and every CRC against its crc32c_ref."""
    n = 10
    masks = [(a,) for a in range(n)] + [(a, b) for a in range(n)
                                        for b in range(a + 1, n)]
    full = _full(8, 2, 512, n=1)[0]
    calls = [("reconstruct_verified", (*_lose(full, lost, 8), 8, 2))
             for lost in masks]

    async def body():
        codec = TorchECCodec(max_batch=64, max_wait_us=20000, device="cpu")
        try:
            return codec, await asyncio.gather(*(getattr(codec, f)(*a)
                                                 for f, a in calls))
        finally:
            await codec.close()

    codec, outs = asyncio.run(body())
    ref = RSCode(8, 2)
    for (_f, (rows, present, want, _k, _m)), (rebuilt, crcs) in zip(calls, outs):
        assert np.array_equal(rebuilt, ref.decode_ref(dict(zip(present, rows)),
                                                      list(want)))
        assert [int(c) for c in crcs] == [crc32c_ref(full[s].tobytes())
                                          for s in (*present, *want)]
    assert codec.batches == 55 and codec.batched_items == 55
    assert codec.codec_counts == {"cuda-decode-words": 55}


def _repair_calls(full: np.ndarray, k: int, m: int):
    """One repair call per lost slot: the single-row program over the
    first-k survivors, zero-coefficient helpers dropped (ec_client's plan)."""
    rs = default_rs(k, m)
    calls = []
    for lost in range(k + m):
        present = [s for s in range(k + m) if s != lost][:k]
        row = rs.reconstruct_gfmatrix(present, [lost])[0]
        keep = [(int(c), s) for c, s in zip(row, present) if c]
        assert single_row_program(rs, present, lost).num_helpers == len(keep)
        calls.append(("repair", (np.stack([full[s] for _c, s in keep]),
                                 tuple(c for c, _s in keep), k, m)))
    return calls


@pytest.mark.parametrize("L,codec", [
    (1024, "cuda-repair-words"),       # fused repair step (B4 + B1)
    (1000, "cuda-repair-words-odd"),   # L % 512 != 0: B4, then B6
    (1001, "cuda-repair-words-odd"),   # L % 4 != 0: padded to whole words
])
def test_repair_all_masks_matches_reference(L, codec, interpret_env):
    full = _full(8, 2, L, n=1)[0]
    calls = _repair_calls(full, 8, 2)
    port, got, want = asyncio.run(_both_calls(calls))
    for lost, ((gr, gc), (wr, wc)) in enumerate(zip(got, want)):
        assert np.array_equal(gr, np.asarray(wr)) and np.array_equal(gr, full[lost])
        assert int(gc) == int(wc) == crc32c_ref(full[lost].tobytes()), lost
    assert set(port.codec_counts) == {codec}


def test_lrc_local_parity_repair_matches_reference(interpret_env):
    """The write path's LRC local XOR parity: repair with all-ones coeffs."""
    groups = [np.ascontiguousarray(s[:3]) for s in _stripes(8, 2048, 4)]
    calls = [("repair", (g, (1, 1, 1), 8, 2)) for g in groups]
    port, got, want = asyncio.run(_both_calls(calls))
    for g, (gr, gc), (wr, wc) in zip(groups, got, want):
        assert np.array_equal(gr, g[0] ^ g[1] ^ g[2]) and np.array_equal(gr, wr)
        assert int(gc) == int(wc)
    assert port.codec_counts == {"cuda-repair-words": 1} and port.batched_items == 4


def test_mixed_patterns_batch_into_groups_in_one_flush():
    """Concurrent requests with different patterns form one group each in
    the same flush; same-pattern requests stack into one call."""
    full = _full(8, 2, 512, n=6)
    patterns = [(2,), (0, 5), (4, 8)]

    async def body():
        codec = TorchECCodec(max_wait_us=20000, device="cpu")
        try:
            calls = [codec.reconstruct_verified(*_lose(f, patterns[i % 3], 8), 8, 2)
                     for i, f in enumerate(full)]
            calls.append(codec.repair(np.ascontiguousarray(full[0][:3]), (1, 1, 1)))
            outs = await asyncio.gather(*calls)
            return codec, outs
        finally:
            await codec.close()

    codec, outs = asyncio.run(body())
    for i, (rebuilt, _crcs) in enumerate(outs[:-1]):
        assert np.array_equal(rebuilt, full[i][list(patterns[i % 3])])
    assert codec.batched_items == 7
    assert codec.flushes == 1
    assert codec.batches == 4                   # three patterns + one program
    assert codec.codec_counts == {"cuda-decode-words": 3, "cuda-repair-words": 1}
    assert len(codec._fns) == 4


def test_warmup_decode_and_repair_build_each_key():
    async def body():
        codec = TorchECCodec(device="cpu")
        try:
            patterns = [((1, 2, 3, 4, 5, 6, 7, 8), (0, 9)),
                        ((0, 1, 2, 3, 4, 6, 7, 8), (5,))]
            codec.warmup_decode(patterns, 1024, batch_sizes=(1, 2))
            rows = [(1, 1, 1), (1, 2, 4, 8, 16, 32, 64, 141)]
            codec.warmup_repair(rows, 512, batch_sizes=(1, 2))
            for present, want in patterns:
                assert ("recv", present, want, 8, 2, 1024) in codec._fns
            for coeffs in rows:
                assert ("rep", coeffs, 8, 2, 512) in codec._fns
            assert codec.codec_counts == {"cuda-decode-words": 4,
                                          "cuda-repair-words": 4}
            # a pattern that cannot be built is logged, not raised
            codec.warmup_decode([((0, 1), (2,))], 1024)
            assert ("recv", (0, 1), (2,), 8, 2, 1024) not in codec._fns
        finally:
            await codec.close()
        codec.warmup_decode([((1, 2, 3, 4, 5, 6, 7, 8), (0,))], 512)
        codec.warmup_repair([(1, 1)], 1024)     # after close(): no-ops
        assert ("rep", (1, 1), 8, 2, 1024) not in codec._fns
    asyncio.run(body())


def _msr_stored(L: int, n: int = 3) -> list[np.ndarray]:
    code = ref_default_msr(8, 2)
    out = []
    for s in _stripes(8, L, n):
        out.append(np.concatenate([s, code.encode_np(s)]))
    return out


def _msr_helpers(full: np.ndarray, f: int) -> np.ndarray:
    sch = ref_default_msr(8, 2).schedule(f)
    sub = full.shape[1] // 32
    return np.stack([full[h].reshape(32, sub)[list(sch.selected)].reshape(-1)
                     for h in sch.helpers])


@pytest.mark.parametrize("L", [16384, 4064])
def test_msr_encode_verified_matches_reference(L, interpret_env):
    stripes = _msr_stored(L)
    calls = [("msr_encode_verified", (f[:8].copy(), 8, 2)) for f in stripes]
    port, got, want = asyncio.run(_both_calls(calls))
    for f, (gp, gc), (wp, wc) in zip(stripes, got, want):
        assert np.array_equal(gp, np.asarray(wp)) and np.array_equal(gp, f[8:])
        assert gc.dtype == np.uint32 and np.array_equal(gc, np.asarray(wc))
        assert [int(c) for c in gc] == [crc32c_ref(r.tobytes()) for r in f]
    assert port.codec_counts == {"cuda-msr-encode": port.batches}


@pytest.mark.parametrize("L", [16384, 4032])
def test_msr_repair_matches_reference(L, interpret_env):
    """Single-loss projection repair of a data slot, the partner of a
    parity slot and a parity slot, concurrently."""
    full = _msr_stored(L, n=1)[0]
    calls = [("msr_repair", (_msr_helpers(full, f), f, 8, 2)) for f in (3, 8, 9)]
    port, got, want = asyncio.run(_both_calls(calls))
    for f, (gr, gc), (wr, wc) in zip((3, 8, 9), got, want):
        assert np.array_equal(gr, np.asarray(wr)) and np.array_equal(gr, full[f])
        assert int(gc) == int(wc) == crc32c_ref(full[f].tobytes())
    assert port.codec_counts == {"cuda-msr-repair": 3}


@pytest.mark.parametrize("lost", [(0, 1), (4, 9), (8, 9)])
def test_msr_decode_verified_matches_reference(lost, interpret_env):
    stripes = _msr_stored(2048, n=2)
    calls = [("msr_decode_verified", (*_lose(f, lost, 8), 8, 2)) for f in stripes]
    port, got, want = asyncio.run(_both_calls(calls))
    for f, (gr, gc), (wr, wc) in zip(stripes, got, want):
        assert np.array_equal(gr, np.asarray(wr)) and np.array_equal(gr, f[list(lost)])
        assert np.array_equal(gc, np.asarray(wc))
        present = _lose(f, lost, 8)[1]
        assert [int(c) for c in gc] == [crc32c_ref(f[s].tobytes())
                                        for s in (*present, *lost)]
    assert port.codec_counts == {"cuda-msr-decode": 1}


def test_warmup_msr_builds_each_key():
    async def body():
        codec = TorchECCodec(device="cpu")
        try:
            codec.warmup_msr([0, 9], 2048, batch_sizes=(1, 2))
            assert ("mencv", 8, 2, 2048) in codec._fns
            for f in (0, 9):
                assert ("mrep", f, 8, 2, 2048) in codec._fns
            assert codec.codec_counts == {"cuda-msr-encode": 2, "cuda-msr-repair": 4}
            # a length the code cannot split into sub-chunks is logged, not raised
            codec.warmup_msr([1], 1000)
            assert ("mrep", 1, 8, 2, 1000) not in codec._fns
        finally:
            await codec.close()
        codec.warmup_msr([2], 2048)             # after close(): a no-op
        assert ("mrep", 2, 8, 2, 2048) not in codec._fns
    asyncio.run(body())
