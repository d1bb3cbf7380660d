"""Codes past the limits of one kernel launch, which the reference runs and a
CUDA TorchECCodec must run too: RAID-6 at k = 40 and k = 254, RS(12+12)
and RS(28+8), at a whole-segment length (4096) and at one that is not a
multiple of 4 (1002).

B3 past k = 32 goes to B5 on the words' byte view; B5 runs one launch per
tile of <= 8 output shards and <= 227 KiB of tables, XOR-accumulating over
input groups; B4 runs one launch per group of <= 32 helpers.  On the CPU the
same tiles and groups run their plain versions, so these tests exercise the
tiling, the accumulation and the routes; the `cuda`-marked twins run them
through the kernels on the card.

Every result is held bit-exact against the JAX package's RSCode, crc32c_ref
and repair-program oracle, and, for RS(12+12) and RS(28+8), against the
reference ECCodec on the CPU (its RAID-6 path compiles a program per k that
takes minutes on the CPU at k = 40)."""

import asyncio

import numpy as np
import pytest
import torch

from t3fs.client.ec_codec import ECCodec
from t3fs.ops.crc32c import crc32c_ref
from t3fs.ops.repair_program import eval_program_np as ref_eval_program_np
from t3fs.ops.repair_program import single_row_program as ref_single_row_program
from t3fs.ops.rs import RSCode
from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.repair_program import schedule_repair_program
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import (
    B4_MAX_HELPERS, B5_MAX_ROWS, B5_MAX_TABLE_BYTES, b5_tile_plan, decode_tables,
    encode_map_tables, load_repair_tables, repair_tables)

rng = np.random.default_rng(29)

CODES = [(40, 2), (254, 2), (12, 12), (28, 8)]
LENGTHS = [4096, 1002]
# (code, one loss, two losses): a data and a parity shard, or two data
LOSSES = {(40, 2): ((5,), (0, 41)), (254, 2): ((200,), (3, 254)),
          (12, 12): ((11,), (0, 13)), (28, 8): ((27,), (4, 30))}
# the reference ECCodec's routes for these codes are XLA bit-matmuls on the CPU
REF_CODES = [(12, 12), (28, 8)]


def _full(k: int, m: int, L: int, n: int | None = None) -> list[np.ndarray]:
    """n stripes (default: 1 of RAID-6 k = 254, else 2), data then parity."""
    n = n or (1 if k > 64 else 2)
    rs = RSCode(k, m)
    out = []
    for _ in range(n):
        d = rng.integers(0, 256, (k, L), dtype=np.uint8)
        out.append(np.concatenate([d, rs.encode_ref(d)]))
    return out


def _lose(full: np.ndarray, lost, k: int):
    present = tuple(i for i in range(full.shape[0]) if i not in lost)[:k]
    return np.ascontiguousarray(full[list(present)]), present, tuple(lost)


async def _run(codec, calls):
    try:
        return await asyncio.gather(*(getattr(codec, f)(*a) for f, a in calls))
    finally:
        await codec.close()


def _port(calls, device="cpu"):
    codec = TorchECCodec(max_wait_us=2000, device=device)
    return codec, asyncio.run(_run(codec, calls))


def _ref(calls):
    return asyncio.run(_run(ECCodec(max_wait_us=2000), calls))


def test_tile_plans_split_past_one_launch():
    """RAID-6 k = 254 decodes in two input groups, RS(12+12) in two row
    groups, RS(28+8) in one launch; a 40-helper row in two helper groups."""
    assert len(b5_tile_plan(254, 2)) == 2
    assert [(j0, wj) for _i0, _ki, j0, wj in b5_tile_plan(12, 12)] == [(0, 8), (8, 4)]
    assert b5_tile_plan(28, 8) == [(0, 28, 0, 8)]
    for k, rows in ((254, 2), (12, 12), (254, 8), (200, 56), (1, 1)):
        plan = b5_tile_plan(k, rows)
        for j0 in range(0, rows, B5_MAX_ROWS):
            groups = [(i0, ki) for i0, ki, j, _w in plan if j == j0]
            assert [i0 for i0, _ in groups] == list(np.cumsum([0] + [ki for _, ki in groups])[:-1])
            assert sum(ki for _, ki in groups) == k
        for _i0, ki, _j0, wj in plan:
            assert wj <= B5_MAX_ROWS and -(-wj // 4) * ki * 1024 <= B5_MAX_TABLE_BYTES
    dec = decode_tables((0, 1) + tuple(range(3, 255)), (2, 255), default_rs(254, 2),
                        device="cpu")
    assert len(dec.tiles) == 2 and dec.tiles[1].i0 == dec.tiles[0].ki
    rep = load_repair_tables(40, ((*range(40),),), 0x11D)
    assert [(g.h0, g.count) for g in rep.groups] == [(0, B4_MAX_HELPERS), (32, 8)]


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("k,m", CODES)
def test_encode_past_one_launch(k, m, L):
    """encode and encode_verified against RSCode.encode_ref and crc32c_ref
    (and the reference ECCodec where its CPU route is quick)."""
    stripes = _full(k, m, L)
    calls = [(f, (s[:k], k, m)) for s in stripes for f in ("encode", "encode_verified")]
    port, got = _port(calls)
    want = _ref(calls) if (k, m) in REF_CODES else None
    for i, s in enumerate(stripes):
        par, (vpar, crcs) = got[2 * i], got[2 * i + 1]
        assert np.array_equal(par, s[k:]) and np.array_equal(vpar, s[k:])
        assert [int(c) for c in crcs] == [crc32c_ref(r.tobytes()) for r in s]
        if want is not None:
            assert np.array_equal(par, want[2 * i])
            assert np.array_equal(vpar, want[2 * i + 1][0])
            assert np.array_equal(crcs, want[2 * i + 1][1])
    assert all(r.startswith("cuda-") for r in port.codec_counts)


@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("k,m", CODES)
def test_reconstruct_past_one_launch(k, m, L):
    """reconstruct and reconstruct_verified of one and of two lost shards
    against the stripe (RSCode's) and crc32c_ref, and the reference
    ECCodec where its CPU route is quick."""
    stripes = _full(k, m, L)
    calls = [(f, (*_lose(s, lost, k), k, m)) for s in stripes for lost in LOSSES[(k, m)]
             for f in ("reconstruct", "reconstruct_verified")]
    port, got = _port(calls)
    want = _ref(calls) if (k, m) in REF_CODES else None
    shard_crcs = [[crc32c_ref(r.tobytes()) for r in s] for s in stripes]
    for j, (_f, (_rows, present, lost, _k, _m)) in enumerate(calls):
        i = j // (2 * len(LOSSES[(k, m)]))
        s = stripes[i]
        if j % 2 == 0:
            assert np.array_equal(got[j], s[list(lost)])
        else:
            rebuilt, crcs = got[j]
            assert np.array_equal(rebuilt, s[list(lost)])
            assert [int(c) for c in crcs] == [shard_crcs[i][x] for x in (*present, *lost)]
        if want is not None:
            w = want[j] if j % 2 == 0 else want[j][0]
            g = got[j] if j % 2 == 0 else got[j][0]
            assert np.array_equal(g, np.asarray(w))
    assert all(r.startswith("cuda-") for r in port.codec_counts)


@pytest.mark.parametrize("L", LENGTHS)
def test_repair_with_40_helpers(L):
    """repair over 40 helpers of RAID-6 k = 40: the all-ones row (slot 0
    from P and the other data shards) and a Horner row (slot 0 from Q),
    against the stripe, crc32c_ref and the JAX package's program oracle."""
    k, m = 40, 2
    s = _full(k, m, L, n=1)[0]
    rs = RSCode(k, m)
    calls, progs = [], []
    for present in ([*range(1, 41)], [*range(1, 40), 41]):
        row = rs.reconstruct_gfmatrix(present, [0])[0]
        assert np.count_nonzero(row) == 40
        calls.append(("repair", (s[present], tuple(int(c) for c in row), k, m)))
        progs.append(ref_single_row_program(rs, present, 0))
    port, got = _port(calls)
    for (rebuilt, crc), prog, (_f, (helpers, _c, _k, _m)) in zip(got, progs, calls):
        assert np.array_equal(rebuilt, s[0])
        assert np.array_equal(rebuilt, ref_eval_program_np(prog, helpers, rs))
        assert int(crc) == crc32c_ref(s[0].tobytes())
    assert all(r.startswith("cuda-repair-words") for r in port.codec_counts)


def _tile_cases():
    """(label, gmap maker, k) for the tile-level wrappers."""
    return [
        ("raid6-254 decode", lambda dev: decode_tables(
            (0, 1) + tuple(range(3, 255)), (2, 255), default_rs(254, 2), dev), 254),
        ("rs12+12 encode", lambda dev: encode_map_tables(default_rs(12, 12), dev), 12),
        ("rs28+8 decode", lambda dev: decode_tables(
            tuple(range(4, 32)), (0, 1, 2, 3, 32, 33, 34, 35), default_rs(28, 8), dev), 28),
    ]


@pytest.mark.parametrize("L", [64, 1002])
@pytest.mark.parametrize("case", range(3))
def test_bitmatmul_tiles_against_whole_matrix(case, L):
    """rs_bitmatmul's tiles, accumulated, equal the whole bit matrix in one
    plain product (rs_bitmatmul_plain)."""
    _label, make, k = _tile_cases()[case]
    gmap = make("cpu")
    shards = torch.from_numpy(rng.integers(0, 256, (2, k, L), dtype=np.uint8))
    assert torch.equal(cc.rs_bitmatmul(shards, gmap), cc.rs_bitmatmul_plain(shards, gmap))


def test_reconstruct_words_past_k32_is_bitmatmul():
    """B3's wrapper at k = 40 runs B5 on the byte view: equal to B3's plain
    ladder and to RSCode.decode_ref."""
    k, m = 40, 2
    s = _full(k, m, 1024, n=1)[0]
    rows, present, lost = _lose(s, (7, 41), k)
    dec = decode_tables(present, lost, default_rs(k, m), "cpu")
    words = torch.from_numpy(rows.view(np.int32)[None].copy())
    got = cc.rs_reconstruct_words(words, dec)
    assert torch.equal(got, cc.rs_reconstruct_words_plain(words, dec))
    assert np.array_equal(got[0].numpy().view(np.uint8), s[list(lost)])


@pytest.mark.parametrize("W", [256, 251])
def test_repair_words_groups_against_whole_program(W):
    """repair_words' helper groups, XOR-accumulated, equal the whole program
    (repair_words_plain) at 40 helpers, on the Horner row."""
    rs = default_rs(40, 2)
    present = [*range(1, 40), 41]
    row = rs.reconstruct_gfmatrix(present, [0])[0]
    rep = repair_tables(schedule_repair_program(tuple(int(c) for c in row)), rs)
    assert len(rep.groups) == 2 and len(rep.groups[1].masks) > 1
    words = torch.from_numpy(rng.integers(0, 2**32, (3, 40, W), dtype=np.uint32).view(np.int32))
    assert torch.equal(cc.repair_words(words, rep), cc.repair_words_plain(words, rep))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("L", [64, 1002, 1 << 16])
def test_tiles_and_groups_on_gpu(cuda_device, L):
    """On the card: B5's tiles, B3 past k = 32 and B4's groups against
    their plain versions, each launch counted."""
    cc.reset_launches()
    tiles = 0
    for _label, make, k in _tile_cases():
        gmap = make(cuda_device)
        shards = torch.from_numpy(rng.integers(0, 256, (2, k, L), dtype=np.uint8)
                                  ).to(cuda_device)
        assert torch.equal(cc.rs_bitmatmul(shards, gmap),
                           cc.rs_bitmatmul_plain(shards, gmap))
        tiles += len(gmap.tiles)
    s = _full(40, 2, 4 * L, n=1)[0]
    rows, present, lost = _lose(s, (7, 41), 40)
    dec = decode_tables(present, lost, default_rs(40, 2), cuda_device)
    words = torch.from_numpy(rows.view(np.int32)[None].copy()).to(cuda_device)
    got = cc.rs_reconstruct_words(words, dec)
    assert np.array_equal(got[0].cpu().numpy().view(np.uint8), s[list(lost)])
    rs = default_rs(40, 2)
    row = rs.reconstruct_gfmatrix([*range(1, 40), 41], [0])[0]
    rep = repair_tables(schedule_repair_program(tuple(int(c) for c in row)), rs)
    hw = torch.from_numpy(rng.integers(0, 2**32, (3, 40, L), dtype=np.uint32).view(np.int32)
                          ).to(cuda_device)
    assert torch.equal(cc.repair_words(hw, rep), cc.repair_words_plain(hw, rep))
    torch.cuda.synchronize()
    assert cc.launches["rs_bitmatmul"] == tiles + len(dec.tiles)
    assert cc.launches["repair_words"] == len(rep.groups) == 2
    assert cc.launches["rs_reconstruct_words"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("L", LENGTHS)
@pytest.mark.parametrize("k,m", CODES)
def test_codec_past_one_launch_on_gpu(cuda_device, k, m, L):
    """On the card: encode_verified and reconstruct_verified (one and two
    losses) of every code against RSCode and crc32c_ref, through the
    kernels (every route a cuda- one, the launch counters moving)."""
    stripes = _full(k, m, L)
    calls = [("encode_verified", (s[:k], k, m)) for s in stripes]
    calls += [("reconstruct_verified", (*_lose(s, lost, k), k, m))
              for s in stripes for lost in LOSSES[(k, m)]]
    cc.reset_launches()
    port, got = _port(calls, cuda_device)
    torch.cuda.synchronize()
    for i, s in enumerate(stripes):
        par, crcs = got[i]
        assert np.array_equal(par, s[k:])
        assert [int(c) for c in crcs] == [crc32c_ref(r.tobytes()) for r in s]
    for (_f, (_rows, _present, lost, _k, _m)), (rebuilt, _crcs), s in zip(
            calls[len(stripes):], got[len(stripes):],
            [s for s in stripes for _ in LOSSES[(k, m)]]):
        assert np.array_equal(rebuilt, s[list(lost)])
    assert all(r.startswith("cuda-") for r in port.codec_counts)
    assert cc.launches["rs_bitmatmul"] > 0
    assert cc.launches["crc_words"] + cc.launches["crc_bytes"] > 0
