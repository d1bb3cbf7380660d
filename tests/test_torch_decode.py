"""The read side's decode kernels (t3fs_torch.ops.cuda_codec B3 and B5 on
CPU tensors, i.e. their plain versions) against the JAX package's Pallas
kernels in interpret mode and its XLA bit-matmul; the decode tables against
the JAX package's arrays; and numpy emulations of the CUDA kernels' own
arithmetic (B3's bit planes and Horner fold, B5's lookup tables), which run
only on a GPU, where the `cuda` test holds them against the plain versions.

Shapes and masks follow tests/test_pallas_codec.py.  Every comparison is
bit-exact."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops import jax_codec
from t3fs.ops import pallas_codec as pc
from t3fs.ops.crc32c import crc32c_ref
from t3fs.ops.rs import default_rs as ref_default_rs
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops import torch_codec
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import (
    build_decode_arrays, build_encode_arrays, decode_tables, load_gfmap_tables)

rng = np.random.default_rng(29)


def _erasure_masks(n_shards: int = 10) -> list[tuple[int, ...]]:
    """All 55 single/double-erasure patterns of RS(8+2)."""
    return ([(a,) for a in range(n_shards)]
            + [(a, b) for a in range(n_shards) for b in range(a + 1, n_shards)])


MASKS = _erasure_masks()


def _pattern(lost, n_shards=10, k=8):
    return tuple(i for i in range(n_shards) if i not in lost)[:k], tuple(lost)


def _stripes(n: int, L: int, k: int = 8, m: int = 2) -> np.ndarray:
    """(n, k+m, L) uint8: random data and its parity."""
    rs = default_rs(k, m)
    data = rng.integers(0, 256, (n, k, L), dtype=np.uint8)
    return np.stack([np.concatenate([d, rs.encode_ref(d)]) for d in data])


def _t(byts: np.ndarray) -> torch.Tensor:
    """uint8 (..., L) -> int32 words (..., L//4) with the same bits."""
    return torch.from_numpy(np.ascontiguousarray(byts).view(np.int32))


def _bytes(words: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(words.numpy()).view(np.uint8)


def test_masks_cover_every_single_and_double_erasure():
    assert len(MASKS) == 55 and len(set(MASKS)) == 55


_ALL = _stripes(1, 512)


@functools.lru_cache(maxsize=None)
def _pallas_rebuilt(lost) -> np.ndarray:
    """The JAX kernel in interpret mode on _ALL's survivors: (1, |want|, 128)
    uint32, built once a pattern for the tests that compare with it."""
    present, want = _pattern(lost)
    surv = _ALL[:, list(present)]
    return np.asarray(pc.make_rs_reconstruct_words_pallas(
        present, want, ref_default_rs(), block_w=128, interpret=True)(
        jnp.asarray(np.ascontiguousarray(surv).view(np.uint32))))


@pytest.mark.parametrize("lost", MASKS)
def test_rs_reconstruct_words_plain_matches_pallas(lost):
    present, want = _pattern(lost)
    surv = _ALL[:, list(present)]
    got = cc.make_rs_reconstruct_words(present, want, device="cpu")(_t(surv))
    assert np.array_equal(got.numpy().view(np.uint32), _pallas_rebuilt(lost))
    assert np.array_equal(_bytes(got)[0], _ALL[0, list(want)])


@pytest.mark.parametrize("lost", [(0, 9), (3, 4), (8, 9), (5,)])
def test_stripe_decode_step_words_matches_pallas(lost):
    L = 2048
    allsh = _stripes(2, L)
    present, want = _pattern(lost)
    surv = allsh[:, list(present)]
    rreb, rcrc = pc.make_stripe_decode_step_words(
        L // 4, present, want, interpret=True)(
        jnp.asarray(np.ascontiguousarray(surv).view(np.uint32)))
    rebuilt, crcs = cc.make_stripe_decode_step_words(
        L // 4, present, want, device="cpu")(_t(surv))
    assert np.array_equal(rebuilt.numpy().view(np.uint32), np.asarray(rreb))
    assert np.array_equal(crcs.numpy().view(np.uint32), np.asarray(rcrc))
    assert crcs.shape == (2, 8 + len(want))
    order = list(present) + list(want)          # survivors, then rebuilt
    assert [int(c) for c in crcs[1].numpy().view(np.uint32)] == \
        [crc32c_ref(allsh[1, s].tobytes()) for s in order]


@pytest.mark.parametrize("k,m,lost", [
    (4, 3, (0, 5, 6)), (4, 3, (2,)), (6, 3, (1, 4, 7)), (6, 3, (0, 8))])
def test_rs_reconstruct_bytes_matches_pallas(k, m, lost):
    L = 1024
    allsh = _stripes(2, L, k, m)
    present, want = _pattern(lost, k + m, k)
    surv = np.ascontiguousarray(allsh[:, list(present)])
    ref = pc.make_rs_reconstruct_pallas(present, want, ref_default_rs(k, m),
                                        block_t=512, interpret=True)(jnp.asarray(surv))
    got = cc.make_rs_reconstruct_bytes(present, want, default_rs(k, m),
                                       device="cpu")(torch.from_numpy(surv))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), allsh[:, list(want)])


@pytest.mark.parametrize("k,m", [(4, 3), (6, 3)])
def test_rs_encode_bytes_matches_pallas(k, m):
    L = 1024
    data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    ref = pc.make_rs_encode_pallas(ref_default_rs(k, m), block_t=512,
                                   interpret=True)(jnp.asarray(data))
    got = cc.make_rs_encode_bytes(default_rs(k, m), device="cpu")(torch.from_numpy(data))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy()[1], default_rs(k, m).encode_ref(data[1]))


@pytest.mark.parametrize("k,m,L,lost", [
    (8, 2, 512, (0, 9)), (8, 2, 1001, (4,)), (4, 3, 999, (1, 2, 6)), (6, 3, 64, (5,))])
def test_torch_make_rs_reconstruct_matches_jax(k, m, L, lost):
    allsh = _stripes(3, L, k, m)
    present, want = _pattern(lost, k + m, k)
    surv = np.ascontiguousarray(allsh[:, list(present)])
    ref = jax_codec.make_rs_reconstruct(present, want, ref_default_rs(k, m))(
        jnp.asarray(surv))
    got = torch_codec.make_rs_reconstruct(present, want, default_rs(k, m),
                                          device="cpu")(torch.from_numpy(surv))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    assert np.array_equal(got.numpy(), allsh[:, list(want)])


def _jax_decode_arrays(present, want, k=8, m=2) -> dict:
    """The decode constants as the JAX package builds them
    (pallas_codec.py:465-468 for the plane-major bit matrix)."""
    rs = ref_default_rs(k, m)
    W = rs.reconstruct_bitmatrix(list(present), list(want))
    pk, pw = pc._plane_major_perm(k), pc._plane_major_perm(len(want))
    return {"gfmatrix": rs.reconstruct_gfmatrix(list(present), list(want)),
            "bitmatrix_t": W[np.ix_(pk, pw)].T,
            "rs_poly": np.array(rs.gf.poly, dtype=np.int64)}


@pytest.mark.parametrize("k,m,lost", [(8, 2, (0, 9)), (8, 2, (6,)), (6, 3, (0, 4, 8))])
def test_decode_tables_from_jax_arrays(k, m, lost):
    """The port's decode constants equal the JAX package's, and tables
    loaded from either give identical kernels' inputs and outputs."""
    present, want = _pattern(lost, k + m, k)
    ref, own = _jax_decode_arrays(present, want, k, m), build_decode_arrays(
        present, want, default_rs(k, m))
    assert ref.keys() == own.keys()
    for key in own:
        assert np.array_equal(np.asarray(ref[key]), np.asarray(own[key])), key
    a, b = load_gfmap_tables(ref, device="cpu"), load_gfmap_tables(own, device="cpu")
    assert (a.coeff_rows, a.poly_low) == (b.coeff_rows, 0x1D)
    assert len(a.tiles) == len(b.tiles) == 1
    assert torch.equal(a.tiles[0].lut, b.tiles[0].lut)
    assert torch.equal(a.bitmatrix_t, b.bitmatrix_t)
    shards = torch.from_numpy(rng.integers(0, 256, (2, k, 96), dtype=np.uint8))
    assert torch.equal(cc.rs_bitmatmul(shards, a), cc.rs_bitmatmul(shards, b))


@pytest.mark.parametrize("k,m", [(4, 3), (6, 3), (8, 2)])
def test_encode_tables_from_jax_arrays(k, m):
    rs = ref_default_rs(k, m)
    pk, pm = pc._plane_major_perm(k), pc._plane_major_perm(m)
    ref = {"gfmatrix": rs.parity_rows,
           "bitmatrix_t": rs.parity_bitmatrix[np.ix_(pk, pm)].T,
           "rs_poly": np.array(rs.gf.poly, dtype=np.int64)}
    own = build_encode_arrays(default_rs(k, m))
    for key in own:
        assert np.array_equal(np.asarray(ref[key]), np.asarray(own[key])), key


def _emulate_bitmatmul_kernel(shards: np.ndarray, gmap) -> np.ndarray:
    """numpy model of rs_bitmatmul.cu, one launch a tile: per input shard i
    of the tile and output group g, one u32 table entry per input byte,
    XORed into the byte position's accumulator; output shard j is byte
    j % 4 of group j // 4's; a tile past input 0 XORs into its rows."""
    n, k, L = shards.shape
    out = np.zeros((n, gmap.rows, L), dtype=np.uint8)
    for t in gmap.tiles:
        lut = t.lut.numpy().view(np.uint32).reshape(-1, t.ki, 256)
        acc = np.zeros((lut.shape[0], n, L), dtype=np.uint32)
        for g in range(lut.shape[0]):
            for i in range(t.ki):
                acc[g] ^= lut[g, i][shards[:, t.i0 + i]]
        part = np.stack([(acc[j // 4] >> np.uint32(8 * (j % 4))).astype(np.uint8)
                         for j in range(t.rows)], axis=1)
        if t.i0:
            out[:, t.j0:t.j0 + t.rows] ^= part
        else:
            out[:, t.j0:t.j0 + t.rows] = part
    return out


@pytest.mark.parametrize("k,m,lost", [(4, 3, (0, 1, 2)), (6, 3, (1, 4, 7)),
                                      (8, 2, (3, 8))])
def test_bitmatmul_kernel_tables_emulated(k, m, lost):
    """The CUDA kernel's lookup tables, emulated on the host, give the plain
    version's bytes, for a decode pattern and for the encode map."""
    present, want = _pattern(lost, k + m, k)
    shards = rng.integers(0, 256, (2, k, 77), dtype=np.uint8)
    for gmap in (decode_tables(present, want, default_rs(k, m), device="cpu"),
                 load_gfmap_tables(build_encode_arrays(default_rs(k, m)), device="cpu")):
        want_bytes = cc.rs_bitmatmul(torch.from_numpy(shards), gmap).numpy()
        assert np.array_equal(_emulate_bitmatmul_kernel(shards, gmap), want_bytes)


def test_bitmatmul_tables_pack_eight_outputs_in_two_groups():
    """Eight output rows: two table groups; the emulation still agrees."""
    arrays = build_encode_arrays(default_rs(4, 8))
    gmap = load_gfmap_tables(arrays, device="cpu")
    assert len(gmap.tiles) == 1 and gmap.tiles[0].lut.numel() == 2 * 4 * 256
    shards = rng.integers(0, 256, (1, 4, 33), dtype=np.uint8)
    assert np.array_equal(_emulate_bitmatmul_kernel(shards, gmap),
                          cc.rs_bitmatmul(torch.from_numpy(shards), gmap).numpy())


def _c_entry_program(dec):
    """B3's program as the C entry t3fs_rs_reconstruct_words builds it from
    the (rows, k) u8 coefficients: plane[r][b] (bit s: bit b of C[r][s]),
    top[r] (highest nonempty plane, -1 for a zero row), used (bit s: some
    row reads survivor s)."""
    plane = [[0] * 8 for _ in range(2)]
    top, used = [-1, -1], 0
    for r in range(dec.rows):
        for b in range(8):
            for s in range(dec.k):
                if (dec.coeff_rows[r][s] >> b) & 1:
                    plane[r][b] |= 1 << s
            if plane[r][b]:
                top[r] = b
            used |= plane[r][b]
    return plane, top, used


def _emulate_reconstruct_kernel(words: np.ndarray, dec) -> np.ndarray:
    """numpy model of rs_reconstruct_words.cu, step by step: the C entry's
    program; survivors loaded in groups of 8 (zero where no row reads
    them); with k <= 8, each row folded from the registers, plane 7 down
    (xtimes below its top plane, then the plane's survivors XORed in); past
    8, each group's selected survivors XORed into the plane sums S[r][b],
    folded at the end the same way."""
    def xtimes(x):
        return (((x << np.uint32(1)) & np.uint32(0xFEFEFEFE))
                ^ (((x >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(dec.poly_low)))

    plane, top, used = _c_entry_program(dec)
    n, k, W = words.shape

    def group(g):
        return [words[:, 8 * g + j] if (used >> (8 * g + j)) & 1
                else np.zeros((n, W), np.uint32) for j in range(8)]

    def xor_selected(acc, x, m):
        for j in range(8):
            if (m >> j) & 1:
                acc = acc ^ x[j]
        return acc

    out = np.zeros((n, dec.rows, W), dtype=np.uint32)
    if k <= 8:
        x = group(0)
        for r in range(dec.rows):
            acc = np.zeros((n, W), np.uint32)
            for b in range(7, -1, -1):
                if b < top[r]:
                    acc = xtimes(acc)
                if plane[r][b]:
                    acc = xor_selected(acc, x, plane[r][b])
            out[:, r] = acc
        return out
    S = np.zeros((dec.rows, 8, n, W), np.uint32)
    for g in range((k + 7) // 8):
        x = group(g)
        for r in range(dec.rows):
            for b in range(8):
                m = (plane[r][b] >> (8 * g)) & 0xFF
                if m:
                    S[r, b] = xor_selected(S[r, b], x, m)
    for r in range(dec.rows):
        acc = np.zeros((n, W), np.uint32)
        for b in range(7, -1, -1):
            if b < top[r]:
                acc = xtimes(acc)
            acc = acc ^ S[r, b]
        out[:, r] = acc
    return out


def _program_coeffs(dec) -> list[list[int]]:
    """The coefficients that the C entry's planes encode, (rows, k)."""
    plane, _, _ = _c_entry_program(dec)
    return [[sum(((plane[r][b] >> s) & 1) << b for b in range(8))
             for s in range(dec.k)] for r in range(dec.rows)]


def test_reconstruct_kernel_planes_emulated_all_masks():
    """The kernel's arithmetic (the C entry's planes, plane sums, Horner
    fold) at all 55 patterns against the plain version and the JAX kernel
    in interpret mode, bit-exact; the planes encode the JAX package's
    reconstruct_gfmatrix."""
    rs = ref_default_rs()
    for lost in MASKS:
        present, want = _pattern(lost)
        dec = decode_tables(present, want, device="cpu")
        assert np.array_equal(_program_coeffs(dec),
                              rs.reconstruct_gfmatrix(list(present), list(want))), lost
        surv = np.ascontiguousarray(_ALL[:, list(present)]).view(np.uint32)
        got = _emulate_reconstruct_kernel(surv, dec)
        plain = cc.rs_reconstruct_words(torch.from_numpy(surv.view(np.int32)), dec)
        assert np.array_equal(got, plain.numpy().view(np.uint32)), lost
        assert np.array_equal(got, _pallas_rebuilt(lost)), lost


@pytest.mark.parametrize("k", [1, 8, 31, 32])
def test_reconstruct_kernel_planes_match_decode_ref(k):
    """The C entry's planes, built from the JAX package's decode arrays and
    evaluated by the kernel's emulation (one group of survivors at k <= 8,
    plane sums over groups past 8), rebuild what the JAX package's
    RSCode.decode_ref rebuilds, as the plain version does, for double and
    single erasures of RAID-6 RS(k+2) encoded by its encode_ref."""
    rs = ref_default_rs(k, 2)
    data = rng.integers(0, 256, (k, 64), dtype=np.uint8)
    full = np.concatenate([data, rs.encode_ref(data)])
    for lost in ((0, k + 1), (k // 2,), (k, k + 1)):
        present, want = _pattern(lost, k + 2, k)
        dec = load_gfmap_tables(_jax_decode_arrays(present, want, k, 2), device="cpu")
        assert dec.coeff_rows == decode_tables(present, want, default_rs(k, 2),
                                               device="cpu").coeff_rows, (k, lost)
        surv = np.ascontiguousarray(full[list(present)])[None].view(np.uint32)
        got = _emulate_reconstruct_kernel(surv, dec)[0].view(np.uint8)
        ref = rs.decode_ref(dict(zip(present, full[list(present)])), list(want))
        assert np.array_equal(got, ref), (k, lost)
        assert np.array_equal(got, full[list(want)]), (k, lost)
        plain = cc.rs_reconstruct_words(torch.from_numpy(surv.view(np.int32)), dec)
        assert np.array_equal(plain.numpy()[0].view(np.uint8), ref), (k, lost)


def test_all_ones_rows_have_top_plane_zero():
    """Every single erasure of a data shard or of P rebuilt from the other
    data and P (or from the data alone), and that side of (d, 9), is an
    all-ones row: one plane, a pure XOR fold."""
    ones = 0
    for lost in MASKS:
        dec = decode_tables(*_pattern(lost), device="cpu")
        plane, top, _ = _c_entry_program(dec)
        for r, row in enumerate(dec.coeff_rows):
            if all(c == 1 for c in row):
                ones += 1
                assert top[r] == 0 and plane[r][0] == (1 << dec.k) - 1, lost
                assert not any(plane[r][1:]), lost
            else:
                assert top[r] > 0, lost
    assert ones == 9 + 9              # (0,) .. (8,), and (d, 9) for d <= 8


def test_decode_wrappers_reject_bad_input():
    dec = decode_tables(*_pattern((0, 1)), device="cpu")
    with pytest.raises(TypeError):
        cc.rs_reconstruct_words(torch.zeros(1, 8, 4, dtype=torch.int64), dec)
    with pytest.raises(ValueError):
        cc.rs_reconstruct_words(torch.zeros(1, 7, 4, dtype=torch.int32), dec)
    with pytest.raises(TypeError):
        cc.rs_bitmatmul(torch.zeros(1, 8, 4, dtype=torch.int32), dec)
    with pytest.raises(ValueError):
        cc.rs_bitmatmul(torch.zeros(1, 8, 8, dtype=torch.uint8)[:, :, ::2], dec)
    with pytest.raises(ValueError):
        cc.make_rs_reconstruct_words((0, 1, 2), (3,), default_rs(4, 3), device="cpu")
    with pytest.raises(ValueError):
        cc.make_rs_reconstruct_words((0, 1), (2,), device="cpu")
    with pytest.raises(ValueError):
        cc.make_stripe_decode_step_words(128, (0, 1, 2, 3), (4,), 4, 3, device="cpu")
    with pytest.raises(ValueError):
        load_gfmap_tables({**build_decode_arrays((1, 2, 3, 4, 5, 6, 7, 8), (0,)),
                           "bitmatrix_t": np.zeros((8, 8), np.uint8)}, device="cpu")


def test_decode_plain_versions_never_count_launches():
    cc.reset_launches()
    present, want = _pattern((2, 7))
    cc.make_rs_reconstruct_words(present, want, device="cpu")(
        torch.zeros(1, 8, 4, dtype=torch.int32))
    cc.make_rs_reconstruct_bytes(present, want, device="cpu")(
        torch.zeros(1, 8, 5, dtype=torch.uint8))
    assert cc.launches["rs_reconstruct_words"] == cc.launches["rs_bitmatmul"] == 0


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_decode_kernels_match_plain_on_gpu(cuda_device):
    """On the card: B3 on every mask and B5 (decode and encode, vector and
    byte paths) against their plain versions, bit-exact."""
    words = torch.from_numpy(rng.integers(0, 2**32, (3, 8, 256), dtype=np.uint32)
                             .view(np.int32)).to(cuda_device)
    cc.reset_launches()
    for lost in MASKS:
        dec = decode_tables(*_pattern(lost), device=cuda_device)
        assert torch.equal(cc.rs_reconstruct_words(words, dec),
                           cc.rs_reconstruct_words_plain(words, dec)), lost
        odd = words[:, :, :255].contiguous()                 # scalar path
        assert torch.equal(cc.rs_reconstruct_words(odd, dec),
                           cc.rs_reconstruct_words_plain(odd, dec)), lost
    rs = default_rs(6, 3)
    for L in (4096, 1000):
        shards = torch.from_numpy(rng.integers(0, 256, (2, 6, L), dtype=np.uint8)
                                  ).to(cuda_device)
        for gmap in (decode_tables((0, 2, 3, 5, 6, 8), (1, 4, 7), rs, cuda_device),
                     load_gfmap_tables(build_encode_arrays(rs), cuda_device)):
            assert torch.equal(cc.rs_bitmatmul(shards, gmap),
                               cc.rs_bitmatmul_plain(shards, gmap))
    torch.cuda.synchronize()
    assert cc.launches["rs_reconstruct_words"] == 110
    assert cc.launches["rs_bitmatmul"] == 4
