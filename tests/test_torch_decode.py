"""The read side's decode kernels (t3fs_torch.ops.cuda_codec B3 and B5 on
CPU tensors, i.e. their plain versions) against the JAX package's Pallas
kernels in interpret mode and its XLA bit-matmul; the decode tables against
the JAX package's arrays; and numpy emulations of the CUDA kernels' own
arithmetic (B3's packed coefficient ladder, B5's lookup tables), which run
only on a GPU, where the `cuda` test holds them against the plain versions.

Shapes and masks follow tests/test_pallas_codec.py.  Every comparison is
bit-exact."""

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


@pytest.mark.parametrize("lost", MASKS)
def test_rs_reconstruct_words_plain_matches_pallas(lost):
    present, want = _pattern(lost)
    surv = _ALL[:, list(present)]
    ref = pc.make_rs_reconstruct_words_pallas(
        present, want, ref_default_rs(), block_w=128, interpret=True)(
        jnp.asarray(np.ascontiguousarray(surv).view(np.uint32)))
    got = cc.make_rs_reconstruct_words(present, want, device="cpu")(_t(surv))
    assert np.array_equal(got.numpy().view(np.uint32), np.asarray(ref))
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


def _emulate_reconstruct_kernel(words: np.ndarray, dec) -> np.ndarray:
    """numpy model of rs_reconstruct_words.cu: one packed column per shard
    (row r in byte r), the ladder walks until every row's bits are used."""
    def xtimes(x):
        return (((x << np.uint32(1)) & np.uint32(0xFEFEFEFE))
                ^ (((x >> np.uint32(7)) & np.uint32(0x01010101)) * np.uint32(dec.poly_low)))

    n, k, W = words.shape
    acc = np.zeros((dec.rows, n, W), dtype=np.uint32)
    for s in range(k):
        col = sum(dec.coeff_rows[r][s] << (8 * r) for r in range(dec.rows))
        t = words[:, s]
        while col:
            for r in range(dec.rows):
                if (col >> (8 * r)) & 1:
                    acc[r] ^= t
            col = (col >> 1) & 0x7F7F7F7F
            if col:
                t = xtimes(t)
    return acc.transpose(1, 0, 2)


def test_reconstruct_kernel_ladder_emulated_all_masks():
    words = rng.integers(0, 2**32, (2, 8, 16), dtype=np.uint32)
    for lost in MASKS:
        present, want = _pattern(lost)
        dec = decode_tables(present, want, device="cpu")
        plain = cc.rs_reconstruct_words(torch.from_numpy(words.view(np.int32)), dec)
        assert np.array_equal(_emulate_reconstruct_kernel(words, dec),
                              plain.numpy().view(np.uint32)), lost


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
