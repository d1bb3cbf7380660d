"""The byte-path CRC (B6) and the byte-path stripe steps on the port:
t3fs_torch.ops.cuda_codec on CPU tensors (the kernels' plain versions)
against the JAX package's make_crc_seg_pallas / make_crc32c_raw_fast /
make_stripe_encode_step_fast (Pallas in interpret mode), its XLA
make_crc32c_batch and decode, and crc32c_ref; B6's tables against the JAX
package's arrays; and a numpy emulation of the CUDA kernel's own
arithmetic (end-aligned partial first segment, unaligned loads, nibble
lookups, run fold).

Shapes follow tests/test_pallas_codec.py.  Every comparison is bit-exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops import jax_codec
from t3fs.ops import pallas_codec as pc
from t3fs.ops.crc32c import crc32c_ref, default_matrices as ref_matrices
from t3fs.ops.rs import default_rs as ref_default_rs
from t3fs_torch.benchmarks import b1_probe
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.blocks import pick_block
from t3fs_torch.ops.repair_program import eval_program_np, single_row_program
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import (
    build_crc_bytes_arrays, crc_bytes_tables, crc_nseg,
    load_crc_bytes_tables)

rng = np.random.default_rng(41)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _bytes(n: int, L: int) -> np.ndarray:
    return rng.integers(0, 256, (n, L), dtype=np.uint8)


def test_crc_seg_bytes_matches_pallas():
    rows = _bytes(16, 512)
    ref = pc.make_crc_seg_pallas(block_r=8, interpret=True)(jnp.asarray(rows))
    want = np.asarray(jax_codec.pack_bits_u32(ref))
    tables = crc_bytes_tables(1, device="cpu")
    assert np.array_equal(_u32(cc.make_crc_seg_bytes(device="cpu")(torch.from_numpy(rows))),
                          want)
    assert np.array_equal(_u32(cc.crc_seg_bytes_plain(torch.from_numpy(rows), tables)),
                          want)


def test_crc32c_raw_fast_matches_pallas():
    L = 1024
    rows = _bytes(3, L)
    ref = pc.make_crc32c_raw_fast(L, seg_bytes=512, block_r=4, interpret=True)(
        jnp.asarray(rows))
    got = cc.make_crc32c_raw_fast(L, device="cpu")(torch.from_numpy(rows))
    assert np.array_equal(_u32(got), np.asarray(jax_codec.pack_bits_u32(ref)))
    affine = ref_matrices().affine_const(L)
    assert [int(c) ^ affine for c in _u32(got)] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("L", [1, 9, 511, 513, 1000, 4093])
def test_crc32c_bytes_matches_xla_batch_and_oracle(L):
    rows = _bytes(3, L)
    got = _u32(cc.make_crc32c_bytes(L, device="cpu")(torch.from_numpy(rows)))
    want = np.asarray(jax_codec.make_crc32c_batch(L)(jnp.asarray(rows)))
    assert np.array_equal(got, want)
    assert [int(c) for c in got] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("L", [9, 1000, 2048])
def test_crc32c_rows_takes_words_or_bytes(L):
    """make_crc32c_rows: B1 on whole segments, B6 otherwise; the same CRCs."""
    rows = _bytes(4, L)
    got = _u32(cc.make_crc32c_rows(L, device="cpu")(torch.from_numpy(rows)))
    assert [int(c) for c in got] == [crc32c_ref(r.tobytes()) for r in rows]


@pytest.mark.parametrize("k,m", [(8, 2), (6, 3)])
def test_stripe_encode_step_fast_matches_pallas(k, m):
    L = 1024
    stripes = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    rpar, rcrc = pc.make_stripe_encode_step_fast(L, k, m, interpret=True)(
        jnp.asarray(stripes))
    parity, crcs = cc.make_stripe_encode_step_fast(L, k, m, device="cpu")(
        torch.from_numpy(stripes))
    assert np.array_equal(parity.numpy(), np.asarray(rpar))
    assert np.array_equal(_u32(crcs), np.asarray(rcrc))
    assert crcs.shape == (2, k + m)


@pytest.mark.parametrize("k,m,L", [(8, 2, 1000), (8, 2, 1002), (6, 3, 777)])
def test_stripe_encode_step_bytes_matches_xla(k, m, L):
    """The codec's byte write step (B2 on words for RAID-6 at L % 4 == 0,
    else B5; then B6) against the reference's XLA encode and batch CRC."""
    stripes = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    parity, crcs = cc.make_stripe_encode_step_bytes(L, k, m, device="cpu")(
        torch.from_numpy(stripes))
    rpar = np.asarray(jax_codec.make_rs_encode(ref_default_rs(k, m))(jnp.asarray(stripes)))
    crcf = jax_codec.make_crc32c_batch(L)
    rcrc = np.concatenate([np.asarray(crcf(jnp.asarray(stripes.reshape(-1, L)))).reshape(2, k),
                           np.asarray(crcf(jnp.asarray(rpar.reshape(-1, L)))).reshape(2, m)],
                          axis=1)
    assert np.array_equal(parity.numpy(), rpar)
    assert np.array_equal(_u32(crcs), rcrc)


@pytest.mark.parametrize("k,m,L,lost", [(6, 3, 1024, (1, 4, 7)), (8, 2, 1000, (0, 9)),
                                        (4, 3, 513, (2,))])
def test_stripe_decode_step_bytes_matches_xla(k, m, L, lost):
    """B5 decode then B6 against the reference ECCodec's XLA-fused decode
    (jax_codec.make_rs_reconstruct + make_crc32c_batch)."""
    rs = ref_default_rs(k, m)
    data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    full = np.stack([np.concatenate([d, rs.encode_ref(d)]) for d in data])
    present = tuple(s for s in range(k + m) if s not in lost)[:k]
    rows = np.ascontiguousarray(full[:, list(present)])
    rebuilt, crcs = cc.make_stripe_decode_step_bytes(L, present, lost, k, m, device="cpu")(
        torch.from_numpy(rows))
    want = np.asarray(jax_codec.make_rs_reconstruct(present, lost, rs)(jnp.asarray(rows)))
    assert np.array_equal(rebuilt.numpy(), want)
    assert np.array_equal(rebuilt.numpy(), full[:, list(lost)])
    crcf = jax_codec.make_crc32c_batch(L)
    rcrc = np.asarray(crcf(jnp.asarray(full[:, list(present + lost)].reshape(-1, L))))
    assert np.array_equal(_u32(crcs), rcrc.reshape(2, k + len(lost)))


@pytest.mark.parametrize("L", [1000, 1001])
def test_repair_step_bytes_matches_oracle(L):
    """B4 on the word-padded rows, cut back, then B6."""
    rs = default_rs(8, 2)
    present = [s for s in range(10) if s != 9][:8]
    prog = single_row_program(rs, present, 9)
    helpers = rng.integers(0, 256, (3, prog.num_helpers, L), dtype=np.uint8)
    out, crcs = cc.make_repair_step_bytes(L, prog, device="cpu")(torch.from_numpy(helpers))
    for i in range(3):
        want = eval_program_np(prog, helpers[i], rs)
        assert np.array_equal(out[i].numpy(), want)
        assert int(_u32(crcs)[i]) == crc32c_ref(want.tobytes())


def _jax_crc_bytes_arrays(nseg: int) -> dict:
    mats = ref_matrices()
    return {"segment_matrix": mats.segment_matrix(512),
            "combine_stack": mats.combine_stack(nseg, 512),
            "seg_shift": mats.shift_matrix(512)}


@pytest.mark.parametrize("nseg", [1, 3])
def test_load_crc_bytes_tables_from_jax_arrays(nseg):
    """The port's own B6 constants equal the JAX package's, tables loaded
    from either give identical outputs, and the kernel's nibble table is
    B1's (the two kernels share crc_common.cuh's layout)."""
    ref_arrays, own = _jax_crc_bytes_arrays(nseg), build_crc_bytes_arrays(nseg)
    assert ref_arrays.keys() == own.keys()
    for key in own:
        assert np.array_equal(ref_arrays[key], own[key]), key
    a = load_crc_bytes_tables(ref_arrays, device="cpu")
    b = load_crc_bytes_tables(own, device="cpu")
    for f in ("seg_matrix_pm", "combine_stack", "nibble_table", "combine_cols",
              "seg_shift_cols"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f
    perm = pc._plane_major_perm(512)
    assert np.array_equal(a.seg_matrix_pm.numpy(),
                          ref_arrays["segment_matrix"][perm].astype(np.float32))
    assert np.array_equal(a.nibble_table.numpy(), b1_probe.nibble_table())
    rows = torch.from_numpy(_bytes(3, nseg * 512 - 7))
    assert torch.equal(cc.crc_bytes_raw(rows, a), cc.crc_bytes_raw(rows, b))


def _emulate_crc_bytes_kernel(buf: np.ndarray, base: int, n: int, L: int,
                              tables, spw: int) -> list[int]:
    """numpy model of crc_bytes.cu over a flat buffer whose rows start at
    byte `base` (any alignment): segments counted from each row's end, each
    lane's 16 bytes loaded as one aligned vector, or as five aligned words
    and funnel shifts, or byte by byte in the front pad; nibble lookups in
    the [j][v][w % 4][w // 4] layout; the Horner fold over a run of spw
    segments with Mb^512, then P[last] of the run."""
    T = tables.nibble_table.numpy().view(np.uint32)
    shift = tables.seg_shift_cols.numpy().view(np.uint32)
    comb = tables.combine_cols.numpy().view(np.uint32)
    S = tables.nseg

    def word(a: int) -> int:                 # aligned little-endian u32 at a
        return int(buf[a:a + 4].view(np.uint32)[0])

    def load16(row0: int, q: int) -> list[int]:
        if q >= 0:
            a = row0 + q
            if a % 16 == 0:
                return [word(a + 4 * i) for i in range(4)]
            a0, sh = a & ~3, (a & 3) * 8
            w = [word(a0 + 4 * i) for i in range(5)]
            if sh == 0:
                return w[:4]
            return [((w[i] | (w[i + 1] << 32)) >> sh) & 0xFFFFFFFF for i in range(4)]
        v = [0, 0, 0, 0]
        for b in range(16):
            if q + b >= 0:
                v[b >> 2] |= int(buf[row0 + q + b]) << (8 * (b & 3))
        return v

    def matvec(cols, x):
        y = 0
        for i in range(32):
            if (x >> i) & 1:
                y ^= int(cols[i])
        return y

    def seg_crc(row0: int, s: int) -> int:
        x = 0
        for lane in range(32):
            q = L - (S - s) * 512 + 16 * lane
            for i, w in enumerate(load16(row0, q)):
                for j in range(8):
                    x ^= int(T[((j * 16 + ((w >> (4 * j)) & 15)) * 4 + i) * 32 + lane])
        return x

    out = []
    for r in range(n):
        total = 0
        for s0 in range(0, S, spw):
            acc = 0
            for s in range(s0, s0 + spw):
                acc = matvec(shift, acc) ^ seg_crc(base + r * L, s)
            total ^= matvec(comb[s0 + spw - 1], acc)
        out.append(total)
    return out


@pytest.mark.parametrize("L,base,spw", [(512, 0, 1), (1000, 3, 1), (1000, 16, 2),
                                        (1531, 5, 3), (37, 1, 1)])
def test_crc_bytes_kernel_emulation(L, base, spw):
    """The CUDA kernel's loads, tables and fold, emulated on the host over
    rows at odd offsets, give the plain version's raw CRCs."""
    n = 2
    S = crc_nseg(L)
    assert S % spw == 0 and spw <= pick_block(S, 16)
    buf = np.zeros(base + n * L + 8, dtype=np.uint8)       # slack: aligned reads
    buf[base:base + n * L] = rng.integers(0, 256, n * L, dtype=np.uint8)
    tables = crc_bytes_tables(S, device="cpu")
    rows = torch.from_numpy(buf[base:base + n * L].reshape(n, L).copy())
    want = [int(c) for c in _u32(cc.crc_bytes_raw(rows, tables))]
    assert _emulate_crc_bytes_kernel(buf, base, n, L, tables, spw) == want


def test_wrappers_reject_bad_input():
    tables = crc_bytes_tables(2, device="cpu")
    with pytest.raises(TypeError):
        cc.crc_bytes_raw(torch.zeros(2, 1000, dtype=torch.int32), tables)
    with pytest.raises(ValueError):
        cc.crc_bytes_raw(torch.zeros(2, 1500, dtype=torch.uint8), tables)
    with pytest.raises(ValueError):
        cc.crc_seg_bytes(torch.zeros(2, 1000, dtype=torch.uint8), tables)
    with pytest.raises(ValueError):
        cc.make_crc32c_raw_fast(1000, device="cpu")


def test_plain_versions_never_count_launches():
    cc.reset_launches()
    cc.make_crc32c_bytes(1000, device="cpu")(torch.zeros(2, 1000, dtype=torch.uint8))
    cc.make_stripe_encode_step_fast(512, 6, 3, device="cpu")(
        torch.zeros(1, 6, 512, dtype=torch.uint8))
    assert cc.launches["crc_bytes"] == 0 and not any(cc.launches.values())


def test_empty_rows_have_crc_zero():
    rows = torch.zeros(3, 0, dtype=torch.uint8)
    assert cc.make_crc32c_bytes(0, device="cpu")(rows).tolist() == [0, 0, 0]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_crc_bytes_kernel_matches_plain_on_gpu(cuda_device):
    """On the card: B6 against its plain version at odd lengths and on a
    view whose rows start at an odd address (bit-exact)."""
    cc.reset_launches()
    for L in (1, 9, 511, 513, 4093, 70000):
        tables = crc_bytes_tables(crc_nseg(L), device=cuda_device)
        rows = torch.from_numpy(_bytes(5, L)).to(cuda_device)
        assert torch.equal(cc.crc_bytes_raw(rows, tables),
                           cc.crc_bytes_raw_plain(rows, tables)), L
    flat = torch.from_numpy(rng.integers(0, 256, 4 * 1000 + 3, dtype=np.uint8)).to(cuda_device)
    view = flat[3:].view(4, 1000)
    tables = crc_bytes_tables(crc_nseg(1000), device=cuda_device)
    assert torch.equal(cc.crc_bytes_raw(view, tables),
                       cc.crc_bytes_raw_plain(view.contiguous(), tables))
    torch.cuda.synchronize()
    assert cc.launches["crc_bytes"] == 7
