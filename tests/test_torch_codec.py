"""The port's plain PyTorch codec (t3fs_torch.ops.torch_codec) against the
JAX package's XLA codec (t3fs.ops.jax_codec) and the scalar CRC oracle.

Every comparison is bit-exact: all the codec math is integer / GF(2).  The
same seeded numpy arrays go to both sides."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from t3fs.ops import jax_codec
from t3fs.ops.crc32c import crc32c_ref
from t3fs.ops.rs import RSCode as RefRSCode
from t3fs_torch.ops import torch_codec
from t3fs_torch.ops.rs import RSCode, default_rs

rng = np.random.default_rng(21)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def test_bit_pack_unpack_match_jax():
    x = rng.integers(0, 256, (3, 5, 16), dtype=np.uint8)
    bits = torch_codec.unpack_bits(torch.from_numpy(x))
    assert np.array_equal(bits.numpy(), np.asarray(jax_codec.unpack_bits(jnp.asarray(x))))
    assert np.array_equal(torch_codec.pack_bits_u8(bits).numpy(), x)
    b32 = rng.integers(0, 2, (7, 32), dtype=np.int32)
    want = np.asarray(jax_codec.pack_bits_u32(jnp.asarray(b32)))
    assert np.array_equal(_u32(torch_codec.pack_bits_u32(torch.from_numpy(b32))), want)


@pytest.mark.parametrize("n", [1, 3, 9, 511, 512, 513, 700, 1024, 2053])
def test_crc32c_batch_matches_jax_and_oracle(n):
    chunks = rng.integers(0, 256, (3, n), dtype=np.uint8)
    got = _u32(torch_codec.make_crc32c_batch(n, device="cpu")(torch.from_numpy(chunks)))
    ref = np.asarray(jax_codec.make_crc32c_batch(n)(jnp.asarray(chunks)))
    assert np.array_equal(got, ref)
    assert [int(c) for c in got] == [crc32c_ref(r.tobytes()) for r in chunks]


def test_crc32c_raw_matches_jax():
    chunks = rng.integers(0, 256, (2, 1536), dtype=np.uint8)
    got = torch_codec.make_crc32c_raw(1536, device="cpu")(torch.from_numpy(chunks))
    ref = np.asarray(jax_codec.make_crc32c_raw(1536)(jnp.asarray(chunks)))
    assert np.array_equal(got.numpy(), ref)


def test_check_vector():
    x = np.frombuffer(b"123456789", dtype=np.uint8)[None]
    got = torch_codec.make_crc32c_batch(9, device="cpu")(torch.from_numpy(x.copy()))
    assert int(_u32(got)[0]) == 0xE3069283


@pytest.mark.parametrize("k,m,L", [
    (8, 2, 1024),    # RAID-6 word path
    (8, 2, 1001),    # RAID-6, odd length: bit-matmul path
    (4, 3, 1000),    # not RAID-6: bit matmul
    (6, 3, 512),
])
def test_rs_encode_matches_jax_and_oracle(k, m, L):
    data = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    got = torch_codec.make_rs_encode(default_rs(k, m), device="cpu")(
        torch.from_numpy(data)).numpy()
    ref_rs = RefRSCode(k, m)
    ref = np.asarray(jax_codec.make_rs_encode(ref_rs)(jnp.asarray(data)))
    assert np.array_equal(got, ref)
    for i in range(2):
        assert np.array_equal(got[i], ref_rs.encode_ref(data[i]))


def test_raid6_word_and_matmul_encoders_agree():
    rs = default_rs(8, 2)
    data = torch.from_numpy(rng.integers(0, 256, (3, 8, 256), dtype=np.uint8))
    fast = torch_codec.make_rs_encode_raid6(rs, device="cpu")(data)
    slow = torch_codec.make_rs_encode_matmul(rs, device="cpu")(data)
    assert torch.equal(fast, slow)


@pytest.mark.parametrize("k,m,L", [(8, 2, 1024), (4, 3, 512)])
def test_stripe_encode_step_matches_jax(k, m, L):
    stripes = rng.integers(0, 256, (2, k, L), dtype=np.uint8)
    parity, crcs = torch_codec.make_stripe_encode_step(L, k, m, device="cpu")(
        torch.from_numpy(stripes))
    rparity, rcrcs = jax_codec.make_stripe_encode_step(L, k, m)(jnp.asarray(stripes))
    assert np.array_equal(parity.numpy(), np.asarray(rparity))
    assert np.array_equal(_u32(crcs), np.asarray(rcrcs))


@pytest.mark.parametrize("k,m", [(8, 2), (4, 3), (6, 2)])
def test_rs_generator_and_code_id_match_reference(k, m):
    """code_id is written on the wire and on disk: the port's generator must
    be the reference's, bit for bit."""
    port, ref = RSCode(k, m), RefRSCode(k, m)
    assert port.code_id == ref.code_id
    assert np.array_equal(port.G, ref.G)
    assert np.array_equal(port.parity_bitmatrix, ref.parity_bitmatrix)
    if (k, m) == (8, 2):
        assert port.code_id == "raid6-g2-11d"
