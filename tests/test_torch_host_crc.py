"""The port's native host CRC32C (t3fs_torch/csrc/chunk_engine.cpp through
t3fs_torch.ops.codec) against the port's table oracle and the reference's
host CRC (t3fs.ops.codec); bit-exact at every length."""

import shutil

import numpy as np
import pytest

from t3fs.ops import codec as ref_codec
from t3fs_torch.ops import codec
from t3fs_torch.ops.crc32c import crc32c_combine_ref, crc32c_ref

LENGTHS = [*range(71), (4 << 20) - 1, 4 << 20, (4 << 20) + 1]


def _data(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).integers(0, 256, n, dtype=np.uint8).tobytes()


def test_host_impl_is_native_where_a_compiler_exists():
    if shutil.which("g++") is None and shutil.which("c++") is None:
        pytest.skip("no host C++ compiler here")
    assert codec.host_impl() == "native"
    assert codec.crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n", LENGTHS)
def test_native_crc_matches_oracle_and_reference(n):
    data = _data(n, seed=n)
    want = crc32c_ref(data)
    assert codec.crc32c(data) == want == ref_codec.crc32c(data)
    # a running CRC continues where the last one stopped
    cut = n // 3
    assert codec.crc32c(data[cut:], codec.crc32c(data[:cut])) == want
    # the buffer types the transport hands over: writable and read-only views
    assert codec.crc32c(bytearray(data)) == want
    assert codec.crc32c(memoryview(data)) == want


@pytest.mark.parametrize("n", LENGTHS[::7] + LENGTHS[-3:])
def test_native_combine_matches_oracle_and_reference(n):
    a, b = _data(1000 + n % 13, seed=7 * n + 1), _data(n, seed=7 * n + 2)
    ca, cb = crc32c_ref(a), crc32c_ref(b)
    got = codec.crc32c_combine(ca, cb, len(b))
    assert got == crc32c_combine_ref(ca, cb, len(b)) \
        == ref_codec.crc32c_combine(ca, cb, len(b)) == crc32c_ref(a + b)
