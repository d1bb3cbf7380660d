"""The plain reference against published vectors and its own definitions."""

import pytest
import torch

from fsbench import reference as R


def _rows(data: bytes) -> torch.Tensor:
    return torch.tensor(list(data), dtype=torch.uint8)[None]


# the CRC-32C check value and RFC 3720's (iSCSI) B.4 vectors
VECTORS = [
    (b"123456789", 0xE3069283),
    (bytes(32), 0x8A9136AA),
    (b"\xff" * 32, 0x62A8AB43),
    (bytes(range(32)), 0x46DD794E),
    (bytes(range(31, -1, -1)), 0x113FDB5C),
]


@pytest.mark.parametrize("data,want", VECTORS)
def test_crc32c_published_vectors(data, want):
    assert R.crc32c_bitwise(data) == want
    assert int(R.crc32c_rows(_rows(data))[0]) == want


@pytest.mark.parametrize("length", [1, 7, 64, 513, 4096, 3 * 4096 + 8, 5 * 4096])
def test_crc32c_rows_match_the_bitwise_definition(length):
    gen = torch.Generator().manual_seed(length)
    rows = torch.empty(3, length, dtype=torch.uint8).random_(generator=gen)
    got = R.crc32c_rows(rows)
    for i in range(3):
        assert int(got[i]) == R.crc32c_bitwise(bytes(rows[i].tolist()))


def test_gf_arithmetic():
    assert R.gf_mul(0x80, 2) == 0x1D          # x^8 = x^4 + x^3 + x^2 + 1
    assert all(R.gf_mul(a, R.gf_inv(a)) == 1 for a in range(1, 256))
    assert R.gf_pow(2, 255) == 1


def test_raid6_parity_by_the_definition():
    gen = torch.Generator().manual_seed(5)
    data = torch.empty(2, 8, 64, dtype=torch.uint8).random_(generator=gen)
    parity = R.raid6_parity(data)
    for n in range(2):
        for j in range(64):
            p = q = 0
            for s in range(8):
                d = int(data[n, s, j])
                p ^= d
                q ^= R.gf_mul(R.gf_pow(2, 7 - s), d)
            assert (int(parity[n, 0, j]), int(parity[n, 1, j])) == (p, q)


@pytest.mark.parametrize("lost", range(8))
@pytest.mark.parametrize("through", ["P", "Q"])
def test_raid6_encode_and_one_loss_round_trip(lost, through):
    gen = torch.Generator().manual_seed(lost)
    data = torch.empty(3, 8, 512, dtype=torch.uint8).random_(generator=gen)
    parity = R.raid6_parity(data)
    shards = {s: data[:, s] for s in range(8) if s != lost}
    shards[8 if through == "P" else 9] = parity[:, 0 if through == "P" else 1]
    assert torch.equal(R.raid6_rebuild_one(shards, lost, 8), data[:, lost])
