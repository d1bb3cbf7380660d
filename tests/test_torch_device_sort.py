"""The port's device key sort against the JAX package's: the permutation of
`t3fs_torch.ops.device_sort.make_device_sorter` on the CPU equals
`lexsort_rows` and the JAX sorter (`jax.lax.sort`, padded to power-of-two
buckets of 0xFFFFFFFF sentinels) at every row count around the buckets'
edges, with tied keys and with real all-0xFF keys; the `cuda`-marked twin
sorts on the card."""

import numpy as np
import pytest
import torch

from t3fs.ops import device_sort as ref
from t3fs_torch.ops import device_sort as ds

SIZES = [0, 1, 7, 1023, 1024, 1025, 5000]


def _rows(n: int, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, 256, (n, ds.REC_LEN),
                                                dtype=np.uint8)


def _tied(n: int, seed: int = 1) -> np.ndarray:
    """Rows whose keys come from 5 distinct keys, payloads all different."""
    rows = _rows(n, seed)
    keys = _rows(5, seed + 1)[:, :ds.KEY_LEN]
    rows[:, :ds.KEY_LEN] = keys[np.random.default_rng(seed).integers(0, 5, n)]
    return rows


@pytest.fixture(scope="module")
def jax_sorter():
    return ref.make_device_sorter()


def test_constants_match_reference():
    assert (ds.KEY_LEN, ds.REC_LEN) == (ref.KEY_LEN, ref.REC_LEN)


@pytest.mark.parametrize("n", [0, 1, 1000])
def test_key_columns_match_reference(n):
    rows = _rows(n, 3)
    for a, b in zip(ds.key_columns(rows), ref.key_columns(rows)):
        assert a.dtype == b.dtype == np.uint32
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(ds.lexsort_rows(rows), ref.lexsort_rows(rows))


@pytest.mark.parametrize("n", SIZES)
def test_sorter_matches_lexsort_and_jax(n, jax_sorter):
    rows = _rows(n)
    perm = ds.make_device_sorter("cpu")(rows)
    want = jax_sorter(rows)
    assert perm.dtype == want.dtype == (np.int64 if n == 0 else np.int32)
    np.testing.assert_array_equal(perm, want)
    np.testing.assert_array_equal(perm, ds.lexsort_rows(rows))


@pytest.mark.parametrize("n", [7, 1025, 5000])
def test_sorter_keeps_ties_in_row_order(n, jax_sorter):
    rows = _tied(n)
    perm = ds.make_device_sorter("cpu")(rows)
    np.testing.assert_array_equal(perm, jax_sorter(rows))
    np.testing.assert_array_equal(perm, ds.lexsort_rows(rows))
    keys = rows[perm, :ds.KEY_LEN]
    same = (keys[1:] == keys[:-1]).all(axis=1)
    assert same.any() and (perm[1:][same] > perm[:-1][same]).all()


@pytest.mark.parametrize("n", [5, 1000, 1025])
def test_sorter_all_ff_keys_tie_with_the_sentinels(n, jax_sorter):
    """Real all-0xFF keys: the reference pads its bucket with 0xFFFFFFFF
    sentinels that tie with them; the twin does not pad, and both give
    the unpadded permutation."""
    rows = _rows(n, 4)
    rows[::3, :ds.KEY_LEN] = 0xFF
    perm = ds.make_device_sorter("cpu")(rows)
    np.testing.assert_array_equal(perm, jax_sorter(rows))
    np.testing.assert_array_equal(perm, ds.lexsort_rows(rows))
    ff = np.arange(0, n, 3)
    np.testing.assert_array_equal(perm[-len(ff):], ff)


def test_sort_columns_sorts_the_48_bit_composite_exactly():
    """k1 and k2 at their extremes: the composite (k1 << 16) | k2 needs all
    48 bits, and k0 the top bit of a uint32."""
    k = np.array([[0xFFFFFFFF, 0xFFFFFFFF, 0xFFFF], [0xFFFFFFFF, 0xFFFFFFFF, 0],
                  [0x80000000, 0, 1], [0x7FFFFFFF, 0xFFFFFFFF, 0xFFFF],
                  [0x80000000, 0, 0], [0, 0x80000000, 0]], dtype=np.int64)
    perm = ds.sort_columns(*(torch.from_numpy(k[:, i].copy()) for i in range(3)))
    assert perm.dtype == torch.int32
    np.testing.assert_array_equal(perm.numpy(), np.lexsort((k[:, 2], k[:, 1], k[:, 0])))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the device sort runs on the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sorter_on_the_card(cuda_device):
    sort_perm = ds.make_device_sorter()
    for n in SIZES:
        rows = _rows(n)
        np.testing.assert_array_equal(sort_perm(rows), ds.lexsort_rows(rows))
    rows = _tied(5000)
    rows[::7, :ds.KEY_LEN] = 0xFF
    perm = sort_perm(rows)
    np.testing.assert_array_equal(perm, ds.make_device_sorter("cpu")(rows))
    np.testing.assert_array_equal(perm, ds.lexsort_rows(rows))
