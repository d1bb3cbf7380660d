"""The plain reference that decides `correct`: CRC32C and the RAID-6 RS(k+2).

Written from the codes' definitions with plain PyTorch operations, on
whatever device its tensors live on.  It imports nothing of the program
under test.

CRC32C (Castagnoli): the reflected polynomial 0x82F63B78, register preset to
all ones, result complemented.  A row is cut into lanes; each lane's raw
CRC (register preset to zero, no final complement) is run byte by byte from
the 256-entry table, all lanes side by side, and the lanes are joined by
linearity: raw(A || B) = Z^|B| raw(A) xor raw(B), where Z is the register's
map over one zero byte (a 32 x 32 matrix over GF(2)).  The preset and the
final complement are then added as Z^L(0xFFFFFFFF) xor 0xFFFFFFFF.

RAID-6 RS(k+2) over GF(2^8) with the polynomial 0x11D and generator 2, as
the program's code id "raid6-g2-11d" names it: shards 0..k-1 are the data,
P (shard k) is the XOR of the data shards and Q (shard k+1) is
sum_s 2^(k-1-s) * d_s.
"""

from __future__ import annotations

import functools

import torch

CRC32C_POLY = 0x82F63B78
GF_POLY = 0x11D
GF_GEN = 2
_MASK = 0xFFFFFFFF
# the longest lane a row is cut into (bytes); a lane is the longest power
# of two at most this that divides the row
MAX_LANE = 4096


# --- CRC32C -------------------------------------------------------------------

def crc32c_bitwise(data: bytes) -> int:
    """CRC32C of `data`, one bit at a time: the definition itself."""
    crc = _MASK
    for byte in data:
        crc ^= byte
        for _ in range(8):
            crc = (crc >> 1) ^ (CRC32C_POLY if crc & 1 else 0)
    return crc ^ _MASK


@functools.lru_cache(maxsize=1)
def _table() -> tuple[int, ...]:
    """table[b]: the register after shifting the byte b through 8 bit steps."""
    out = []
    for b in range(256):
        crc = b
        for _ in range(8):
            crc = (crc >> 1) ^ (CRC32C_POLY if crc & 1 else 0)
        out.append(crc)
    return tuple(out)


def _zero_byte_map() -> tuple[int, ...]:
    """Z: column i is the register after one zero byte from the register 1<<i."""
    t = _table()
    return tuple(t[(1 << i) & 0xFF] ^ ((1 << i) >> 8) for i in range(32))


def _apply(mat: tuple[int, ...], x: int) -> int:
    out = 0
    for i in range(32):
        if (x >> i) & 1:
            out ^= mat[i]
    return out


def _compose(a: tuple[int, ...], b: tuple[int, ...]) -> tuple[int, ...]:
    """a after b."""
    return tuple(_apply(a, col) for col in b)


@functools.lru_cache(maxsize=64)
def _zero_bytes_map(n: int) -> tuple[int, ...]:
    """Z^n, by squaring."""
    result = tuple(1 << i for i in range(32))
    power = _zero_byte_map()
    while n:
        if n & 1:
            result = _compose(power, result)
        power = _compose(power, power)
        n >>= 1
    return result


def _apply_rows(mat: tuple[int, ...], x: torch.Tensor) -> torch.Tensor:
    """Z-style matrix times each int64 register in x."""
    out = torch.zeros_like(x)
    for i in range(32):
        out ^= ((x >> i) & 1) * mat[i]
    return out


def _lane_len(length: int) -> int:
    lane = MAX_LANE
    while length % lane:
        lane //= 2
    return lane


def crc32c_rows(rows: torch.Tensor) -> torch.Tensor:
    """(n, L) uint8 -> (n,) int64: the CRC32C of each row."""
    if rows.dtype != torch.uint8 or rows.dim() != 2:
        raise ValueError(f"crc32c_rows takes (n, L) uint8, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    n, length = rows.shape
    dev = rows.device
    if length == 0:
        return torch.zeros(n, dtype=torch.int64, device=dev)
    lane = _lane_len(length)
    lanes = length // lane
    cols = rows.reshape(n * lanes, lane).t().contiguous()   # (lane, n*lanes)
    table = torch.tensor(_table(), dtype=torch.int64, device=dev)
    crc = torch.zeros(n * lanes, dtype=torch.int64, device=dev)
    for i in range(lane):
        crc = table[(crc ^ cols[i]) & 0xFF] ^ (crc >> 8)
    del cols
    crc = crc.reshape(n, lanes)
    span = lane
    while crc.shape[1] > 1:
        if crc.shape[1] % 2:
            # a zero lane in front changes no raw CRC
            crc = torch.cat([torch.zeros_like(crc[:, :1]), crc], dim=1)
        crc = _apply_rows(_zero_bytes_map(span), crc[:, 0::2]) ^ crc[:, 1::2]
        span *= 2
    preset = _apply(_zero_bytes_map(length), _MASK) ^ _MASK
    return crc[:, 0] ^ preset


# --- GF(2^8) and RAID-6 -------------------------------------------------------

def gf_mul(a: int, b: int) -> int:
    """a * b in GF(2^8) modulo GF_POLY, by shift and add."""
    out = 0
    while b:
        if b & 1:
            out ^= a
        a <<= 1
        if a & 0x100:
            a ^= GF_POLY
        b >>= 1
    return out


def gf_pow(a: int, e: int) -> int:
    out = 1
    for _ in range(e):
        out = gf_mul(out, a)
    return out


def gf_inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return next(b for b in range(1, 256) if gf_mul(a, b) == 1)


@functools.lru_cache(maxsize=8)
def _mul_table(device: str) -> torch.Tensor:
    """(256, 256) uint8: [c, x] = c * x."""
    vals = [gf_mul(c, x) for c in range(256) for x in range(256)]
    return torch.tensor(vals, dtype=torch.uint8, device=device).reshape(256, 256)


def _scale(c: int, shard: torch.Tensor) -> torch.Tensor:
    return _mul_table(str(shard.device))[c][shard.long()]


def q_coeff(s: int, k: int) -> int:
    """Q's coefficient of data shard s."""
    return gf_pow(GF_GEN, k - 1 - s)


def _check_stripes(data: torch.Tensor) -> None:
    if data.dtype != torch.uint8 or data.dim() != 3:
        raise ValueError(f"expected (n, k, L) uint8 data shards, got {data.dtype} "
                         f"{tuple(data.shape)}")


def raid6_p(data: torch.Tensor) -> torch.Tensor:
    """(n, k, L) uint8 data shards -> (n, L) uint8: P."""
    _check_stripes(data)
    p = data[:, 0].clone()
    for s in range(1, data.shape[1]):
        p ^= data[:, s]
    return p


def raid6_parity(data: torch.Tensor) -> torch.Tensor:
    """(n, k, L) uint8 data shards -> (n, 2, L) uint8: P, then Q."""
    p = raid6_p(data)
    k = data.shape[1]
    q = _scale(q_coeff(0, k), data[:, 0])
    for s in range(1, k):
        q ^= _scale(q_coeff(s, k), data[:, s])
    return torch.stack([p, q], dim=1)


def raid6_rebuild_one(shards: dict[int, torch.Tensor], lost: int,
                      k: int) -> torch.Tensor:
    """One lost data shard from the others and P (shard k) or, without P,
    from the others and Q (shard k+1): (L,) or (n, L) uint8."""
    others = [s for s in range(k) if s != lost]
    if k in shards:
        out = shards[k].clone()
        for s in others:
            out ^= shards[s]
        return out
    acc = shards[k + 1].clone()
    for s in others:
        acc ^= _scale(q_coeff(s, k), shards[s])
    return _scale(gf_inv(q_coeff(lost, k)), acc)
