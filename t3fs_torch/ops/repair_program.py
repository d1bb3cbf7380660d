"""Repair programs: scheduled GF(2^8) linear combinations for EC repair.

The port's own copy of t3fs/ops/repair_program.py (t3fs_torch never imports
the JAX package); programs must stay identical with the reference's.

A single-shard repair is one row of a decode matrix: the lost shard is
sum_i c_i * helper_i over GF(2^8).  The row is scheduled as one shared
program instead of a private xtimes ladder per helper:

    result = sum_b x^b * S_b      where  S_b = XOR of helpers with bit b set

evaluated Horner-style from the top bit down: at most 7 xtimes ops in total
regardless of helper count, plus popcount(c_i) XORs per helper.  All-ones
rows (RAID-6 P repair, LRC local-parity repair) collapse to a pure XOR fold.

The program is host-built once per coefficient row and handed to the CUDA
repair kernel as one helper bitmask per plane (tables.repair_tables);
`eval_program_np` is the bit-exact numpy reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np

from t3fs_torch.ops.rs import RSCode, default_rs


@dataclass(frozen=True)
class RepairProgram:
    """Scheduled evaluation of sum_i coeffs[i] * helper_i over GF(2^8).

    planes[b] lists the helper indices whose coefficient has bit b set;
    trailing all-empty planes are trimmed so len(planes)-1 == top bit.
    xor_ops / xtimes_ops are the scheduled device-op counts (per word);
    naive_xtimes_ops is what the per-helper ladder would have cost."""

    coeffs: tuple[int, ...]
    planes: tuple[tuple[int, ...], ...]
    is_xor: bool
    xor_ops: int
    xtimes_ops: int
    naive_xtimes_ops: int

    @property
    def num_helpers(self) -> int:
        return len(self.coeffs)


def schedule_repair_program(coeffs: Sequence[int]) -> RepairProgram:
    """Build the bit-plane/Horner schedule for one GF(2^8) coefficient row.

    All coefficients must be in 1..255: zero-coefficient helpers carry no
    information and must be dropped by the caller before scheduling."""
    cs = tuple(int(c) for c in coeffs)
    if not cs:
        raise ValueError("repair program needs at least one helper")
    for c in cs:
        if not 0 < c < 256:
            raise ValueError(f"coefficient {c} out of GF(2^8) range (or zero)")
    top = max(c.bit_length() for c in cs) - 1
    planes = tuple(
        tuple(i for i, c in enumerate(cs) if (c >> b) & 1)
        for b in range(top + 1))
    assert planes[top], cs
    xor_ops = sum(int(c).bit_count() for c in cs) - 1
    naive = sum(c.bit_length() - 1 for c in cs)
    return RepairProgram(coeffs=cs, planes=planes, is_xor=(top == 0),
                         xor_ops=xor_ops, xtimes_ops=top,
                         naive_xtimes_ops=naive)


def xor_program(num_helpers: int) -> RepairProgram:
    """The all-ones program: pure XOR fold (P-row / LRC-local repair)."""
    return schedule_repair_program((1,) * num_helpers)


def single_row_program(rs: RSCode | None, present: Sequence[int],
                       lost: int) -> RepairProgram:
    """Program rebuilding shard `lost` from the k shards in `present`."""
    rs = rs or default_rs()
    row = rs.reconstruct_gfmatrix(list(present), [lost])[0]
    return schedule_repair_program([int(c) for c in row])


def _xtimes_np(x: np.ndarray, poly_low: int) -> np.ndarray:
    hi = (x >> 7).astype(np.uint8)
    return (((x.astype(np.uint16) << 1) & 0xFF).astype(np.uint8)
            ^ (hi * np.uint8(poly_low)))


def eval_program_np(prog: RepairProgram, helpers: np.ndarray,
                    rs: RSCode | None = None) -> np.ndarray:
    """Numpy reference: helpers (h, L) uint8 -> (L,) uint8 rebuilt bytes,
    by the same schedule the kernel runs (Horner over bit planes)."""
    rs = rs or default_rs()
    helpers = np.ascontiguousarray(helpers, dtype=np.uint8)
    if helpers.ndim != 2 or helpers.shape[0] != prog.num_helpers:
        raise ValueError(f"helpers {helpers.shape} != (h={prog.num_helpers}, L)")
    poly_low = rs.gf.poly & 0xFF

    def plane_sum(idx: tuple[int, ...]) -> np.ndarray | None:
        acc = None
        for i in idx:
            acc = helpers[i].copy() if acc is None else acc ^ helpers[i]
        return acc

    top = len(prog.planes) - 1
    acc = plane_sum(prog.planes[top])
    for b in range(top - 1, -1, -1):
        acc = _xtimes_np(acc, poly_low)
        s = plane_sum(prog.planes[b])
        if s is not None:
            acc ^= s
    return acc
