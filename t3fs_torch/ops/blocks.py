"""Block-size arithmetic (the port's copy of t3fs/ops/blocks.py)."""

from __future__ import annotations


def pick_block(total: int, preferred: int) -> int:
    """Largest divisor of `total` that is <= preferred (kernel work units
    must tile the axis exactly; chunk sizes are powers of two in practice
    but tests use arbitrary small lengths)."""
    b = min(preferred, total)
    while total % b:
        b -= 1
    return b
