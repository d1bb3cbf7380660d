"""Published peaks of the card and the least bytes each kernel must move.

A roofline share is the least time the card could take, the bytes the
algorithm needs at the HBM rate, over the kernel's device time: each input
byte read once and each output byte written once, whatever the kernel reads
again.  Bit work (CRC products, GF(2^8) shifts) has no rated peak, so the
bytes bound these kernels.
"""

from __future__ import annotations

# NVIDIA H100 SXM5 data sheet: 80 GB HBM3 at 3.35 TB/s (at its 700 W limit)
HBM_BYTES_PER_S = 3.35e12
# PCIe Gen5 x16, the card's host link: 64 GB/s in each direction
H2D_BYTES_PER_S = 64e9


def crc_bytes(rows: int, row_bytes: int) -> int:
    """B1: every row read once, one 4-byte CRC a row written."""
    return rows * (row_bytes + 4)


def raid6_encode_bytes(k: int, m: int, shard_bytes: int) -> int:
    """B2: k data shards read, m parity shards written."""
    return (k + m) * shard_bytes


def raid6_decode_bytes(k: int, nwant: int, shard_bytes: int) -> int:
    """B3: k survivors read, the wanted shards written."""
    return (k + nwant) * shard_bytes


def share_pct(nbytes: float, device_s: float) -> float | None:
    """The least time over the device time, in %; None where nothing ran."""
    if nbytes <= 0 or device_s <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / device_s


def layer_share(ctx, layer: str) -> float | None:
    """The roofline share of the kernels the cell's operation runs in
    `layer`, over the items the seam batched in the traced window."""
    if ctx.trace is None or layer not in ctx.op.kernels:
        return None
    names, per_item = ctx.op.kernels[layer]
    return share_pct(ctx.counters.get("batched_items", 0) * per_item,
                     ctx.trace.kernel_seconds(names))
