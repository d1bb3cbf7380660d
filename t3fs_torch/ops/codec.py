"""Host CRC32C for payloads below the device cutoff.

The reference's fast host CRC is the native SSE4.2 library under
t3fs/native, which the port may not load; until the port carries its own
native build, the host path is the port's copy of the table-driven oracle.
It serves payloads below 64 KiB only (the device backend's cutoff), where a
table loop costs tens of milliseconds at most.
"""

from __future__ import annotations

from t3fs_torch.ops.crc32c import crc32c_combine_ref, crc32c_ref


def crc32c(data: bytes, crc: int = 0) -> int:
    return crc32c_ref(data, crc)


def crc32c_combine(a: int, b: int, len_b: int) -> int:
    return crc32c_combine_ref(a, b, len_b)
