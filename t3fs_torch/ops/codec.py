"""Host CRC32C: the fastest host path for the storage service's host-side
checksums (the client's per-chunk checksum, a replica's recompute after an
overwrite or a truncate, payloads below the device cutoff, the RPC envelope
and header CRCs).

Two tiers, as in the reference (t3fs/ops/codec.py):
  native -- the SSE4.2 CRC of the port's native storage library
            (csrc/chunk_engine.cpp, bound by storage/native_engine.py),
            built by the host compiler at first use and self-checked;
  ref    -- the pure-Python table loop (the correctness oracle), kept where
            no compiler is present.
`host_impl()` says which one runs.
"""

from __future__ import annotations

import threading

from t3fs_torch.ops.crc32c import crc32c_combine_ref, crc32c_ref

_lock = threading.Lock()
_native = None
_tried = False


def _load_native():
    global _native, _tried
    if _tried:
        return _native
    with _lock:
        if not _tried:
            try:
                from t3fs_torch.storage.native_engine import (
                    crc32c_combine_native, crc32c_native)

                # force the build now and self-check it, so a host without a
                # compiler falls back here instead of raising later
                if crc32c_native(b"123456789") != 0xE3069283:
                    raise RuntimeError("native crc32c self-check failed")
                _native = (crc32c_native, crc32c_combine_native)
            except (OSError, RuntimeError):
                # no compiler, or a library that fails its check: the host
                # keeps the table oracle (this is the host path, not the card)
                _native = None
            _tried = True
    return _native


def host_impl() -> str:
    """"native" where the port's host library built and its CRC passed the
    self-check, else "ref" (the table oracle)."""
    return "native" if _load_native() is not None else "ref"


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of any bytes-like object.  bytes and writable buffers pass
    without a copy; a read-only or non-contiguous view is copied once."""
    n = _load_native()
    if n is None:
        return crc32c_ref(bytes(data), crc)
    return n[0](data, crc)


def crc32c_combine(a: int, b: int, len_b: int) -> int:
    n = _load_native()
    if n is None:
        return crc32c_combine_ref(a, b, len_b)
    return n[1](a, b, len_b)
