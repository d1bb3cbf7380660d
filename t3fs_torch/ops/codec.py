"""Host CRC32C: the fastest host path for the storage service's host-side
checksums (the client's per-chunk checksum, a replica's recompute after an
overwrite or a truncate, payloads below the device cutoff, the RPC envelope
and header CRCs).

Two tiers, as in the reference (t3fs/ops/codec.py):
  native -- the port's own SSE4.2 library, csrc/host_crc32c.cc, built by the
            host compiler at first use and self-checked;
  ref    -- the pure-Python table loop (the correctness oracle), kept where
            no compiler is present.
`host_impl()` says which one runs.
"""

from __future__ import annotations

import ctypes
import threading

from t3fs_torch.ops.crc32c import crc32c_combine_ref, crc32c_ref

_lock = threading.Lock()
_native: ctypes.CDLL | None = None
_tried = False


def _load_native() -> ctypes.CDLL | None:
    global _native, _tried
    if _tried:
        return _native
    with _lock:
        if not _tried:
            try:
                from t3fs_torch.ops._build import host_library

                lib = host_library("host_crc32c")
                lib.t3fs_crc32c.argtypes = [ctypes.c_void_p, ctypes.c_uint64,
                                            ctypes.c_uint32]
                lib.t3fs_crc32c.restype = ctypes.c_uint32
                lib.t3fs_crc32c_combine.argtypes = [
                    ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint64]
                lib.t3fs_crc32c_combine.restype = ctypes.c_uint32
                if lib.t3fs_crc32c(b"123456789", 9, 0) != 0xE3069283:
                    raise RuntimeError("native crc32c self-check failed")
                _native = lib
            except (OSError, RuntimeError):
                # no compiler, or a library that fails its check: the host
                # keeps the table oracle (this is the host path, not the card)
                _native = None
            _tried = True
    return _native


def host_impl() -> str:
    """"native" where the port's host CRC library built and passed its
    self-check, else "ref" (the table oracle)."""
    return "native" if _load_native() is not None else "ref"


def crc32c(data, crc: int = 0) -> int:
    """CRC32C of any bytes-like object.  bytes and writable buffers pass
    without a copy; a read-only view is copied once."""
    lib = _load_native()
    if lib is None:
        return crc32c_ref(bytes(data), crc)
    if isinstance(data, bytes):
        return lib.t3fs_crc32c(data, len(data), crc)
    mv = data if isinstance(data, memoryview) else memoryview(data)
    if mv.readonly or not mv.c_contiguous:
        b = bytes(mv)
        return lib.t3fs_crc32c(b, len(b), crc)
    arr = (ctypes.c_ubyte * mv.nbytes).from_buffer(mv)
    return lib.t3fs_crc32c(arr, mv.nbytes, crc)


def crc32c_combine(a: int, b: int, len_b: int) -> int:
    lib = _load_native()
    if lib is None:
        return crc32c_combine_ref(a, b, len_b)
    return lib.t3fs_crc32c_combine(a, b, len_b)
