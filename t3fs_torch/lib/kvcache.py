"""KVCache store: block-oriented LLM KV-cache over the chunk layer.

Reference analog: the KVCache workload in README.md:45-51 — a cost-effective
alternative to DRAM caching of inference KV state, with a peak read
throughput figure (~40 GiB/s/cluster) and a GC removal-IOPS figure.  In the
reference this is an *application* of 3FS (files over chunks); t3fs ships it
as a first-class library because the mapping is pure chunk I/O: cache blocks
never need directories, sessions, or file lengths, so the meta service can
stay out of the hot path entirely (the same zero-metadata placement argument
as file striping, docs/design_notes.md:57-59).

Design:

- A **namespace** owns a slice of the 128-bit ChunkId space:
  ``inode = (1<<63) | blake2b-63(namespace)`` (the high bit keeps it disjoint
  from meta-allocated inode ids, which grow from 1), and each cache key maps
  to ``index = blake2b-64(key)``.  Chain placement is ``hash(key)`` over the
  namespace's chain list — clients compute placement with zero metadata
  involvement.
- **Blocks are self-describing**: [magic u32 | key_len u32 | value_len u32 |
  key | value].  A 64-bit index collision between two live keys makes the
  newer block win (cache-eviction semantics); `get` verifies the stored key
  and reports a clean miss on mismatch, never wrong bytes.
- **put** is one CRAQ chunk write (exactly-once via client channels);
  **get_many** is one `batch_read` fan-out grouped by serving node — the
  high-IOPS random-read path (BASELINE config #5); **remove_many** issues
  REMOVE updates through the same chains — the GC removal-IOPS path.
- **Prefix caching** (the LLM-serving access pattern): block keys form a
  rolling hash chain over token blocks, ``h_i = H(h_{i-1} || tokens_i)``, so
  a shared prompt prefix yields shared keys regardless of what follows.
  `longest_prefix` probes the whole chain with a single batched read.

Bench: ``t3fs_torch/benchmarks/kvcache_bench.py`` (get IOPS + GC removal IOPS).

The port of t3fs/lib/kvcache.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

import asyncio
import hashlib
import struct
from dataclasses import dataclass

from t3fs_torch.client.storage_client import StorageClient
from t3fs_torch.storage.types import ChunkId, ReadIO, UpdateType
from t3fs_torch.utils.status import Status, StatusCode, StatusError, make_error

_MAGIC = 0x7C3F5CAB
_HDR = struct.Struct("<III")


def _h64(data: bytes, *, person: bytes) -> int:
    return int.from_bytes(
        hashlib.blake2b(data, digest_size=8, person=person).digest(), "big")


def _pack_block(key: bytes, value: bytes) -> bytes:
    return _HDR.pack(_MAGIC, len(key), len(value)) + key + value


def _unpack_block(blob: bytes, key: bytes) -> bytes | None:
    """Return the value iff the block is intact and stores `key`."""
    if len(blob) < _HDR.size:
        return None
    magic, klen, vlen = _HDR.unpack_from(blob)
    if magic != _MAGIC or len(blob) < _HDR.size + klen + vlen:
        return None
    if blob[_HDR.size:_HDR.size + klen] != key:
        return None  # index collision: another key lives here
    off = _HDR.size + klen
    return bytes(blob[off:off + vlen])


@dataclass
class KVCacheConfig:
    block_size: int = 64 << 10        # chunk allocation class for blocks
    gc_concurrency: int = 64          # parallel REMOVEs in remove_many
    # hedged reads for the high-IOPS random-read get path: "on"/"off"
    # override the storage client's setting; "inherit" keeps it.  The cache
    # lookup is the first beneficiary of hedging (small IOs, tail-bound),
    # so it opts IN by default even when the client-wide default is off.
    read_hedging: str = "on"


class KVCacheStore:
    """One cache namespace over a set of chains.

    `chains` is the namespace's placement domain (typically a chain table's
    chains).  All methods are safe to call concurrently.
    """

    def __init__(self, client: StorageClient, chains: list[int],
                 namespace: str = "default",
                 config: KVCacheConfig | None = None):
        if not chains:
            raise make_error(StatusCode.INVALID_ARG, "empty chain list")
        self.client = client
        self.chains = list(chains)
        self.cfg = config or KVCacheConfig()
        self.namespace = namespace
        self.inode = (1 << 63) | _h64(namespace.encode(), person=b"t3fs-ns")

    @property
    def _hedging(self) -> str | None:
        """Per-call hedging override for this namespace's reads.  Derived
        lazily on every call — the old construction-time copy.copy(cfg)
        view went stale when the caller mutated client.cfg afterwards."""
        return None if self.cfg.read_hedging == "inherit" \
            else self.cfg.read_hedging

    # --- placement ---

    def locate(self, key: bytes) -> tuple[int, ChunkId]:
        idx = _h64(key, person=b"t3fs-key")
        chain = self.chains[_h64(key, person=b"t3fs-chn") % len(self.chains)]
        return chain, ChunkId(self.inode, idx)

    # --- data path ---

    async def put(self, key: bytes, value: bytes) -> int:
        """Store one block; returns the chunk's assigned update version —
        the fence a later conditional remove can use."""
        blob = _pack_block(key, value)
        if len(blob) > self.cfg.block_size:
            raise make_error(
                StatusCode.INVALID_ARG,
                f"block {len(blob)}B exceeds block_size {self.cfg.block_size}")
        chain, cid = self.locate(key)
        result = await self.client.write_chunk(
            chain, cid, 0, blob, self.cfg.block_size)
        st = Status(StatusCode(result.status.code), result.status.message)
        if st.code == StatusCode.CHUNK_STALE_UPDATE:
            # superseded: another writer committed a NEWER update to this
            # chunk while our (retried) write was in flight — under the
            # cache's hash-placement that is a racing put of the same key
            # (or a collided one), and last-writer-wins is exactly the
            # namespace's replay semantics.  Succeeding here is
            # indistinguishable from "mine landed, then the winner
            # overwrote it a microsecond later".  The result carries no
            # version for OUR update (it never committed); 0 = no fence
            return 0
        if not st.ok:
            raise StatusError(st.code, st.message)
        return result.update_ver

    async def get(self, key: bytes) -> bytes | None:
        values = await self.get_many([key])
        return values[0]

    async def get_many(self, keys: list[bytes],
                       stats: dict | None = None) -> list[bytes | None]:
        """One batched read across all keys; None = miss (absent, collided,
        or torn block — never wrong bytes).  `stats`, when provided,
        accumulates the read's hedge_fired/hedge_won/hedge_wasted counts."""
        ios = []
        for key in keys:
            chain, cid = self.locate(key)
            ios.append(ReadIO(chunk_id=cid, chain_id=chain, offset=0,
                              length=0,
                              verify_checksum=self.client.cfg.verify_checksums))
        results, payloads = await self.client.batch_read(
            ios, stats=stats, hedging=self._hedging)
        out: list[bytes | None] = []
        for key, result, payload in zip(keys, results, payloads):
            if result.status.code != int(StatusCode.OK):
                out.append(None)
            else:
                out.append(_unpack_block(payload, key))
        return out

    async def probe_many(self, keys: list[bytes]
                         ) -> list[tuple[bool, int]]:
        """Eviction's verify-read: for each key, (block stores this key,
        chunk update_ver) — reading only the header + key prefix, never
        the value bytes.  (False, 0) = absent; (False, ver) = an index
        collision overwrote this key's block (another key lives in the
        chunk).  The version is the fence a subsequent conditional
        remove_keys uses so a put racing the probe wins."""
        ios = []
        for key in keys:
            chain, cid = self.locate(key)
            ios.append(ReadIO(chunk_id=cid, chain_id=chain, offset=0,
                              length=_HDR.size + len(key)))
        results, payloads = await self.client.batch_read(
            ios, hedging=self._hedging)
        out: list[tuple[bool, int]] = []
        for key, result, payload in zip(keys, results, payloads):
            if result.status.code != int(StatusCode.OK) \
                    or len(payload) < _HDR.size:
                out.append((False, 0))
                continue
            magic, klen, _vlen = _HDR.unpack_from(payload)
            match = (magic == _MAGIC and klen == len(key)
                     and payload[_HDR.size:_HDR.size + klen] == key)
            out.append((match, result.update_ver))
        return out

    async def remove_keys(self, keys: list[bytes],
                          fences: list[int] | None = None) -> list[bool]:
        """REMOVE each key's block via its chain head; returns a per-key
        removed flag.  Removing an absent block is acked (idempotent GC).
        With `fences` (per-key expected update versions from probe_many),
        a remove answered CHUNK_STALE_UPDATE — the chunk was re-put past
        the fence — reports False and the newer block survives.
        Bounded-concurrent; the first hard error raises after every
        in-flight task settles."""
        sem = asyncio.Semaphore(self.cfg.gc_concurrency)
        flags = [False] * len(keys)

        async def one(i: int, key: bytes) -> None:
            chain, cid = self.locate(key)
            fence = fences[i] if fences is not None else 0
            async with sem:
                result = await self.client.write_chunk(
                    chain, cid, 0, b"", self.cfg.block_size,
                    update_type=UpdateType.REMOVE, remove_fence_ver=fence)
            code = StatusCode(result.status.code)
            if code in (StatusCode.OK, StatusCode.CHUNK_NOT_FOUND):
                flags[i] = True
            elif fence and code == StatusCode.CHUNK_STALE_UPDATE:
                flags[i] = False     # newer block won the race: keep it
            else:
                raise StatusError(code, result.status.message)

        # return_exceptions so a failing chain doesn't leave the other
        # in-flight REMOVE tasks running detached; first error raises after
        # every task has settled
        settled = await asyncio.gather(*(one(i, k)
                                         for i, k in enumerate(keys)),
                                       return_exceptions=True)
        for r in settled:
            if isinstance(r, BaseException):
                raise r
        return flags

    async def remove_many(self, keys: list[bytes]) -> int:
        """Unfenced bulk GC: number of acknowledged removals."""
        return sum(await self.remove_keys(keys))

    # --- LLM prefix-caching helpers ---

    @staticmethod
    def prefix_keys(model_tag: str, token_blocks: list[bytes]) -> list[bytes]:
        """Rolling-hash chain over token blocks: key_i commits to the model
        tag and ALL tokens up to block i, so equal prompt prefixes produce
        equal keys and any divergence changes every later key."""
        keys = []
        h = hashlib.blake2b(model_tag.encode(), digest_size=16,
                            person=b"t3fs-pfx").digest()
        for block in token_blocks:
            h = hashlib.blake2b(h + block, digest_size=16,
                                person=b"t3fs-pfx").digest()
            keys.append(h)
        return keys

    async def longest_prefix(self, model_tag: str,
                             token_blocks: list[bytes]
                             ) -> tuple[int, list[bytes]]:
        """(number of leading cached blocks, their values) — one batched
        read for the entire chain."""
        keys = self.prefix_keys(model_tag, token_blocks)
        values = await self.get_many(keys)
        out: list[bytes] = []
        for v in values:
            if v is None:
                break
            out.append(v)
        return len(out), out
