"""RemoteKVEngine: the transactional KV over the wire.

Reference analog: src/fdb/CustomKvEngine.h:14-29 — an external KV service
reached via cluster_endpoints, selected by the HybridKvEngine switch.  The
client mirrors the local Transaction surface exactly (meta/mgmtd code is
engine-agnostic): reads go to the primary at a pinned snapshot version,
writes buffer locally, and commit ships the read/write sets for the
server's atomic SSI conflict-check + apply.

Failover: the address list is probed in order; KV_NOT_PRIMARY and transport
errors rotate to the next address.  A transaction that started on a
now-dead primary fails with TXN_RETRYABLE, which with_transaction retries
from scratch against the new primary.
"""

from __future__ import annotations

import asyncio
import logging

from t3fs_torch.kv.engine import KVEngine
from t3fs_torch.kv.service import KvCommitReq, KvRangeReq, KvReadReq
from t3fs_torch.net.client import Client
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.kv.remote")


class RemoteTransaction:
    """Client-side transaction buffer mirroring kv.engine.Transaction."""

    def __init__(self, engine: "RemoteKVEngine"):
        self.engine = engine
        self.read_version: int | None = None
        self._writes: dict[bytes, bytes | None] = {}
        self._range_clears: list[tuple[bytes, bytes]] = []
        self._read_keys: set[bytes] = set()
        self._read_ranges: list[tuple[bytes, bytes]] = []
        self._committed = False
        # serializes snapshot pinning: concurrent first reads each
        # sending version=-1 would pin DIFFERENT versions into one txn
        self._pin_lock = asyncio.Lock()

    async def _ver(self) -> int:
        """Pinned snapshot version, acquiring it if this is the first
        read.  The read RPCs prefer _pin_version() — version=-1 folds the
        pin into the read itself (the server reads at current and returns
        the version), so a txn's first read costs ONE round trip, not two
        (per-read version RPCs would halve sharded batch_stat
        throughput)."""
        if self.read_version is None:
            # exactly-one pin RPC per txn: waiters queue on the lock
            # while the first reader fetches the snapshot version
            async with self._pin_lock:  # t3fslint: allow(async-lock-await-discipline)
                if self.read_version is None:
                    rsp = await self.engine._call("Kv.get_version", None)
                    self.read_version = rsp.version
        return self.read_version

    async def _pin_version(self):
        """Returns (version, pinned_here): version to send (-1 = fold the
        pin into this read), and whether the caller must record the
        response's version.  Holds the pin lock only while unpinned."""
        if self.read_version is not None:
            return self.read_version, False
        await self._pin_lock.acquire()
        if self.read_version is not None:
            self._pin_lock.release()
            return self.read_version, False
        return -1, True            # caller calls _pinned()/_pin_failed()

    def _pinned(self, version: int) -> None:
        self.read_version = version
        self._pin_lock.release()

    def _pin_failed(self) -> None:
        self._pin_lock.release()

    # --- reads ---

    async def get(self, key: bytes, *, snapshot: bool = False) -> bytes | None:
        if key in self._writes:
            return self._writes[key]
        if not snapshot:
            self._read_keys.add(key)
        if any(b <= key < e for b, e in self._range_clears):
            return None
        ver, pinning = await self._pin_version()
        try:
            rsp = await self.engine._call("Kv.read",
                                          KvReadReq(keys=[key], version=ver))
        except BaseException:
            if pinning:
                self._pin_failed()
            raise
        if pinning:
            self._pinned(rsp.version)
        return rsp.values[0] if rsp.found[0] else None

    async def snapshot_get(self, key: bytes) -> bytes | None:
        return await self.get(key, snapshot=True)

    async def get_many(self, keys: list[bytes], *,
                       snapshot: bool = False) -> list[bytes | None]:
        """Batched point reads: ONE RPC for the whole batch (the wire
        request always carried a keys list; the per-key client calls were
        the amplification)."""
        if not keys:
            return []
        out: list[bytes | None] = [None] * len(keys)
        fetch: list[tuple[int, bytes]] = []
        for i, key in enumerate(keys):
            if key in self._writes:
                out[i] = self._writes[key]
                continue
            if not snapshot:
                self._read_keys.add(key)
            if any(b <= key < e for b, e in self._range_clears):
                continue
            fetch.append((i, key))
        if fetch:
            ver, pinning = await self._pin_version()
            try:
                rsp = await self.engine._call(
                    "Kv.read",
                    KvReadReq(keys=[k for _, k in fetch], version=ver))
            except BaseException:
                if pinning:
                    self._pin_failed()
                raise
            if pinning:
                self._pinned(rsp.version)
            for (i, _k), v, found in zip(fetch, rsp.values, rsp.found):
                out[i] = v if found else None
        return out

    async def get_range(self, begin: bytes, end: bytes, *, limit: int = 0,
                        snapshot: bool = False) -> list[tuple[bytes, bytes]]:
        if not snapshot:
            self._read_ranges.append((begin, end))
        ver, pinning = await self._pin_version()
        try:
            rsp = await self.engine._call(
                "Kv.read_range",
                # fetch unlimited when local writes overlay: a write may
                # push a row out of the limit window
                KvRangeReq(begin=begin, end=end, version=ver,
                           limit=0 if self._writes or self._range_clears
                           else limit))
        except BaseException:
            if pinning:
                self._pin_failed()
            raise
        if pinning:
            self._pinned(rsp.version)
        base = dict(zip(rsp.keys, rsp.values))
        for k, v in self._writes.items():
            if begin <= k < end:
                if v is None:
                    base.pop(k, None)
                else:
                    base[k] = v
        for b, e in self._range_clears:
            for k in [k for k in base if b <= k < e and k not in self._writes]:
                base.pop(k)
        out = sorted(base.items())
        return out[:limit] if limit else out

    # --- writes ---

    def set(self, key: bytes, value: bytes) -> None:
        self._writes[key] = bytes(value)

    def clear(self, key: bytes) -> None:
        self._writes[key] = None

    def clear_range(self, begin: bytes, end: bytes) -> None:
        self._range_clears.append((begin, end))
        for k in list(self._writes):
            if begin <= k < end:
                self._writes[k] = None

    def add_read_conflict_key(self, key: bytes) -> None:
        self._read_keys.add(key)

    def add_read_conflict_range(self, begin: bytes, end: bytes) -> None:
        self._read_ranges.append((begin, end))

    # --- commit ---

    def to_commit_req(self) -> KvCommitReq:
        """The single wire encoding of this txn's read/write sets — used by
        both the one-shot commit and the sharded 2PC prepare
        (t3fs_torch/kv/shard.py), so the validations can't drift."""
        return KvCommitReq(
            read_version=self.read_version or 0,
            read_keys=sorted(self._read_keys),
            range_begins=[b for b, _ in self._read_ranges],
            range_ends=[e for _, e in self._read_ranges],
            write_keys=list(self._writes.keys()),
            write_values=[v if v is not None else b""
                          for v in self._writes.values()],
            write_deletes=[v is None for v in self._writes.values()],
            clear_begins=[b for b, _ in self._range_clears],
            clear_ends=[e for _, e in self._range_clears])

    async def validate_reads(self) -> None:
        """Ship the read set for SSI validation WITHOUT mutating — the
        sharded engine's multi-shard read-only path needs it: two shards
        pinned at different moments are not one snapshot, so each
        shard's reads must prove they still hold (t3fs_torch/kv/shard.py
        _commit_inner)."""
        if not (self._read_keys or self._read_ranges):
            return
        await self._ver()
        await self.engine._call("Kv.commit", self.to_commit_req(),
                                commit_ambiguous=False)

    async def commit(self) -> None:
        assert not self._committed, "transaction reused after commit"
        if not (self._writes or self._range_clears):
            # read-only: every read came from ONE pinned MVCC snapshot,
            # which is a consistent serializable cut by construction —
            # validation could only reject a still-correct result.  FDB
            # makes the same call (read-only commits don't visit the
            # resolver); otherwise every batch_stat/readdir on the remote
            # meta path would pay a full read-set RPC.
            self._committed = True
            return
        await self._ver()
        req = self.to_commit_req()
        await self.engine._call("Kv.commit", req, commit_ambiguous=True)
        self._committed = True


class RemoteKVEngine(KVEngine):
    """KVEngine over a replicated KvService deployment."""

    def __init__(self, addresses: list[str], client: Client | None = None,
                 timeout_s: float = 15.0):
        assert addresses
        self.addresses = list(addresses)
        self.client = client or Client()
        self.timeout_s = timeout_s
        self._active = 0        # index of the address last seen as primary

    def transaction(self) -> RemoteTransaction:
        return RemoteTransaction(self)

    async def _call(self, method: str, req, *, commit_ambiguous: bool = False):
        last: StatusError | None = None
        for probe in range(len(self.addresses)):
            idx = (self._active + probe) % len(self.addresses)
            try:
                rsp, _ = await self.client.call(
                    self.addresses[idx], method, req, timeout=self.timeout_s)
                self._active = idx
                return rsp
            except StatusError as e:
                last = e
                if commit_ambiguous and e.code in (
                        StatusCode.RPC_TIMEOUT, StatusCode.RPC_SEND_FAILED,
                        StatusCode.KV_REPLICATION_FAILED):
                    # a mutating commit whose RPC reached (or may have
                    # reached) the primary and then timed out MAY have
                    # applied — blind re-execution would double-apply.
                    # KV_REPLICATION_FAILED is ambiguous too: some follower
                    # may hold the batch and resurrect it after a failover.
                    # Surface the ambiguity (FDB commit_unknown_result /
                    # reference retryMaybeCommitted, MetaStore.h:54-66);
                    # idempotent callers (meta ops carry idempotency
                    # records) retry safely, others must check first.
                    raise make_error(
                        StatusCode.TXN_MAYBE_COMMITTED,
                        f"commit to {self.addresses[idx]} ambiguous: {e}"
                    ) from None
                if e.code in (StatusCode.KV_NOT_PRIMARY,
                              StatusCode.RPC_CONNECT_FAILED,
                              StatusCode.RPC_SEND_FAILED,
                              StatusCode.RPC_TIMEOUT):
                    continue    # probe the next address for the primary
                raise
        # no primary reachable: surface as retryable so with_transaction
        # restarts the whole transaction once one is promoted
        raise make_error(StatusCode.TXN_RETRYABLE,
                         f"no KV primary reachable: {last}")

    async def commit_async(self, txn) -> None:  # pragma: no cover - unused
        raise NotImplementedError("RemoteTransaction commits via RPC")

    def clear_all(self) -> None:
        raise NotImplementedError("clear_all is a local-engine test helper")

    async def close(self) -> None:
        await self.client.close()
