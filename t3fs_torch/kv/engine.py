"""Transactional KV: interface + in-memory SSI engine + retry driver.

Reference analogs: common/kv/IKVEngine.h / ITransaction.h (snapshot get/range,
set, conflict ranges), common/kv/mem/ MemKVEngine (STM-style store used by
meta/mgmtd tests and single-node deploys), WithTransaction retry driver
(meta MetaStore.h:54-66 retryMaybeCommitted).

Concurrency model (serializable snapshot isolation, FDB-like):
  - a transaction reads at its snapshot version;
  - reads (point + range) are recorded as conflict ranges unless snapshot_*;
  - commit (atomic under the engine lock) aborts with TXN_CONFLICT if any
    conflict range saw a write with version > snapshot.

The port of t3fs/kv/engine.py (host code; no device work).
"""

from __future__ import annotations

import asyncio
import bisect
import random
import threading
from typing import Awaitable, Callable

from t3fs_torch.utils.status import StatusCode, StatusError, make_error


class Transaction:
    """One transaction against a MemKVEngine."""

    def __init__(self, engine: "MemKVEngine", read_version: int | None = None):
        self.engine = engine
        self.read_version = (engine._version if read_version is None
                             else read_version)
        self._writes: dict[bytes, bytes | None] = {}   # None = clear
        self._range_clears: list[tuple[bytes, bytes]] = []
        self._read_keys: set[bytes] = set()
        self._read_ranges: list[tuple[bytes, bytes]] = []
        self._committed = False

    # --- reads ---

    async def get(self, key: bytes, *, snapshot: bool = False) -> bytes | None:
        if key in self._writes:
            return self._writes[key]
        if not snapshot:
            self._read_keys.add(key)
        if any(b <= key < e for b, e in self._range_clears):
            return None  # read-your-writes across clear_range
        return self.engine._get_at(key, self.read_version)

    async def snapshot_get(self, key: bytes) -> bytes | None:
        return await self.get(key, snapshot=True)

    async def get_many(self, keys: list[bytes], *,
                       snapshot: bool = False) -> list[bytes | None]:
        """Point-read a batch at one snapshot.  Local engines answer from
        memory under ONE lock acquisition (an N-key batch paid N awaits
        + N lock round trips otherwise); the REMOTE engines override this
        into one RPC per shard — callers with N keys (batch_stat,
        readdirplus) should prefer it over N awaited get()s."""
        out: list[bytes | None] = [None] * len(keys)
        misses: list[tuple[int, bytes]] = []
        clears = self._range_clears
        for i, key in enumerate(keys):
            if key in self._writes:
                out[i] = self._writes[key]
                continue
            if not snapshot:
                self._read_keys.add(key)
            if clears and any(b <= key < e for b, e in clears):
                continue
            misses.append((i, key))
        if misses:
            vals = self.engine._get_at_many([k for _, k in misses],
                                            self.read_version)
            for (i, _k), val in zip(misses, vals):
                out[i] = val
        return out

    async def get_range(self, begin: bytes, end: bytes, *, limit: int = 0,
                        snapshot: bool = False) -> list[tuple[bytes, bytes]]:
        """Keys in [begin, end), sorted; limit 0 = unlimited."""
        if not snapshot:
            self._read_ranges.append((begin, end))
        base = dict(self.engine._range_at(begin, end, self.read_version))
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

    async def commit(self) -> None:
        assert not self._committed, "transaction reused after commit"
        await self.engine.commit_async(self)
        self._committed = True


class KVEngine:
    def transaction(self) -> Transaction:
        raise NotImplementedError

    def clear_all(self) -> None:
        raise NotImplementedError

    async def commit_async(self, txn: Transaction) -> None:
        """Engines whose commit blocks (fsync) override to offload the
        commit off the event loop; the in-memory commit stays inline."""
        self._commit(txn)

    async def commit_submit(self, txn: Transaction):
        """Pipelined commit, phase A: conflict-check + APPLY now, in call
        order (the caller serializes submits — KvService's applier loop).
        Returns an awaitable that completes when the commit is DURABLE
        (phase B).  Splitting the phases is what lets the service overlap
        N commits' fsyncs into one group-commit barrier while applies
        stay strictly ordered (the FDB commit-pipeline role,
        src/fdb/FDBTransaction.h analog).  Engines whose
        commit is already durable-on-apply get a completed phase B."""
        await self.commit_async(txn)
        fut = asyncio.get_running_loop().create_future()
        fut.set_result(None)
        return fut


class MemKVEngine(KVEngine):
    """In-memory multi-version store with SSI conflict checking."""

    def __init__(self):
        self._lock = threading.Lock()
        self._version = 0
        # key -> list of (version, value|None) appends, newest last
        self._data: dict[bytes, list[tuple[int, bytes | None]]] = {}
        self._sorted_keys: list[bytes] = []

    def transaction(self) -> Transaction:
        return Transaction(self)

    def clear_all(self) -> None:
        with self._lock:
            self._data.clear()
            self._sorted_keys.clear()
            self._version = 0

    # --- service accessors (KvService reads at explicit versions) ---

    def current_version(self) -> int:
        return self._version

    def applied_version(self) -> int:
        """The APPLIED MVCC version — distinct from current_version(),
        which durable engines clamp to the fsync watermark for reader
        visibility.  The commit pipeline chains new versions off this
        (admission must continue from what the engine really assigned)
        and stamps follower snapshots with it (the rows reflect applied
        state)."""
        return self._version

    def read_at(self, key: bytes, version: int) -> bytes | None:
        return self._get_at(key, version)

    def snapshot_rows(self) -> list[tuple[bytes, bytes]]:
        """ALL live rows at the current version — used for follower
        catch-up snapshots.  Unbounded by construction: a key-range scan
        with a finite end sentinel would silently drop keys sorting above
        the sentinel."""
        out = []
        with self._lock:
            for k in self._sorted_keys:
                for ver, val in reversed(self._data.get(k, ())):
                    if ver <= self._version:
                        if val is not None:
                            out.append((k, val))
                        break
        return out

    def range_at(self, begin: bytes, end: bytes, version: int,
                 limit: int = 0) -> list[tuple[bytes, bytes]]:
        rows = self._range_at(begin, end, version)
        return rows[:limit] if limit else rows

    # --- internals ---

    def _get_at(self, key: bytes, version: int) -> bytes | None:
        with self._lock:
            versions = self._data.get(key)
            if not versions:
                return None
            for ver, val in reversed(versions):
                if ver <= version:
                    return val
            return None

    def _get_at_many(self, keys: list[bytes],
                     version: int) -> list[bytes | None]:
        """Batch point-read under ONE lock acquisition (the engine-seam
        twin of _get_at; an N-key readdirplus batch would pay N lock
        round trips through per-key reads)."""
        out: list[bytes | None] = [None] * len(keys)
        with self._lock:
            data = self._data
            for i, key in enumerate(keys):
                versions = data.get(key)
                if not versions:
                    continue
                for ver, val in reversed(versions):
                    if ver <= version:
                        out[i] = val
                        break
        return out

    def _range_at(self, begin: bytes, end: bytes, version: int) -> list[tuple[bytes, bytes]]:
        out = []
        with self._lock:  # one pass under one acquisition
            lo = bisect.bisect_left(self._sorted_keys, begin)
            hi = bisect.bisect_left(self._sorted_keys, end)
            for k in self._sorted_keys[lo:hi]:
                for ver, val in reversed(self._data.get(k, ())):
                    if ver <= version:
                        if val is not None:
                            out.append((k, val))
                        break
        return out

    def _latest_write_version(self, key: bytes) -> int:
        versions = self._data.get(key)
        return versions[-1][0] if versions else 0

    def check_conflicts(self, txn: Transaction) -> None:
        """Conflict-check WITHOUT applying.  The replicated KvService uses
        this to validate a commit before shipping it to followers, so a
        replication failure leaves nothing applied on the primary."""
        with self._lock:
            self._check_conflicts_locked(txn)

    def advance_version(self, version: int) -> None:
        """Fast-forward the MVCC clock (never backward).  Followers call
        this with the primary's version so that version numbers stay
        comparable across a promotion: a client transaction pinned at the
        old primary's read_version must see consistent snapshots and real
        conflict detection on the new primary.  Not WAL-logged: a follower
        that crashes re-syncs via the replica-gap -> snapshot path, which
        re-advances the clock."""
        with self._lock:
            self._version = max(self._version, version)

    def _commit(self, txn: Transaction) -> None:
        with self._lock:
            self._check_conflicts_locked(txn)
            self._apply_locked(txn)

    def _check_conflicts_locked(self, txn: Transaction) -> None:
        """Abort if any tracked read was invalidated after the snapshot."""
        for key in txn._read_keys:
            if self._latest_write_version(key) > txn.read_version:
                raise make_error(StatusCode.TXN_CONFLICT, f"key {key!r}")
        for begin, end in txn._read_ranges:
            lo = bisect.bisect_left(self._sorted_keys, begin)
            hi = bisect.bisect_left(self._sorted_keys, end)
            for k in self._sorted_keys[lo:hi]:
                if self._latest_write_version(k) > txn.read_version:
                    raise make_error(StatusCode.TXN_CONFLICT, f"range key {k!r}")

    def _apply_locked(self, txn: Transaction) -> None:
        if not txn._writes and not txn._range_clears:
            return
        self._version += 1
        ver = self._version
        # expand range clears against current live keys
        for begin, end in txn._range_clears:
            lo = bisect.bisect_left(self._sorted_keys, begin)
            hi = bisect.bisect_left(self._sorted_keys, end)
            for k in self._sorted_keys[lo:hi]:
                if k not in txn._writes:
                    self._data.setdefault(k, []).append((ver, None))
        for key, val in txn._writes.items():
            if key not in self._data:
                bisect.insort(self._sorted_keys, key)
                self._data[key] = []
            self._data[key].append((ver, val))


async def with_transaction(engine: KVEngine,
                           fn: Callable[[Transaction], Awaitable],
                           *, max_retries: int = 10,
                           backoff_s: float = 0.001,
                           retry_maybe_committed: bool = False):
    """Run fn(txn) and commit, retrying on TXN_CONFLICT/TXN_RETRYABLE with
    jittered backoff (reference: TransactionRetry / retryMaybeCommitted).

    retry_maybe_committed=True additionally retries TXN_MAYBE_COMMITTED
    (a mutating commit whose RPC timed out and MAY have applied).  Only
    set it when fn is replay-safe — e.g. meta ops carrying idempotency
    records, whose re-execution reads the record the committed attempt
    wrote and returns it instead of double-applying (Idempotent.h /
    MetaStore.h:54-66 retryMaybeCommitted)."""
    retry_codes = {StatusCode.TXN_CONFLICT, StatusCode.TXN_RETRYABLE,
                   StatusCode.TXN_TOO_OLD}
    if retry_maybe_committed:
        retry_codes.add(StatusCode.TXN_MAYBE_COMMITTED)
    attempt = 0
    while True:
        txn = engine.transaction()
        try:
            result = await fn(txn)
            await txn.commit()
            return result
        except StatusError as e:
            if e.code not in retry_codes:
                raise
            attempt += 1
            if attempt > max_retries:
                raise
            await asyncio.sleep(backoff_s * (2 ** min(attempt, 8)) * random.random())
