"""Durable transactional KV: WAL + snapshot over the in-memory SSI engine.

Reference analogs: the transactional-KV seam of src/fdb/ — HybridKvEngine
picks an engine {fdb | memkv | custom} behind IKVEngine
(HybridKvEngine.h:13-31); here the durable engine is a write-ahead log +
snapshot pair (the role FoundationDB plays for meta/mgmtd state), reusing
MemKVEngine's MVCC/SSI commit logic so transaction semantics are identical
across engines — exactly how the reference's tests swap memkv for fdb.

Files (under one directory):
  kv.snap     point-in-time latest-value dump  [tmp+rename, crc-framed]
  kv.wal      committed write batches since the snapshot  [crc-framed]

Crash atomicity: a commit is durable once its WAL frame is written (+fsync
in "always" mode).  A torn/corrupt tail frame is discarded on open —
commits are applied prefix-wise, like RocksDB WriteBatch recovery
(chunk_engine/README.md "Maintaining the Allocator's in-memory state").

The port of t3fs/kv/wal_engine.py (host code; no device work): the same
frames, so either package opens the other's directory.  open_kv_engine
takes "mem", "wal:", and the replicated and range-sharded deployments
("remote:", "shards:") over kv/{service,remote,shard}.
"""

from __future__ import annotations

import asyncio
import bisect
import logging
import os
import struct
import threading
import time
import zlib

from t3fs_torch.kv.engine import KVEngine, MemKVEngine, Transaction
from t3fs_torch.utils.status import StatusCode, make_error

log = logging.getLogger("t3fs_torch.kv")

_FRAME_HDR = struct.Struct("<II")     # payload_len, crc32(payload)
_SNAP_MAGIC = b"T3KVSNP1"
_WAL_MAGIC = b"T3KVWAL1"


def _pack_batch(writes: list[tuple[bytes, bytes | None]],
                range_clears: list[tuple[bytes, bytes]]) -> bytes:
    out = [struct.pack("<II", len(writes), len(range_clears))]
    for k, v in writes:
        if v is None:
            out.append(struct.pack("<Iq", len(k), -1))
            out.append(k)
        else:
            out.append(struct.pack("<Iq", len(k), len(v)))
            out.append(k)
            out.append(v)
    for b, e in range_clears:
        out.append(struct.pack("<II", len(b), len(e)))
        out.append(b)
        out.append(e)
    return b"".join(out)


def _unpack_batch(buf: bytes):
    nw, nc = struct.unpack_from("<II", buf, 0)
    off = 8
    writes: list[tuple[bytes, bytes | None]] = []
    for _ in range(nw):
        klen, vlen = struct.unpack_from("<Iq", buf, off)
        off += 12
        k = buf[off:off + klen]
        off += klen
        if vlen < 0:
            writes.append((k, None))
        else:
            writes.append((k, buf[off:off + vlen]))
            off += vlen
    clears: list[tuple[bytes, bytes]] = []
    for _ in range(nc):
        blen, elen = struct.unpack_from("<II", buf, off)
        off += 8
        clears.append((buf[off:off + blen], buf[off + blen:off + blen + elen]))
        off += blen + elen
    return writes, clears


class WalKVEngine(MemKVEngine):
    """MemKVEngine whose committed batches are logged to disk and replayed
    on open.  sync: "always" fsyncs each commit (durable vs power loss),
    "os" leaves flushing to the page cache (durable vs process crash)."""

    def __init__(self, root: str, *, sync: str = "always",
                 compact_threshold_bytes: int = 8 << 20,
                 rate_mbps: float = 0.0):
        super().__init__()
        assert sync in ("always", "os")
        self.root = root
        self.sync = sync
        # write-bandwidth budget (<=0 disables): WAL appends draw from a
        # byte token bucket and SLEEP off any deficit under _io_lock, so
        # later appends queue behind the wait — the shape of a
        # bandwidth-capped volume (cloud disks meter MB/s per volume;
        # a range-sharded deployment multiplies aggregate budget by
        # adding volumes, which is what the KV distributor load-balances)
        self.rate_mbps = rate_mbps
        self._rate_bytes_s = rate_mbps * 1e6
        self._rate_capacity = max(self._rate_bytes_s, 1.0)  # ~1s of burst
        self._rate_tokens = self._rate_capacity
        self._rate_stamp: float | None = None
        self.rate_waits = 0
        self.rate_waited_s = 0.0
        self.compact_threshold_bytes = compact_threshold_bytes
        os.makedirs(root, exist_ok=True)
        self.snap_path = os.path.join(root, "kv.snap")
        self.wal_path = os.path.join(root, "kv.wal")
        self._io_lock = threading.Lock()
        self._wal_valid_end = 0
        self._load()
        if (os.path.exists(self.wal_path)
                and os.path.getsize(self.wal_path) > self._wal_valid_end):
            # discard the torn tail BEFORE appending — otherwise new frames
            # land after the tear and every future replay stops short of them
            with open(self.wal_path, "r+b") as f:
                f.truncate(self._wal_valid_end)
        # unbuffered: write() reaches the OS or raises — a Python-level
        # buffer could replay an aborted frame on a later flush
        self._wal = open(self.wal_path, "ab", buffering=0)
        self._broken = False
        if self._wal.tell() == 0:
            self._wal.write(_WAL_MAGIC)
        # GROUP COMMIT state: concurrent committers append their frames
        # under _io_lock and then meet at a durability barrier where ONE
        # leader's fsync covers every frame appended so far — N
        # concurrent commits pay ~1 fsync instead of N (the reference
        # gets this from FDB; a per-commit fsync made the multi-process
        # meta create path 1.7k/s on a disk that batches far higher).
        # Watermark is (epoch, pos); _wal_epoch bumps on WAL rotation
        # (compaction), whose snapshot fsync covers every earlier frame.
        self._sync_cv = threading.Condition()
        self._wal_epoch = 0              # written under _io_lock
        self._synced_epoch = 0           # watermark, under _sync_cv
        self._synced_upto = 0
        self._sync_leader = False
        # bumped by clear_all: a committer parked at the barrier across a
        # wipe must NOT ratchet the durable watermark back up afterwards
        # (its frame's data is gone; see _commit / clear_all)
        self._clear_gen = 0              # written under _io_lock+_sync_cv
        # rotation defers closing the outgoing WAL one epoch so a
        # leader's out-of-lock fsync of the previous epoch stays valid
        self._prev_wal = None
        # read-visibility watermark: snapshots open at the last DURABLE
        # version, so a reader can never externalize state a crash
        # would erase (applied-but-unsynced frames are invisible until
        # their group's fsync lands)
        self._durable_version = self._version
        self.fsyncs = 0                  # observability: barrier fsyncs
        # dedicated commit pool: the loop's default executor is cpu+4
        # threads, which would cap the group size at ~5 — barrier
        # waiters are parked threads, so a wide pool is cheap
        from concurrent.futures import ThreadPoolExecutor
        self._commit_pool = ThreadPoolExecutor(
            max_workers=32, thread_name_prefix="t3fs-wal")

    def current_version(self) -> int:
        """Snapshots open at the DURABLE watermark under sync="always":
        group commit applies frames to memory before their fsync lands,
        and a reader must not externalize state a crash would erase.
        (A committer's own ack always follows the barrier, so its next
        snapshot includes its write.)"""
        if self.sync != "always":
            return super().current_version()
        with self._sync_cv:
            return self._durable_version

    def transaction(self) -> Transaction:
        """Embedded-path snapshots must honor the durable-read watermark
        too: meta/mgmtd running directly on a wal: engine open their
        transactions here, and pinning at the applied (possibly
        un-fsynced) _version would externalize state a crash erases —
        the exact guarantee current_version() documents."""
        return Transaction(self, read_version=self.current_version())

    def advance_version(self, version: int) -> None:
        """Follower clock fast-forward (see MemKVEngine.advance_version).
        The versions being skipped carry no local WAL frames — the
        caller's adjacent replicated-batch / snapshot fsync covers the
        state they name — so the durable watermark may advance up to
        `version` with them.  Capped at `version` (not _version): any
        locally-applied-but-unsynced frames above it must stay
        invisible."""
        super().advance_version(version)
        if self.sync == "always":
            with self._sync_cv:
                self._durable_version = max(
                    self._durable_version, min(version, self._version))

    # --- recovery ---

    def _load(self) -> None:
        if os.path.exists(self.snap_path):
            with open(self.snap_path, "rb") as f:
                data = f.read()
            if data[:8] == _SNAP_MAGIC and len(data) >= 8 + _FRAME_HDR.size:
                payload = data[8 + _FRAME_HDR.size:]
                plen, crc = _FRAME_HDR.unpack_from(data, 8)
                if len(payload) == plen and zlib.crc32(payload) == crc:
                    writes, _ = _unpack_batch(payload)
                    self._version = 1
                    for k, v in writes:
                        self._apply_loaded(k, v, 1)
                else:
                    # a post-compaction WAL is near-empty: booting without
                    # the snapshot is near-total data loss — say so loudly
                    log.critical(
                        "snapshot %s is CORRUPT (crc/length mismatch); "
                        "starting from WAL alone — state may be missing "
                        "everything before the last compaction",
                        self.snap_path)
            else:
                log.critical("snapshot %s is CORRUPT (bad magic/truncated); "
                             "starting from WAL alone", self.snap_path)
        if os.path.exists(self.wal_path):
            with open(self.wal_path, "rb") as f:
                data = f.read()
            off = len(_WAL_MAGIC) if data[:8] == _WAL_MAGIC else 0
            self._wal_valid_end = off
            while off + _FRAME_HDR.size <= len(data):
                plen, crc = _FRAME_HDR.unpack_from(data, off)
                start = off + _FRAME_HDR.size
                payload = data[start:start + plen]
                if len(payload) != plen or zlib.crc32(payload) != crc:
                    break  # torn tail: stop replay here
                writes, clears = _unpack_batch(payload)
                self._version += 1
                ver = self._version
                for b, e in clears:
                    lo = bisect.bisect_left(self._sorted_keys, b)
                    hi = bisect.bisect_left(self._sorted_keys, e)
                    for k in self._sorted_keys[lo:hi]:
                        self._data.setdefault(k, []).append((ver, None))
                for k, v in writes:
                    self._apply_loaded(k, v, ver)
                off = start + plen
                self._wal_valid_end = off

    def _apply_loaded(self, k: bytes, v: bytes | None, ver: int) -> None:
        if k not in self._data:
            bisect.insort(self._sorted_keys, k)
            self._data[k] = []
        self._data[k].append((ver, v))

    # --- durable commit ---

    async def commit_async(self, txn: Transaction) -> None:
        if not txn._writes and not txn._range_clears:
            # read-only: no WAL, no fsync — conflict-check inline rather than
            # paying two thread hops on every stat/readdir/open
            self._commit(txn)
            return
        # durable commits run in the engine's own worker pool so a slow
        # disk doesn't stall the node's event loop (all locks below are
        # threading locks, so cross-thread commit is safe) and so the
        # group-commit barrier can gather a full window of waiters
        fut = asyncio.get_running_loop().run_in_executor(
            self._commit_pool, self._commit, txn)
        try:
            await asyncio.shield(fut)
        except asyncio.CancelledError:
            # The thread may still complete the append+fsync: the commit is
            # maybe-committed from the caller's view (same contract as any
            # distributed KV commit interrupted by cancellation).  Consume
            # the outcome so a late error — e.g. ValueError when close()
            # already closed the WAL before a queued commit started — isn't
            # logged as a never-retrieved exception.
            fut.add_done_callback(lambda f: f.cancelled() or f.exception())
            raise

    async def commit_submit(self, txn: Transaction):
        """Pipelined commit: phase A (conflict-check + WAL append + apply,
        atomic under _io_lock, in the caller's submit order) runs before
        this returns; the returned awaitable is phase B (the group-commit
        durability barrier).  A caller that overlaps N phase-B waits pays
        ~1 fsync for the whole window — the engine-level group commit
        finally sees concurrent frames (KvService serialized commit_async
        end-to-end, so the barrier never had company)."""
        loop = asyncio.get_running_loop()
        fut = loop.run_in_executor(self._commit_pool, self._commit_phase_a,
                                   txn)
        try:
            tokens = await asyncio.shield(fut)
        except asyncio.CancelledError:
            fut.add_done_callback(lambda f: f.cancelled() or f.exception())
            raise
        if tokens is None or self.sync != "always":
            done = loop.create_future()
            done.set_result(None)
            return done
        barrier = loop.run_in_executor(self._commit_pool,
                                       self._commit_phase_b, *tokens)
        # consume a late error even if the awaiting caller is cancelled:
        # the barrier thread cannot be interrupted and its failure would
        # otherwise log as a never-retrieved exception
        barrier.add_done_callback(lambda f: f.cancelled() or f.exception())
        return barrier

    def _commit(self, txn: Transaction) -> None:
        tokens = self._commit_phase_a(txn)
        if tokens is not None and self.sync == "always":
            self._commit_phase_b(*tokens)

    def _charge_rate(self, nbytes: int) -> None:
        """Caller holds _io_lock (commit-pool thread: blocking sleep is
        fine, the event loop never runs here).  TokenBucketPacer shape —
        a deficit is slept off, never an error."""
        if self._rate_bytes_s <= 0:
            return
        now = time.monotonic()
        if self._rate_stamp is not None:
            self._rate_tokens = min(
                self._rate_capacity,
                self._rate_tokens
                + (now - self._rate_stamp) * self._rate_bytes_s)
        self._rate_stamp = now
        take = min(float(nbytes), self._rate_capacity)
        if self._rate_tokens < take:
            wait = (take - self._rate_tokens) / self._rate_bytes_s
            self.rate_waits += 1
            self.rate_waited_s += wait
            time.sleep(wait)
            self._rate_stamp = time.monotonic()
            self._rate_tokens = take     # earned exactly the deficit
        self._rate_tokens -= take

    def _commit_phase_a(self, txn: Transaction) -> tuple | None:
        end_pos = epoch = gen = my_version = None
        with self._io_lock:
            # standard WAL ordering: conflict-check, LOG, then apply — a
            # failed append must leave memory untouched, or restart silently
            # diverges (lost batch, persisted dependents).  check+append+
            # apply stay atomic under _io_lock (so SSI conflict checks see
            # every earlier commit's writes); the FSYNC moves to a group
            # barrier AFTER the lock.  A reader may briefly observe a
            # not-yet-durable write, but (a) the committer's ACK waits for
            # the barrier, and (b) any commit derived from such a read
            # appends LATER in the WAL, so replay can never keep the
            # derived state while losing its source (prefix property) —
            # the standard group-commit argument.
            with self._lock:
                self._check_conflicts_locked(txn)
            writes = list(txn._writes.items())
            clears = list(txn._range_clears)
            if writes or clears:
                if self._broken:
                    raise make_error(
                        StatusCode.INTERNAL,
                        "WAL is failed (earlier append error); "
                        "reopen the engine")
                payload = _pack_batch(writes, clears)
                self._charge_rate(_FRAME_HDR.size + len(payload))
                pos = self._wal.tell()
                try:
                    self._wal.write(_FRAME_HDR.pack(len(payload),
                                                    zlib.crc32(payload))
                                    + payload)
                except OSError:
                    # drop the torn frame so later commits don't land
                    # beyond a tear that replay will stop at; if even
                    # that fails, refuse all further commits — anything
                    # appended past a tear would be silently lost
                    try:
                        os.ftruncate(self._wal.fileno(), pos)
                        self._wal.seek(pos)
                    except OSError:
                        self._broken = True
                        log.critical(
                            "WAL %s: failed append AND failed truncate; "
                            "engine is read-only until reopen",
                            self.wal_path)
                    raise
                end_pos = self._wal.tell()
                epoch = self._wal_epoch
                gen = self._clear_gen
            with self._lock:
                self._apply_locked(txn)
                my_version = self._version
            if self._wal.tell() >= self.compact_threshold_bytes:
                self._compact_locked()
                epoch = None          # rotation's snapshot fsync covers us
        if end_pos is None:
            return None
        return (epoch, end_pos, gen, my_version)

    def _commit_phase_b(self, epoch, end_pos, gen, my_version) -> None:
        if epoch is not None:
            self._group_fsync(epoch, end_pos)
        # versions are assigned in WAL-append order (both under
        # _io_lock), so the barrier covering our frame covers every
        # version <= ours: advance the read-visibility watermark.
        # Skip if clear_all ran while we were parked at the barrier
        # (generation mismatch): our frame's data was wiped and the
        # clock reset, so ratcheting the watermark back up would
        # reopen the durable>_version hole clear_all closes.
        with self._sync_cv:
            if (gen == self._clear_gen
                    and my_version > self._durable_version):
                self._durable_version = my_version

    def _covered(self, epoch: int, end_pos: int) -> bool:
        """Caller holds _sync_cv."""
        return (self._synced_epoch > epoch
                or (self._synced_epoch == epoch
                    and self._synced_upto >= end_pos))

    def _group_fsync(self, epoch: int, end_pos: int) -> None:
        """Durability barrier: returns once the frame ending at (epoch,
        end_pos) is fsync-covered.  One waiter becomes the leader and
        fsyncs; the rest sleep on the condvar until the leader advances
        the watermark (their frames were appended before the leader read
        tell(), so one fsync covers the whole group).

        The fsync runs OUTSIDE _io_lock (appends overlap the flush —
        that is group commit's pipelining); rotation keeps the previous
        epoch's file object alive one epoch (self._prev_wal), so a
        leader flushing epoch e is safe across one concurrent rotation,
        and a second rotation's EBADF/ValueError is benign because that
        rotation's snapshot fsync already over-covered epoch e.

        An fsync FAILURE is terminal (the kernel reports a writeback
        error once and may mark the failed pages clean — a retry could
        spuriously "succeed", acking lost data): the engine goes broken,
        the un-durable WAL tail past the watermark is truncated so the
        FAILED commits cannot resurrect on replay, and every parked
        waiter raises instead of electing a new leader."""
        while True:
            with self._sync_cv:
                while not self._covered(epoch, end_pos):
                    if self._broken:
                        raise make_error(
                            StatusCode.INTERNAL,
                            "WAL fsync failed; commit durability unknown "
                            "— engine is read-only until reopen")
                    if not self._sync_leader:
                        self._sync_leader = True
                        break
                    self._sync_cv.wait()
                else:
                    return
            # we are the leader (outside the cv; never holding both)
            with self._io_lock:
                wal = self._wal
                target_epoch = self._wal_epoch
                target = self._wal.tell()
            try:
                os.fsync(wal.fileno())
            except ValueError:
                # file closed by a SECOND rotation since our append: its
                # snapshot fsync over-covered us; release and re-check
                with self._sync_cv:
                    self._sync_leader = False
                    self._sync_cv.notify_all()
                continue
            except OSError:
                self._fsync_failed()
                raise make_error(
                    StatusCode.INTERNAL,
                    "WAL fsync failed; commit durability unknown — "
                    "engine is read-only until reopen")
            self.fsyncs += 1
            with self._sync_cv:
                if (target_epoch > self._synced_epoch
                        or (target_epoch == self._synced_epoch
                            and target > self._synced_upto)):
                    self._synced_epoch = target_epoch
                    self._synced_upto = target
                self._sync_leader = False
                self._sync_cv.notify_all()
                # loop: re-check coverage (a rotation between our append
                # and the fsync can only OVER-cover, never under)

    def _fsync_failed(self) -> None:
        """Terminal fsync failure: brick the engine and drop the
        un-durable WAL tail so commits whose callers saw an ERROR can
        never resurrect on replay."""
        with self._io_lock:
            self._broken = True
            try:
                with self._sync_cv:
                    keep = self._synced_upto \
                        if self._wal_epoch == self._synced_epoch \
                        else len(_WAL_MAGIC)
                os.ftruncate(self._wal.fileno(), keep)
            except (OSError, ValueError):
                log.critical("WAL %s: could not truncate past the failed "
                             "fsync; un-acked frames may replay on reopen",
                             self.wal_path)
        log.critical("WAL %s: fsync failed; engine is read-only until "
                     "reopen", self.wal_path)
        with self._sync_cv:
            self._sync_leader = False
            self._sync_cv.notify_all()     # waiters wake and raise

    # --- compaction ---

    def compact(self) -> None:
        with self._io_lock:
            self._compact_locked()

    def clear_all(self) -> None:
        """Wipe memory AND durable state.  The inherited (memory-only)
        clear_all would let pre-clear WAL frames replay on restart and
        resurrect keys that a subsequent snapshot load (KvService follower
        catch-up) had deleted cluster-wide."""
        # the wipe, the empty snapshot, and the watermark reset are ONE
        # step under _io_lock (commits serialize behind it), and the
        # watermark drops FIRST: readers take only _sync_cv, so a reset
        # after the wipe would leave a window where a cross-thread
        # reader opens read_version above the wiped clock — stale-high
        # watermarks make SSI checks unsound.  Dropping early just shows
        # them the empty post-clear view a moment sooner.  The
        # generation bump stops barrier stragglers from ratcheting the
        # watermark back up, and _compact_locked's own ratchet runs after
        # _version is already 0.
        with self._io_lock:
            with self._sync_cv:
                self._clear_gen += 1
                self._durable_version = 0
            super().clear_all()
            self._compact_locked()   # empty snapshot + fresh WAL

    def _compact_locked(self) -> None:
        with self._lock:
            latest = []
            for k in self._sorted_keys:
                versions = self._data.get(k)
                if versions and versions[-1][1] is not None:
                    latest.append((k, versions[-1][1]))
        payload = _pack_batch(latest, [])
        tmp = self.snap_path + ".tmp"
        with open(tmp, "wb") as f:
            f.write(_SNAP_MAGIC)
            f.write(_FRAME_HDR.pack(len(payload), zlib.crc32(payload)))
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snap_path)
        if self.sync == "always":
            # the RENAME must be durable before the WAL truncates: on a
            # crash some filesystems persist the truncated WAL but not
            # the directory entry, booting the OLD snapshot + empty WAL
            # — fsync the directory between the two
            dfd = os.open(self.root, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        # snapshot durable -> WAL can restart.  Close is DEFERRED one
        # epoch: a group-commit leader may be fsyncing the outgoing fd
        # outside _io_lock right now
        if self._prev_wal is not None:
            self._prev_wal.close()
        self._prev_wal = self._wal
        self._wal = open(self.wal_path, "wb", buffering=0)
        self._wal.write(_WAL_MAGIC)
        if self.sync == "always":
            os.fsync(self._wal.fileno())
        # rotation: the snapshot fsync above covers every frame (and so
        # every applied version) of the old epoch — release any
        # group-commit waiters parked on them
        with self._sync_cv:
            self._wal_epoch += 1
            self._synced_epoch = self._wal_epoch
            self._synced_upto = self._wal.tell()
            self._durable_version = max(self._durable_version,
                                        self._version)
            self._sync_cv.notify_all()

    def close(self) -> None:
        self._commit_pool.shutdown(wait=True, cancel_futures=True)
        with self._io_lock:
            if self._prev_wal is not None and not self._prev_wal.closed:
                self._prev_wal.close()
            if not self._wal.closed:
                self._wal.flush()
                if self.sync == "always":
                    os.fsync(self._wal.fileno())
                self._wal.close()


def open_kv_engine(spec: str) -> KVEngine:
    """HybridKvEngine-style selector (HybridKvEngine.h:13-31):
      "mem"                       in-memory SSI engine (tests, single node)
      "wal:/path[?sync=os][&rate_mbps=N]"
                                  durable WAL+snapshot engine at /path;
                                  rate_mbps caps WAL append bandwidth
                                  (a per-volume budget: appends queue
                                  behind the token bucket)
      "remote:host:p,host:p"      replicated KvService deployment
                                  (CustomKvEngine cluster_endpoints analog)
      "shards:a:p,a:p;<hexkey>;a:p,..."
                                  range-sharded deployment: ';'-separated
                                  alternation of address groups and hex
                                  split keys, e.g.
                                  "shards:h1:1,h2:1;494e4f44;h3:1"
                                  = group1 [b'' .. b'INOD'), group2 rest
    """
    if spec == "mem":
        return MemKVEngine()
    if spec.startswith("shards:"):
        from t3fs_torch.kv.shard import (
            KEY_MAX, ShardMap, ShardRange, ShardedKVEngine,
        )
        parts = spec[len("shards:"):].split(";")
        if len(parts) % 2 != 1:
            raise ValueError(
                "shards spec must alternate group;splitkey;group;...")
        groups = [p.split(",") for p in parts[0::2]]
        splits = [bytes.fromhex(p) for p in parts[1::2]]
        bounds = [b""] + splits + [KEY_MAX]
        # the FIRST group doubles as the map home: when surgery has
        # published a versioned map there, clients converge to it (the
        # spec's static layout is just the bootstrap routing)
        return ShardedKVEngine(ShardMap(ranges=[
            ShardRange(begin=bounds[i], end=bounds[i + 1],
                       addresses=groups[i])
            for i in range(len(groups))]),
            map_home=groups[0])
    if spec.startswith("remote:"):
        from t3fs_torch.kv.remote import RemoteKVEngine
        return RemoteKVEngine(spec[len("remote:"):].split(","))
    if spec.startswith("wal:"):
        rest = spec[4:]
        sync = "always"
        rate_mbps = 0.0
        if "?" in rest:
            rest, q = rest.split("?", 1)
            for part in q.split("&"):
                k, _, v = part.partition("=")
                if k == "sync":
                    sync = v
                elif k == "rate_mbps":
                    rate_mbps = float(v)
        return WalKVEngine(rest, sync=sync, rate_mbps=rate_mbps)
    raise ValueError(f"unknown kv engine spec: {spec!r}")
