"""Fixed-capacity iov slot allocator shared by the ring data plane.

Both the usrbio bench's app loop and RingClient's staging arena carve a
flat iov into equal slots and need the same discipline: a slot handed to
an in-flight IO must never be reissued until that IO completes (deriving
the slot from `userdata % depth` hands a live IO's slot to a new one
after out-of-order completions — torn reads).  This is the explicit
free-list both sides now share, with key binding for the common
userdata -> slot bookkeeping.

`ShmTokenArena` extends the same slot discipline across PROCESSES: a
named shared-memory segment carved into per-pool token slots, stamped
with the holder's pid, mutated only under a host-wide file lock.  It is
the backing store for the KVCache tier's cross-process admission plane
(t3fs_torch/kvcache/admission.py): N client processes on one host draw
namespace/size-class tokens from ONE pool instead of N private
semaphores, and tokens held by a crashed process are reclaimed by
liveness-probing the stamped pid.

The port of t3fs/usrbio/slots.py, a copy with its imports re-pointed.
"""

from __future__ import annotations

from typing import Hashable


class SlotAllocator:
    """Free-list of `count` equal slots of `slot_size` bytes each.

    Slots are plain indices; `offset(slot)` maps to the byte offset in
    the backing iov.  Double release and release of a never-acquired
    slot raise — silent corruption of the free list is exactly the bug
    class this exists to prevent.

    ``release(slot, discard=True)`` quarantines instead of freeing: the
    slot re-enters the free list only after ``quarantine_s``.  This is
    the one-sided-buffer discard discipline for arena slots — a ring op
    that TIMED OUT client-side may still be processed by the server,
    which dereferences the slot's offset later (an aliased read lands
    its payload bytes in the client arena with no connection involved
    at all).  Re-issuing that slot immediately lets the late server
    write clobber a newer op's staged payload — the new occupant then
    fails the server's payload-crc check through no fault of its own."""

    def __init__(self, count: int, slot_size: int = 1,
                 quarantine_s: float = 0.0):
        if count <= 0:
            raise ValueError(f"slot count must be positive, got {count}")
        if slot_size <= 0:
            raise ValueError(f"slot size must be positive, got {slot_size}")
        self.count = count
        self.slot_size = slot_size
        self.quarantine_s = quarantine_s
        self.discarded = 0              # total quarantine entries (stat)
        self._free = list(range(count))
        self._held: set[int] = set()
        self._quarantine: list[tuple[float, int]] = []  # (reuse-at, slot)
        self._bound: dict[Hashable, int] = {}

    @property
    def available(self) -> int:
        return len(self._free)

    @property
    def in_flight(self) -> int:
        return len(self._held)

    @property
    def quarantined(self) -> int:
        return len(self._quarantine)

    def offset(self, slot: int) -> int:
        if not 0 <= slot < self.count:
            raise ValueError(f"slot {slot} outside [0, {self.count})")
        return slot * self.slot_size

    def _reclaim_quarantine(self) -> None:
        if not self._quarantine:
            return
        now = time.monotonic()
        # entries are appended in deadline order (monotonic clock +
        # constant quarantine_s), so one front-scan reclaims all ripe
        ripe = 0
        for due, _slot in self._quarantine:
            if due > now:
                break
            ripe += 1
        if ripe:
            self._free.extend(s for _, s in self._quarantine[:ripe])
            del self._quarantine[:ripe]

    def try_acquire(self) -> int | None:
        if not self._free:
            self._reclaim_quarantine()
            if not self._free:
                return None
        slot = self._free.pop()
        self._held.add(slot)
        return slot

    def acquire(self) -> int:
        slot = self.try_acquire()
        if slot is None:
            raise RuntimeError(
                f"no free slots ({self.count} all in flight)")
        return slot

    def release(self, slot: int, discard: bool = False) -> None:
        if slot not in self._held:
            raise ValueError(f"slot {slot} is not held (double release?)")
        self._held.discard(slot)
        if discard and self.quarantine_s > 0.0:
            self.discarded += 1
            self._quarantine.append(
                (time.monotonic() + self.quarantine_s, slot))
        else:
            self._free.append(slot)

    # -- key binding: userdata -> slot for completion-driven release --

    def bind(self, key: Hashable, slot: int) -> None:
        if slot not in self._held:
            raise ValueError(f"cannot bind free slot {slot}")
        if key in self._bound:
            raise ValueError(f"key {key!r} already bound to a slot")
        self._bound[key] = slot

    def release_key(self, key: Hashable) -> int:
        """Release the slot bound to `key`; returns the slot index."""
        slot = self._bound.pop(key, None)
        if slot is None:
            raise KeyError(f"key {key!r} is not bound")
        self.release(slot)
        return slot


# ---------------------------------------------------------------------------
# Cross-process token arena
# ---------------------------------------------------------------------------

import contextlib
import os
import struct
import tempfile
import time

_ARENA_MAGIC = 0x7C3F70C5
_ARENA_HDR = struct.Struct("<III")      # magic, npools, reserved
_ARENA_POOL = struct.Struct("<III")     # count, used, peak_used
_ARENA_SLOT = struct.Struct("<Qd")      # owner pid (0 = free), stamp ts


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True        # exists, owned by someone else
    return True


class ShmTokenArena:
    """Named shared-memory token pool shared by every process on a host.

    Layout: header, a pool directory of ``(count, used, peak_used)``
    triples, then one fixed-stride slot record per token.  A slot is
    either free (owner pid 0) or stamped with the holder's pid + a
    wall-clock acquisition timestamp.  All mutations happen under an
    ``fcntl`` file lock beside the segment, so no cross-process atomics
    are needed and a holder dying mid-critical-section cannot wedge the
    arena (the kernel drops its lock).

    Crash reclaim: ``try_acquire`` on an exhausted pool (and explicit
    ``reclaim_dead``) liveness-probes every distinct stamped pid with
    ``os.kill(pid, 0)`` and frees the slots of dead holders — a crashed
    client process gives its admission tokens back without operator
    action.  (Pid reuse can park a dead holder's token on an unrelated
    live process until *that* pid exits; the stamp ts is kept so an
    operator can spot a geriatric token.)

    Creation races: the first process creates and initializes the
    segment under the file lock; attachers validate the magic and pool
    geometry under the same lock, so a half-initialized segment is
    never observed.
    """

    def __init__(self, name: str, pool_sizes: list[int] | None = None):
        if not name:
            raise ValueError("arena needs a non-empty name")
        self.name = name
        self._lock_path = os.path.join(tempfile.gettempdir(),
                                       f"{name}.lock")
        self._lock_fd = os.open(self._lock_path,
                                os.O_CREAT | os.O_RDWR, 0o666)
        self._shm = None
        with self._locked():
            self._open_or_create(pool_sizes)
        self.pid = os.getpid()

    # -- layout helpers --

    @staticmethod
    def _size_for(pool_sizes: list[int]) -> int:
        return (_ARENA_HDR.size + _ARENA_POOL.size * len(pool_sizes)
                + _ARENA_SLOT.size * sum(pool_sizes))

    def _pool_dir_off(self, pool: int) -> int:
        return _ARENA_HDR.size + _ARENA_POOL.size * pool

    def _slot_off(self, pool: int, slot: int) -> int:
        return (self._slots_base
                + _ARENA_SLOT.size * (self._pool_base[pool] + slot))

    @contextlib.contextmanager
    def _locked(self):
        import fcntl
        fcntl.lockf(self._lock_fd, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.lockf(self._lock_fd, fcntl.LOCK_UN)

    def _open_or_create(self, pool_sizes: list[int] | None) -> None:
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=self.name)
            created = False
        except FileNotFoundError:
            if not pool_sizes:
                raise
            shm = shared_memory.SharedMemory(
                name=self.name, create=True,
                size=self._size_for(pool_sizes))
            created = True
        # the resource tracker would unlink the segment when THIS process
        # exits, yanking it out from under surviving fleet members; the
        # arena's lifetime is managed explicitly via unlink()
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name,          # noqa: SLF001
                                        "shared_memory")
        except Exception:
            pass
        self._shm = shm
        buf = shm.buf
        if created:
            _ARENA_HDR.pack_into(buf, 0, _ARENA_MAGIC, len(pool_sizes), 0)
            off = _ARENA_HDR.size
            for count in pool_sizes:
                _ARENA_POOL.pack_into(buf, off, count, 0, 0)
                off += _ARENA_POOL.size
            for i in range(sum(pool_sizes)):
                _ARENA_SLOT.pack_into(buf, off + i * _ARENA_SLOT.size,
                                      0, 0.0)
        magic, npools, _ = _ARENA_HDR.unpack_from(buf, 0)
        if magic != _ARENA_MAGIC:
            raise ValueError(f"arena {self.name}: bad magic {magic:#x}")
        self.npools = npools
        counts = []
        for p in range(npools):
            count, _, _ = _ARENA_POOL.unpack_from(buf, self._pool_dir_off(p))
            counts.append(count)
        if pool_sizes is not None and list(pool_sizes) != counts:
            raise ValueError(
                f"arena {self.name}: geometry mismatch (existing {counts} "
                f"vs requested {list(pool_sizes)})")
        self.pool_sizes = counts
        self._pool_base = [0] * npools
        for p in range(1, npools):
            self._pool_base[p] = self._pool_base[p - 1] + counts[p - 1]
        self._slots_base = _ARENA_HDR.size + _ARENA_POOL.size * npools

    # -- token ops (all under the host file lock) --

    def _read_pool(self, pool: int) -> tuple[int, int, int]:
        return _ARENA_POOL.unpack_from(self._shm.buf,
                                       self._pool_dir_off(pool))

    def _write_pool(self, pool: int, count: int, used: int,
                    peak: int) -> None:
        _ARENA_POOL.pack_into(self._shm.buf, self._pool_dir_off(pool),
                              count, used, peak)

    def try_acquire(self, pool: int) -> int | None:
        """Claim one token from `pool` for this process; None when the
        pool is exhausted even after reclaiming dead holders' tokens."""
        with self._locked():
            slot = self._scan_free(pool)
            if slot is None:
                if self._reclaim_dead_locked():
                    slot = self._scan_free(pool)
            if slot is None:
                return None
            _ARENA_SLOT.pack_into(self._shm.buf, self._slot_off(pool, slot),
                                  self.pid, time.time())
            count, used, peak = self._read_pool(pool)
            used += 1
            self._write_pool(pool, count, used, max(peak, used))
            return slot

    def _scan_free(self, pool: int) -> int | None:
        buf = self._shm.buf
        for slot in range(self.pool_sizes[pool]):
            owner, _ = _ARENA_SLOT.unpack_from(buf,
                                               self._slot_off(pool, slot))
            if owner == 0:
                return slot
        return None

    def release(self, pool: int, slot: int) -> None:
        with self._locked():
            owner, _ = _ARENA_SLOT.unpack_from(
                self._shm.buf, self._slot_off(pool, slot))
            if owner != self.pid:
                raise ValueError(
                    f"arena {self.name} pool {pool} slot {slot}: held by "
                    f"pid {owner}, not us ({self.pid}) — double release?")
            _ARENA_SLOT.pack_into(self._shm.buf, self._slot_off(pool, slot),
                                  0, 0.0)
            count, used, peak = self._read_pool(pool)
            self._write_pool(pool, count, max(0, used - 1), peak)

    def _reclaim_dead_locked(self) -> int:
        buf = self._shm.buf
        liveness: dict[int, bool] = {}
        freed = 0
        for pool in range(self.npools):
            count, used, peak = self._read_pool(pool)
            for slot in range(self.pool_sizes[pool]):
                off = self._slot_off(pool, slot)
                owner, _ = _ARENA_SLOT.unpack_from(buf, off)
                if owner == 0:
                    continue
                alive = liveness.get(owner)
                if alive is None:
                    alive = liveness[owner] = _pid_alive(owner)
                if not alive:
                    _ARENA_SLOT.pack_into(buf, off, 0, 0.0)
                    used = max(0, used - 1)
                    freed += 1
            self._write_pool(pool, count, used, peak)
        return freed

    def reclaim_dead(self) -> int:
        """Free every token held by a no-longer-running pid; returns the
        number of tokens reclaimed."""
        with self._locked():
            return self._reclaim_dead_locked()

    def release_all(self) -> int:
        """Free every token THIS process holds (clean shutdown path)."""
        freed = 0
        with self._locked():
            buf = self._shm.buf
            for pool in range(self.npools):
                count, used, peak = self._read_pool(pool)
                for slot in range(self.pool_sizes[pool]):
                    off = self._slot_off(pool, slot)
                    owner, _ = _ARENA_SLOT.unpack_from(buf, off)
                    if owner == self.pid:
                        _ARENA_SLOT.pack_into(buf, off, 0, 0.0)
                        used = max(0, used - 1)
                        freed += 1
                self._write_pool(pool, count, used, peak)
        return freed

    # -- introspection --

    def used(self, pool: int) -> int:
        return self._read_pool(pool)[1]

    def peak(self, pool: int) -> int:
        return self._read_pool(pool)[2]

    def pool_size(self, pool: int) -> int:
        return self.pool_sizes[pool]

    def stats(self) -> dict:
        pools = []
        for p in range(self.npools):
            count, used, peak = self._read_pool(p)
            pools.append({"count": count, "used": used, "peak": peak})
        return {"name": self.name, "pools": pools}

    # -- lifecycle --

    def close(self) -> None:
        if self._shm is not None:
            self.release_all()
            self._shm.close()
            self._shm = None
        if self._lock_fd is not None:
            os.close(self._lock_fd)
            self._lock_fd = None

    def unlink(self) -> None:
        """Remove the segment's name (the creator's/tests' teardown);
        attached processes keep their mappings until they close."""
        from multiprocessing import shared_memory
        try:
            shm = shared_memory.SharedMemory(name=self.name)
        except FileNotFoundError:
            return
        try:
            from multiprocessing import resource_tracker
            resource_tracker.unregister(shm._name,          # noqa: SLF001
                                        "shared_memory")
        except Exception:
            pass
        shm.close()
        shm.unlink()
        try:
            os.unlink(self._lock_path)
        except OSError:
            pass
