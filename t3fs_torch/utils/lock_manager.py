"""Keyed lock manager + bounded TTL map.

Reference analogs: src/common/utils/{LockManager.h,CoLockManager.h,
ReentrantLockManager.h} (keyed lock tables with bounded footprint) and the
reference's bounding of the ReliableUpdate channel map via client-session
expiry (src/mgmtd/background/MgmtdClientSessionsChecker.h).  Unbounded, the
per-chunk lock dict and the update-channel session map would grow without
bound; these two classes bound them.

Queues/pools decision (src/common/utils/{BoundedQueue,MPSCQueue,
WorkStealingBlockingQueue,CoroutinesPool,ObjectPool}.h): those exist because
folly coroutines need explicit executors and hand-built backpressure.  Under
asyncio the same roles are primitives — asyncio.Queue(maxsize) IS the
bounded MPSC queue, Semaphore-bounded gather IS the coroutine pool,
run_in_executor pools ARE the worker pools (see storage/service.py write
offload), and the registered BufferPool (net/rdma.py) is the one object
pool whose reuse discipline actually matters.  Re-wrapping the primitives
would add indirection, not capability; no further queue/pool layer is
built, deliberately.
"""

from __future__ import annotations

import asyncio
import time
from typing import Any, Callable, Iterator


class LockManager:
    """Keyed asyncio locks with automatic reclamation.

    Unlike a plain ``dict.setdefault(key, asyncio.Lock())``, the table does
    not grow forever: whenever it exceeds ``high_water`` the manager drops
    locks that are neither held nor awaited.  A lock object that callers
    still reference keeps working after eviction — eviction only forgets the
    *mapping*, so two concurrent holders can never observe different lock
    objects for the same key (eviction skips locked/waited locks).
    """

    def __init__(self, high_water: int = 4096):
        self._locks: dict[Any, asyncio.Lock] = {}
        self._high_water = max(1, high_water)

    def __len__(self) -> int:
        return len(self._locks)

    def get(self, key: Any) -> asyncio.Lock:
        lock = self._locks.get(key)
        if lock is None:
            if len(self._locks) >= self._high_water:
                self._shrink()
            lock = self._locks[key] = asyncio.Lock()
        return lock

    @staticmethod
    def _idle(lock: asyncio.Lock) -> bool:
        # locked() alone is NOT enough: release() clears _locked before the
        # woken waiter runs, so a lock can report unlocked while a waiter is
        # about to take it — evicting it then would mint a second Lock for
        # the same key and break mutual exclusion.  _waiters stays non-empty
        # until the woken acquirer actually resumes, so checking both closes
        # the window.
        return not lock.locked() and not getattr(lock, "_waiters", None)

    def _shrink(self) -> None:
        idle = [k for k, l in self._locks.items() if self._idle(l)]
        # drop the oldest-inserted half of the idle locks (dict preserves
        # insertion order; recently created keys are likelier to be hot)
        for k in idle[: max(1, len(idle) // 2)]:
            del self._locks[k]


class ExpiringMap:
    """Dict with per-entry TTL and a capacity bound.

    Entries are stamped with a monotonic time on every write (and on read
    when ``touch_on_get``).  Expired entries are reaped opportunistically on
    access and via :meth:`sweep`; when capacity is exceeded the oldest
    entries are evicted first, except those ``pin`` says must stay (e.g.
    in-flight update channels).
    """

    def __init__(self, ttl_s: float = 3600.0, capacity: int = 65536,
                 touch_on_get: bool = True,
                 pin: Callable[[Any], bool] | None = None,
                 clock: Callable[[], float] = time.monotonic):
        self._data: dict[Any, Any] = {}
        self._stamp: dict[Any, float] = {}
        self.ttl_s = ttl_s
        self.capacity = capacity
        self._touch_on_get = touch_on_get
        self._pin = pin
        self._clock = clock

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: Any) -> bool:
        return self.get(key) is not None

    def keys(self) -> Iterator[Any]:
        return iter(list(self._data.keys()))

    def items(self) -> Iterator[tuple[Any, Any]]:
        return iter(list(self._data.items()))

    def get(self, key: Any, default: Any = None) -> Any:
        stamp = self._stamp.get(key)
        if stamp is None:
            return default
        now = self._clock()
        if now - stamp > self.ttl_s and not self._pinned(key):
            self._drop(key)
            return default
        if self._touch_on_get:
            # re-insert so dict order stays oldest-stamp-first (see set())
            val = self._data.pop(key)
            del self._stamp[key]
            self._data[key] = val
            self._stamp[key] = now
            return val
        return self._data[key]

    def __setitem__(self, key: Any, value: Any) -> None:
        self.set(key, value)

    def set(self, key: Any, value: Any) -> None:
        # maintain the invariant "dict insertion order == stamp order" by
        # re-inserting on every stamp update; eviction then pops from the
        # front in O(evicted) instead of sorting the whole map (the session
        # map sits on the per-update hot path at capacity)
        self._data.pop(key, None)
        self._stamp.pop(key, None)
        self._data[key] = value
        self._stamp[key] = self._clock()
        if len(self._data) > self.capacity:
            self._evict_oldest(len(self._data) - self.capacity)

    def pop(self, key: Any, default: Any = None) -> Any:
        val = self._data.pop(key, default)
        self._stamp.pop(key, None)
        return val

    def sweep(self) -> int:
        """Drop all expired, unpinned entries; returns how many."""
        now = self._clock()
        dead = [k for k, ts in self._stamp.items()
                if now - ts > self.ttl_s and not self._pinned(k)]
        for k in dead:
            self._drop(k)
        return len(dead)

    def _pinned(self, key: Any) -> bool:
        return self._pin is not None and self._pin(self._data.get(key))

    def _drop(self, key: Any) -> None:
        self._data.pop(key, None)
        self._stamp.pop(key, None)

    def _evict_oldest(self, count: int) -> None:
        # dict order is oldest-first (set()/get() re-insert on touch)
        for k in list(self._stamp):
            if count <= 0:
                break
            if self._pinned(k):
                continue
            self._drop(k)
            count -= 1
