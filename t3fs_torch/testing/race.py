"""Concurrency-bug detectors: the sanitizer layer for an asyncio runtime.

Reference analog (SURVEY §5.2): the reference runs its gtest suites under
TSan (tsan_suppressions.txt) to catch data races between its executor
threads.  t3fs's data plane is asyncio, where the two race classes that
matter are different:

  1. **Event-loop stalls** — synchronous disk/CPU work on the loop thread
     serializes the whole node (every RPC, heartbeat, forward).  TSan can't
     see these; `LoopStallDetector` can: a watchdog thread measures gaps in
     a high-frequency loop heartbeat and snapshots the loop thread's stack
     mid-stall, naming the blocking frame.

  2. **Critical-section overlap** — two coroutines mutating the same
     resource (a chunk's replica state, a KV commit) concurrently because a
     lock was forgotten or an await crept inside a lock-free section.
     `CriticalSectionAuditor` tracks named sections and raises at the
     moment of overlap, with both holders' creation stacks.

Both are test/debug instruments: production code paths carry optional
hooks (`StorageNode.audit`), tests and the protocol simulator run with
them enabled — the same division as the reference's sanitizer builds.

The port of t3fs/testing/race.py, a copy with its imports re-pointed: its
race_audit patches the port's ChunkReplica and StorageFabric.
"""

from __future__ import annotations

import asyncio
import contextlib
import sys
import threading
import time
import traceback
import warnings
from dataclasses import dataclass, field
from typing import Any


@dataclass
class Stall:
    duration_s: float
    stack: str          # loop-thread stack captured mid-stall


class LoopStallDetector:
    """Watchdog for the running event loop.

    Usage::

        async with LoopStallDetector(threshold_s=0.05) as det:
            ...   # drive the system
        assert not det.stalls, det.report()

    A sampler thread wakes every ``threshold_s / 4``; the loop posts a
    heartbeat timestamp via ``call_soon`` chaining.  If the heartbeat age
    exceeds ``threshold_s`` the loop thread is mid-blocking-call; the
    sampler grabs its stack with ``sys._current_frames`` (one stall is
    recorded per contiguous blockage).
    """

    def __init__(self, threshold_s: float = 0.05):
        self.threshold_s = threshold_s
        self.stalls: list[Stall] = []
        self._beat = time.monotonic()
        self._stop = threading.Event()
        self._loop_thread_id: int | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._in_stall = False
        self._thread: threading.Thread | None = None

    async def __aenter__(self) -> "LoopStallDetector":
        self._loop = asyncio.get_running_loop()
        self._loop_thread_id = threading.get_ident()
        self._beat = time.monotonic()
        self._schedule_beat()
        self._thread = threading.Thread(target=self._sample, daemon=True,
                                        name="t3fs-stall-detector")
        self._thread.start()
        return self

    async def __aexit__(self, *exc) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=1.0)

    def _schedule_beat(self) -> None:
        if self._stop.is_set():
            return
        self._beat = time.monotonic()
        self._loop.call_later(self.threshold_s / 4, self._schedule_beat)

    def _sample(self) -> None:
        while not self._stop.wait(self.threshold_s / 4):
            age = time.monotonic() - self._beat
            if age > self.threshold_s:
                if not self._in_stall:
                    self._in_stall = True
                    frame = sys._current_frames().get(self._loop_thread_id)
                    stack = "".join(traceback.format_stack(frame)) \
                        if frame is not None else "<no frame>"
                    self.stalls.append(Stall(age, stack))
                else:
                    # still the same blockage: update its duration
                    self.stalls[-1].duration_s = age
            else:
                self._in_stall = False

    def report(self) -> str:
        lines = [f"{len(self.stalls)} event-loop stall(s) "
                 f"> {self.threshold_s * 1000:.0f} ms:"]
        for i, s in enumerate(self.stalls):
            lines.append(f"--- stall {i}: {s.duration_s * 1000:.1f} ms ---")
            lines.append(s.stack)
        return "\n".join(lines)


class RaceError(AssertionError):
    pass


@dataclass
class _Section:
    owner: str
    stack: str
    entered_at: float = field(default_factory=time.monotonic)


class CriticalSectionAuditor:
    """Detects concurrent entry into named critical sections.

    Production code calls ``enter(key, who)`` / ``exit(key)`` around a
    section that must be mutually exclusive per key (via the
    ``audited_section`` helper).  Overlap raises ``RaceError`` carrying
    both parties' entry stacks — the race is caught at the interleaving
    itself, like TSan, not from a corrupted result later.
    """

    def __init__(self, capture_stacks: bool = True):
        self._active: dict[Any, _Section] = {}
        self.capture_stacks = capture_stacks
        self.entries = 0            # observability: sections audited

    def enter(self, key: Any, who: str = "?") -> None:
        cur = self._active.get(key)
        if cur is not None:
            raise RaceError(
                f"critical-section race on {key!r}: {who!r} entered while "
                f"{cur.owner!r} holds it (entered "
                f"{time.monotonic() - cur.entered_at:.4f}s ago)\n"
                f"--- current holder's entry stack ---\n{cur.stack}\n"
                f"--- second entrant's stack ---\n"
                + ("".join(traceback.format_stack(sys._getframe(1)))
                   if self.capture_stacks else "<stacks off>"))
        stack = ("".join(traceback.format_stack(sys._getframe(1)))
                 if self.capture_stacks else "")
        self._active[key] = _Section(who, stack)
        self.entries += 1

    def exit(self, key: Any) -> None:
        self._active.pop(key, None)

    def section(self, key: Any, who: str = "?"):
        """``async with auditor.section(("chunk", cid)):`` context."""
        return _AuditedSection(self, key, who)


class _AuditedSection:
    def __init__(self, auditor: CriticalSectionAuditor, key: Any, who: str):
        self.auditor, self.key, self.who = auditor, key, who

    async def __aenter__(self):
        self.auditor.enter(self.key, self.who)

    async def __aexit__(self, *exc):
        self.auditor.exit(self.key)

    # sync form for non-async sections (engine-thread work)
    def __enter__(self):
        self.auditor.enter(self.key, self.who)

    def __exit__(self, *exc):
        self.auditor.exit(self.key)


@contextlib.contextmanager
def race_audit(stall_threshold_s: float = 0.25):
    """Install the runtime detectors tree-wide for the enclosed scope.

    The cross-check companion to t3fslint (the reference's tests/conftest.py
    enables its twin under ``T3FS_RACE_AUDIT=1``): where the static rules reason about
    lock/await shapes, this watches the same invariants at runtime —

      * every ``StorageFabric`` node gets a shared
        ``CriticalSectionAuditor`` on its ``audit`` hook, so the CRAQ
        chunk-lock section (the async-lock-await-discipline pragma site)
        raises ``RaceError`` the moment two updates overlap on one chunk;
      * every ``ChunkReplica.apply_update`` — the storage service AND the
        CRAQ step simulator both funnel through it — runs inside a sync
        audited section keyed by (replica, chunk);
      * each fabric's lifetime runs under a ``LoopStallDetector``
        (generous threshold: CI machines jitter); stalls surface as
        warnings, not failures, since the *blocking-in-async* static rule
        is the enforced twin.

    Yields the shared auditor; ``auditor.entries`` > 0 proves coverage.
    """
    from t3fs_torch.storage.chunk_replica import ChunkReplica
    from t3fs_torch.testing.fabric import StorageFabric

    auditor = CriticalSectionAuditor()
    orig_start = StorageFabric.start
    orig_stop = StorageFabric.stop
    orig_apply = ChunkReplica.apply_update

    async def start(self) -> None:
        det = LoopStallDetector(threshold_s=stall_threshold_s)
        await det.__aenter__()
        self._race_stall_det = det
        await orig_start(self)
        for node in self.nodes:
            node.audit = auditor

    async def stop(self) -> None:
        await orig_stop(self)
        det = getattr(self, "_race_stall_det", None)
        if det is not None:
            self._race_stall_det = None
            await det.__aexit__(None, None, None)
            if det.stalls:
                warnings.warn("T3FS_RACE_AUDIT: " + det.report(),
                              stacklevel=2)

    def apply_update(self, io, payload, *args, **kwargs):
        with auditor.section((id(self), io.chunk_id), "apply_update"):
            return orig_apply(self, io, payload, *args, **kwargs)

    StorageFabric.start = start
    StorageFabric.stop = stop
    ChunkReplica.apply_update = apply_update
    try:
        yield auditor
    finally:
        StorageFabric.start = orig_start
        StorageFabric.stop = orig_stop
        ChunkReplica.apply_update = orig_apply
