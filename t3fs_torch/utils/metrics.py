"""In-process metric registry: recorders + periodic collector.

Mirrors the reference's monitor layer (common/monitor/Recorder.h:32-351:
CountRecorder / LatencyRecorder / DistributionRecorder / ValueRecorder,
sampled by Collector::periodicallyCollect).  Reporters are pluggable; the
built-in one logs JSON lines (ClickHouse/TSDB reporters slot in later).
"""

from __future__ import annotations

import json
import logging
import math
import random
import threading
import time
from typing import Any, Callable

log = logging.getLogger("t3fs_torch.metrics")

_registry_lock = threading.Lock()
_registry: dict[str, "Recorder"] = {}


def _register(rec: "Recorder") -> None:
    with _registry_lock:
        _registry[rec.name] = rec


def all_recorders() -> list["Recorder"]:
    with _registry_lock:
        return list(_registry.values())


def reset_registry() -> None:
    """Test hook."""
    with _registry_lock:
        _registry.clear()


class Recorder:
    def __init__(self, name: str, tags: dict[str, str] | None = None):
        self.name = name
        self.tags = tags or {}
        self._lock = threading.Lock()
        _register(self)

    def collect(self) -> dict[str, Any]:
        raise NotImplementedError


class CountRecorder(Recorder):
    """Monotonic-ish counter, reported as delta since last collect."""

    def __init__(self, name: str, tags: dict[str, str] | None = None):
        super().__init__(name, tags)
        self._value = 0

    def add(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    def collect(self) -> dict[str, Any]:
        with self._lock:
            v, self._value = self._value, 0
        return {"name": self.name, "type": "count", "value": v, **self.tags}


class ValueRecorder(Recorder):
    """Last-value gauge."""

    def __init__(self, name: str, tags: dict[str, str] | None = None):
        super().__init__(name, tags)
        self._value: float = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = v

    def collect(self) -> dict[str, Any]:
        with self._lock:
            v = self._value
        return {"name": self.name, "type": "value", "value": v, **self.tags}


class CallbackGauge(Recorder):
    """Gauge whose value is pulled from a callable at collect time —
    for state that lives elsewhere (queue depths, buffer occupancy)
    where pushing on the hot path would be wasted work."""

    def __init__(self, name: str, fn: Callable[[], float],
                 tags: dict[str, str] | None = None):
        super().__init__(name, tags)
        self._fn = fn

    def collect(self) -> dict[str, Any]:
        try:
            v = float(self._fn())
        except Exception:
            log.exception("callback gauge %s failed", self.name)
            # a failed pull is NOT a zero: flag it so reporters skip the
            # row instead of recording a fake measurement
            return {"name": self.name, "type": "value", "value": 0.0,
                    "error": True, **self.tags}
        return {"name": self.name, "type": "value", "value": v, **self.tags}


class DistributionRecorder(Recorder):
    """Windowed distribution: count/sum/min/max/mean + p50/p90/p99 estimates
    via a fixed reservoir."""

    RESERVOIR = 1024

    def __init__(self, name: str, tags: dict[str, str] | None = None):
        super().__init__(name, tags)
        self._samples: list[float] = []
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    def add(self, v: float) -> None:
        with self._lock:
            self._count += 1
            self._sum += v
            self._min = min(self._min, v)
            self._max = max(self._max, v)
            if len(self._samples) < self.RESERVOIR:
                self._samples.append(v)
            else:  # reservoir sampling
                i = random.randrange(self._count)
                if i < self.RESERVOIR:
                    self._samples[i] = v

    def collect(self) -> dict[str, Any]:
        with self._lock:
            if self._count == 0:
                return {"name": self.name, "type": "dist", "count": 0, **self.tags}
            s = sorted(self._samples)
            out = {
                "name": self.name, "type": "dist",
                "count": self._count, "sum": self._sum,
                "min": self._min, "max": self._max,
                "mean": self._sum / self._count,
                "p50": s[len(s) // 2],
                "p90": s[int(len(s) * 0.9)],
                "p99": s[min(int(len(s) * 0.99), len(s) - 1)],
                **self.tags,
            }
            self._samples.clear()
            self._count = 0
            self._sum = 0.0
            self._min = math.inf
            self._max = -math.inf
        return out


class LatencyRecorder(DistributionRecorder):
    """Distribution of seconds; use .time() as a context manager."""

    class _Timer:
        def __init__(self, rec: "LatencyRecorder"):
            self.rec = rec

        def __enter__(self):
            self.t0 = time.perf_counter()
            return self

        def __exit__(self, *exc):
            self.rec.add(time.perf_counter() - self.t0)
            return False

    def time(self) -> "_Timer":
        return self._Timer(self)


class Collector:
    """Periodic sampler pushing snapshots to reporters (list of callables)."""

    def __init__(self, period_s: float = 10.0,
                 reporters: list[Callable[[list[dict]], None]] | None = None,
                 samplers: list[Callable[[], None]] | None = None):
        self.period_s = period_s
        self.reporters = reporters if reporters is not None else [log_reporter]
        # gauges that must be refreshed at collection time (e.g. process
        # memory) rather than on the hot path
        self.samplers = samplers if samplers is not None else []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def collect_once(self) -> list[dict]:
        for s in self.samplers:
            try:
                s()
            except Exception:
                log.exception("metric sampler failed")
        snap = [r.collect() for r in all_recorders()]
        for rep in self.reporters:
            try:
                rep(snap)
            except Exception:
                log.exception("metric reporter failed")
        return snap

    def start(self) -> None:
        def loop():
            while not self._stop.wait(self.period_s):
                self.collect_once()
        self._thread = threading.Thread(target=loop, name="t3fs-metrics", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)


def log_reporter(snapshot: list[dict]) -> None:
    for row in snapshot:
        if row.get("error"):
            continue   # failed callback pull, not a measurement
        if row.get("value") or row.get("count"):
            log.info("%s", json.dumps(row, default=str))
