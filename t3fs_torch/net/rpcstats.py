"""Per-process RPC latency decomposition over the wire timestamps.

Reference role: MessagePacket carries 8 timestamps
(src/common/serde/MessagePacket.h:43-50) precisely so
"where did this RPC spend its time" is answerable.  Every Connection.call
now records a 4-way split per method:

  total   — client call() to response in hand
  squeue  — server read-loop receive -> handler task first scheduled
            (event-loop/backlog pressure on the server)
  server  — handler body (engine, disk, chain forward, ...)
  network — total - (replied - received): wire + client-loop turnaround
            (clock-skew-free: subtracts a SERVER-side interval from a
            CLIENT-side one, no cross-host timestamp differencing)

Samples land in a bounded per-method reservoir (uniform replacement), so
the recorder is O(1) per call and a long bench cannot grow it.  Dump a
snapshot with `dump()` (or set T3FS_RPC_STATS=<path> to auto-dump at
process exit) and render it with `t3fs_torch.cli.admin rpc-top <path>`.
"""

from __future__ import annotations

import atexit
import json
import os
import random
import threading

RESERVOIR = 2048


class _MethodStats:
    __slots__ = ("count", "total_s", "errors", "samples",
                 "wcount", "wtotal_s", "werrors", "wsamples")

    def __init__(self):
        self.count = 0
        self.total_s = 0.0
        self.errors = 0
        # each sample: (total, squeue, server, network)
        self.samples: list[tuple[float, float, float, float]] = []
        # window tier: drained by the monitor recorder each collect tick
        # (cumulative stats would flatten the time series — a latency
        # spike at hour N must show in hour N's row)
        self.wcount = 0
        self.wtotal_s = 0.0
        self.werrors = 0
        self.wsamples: list[tuple[float, float, float, float]] = []

    def add(self, sample: tuple[float, float, float, float],
            ok: bool = True) -> None:
        self.count += 1
        self.total_s += sample[0]
        if not ok:
            self.errors += 1
            self.werrors += 1
        if len(self.samples) < RESERVOIR:
            self.samples.append(sample)
        else:
            i = random.randrange(self.count)
            if i < RESERVOIR:
                self.samples[i] = sample
        self.wcount += 1
        self.wtotal_s += sample[0]
        if len(self.wsamples) < RESERVOIR:
            self.wsamples.append(sample)
        else:
            # reservoir replacement, same as the cumulative tier: a
            # first-2048-only cap would hide a latency spike landing
            # late in a busy tick — the exact failure this tier exists
            # to expose
            i = random.randrange(self.wcount)
            if i < RESERVOIR:
                self.wsamples[i] = sample


class RpcStats:
    """Process-wide recorder; thread-safe enough for the asyncio world
    (single loop per process; the lock covers cross-thread dumps)."""

    def __init__(self):
        self._methods: dict[str, _MethodStats] = {}
        self._lock = threading.Lock()

    def record(self, method: str, total: float, squeue: float,
               server: float, network: float, ok: bool = True) -> None:
        st = self._methods.get(method)
        if st is None:
            with self._lock:
                st = self._methods.setdefault(method, _MethodStats())
        st.add((total, squeue, server, network), ok)

    @staticmethod
    def _row(count: int, total_s: float, samples: list,
             errors: int = 0) -> dict:
        def pct(vals: list[float], q: float) -> float:
            if not vals:
                return 0.0
            s = sorted(vals)
            return s[min(len(s) - 1, int(q * len(s)))]

        cols = list(zip(*samples)) if samples else [[], [], [], []]
        row = {"count": count, "errors": errors,
               "avg_ms": round(total_s / count * 1e3, 3) if count else 0.0}
        for name, vals in zip(("total", "squeue", "server", "network"),
                              cols):
            vals = list(vals)
            row[f"{name}_p50_ms"] = round(pct(vals, 0.50) * 1e3, 3)
            row[f"{name}_p99_ms"] = round(pct(vals, 0.99) * 1e3, 3)
        return row

    def snapshot(self) -> dict:
        """Cumulative since process start (rpc-top dumps/CLI)."""
        with self._lock:
            items = list(self._methods.items())
        return {m: self._row(st.count, st.total_s, st.samples, st.errors)
                for m, st in items}

    def window_snapshot(self) -> dict:
        """Per-window stats since the LAST window_snapshot call, then the
        window resets — the monitor pipeline's per-tick time series
        (every other registry recorder reports deltas too)."""
        out = {}
        with self._lock:
            for m, st in self._methods.items():
                if not st.wcount:
                    continue
                out[m] = self._row(st.wcount, st.wtotal_s, st.wsamples,
                                   st.werrors)
                st.wcount = 0
                st.wtotal_s = 0.0
                st.werrors = 0
                st.wsamples = []
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def clear(self) -> None:
        with self._lock:
            self._methods.clear()


RPC_STATS = RpcStats()

# Serving-side twin, recorded at request dispatch (conn._handle_request):
# total = receive->reply, squeue = receive->handler-start, server = handler
# body, network = 0.  RPC_STATS attributes latency to the CALLING process's
# outbound methods; this one attributes it to the process that SERVED the
# request — which is what per-node health rollups need (the MonitorReporter
# that ships it stamps the serving node's node_id on the row).
SERVER_STATS = RpcStats()


def _stream_quantile(est: float, x: float, q: float,
                     lr: float = 0.05) -> float:
    """One step of a scale-free streaming quantile estimate: nudge the
    estimate up by lr*q of itself when the sample lands above it, down by
    lr*(1-q) when below.  In steady state the fraction of samples above
    the estimate converges to 1-q, i.e. the estimate tracks the
    q-quantile — O(1) state per (address, quantile), no reservoir on the
    hot path."""
    if est <= 0.0:
        return x
    step = lr * est
    return est + step * q if x > est else max(0.0, est - step * (1.0 - q))


_ADDR_RESERVOIR = 512

# read-size classes for the hedge delay: a 4 MiB checkpoint read and a
# 16 KiB KVCache block get have order-of-magnitude different latency
# distributions, and ONE per-address p9x conflates them — large reads
# would hedge on small-read tail estimates.  Classes key off the RPC's TOTAL payload bytes (a batch is one
# latency sample today, so the class must describe the whole batch too).
SIZE_CLASS_BOUNDS = (128 << 10, 2 << 20)      # < 128 KiB | < 2 MiB | rest
SIZE_CLASS_NAMES = ("small", "medium", "large")
# per-class streaming estimates need a few samples before they beat the
# class-agnostic fallback
_CLASS_MIN_SAMPLES = 8


def read_size_class(nbytes: int) -> int:
    for cls, bound in enumerate(SIZE_CLASS_BOUNDS):
        if nbytes < bound:
            return cls
    return len(SIZE_CLASS_BOUNDS)


class _AddrReadStats:
    __slots__ = ("count", "ewma_s", "p50_s", "p9x_s", "inflight",
                 "hedge_fired", "hedge_won", "hedge_wasted", "samples",
                 "cls_count", "cls_p9x_s", "seeded")

    def __init__(self):
        self.seeded = False       # estimates start from a scorecard prior
        self.count = 0
        self.ewma_s = 0.0
        self.p50_s = 0.0          # streaming median (adaptive selection)
        self.p9x_s = 0.0          # streaming tail quantile (hedge delay)
        self.inflight = 0         # ALL in-flight RPCs to the address
        self.hedge_fired = 0
        self.hedge_won = 0
        self.hedge_wasted = 0
        # bounded reservoir for exact report-time quantiles (read-stats CLI)
        self.samples: list[float] = []
        # per-size-class tail estimates (hedge delay); the class-agnostic
        # p9x above stays as the fallback until a class has samples
        self.cls_count = [0] * (len(SIZE_CLASS_BOUNDS) + 1)
        self.cls_p9x_s = [0.0] * (len(SIZE_CLASS_BOUNDS) + 1)

    def add(self, elapsed: float, tail_q: float, nbytes: int = 0) -> None:
        self.count += 1
        alpha = 0.2
        self.ewma_s = (elapsed if self.count == 1
                       else (1 - alpha) * self.ewma_s + alpha * elapsed)
        self.p50_s = _stream_quantile(self.p50_s, elapsed, 0.5)
        self.p9x_s = _stream_quantile(self.p9x_s, elapsed, tail_q)
        cls = read_size_class(nbytes)
        self.cls_count[cls] += 1
        self.cls_p9x_s[cls] = _stream_quantile(self.cls_p9x_s[cls],
                                               elapsed, tail_q)
        if len(self.samples) < _ADDR_RESERVOIR:
            self.samples.append(elapsed)
        else:
            i = random.randrange(self.count)
            if i < _ADDR_RESERVOIR:
                self.samples[i] = elapsed


class ReadStats:
    """Per-address latency / in-flight tracker behind the adaptive read
    path (TargetSelection.ADAPTIVE + hedged batch reads,
    docs/design_notes.md "Adaptive read path").

    Fed from Client.call: every RPC counts toward the address's in-flight
    gauge (a pure load signal), while LATENCY samples are restricted to
    the read-path methods in `read_methods` — a head's Storage.write
    latency includes the whole chain's replication time and would make
    every head look degraded to a read picker."""

    read_methods = frozenset({"Storage.batch_read", "Storage.ring_rw"})
    tail_quantile = 0.95   # the "p9x" the hedge delay keys off

    def __init__(self):
        self._addrs: dict[str, _AddrReadStats] = {}
        self._lock = threading.Lock()

    def _get(self, address: str) -> _AddrReadStats:
        st = self._addrs.get(address)
        if st is None:
            with self._lock:
                st = self._addrs.setdefault(address, _AddrReadStats())
        return st

    def begin(self, address: str) -> None:
        self._get(address).inflight += 1

    def end(self, address: str, method: str, elapsed: float,
            ok: bool, nbytes: int = 0) -> None:
        st = self._get(address)
        st.inflight = max(0, st.inflight - 1)
        # failures are excluded from latency: a dead node failing fast
        # must not look like the FASTEST replica
        if ok and method in self.read_methods:
            st.add(elapsed, self.tail_quantile, nbytes)

    def inflight(self, address: str) -> int:
        st = self._addrs.get(address)
        return st.inflight if st is not None else 0

    def p50(self, address: str) -> float:
        """Streaming read-latency median; 0.0 = no samples yet (callers
        treat unknown addresses optimistically, so new nodes get probed)."""
        st = self._addrs.get(address)
        return st.p50_s if st is not None else 0.0

    def p9x(self, address: str, nbytes: int | None = None) -> float:
        """Streaming tail estimate; with `nbytes` (the planned RPC's total
        payload bytes) the estimate is size-class-specific once that class
        has enough samples, else the class-agnostic fallback — a cold
        class must not hedge at delay 0."""
        st = self._addrs.get(address)
        if st is None:
            return 0.0
        if nbytes is not None:
            cls = read_size_class(nbytes)
            if st.cls_count[cls] >= _CLASS_MIN_SAMPLES:
                return st.cls_p9x_s[cls]
        return st.p9x_s

    def seed_prior(self, address: str, p50_s: float = 0.0,
                   p9x_s: float = 0.0,
                   cls_p9x_s: dict[int, float] | None = None) -> bool:
        """Seed the streaming estimates from a cluster-scorecard prior
        (the health plane) so a COLD process's adaptive selection and
        hedge-delay clamps know about slow nodes before its first read.

        Only a cold entry (zero live samples) takes the prior — live
        local observations always win — and counts are NOT bumped, so
        the very first real sample starts nudging the estimate via the
        normal streaming update.  Per-class priors get their class
        credited with _CLASS_MIN_SAMPLES so `p9x(addr, nbytes)` uses
        them immediately (live samples keep refining from there).
        Returns True iff the prior was applied."""
        st = self._get(address)
        if st.count:
            return False
        st.seeded = True
        if p50_s > 0.0:
            st.p50_s = p50_s
            st.ewma_s = p50_s
        if p9x_s > 0.0:
            st.p9x_s = p9x_s
        for cls, est in (cls_p9x_s or {}).items():
            if 0 <= cls < len(st.cls_p9x_s) and est > 0.0:
                st.cls_p9x_s[cls] = est
                st.cls_count[cls] = max(st.cls_count[cls],
                                        _CLASS_MIN_SAMPLES)
        return True

    def hedge(self, address: str, fired: int = 0, won: int = 0,
              wasted: int = 0) -> None:
        """Hedge counters accrue to the PRIMARY address whose slowness
        triggered the hedge — that is the node the operator wants named."""
        st = self._get(address)
        st.hedge_fired += fired
        st.hedge_won += won
        st.hedge_wasted += wasted

    def snapshot(self) -> dict:
        def pct(vals: list[float], q: float) -> float:
            if not vals:
                return 0.0
            s = sorted(vals)
            return s[min(len(s) - 1, int(q * len(s)))]

        with self._lock:
            items = list(self._addrs.items())
        out = {}
        for addr, st in items:
            vals = list(st.samples)
            out[addr] = {
                "count": st.count, "inflight": st.inflight,
                "seeded": st.seeded,
                "ewma_ms": round(st.ewma_s * 1e3, 3),
                "p50_ms": round(st.p50_s * 1e3, 3),
                "p9x_ms": round(st.p9x_s * 1e3, 3),
                **{f"p9x_{name}_ms": round(st.cls_p9x_s[cls] * 1e3, 3)
                   for cls, name in enumerate(SIZE_CLASS_NAMES)
                   if st.cls_count[cls]},
                "q50_ms": round(pct(vals, 0.50) * 1e3, 3),
                "q90_ms": round(pct(vals, 0.90) * 1e3, 3),
                "q99_ms": round(pct(vals, 0.99) * 1e3, 3),
                "hedge_fired": st.hedge_fired,
                "hedge_won": st.hedge_won,
                "hedge_wasted": st.hedge_wasted,
            }
        return out

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1, sort_keys=True)

    def clear(self) -> None:
        with self._lock:
            self._addrs.clear()


READ_STATS = ReadStats()


def render_read_stats(snapshots: list[dict], limit: int = 40) -> str:
    """Merge per-process read-stats snapshots and render the table the
    admin `read-stats` command prints."""
    merged: dict[str, dict] = {}
    for snap in snapshots:
        for addr, row in snap.items():
            cur = merged.get(addr)
            if cur is None:
                merged[addr] = dict(row)
                continue
            n1, n2 = cur["count"], row["count"]
            tot = n1 + n2 or 1
            for k in set(cur) | set(row):
                if k in ("count", "inflight") or k.startswith("hedge_"):
                    cur[k] = cur.get(k, 0) + row.get(k, 0)
                elif k in ("q90_ms", "q99_ms", "seeded") \
                        or k.startswith("p9x"):
                    # upper bound; per-size-class p9x columns are sparse
                    # (a process only reports classes it has samples for)
                    cur[k] = max(cur.get(k, 0.0), row.get(k, 0.0))
                else:                                 # count-weighted
                    cur[k] = round((cur.get(k, 0.0) * n1
                                    + row.get(k, 0.0) * n2) / tot, 3)
    rows = sorted(merged.items(), key=lambda kv: -kv[1].get("q99_ms", 0))
    hdr = (f"{'address':<22}{'reads':>8}{'infl':>6}{'ewma':>8}"
           f"{'p50~':>8}{'p9x~':>8}{'q50':>8}{'q90':>8}{'q99':>8}"
           f"{'fired':>7}{'won':>6}{'waste':>7}  (ms)")
    lines = [hdr, "-" * len(hdr)]
    for addr, r in rows[:limit]:
        lines.append(
            f"{addr:<22}{r['count']:>8}{r['inflight']:>6}"
            f"{r['ewma_ms']:>8.2f}{r['p50_ms']:>8.2f}{r['p9x_ms']:>8.2f}"
            f"{r['q50_ms']:>8.2f}{r['q90_ms']:>8.2f}{r['q99_ms']:>8.2f}"
            f"{r['hedge_fired']:>7}{r['hedge_won']:>6}"
            f"{r['hedge_wasted']:>7}")
    return "\n".join(lines)


def _autodump() -> None:
    path = os.environ.get("T3FS_RPC_STATS")
    if path and RPC_STATS._methods:
        try:
            # one file per process (servers + client each dump their own)
            RPC_STATS.dump(f"{path}.{os.getpid()}"
                           if os.path.isdir(path) or path.endswith("/")
                           else path)
        except OSError:
            pass
    rpath = os.environ.get("T3FS_READ_STATS")
    if rpath and READ_STATS._addrs:
        try:
            READ_STATS.dump(f"{rpath}.{os.getpid()}"
                            if os.path.isdir(rpath) or rpath.endswith("/")
                            else rpath)
        except OSError:
            pass


atexit.register(_autodump)


def render_top(snapshots: list[dict], sort_by: str = "total_p99_ms",
               limit: int = 30) -> str:
    """Merge per-process snapshot dicts and render the rpc-top table."""
    merged: dict[str, dict] = {}
    for snap in snapshots:
        for method, row in snap.items():
            cur = merged.get(method)
            if cur is None:
                merged[method] = dict(row)
            else:
                n1, n2 = cur["count"], row["count"]
                tot = n1 + n2 or 1
                for k in cur:
                    if k in ("count", "errors"):
                        continue
                    if k.endswith("_p99_ms"):
                        cur[k] = max(cur[k], row[k])   # upper bound
                    else:                              # count-weighted
                        cur[k] = round((cur[k] * n1 + row[k] * n2) / tot, 3)
                cur["count"] = tot
                cur["errors"] = cur.get("errors", 0) + row.get("errors", 0)
    rows = sorted(merged.items(), key=lambda kv: -kv[1].get(sort_by, 0))
    hdr = (f"{'method':<34}{'calls':>8}{'avg':>8}"
           f"{'tot50':>8}{'tot99':>8}{'sq50':>7}{'sq99':>7}"
           f"{'srv50':>8}{'srv99':>8}{'net50':>8}{'net99':>8}  (ms)")
    lines = [hdr, "-" * len(hdr)]
    for method, r in rows[:limit]:
        lines.append(
            f"{method:<34}{r['count']:>8}{r['avg_ms']:>8.2f}"
            f"{r['total_p50_ms']:>8.2f}{r['total_p99_ms']:>8.2f}"
            f"{r['squeue_p50_ms']:>7.2f}{r['squeue_p99_ms']:>7.2f}"
            f"{r['server_p50_ms']:>8.2f}{r['server_p99_ms']:>8.2f}"
            f"{r['network_p50_ms']:>8.2f}{r['network_p99_ms']:>8.2f}")
    return "\n".join(lines)


def register_monitor_recorder() -> None:
    """Feed the per-method latency decomposition into the monitor
    pipeline: registers a metrics-registry Recorder whose collect()
    row carries the full rpc-top snapshot (one row per tick; the
    monitor sink keeps the dict in its JSON payload column, so
    `metrics-query rpc.latency` returns the splits over time).
    Idempotent."""
    from t3fs_torch.utils.metrics import Recorder, all_recorders

    if any(r.name == "rpc.latency" for r in all_recorders()):
        return

    class _RpcStatsRecorder(Recorder):
        def collect(self) -> dict:
            return {"name": self.name, "type": "rpc_top",
                    "methods": RPC_STATS.window_snapshot(),
                    "server_methods": SERVER_STATS.window_snapshot(),
                    **self.tags}

    _RpcStatsRecorder("rpc.latency")   # Recorder.__init__ registers it
