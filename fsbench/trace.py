"""The device timeline of a traced window, from torch.profiler's trace.

The window is marked by a host annotation, so device work is read inside
exactly the stretch that the host measured.  Device activity is every
kernel, copy and memset on the card; a gap is a stretch of the window with
none, named by the host operation that overlaps most of it (the innermost
one where several cover it whole)."""

from __future__ import annotations

import bisect
import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

WINDOW_MARK = "fsbench.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
# host categories: these and every "cuda_" one (runtime and lower API calls)
_HOST_CATS = ("cpu_op", "user_annotation")
UNTRACED = "host: no traced op (python, numpy)"
TOP = 10


@dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict[str, float] = field(default_factory=dict)   # name -> s
    op_s: dict[str, float] = field(default_factory=dict)       # device op -> s
    h2d_bytes: int | None = None
    gaps: dict[str, float] = field(default_factory=dict)       # host op -> s

    def kernel_seconds(self, names: tuple[str, ...]) -> float:
        """Device seconds of the kernels whose name holds any of `names`."""
        return sum(s for k, s in self.kernel_s.items()
                   if any(n in k for n in names))

    def breakdown(self) -> dict:
        def top(d: dict[str, float]) -> list:
            return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.op_s), "idle_gaps": top(self.gaps)}


def _short(name: str) -> str:
    """A kernel's name without its return type, namespaces' anonymity and
    argument list; a copy's name as it is."""
    if name.startswith("Memcpy") or name.startswith("Memset"):
        return name
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    return name.split("(")[0]


def _union(intervals: list[tuple[float, float]]) -> list[tuple[float, float]]:
    out: list[tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def summarize(events: list[dict]) -> Trace:
    """A Trace of the window from chrome-trace events (times in us)."""
    marks = [e for e in events if e.get("name") == WINDOW_MARK
             and e.get("cat") == "user_annotation"]
    if not marks:
        raise RuntimeError("trace holds no window mark")
    w0 = float(marks[0]["ts"])
    w1 = w0 + float(marks[0]["dur"])
    spans: list[tuple[float, float]] = []
    kernel_s: dict[str, float] = {}
    op_s: dict[str, float] = {}
    h2d = 0
    h2d_seen = False
    host: list[tuple[float, float, str]] = []
    for e in events:
        cat = e.get("cat")
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        b = a + float(e["dur"])
        if cat in _DEVICE_CATS:
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            spans.append((a, b))
            name = _short(e.get("name", "?"))
            op_s[name] = op_s.get(name, 0.0) + (b - a) / 1e6
            if cat == "kernel":
                kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) / 1e6
            elif cat == "gpu_memcpy" and "HtoD" in e.get("name", ""):
                nbytes = (e.get("args") or {}).get("bytes")
                if nbytes is not None:
                    h2d_seen = True
                    h2d += int(nbytes)
        elif (cat in _HOST_CATS or str(cat).startswith("cuda_")) \
                and e.get("name") != WINDOW_MARK:
            if b > w0 and a < w1:
                host.append((a, b, e.get("name", "?")))
    busy = _union(spans)
    busy_s = sum(b - a for a, b in busy) / 1e6
    gaps = _name_gaps(_gaps(busy, w0, w1), host)
    return Trace(window_s=(w1 - w0) / 1e6, busy_s=busy_s, kernel_s=kernel_s,
                 op_s=op_s, h2d_bytes=h2d if h2d_seen else None, gaps=gaps)


def _gaps(busy: list[tuple[float, float]], w0: float, w1: float
          ) -> list[tuple[float, float]]:
    out = []
    t = w0
    for a, b in busy:
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if w1 > t:
        out.append((t, w1))
    return out


def _name_gaps(gaps: list[tuple[float, float]],
               host: list[tuple[float, float, str]]) -> dict[str, float]:
    """Each gap's time, by the host operation running in it: the innermost
    traced operation at each instant, and UNTRACED where none ran."""
    host.sort()
    starts = [h[0] for h in host]
    longest = max((b - a for a, b, _ in host), default=0.0)
    out: dict[str, float] = {}
    for a, b in gaps:
        inside = []
        i = bisect.bisect_left(starts, b) - 1
        while i >= 0 and starts[i] >= a - longest:
            ha, hb, name = host[i]
            if hb > a:
                inside.append((hb - ha, max(a, ha), min(b, hb), name))
            i -= 1
        covered: list[tuple[float, float]] = []
        for _dur, ha, hb, name in sorted(inside):       # innermost first
            new = _minus((ha, hb), covered)
            if new > 0:
                out[f"host: {name}"] = out.get(f"host: {name}", 0.0) + new / 1e6
                covered = _union(covered + [(ha, hb)])
        rest = (b - a) - sum(y - x for x, y in covered)
        if rest > 0:
            out[UNTRACED] = out.get(UNTRACED, 0.0) + rest / 1e6
    return out


def _minus(span: tuple[float, float], covered: list[tuple[float, float]]) -> float:
    """The length of `span` outside the intervals of `covered`."""
    a, b = span
    left = b - a
    for x, y in covered:
        left -= max(0.0, min(b, y) - max(a, x))
    return left


class Capture:
    """Profile what runs inside it when enabled; the window itself is what
    runs inside `window()`.  `trace` holds the window's Trace after exit."""

    def __init__(self, enabled: bool):
        self.enabled = enabled
        self.trace: Trace | None = None
        self._prof = None

    def __enter__(self) -> "Capture":
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU,
                                             ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def window(self):
        if not self.enabled:
            return contextlib.nullcontext()
        from torch.profiler import record_function

        return record_function(WINDOW_MARK)

    def __exit__(self, *exc) -> None:
        if self._prof is None:
            return
        self._prof.__exit__(*exc)
        if exc[0] is not None:
            return
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path) as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.unlink(path)
        self.trace = summarize(events)
