"""Run one cell of the benchmark on the card and print its result line.

    python3 -m fsbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up makes the cell's inputs on the card
from the seed, opens the program's seam at its defaults and warms it with
the cell's own traffic; then `callers` closed-loop clients on one event loop
each await the seam on the next request until the window closes, and every
request still in flight is waited for.  With --trace 0 the line carries the
cell's end-to-end metrics, with --trace 1 its per-layer metrics, read from
the seam's counters and a profiler trace of the window.  Either way every
answer is then held against the plain reference, and `correct` says whether
each compared number kept its limit; those numbers are the last lines on
standard error and the last key of the line.

Without a CUDA card, or with fewer cards than the cell asks for, it prints
no result and exits 2; with jax, jaxlib, flax or t3fs loaded once the
window has closed it names them and exits 3.
"""

from __future__ import annotations

import time

_T_IMPORTED = time.perf_counter()

import argparse  # noqa: E402
import asyncio  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass  # noqa: E402

from fsbench import spec  # noqa: E402

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "t3fs"})
# how long past the close a request may take before it counts as missing
DRAIN_S = 60.0
CACHE_DIR = spec.ROOT / ".fsbench_cache"


@dataclass
class Context:
    """What a per-layer metric's reader sees: the cell's operation, the
    seam's counters over the traced window and the window's trace."""
    op: object
    counters: dict
    trace: object


def process_age_s() -> float:
    """Seconds since this process started (its start time in /proc), or
    since this module was imported where /proc does not say."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        age = time.clock_gettime(time.CLOCK_BOOTTIME) \
            - start_ticks / os.sysconf("SC_CLK_TCK")
        if 0 <= age < 3600:
            return age
    except (OSError, ValueError, IndexError):
        pass
    return time.perf_counter() - _T_IMPORTED


def loaded_forbidden() -> list[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def power_limit(index: int) -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


async def _drive(op, callers: int, take, log: list, errors: list) -> None:
    """`callers` closed-loop clients; take() gives the next request's
    number, or None once no more are to be made."""
    async def client() -> None:
        while True:
            seq = take()
            if seq is None:
                return
            t_sub = time.perf_counter()
            try:
                answer = await op.call(seq)
            except Exception as e:      # a failed request counts; the run goes on
                log.append((seq, t_sub, None))
                errors.append(f"request {seq}: {e!r}")
                continue
            t_done = time.perf_counter()
            op.keep(seq, answer)
            log.append((seq, t_sub, t_done))

    await asyncio.gather(*(client() for _ in range(callers)))


class _Requests:
    def __init__(self):
        self.next = 0
        self.limit = None           # make requests below this number
        self.stop_at = None         # or until this clock time

    def __call__(self):
        if self.limit is not None and self.next >= self.limit:
            return None
        if self.stop_at is not None and time.perf_counter() >= self.stop_at:
            return None
        seq = self.next
        self.next += 1
        return seq


def run_cell(bench: dict, name: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", config: dict | None = None,
             traffic: dict | None = None, seam=None) -> dict:
    """The result line of one run of cell `name` (a dict, `checks` last).
    `config` and `traffic` stand in for the cell's files where given (the
    tests run cells at small sizes on the CPU); `seam(op)`, where given,
    installs another seam in the program's place (the control)."""
    import torch

    from fsbench import seams, stats
    from fsbench.trace import Capture

    cell = spec.workload(bench, name)
    traffic = traffic or spec.traffic(cell["traffic"])
    op = seams.OPS[traffic["op"]](config or spec.config(bench, cell["config"]),
                                  seed, torch.device(device))
    cuda = op.device.type == "cuda"
    marks = {"start": process_age_s()}
    op.make_inputs()
    if cuda:
        # the inputs were made on the card; the peak is the program's
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(op.device)
    loop = asyncio.new_event_loop()
    log: list = []
    errors: list = []
    reqs = _Requests()
    callers = int(traffic["callers"])
    try:
        marks["inputs"] = process_age_s()
        (seam or type(op).open)(op)
        marks["open"] = process_age_s()
        reqs.limit = int(traffic["warm_requests"])
        loop.run_until_complete(_drive(op, callers, reqs, log, errors))
        marks["warm"] = process_age_s()
        reqs.limit = None
        n_warm = len(log)
        first = reqs.next
        # set-up's objects need no more collecting
        gc.collect()
        gc.freeze()
        with Capture(trace) as cap:
            c0 = op.counters()
            with cap.window():
                t0 = time.perf_counter()
                setup_s = process_age_s()
                reqs.stop_at = t0 + seconds
                try:
                    loop.run_until_complete(asyncio.wait_for(
                        _drive(op, callers, reqs, log, errors),
                        seconds + DRAIN_S))
                except asyncio.TimeoutError:
                    errors.append(f"requests still unanswered {DRAIN_S} s "
                                  "past the close")
                if cuda:
                    torch.cuda.synchronize()
            c1 = op.counters()
        peak = torch.cuda.max_memory_allocated(op.device) if cuda else 0
        settings = op.settings()
    finally:
        loop.run_until_complete(op.close())
        loop.close()
    gc.unfreeze()
    counters = {k: c1[k] - c0[k] for k in c0}
    window = log[n_warm:]
    attempted = reqs.next - first
    stop_at = t0 + seconds
    done = [t for _s, _a, t in window if t is not None and t <= stop_at]
    # a request never answered, or cut off by the drain's limit, has no
    # latency: it misses any limit
    lat_ms = [(t - a) * 1e3 if t is not None else math.inf
              for _s, a, t in window] + [math.inf] * (attempted - len(window))
    failed = attempted - sum(1 for _s, _a, t in window if t is not None)

    metrics: dict = {}
    units = {}
    if trace:
        ctx = Context(op=op, counters=counters, trace=cap.trace)
        for m in spec.per_layer(bench, name):
            value = spec.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = value
            units[m["name"]] = m["unit"]
    else:
        e2e = {"payload_GBps": len(done) * op.bytes_per_request / seconds / 1e9,
               "op_p95_ms": stats.percentile(lat_ms, 95) if lat_ms else math.inf,
               "setup_s": setup_s}
        for m in spec.end_to_end(bench, name):
            metrics[m["name"]] = e2e[m["name"]]
            units[m["name"]] = m["unit"]

    # the program's state is gone; free the inputs, then the reference
    made = list(range(reqs.next))
    op.pool = None
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    checks = op.check(made)
    for e in errors[:5]:
        print(f"fsbench: {e}", file=sys.stderr)

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(op.device) if cuda else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    if trace:
        dev["busy_s"] = cap.trace.busy_s
        dev["window_s"] = cap.trace.window_s
    if cuda:
        dev["power_limit"] = power_limit(op.device.index or 0)
    result = {
        "correct": all(v <= lim for v, lim in checks.values()),
        "attempted": attempted, "failed": failed,
        "metrics": {k: {"value": _finite(v), "unit": units[k]}
                    for k, v in metrics.items()},
        "device": dev,
    }
    if trace:
        result["breakdown"] = cap.trace.breakdown()
        result["counters"] = counters
    result["seam"] = settings
    # where set-up went: process start to the harness, the inputs, the
    # seam's opening (library load or build, tables), the warm-up traffic
    names = list(marks)
    result["setup_split_s"] = {
        "to_harness": marks["start"],
        **{n: marks[n] - marks[p] for p, n in zip(names, names[1:])},
        "to_window": setup_s - marks["warm"]}
    result["requests"] = {"warm": n_warm, "window": len(window),
                          "completed_in_window": len(done)}
    # the rate in each quarter of the window: drift within a run
    quarter = seconds / 4
    result["rate_quarters_GBps"] = [
        sum(1 for t in done if t0 + i * quarter < t <= t0 + (i + 1) * quarter)
        * op.bytes_per_request / quarter / 1e9 for i in range(4)]
    if lat_ms:
        result["latency_ms"] = {f"p{q}": _finite(stats.percentile(lat_ms, q))
                                for q in (50, 90, 95, 99, 100)}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def _finite(v: float) -> float:
    # a failed request makes a tail infinite; JSON has no infinity
    return v if math.isfinite(v) else 1e300


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fsbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = spec.load_bench()
    chips = int(spec.workload(bench, args.workload)["chips"])
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("CUDA_CACHE_PATH", "nv")):
        os.environ.setdefault(var, str(CACHE_DIR / sub))

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"fsbench: {args.workload} needs {chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}: no result",
              file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace))
    bad = loaded_forbidden()
    if bad:
        print(f"fsbench: loaded after the window: {', '.join(bad)}: no result",
              file=sys.stderr)
        return 3
    print(f"fsbench: {args.workload} seed {args.seed} on "
          f"{result['device']['kind']}, power.limit "
          f"{result['device'].get('power_limit')}", file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
