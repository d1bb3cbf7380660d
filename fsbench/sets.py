"""Run a set of runs of one cell, one process a run, and report each metric's
median and spread (the distance between the quartiles over the median).

    python3 -m fsbench.sets --workload <name> --seeds <a,b,...> --seconds <s>
        [--trace 0|1] [--out <file.jsonl>]

The runs go one after another on the machine it is started on; each run's
line, exit code and wall time are appended to --out.  A cell's bound is set
from two such sets on the same seeds.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

from fsbench.stats import spread

RUN_TIMEOUT_S = 1300


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    cmd = [sys.executable, "-m", "fsbench.run", "--workload", workload,
           "--seed", str(seed), "--seconds", str(seconds), "--trace", str(trace)]
    t = time.perf_counter()
    try:
        p = subprocess.run(cmd, capture_output=True, text=True,
                           timeout=RUN_TIMEOUT_S)
        rc, out, err = p.returncode, p.stdout, p.stderr
    except subprocess.TimeoutExpired as e:
        rc, out, err = 124, e.stdout or "", e.stderr or ""
        out = out if isinstance(out, str) else out.decode(errors="replace")
        err = err if isinstance(err, str) else err.decode(errors="replace")
    wall = time.perf_counter() - t
    lines = out.strip().splitlines()
    try:
        result = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "seconds": seconds,
            "trace": trace, "rc": rc, "wall_s": wall, "result": result,
            "stderr_tail": err[-2000:]}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="fsbench.sets")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    values: dict[str, list[float]] = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        rec = one(args.workload, seed, args.seconds, args.trace)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        r = rec["result"] or {}
        ms = {k: v["value"] for k, v in r.get("metrics", {}).items()}
        for k, v in ms.items():
            values.setdefault(k, []).append(v)
        print(json.dumps({"seed": seed, "rc": rec["rc"],
                          "wall_s": round(rec["wall_s"], 1),
                          "correct": r.get("correct"), "metrics": ms,
                          "power_limit": r.get("device", {}).get("power_limit"),
                          "checks": r.get("checks")}), flush=True)
        if rec["rc"] != 0 or not r:
            print(rec["stderr_tail"], file=sys.stderr)
    for k, vs in values.items():
        line = {"metric": k, "n": len(vs), "median": statistics.median(vs)}
        if len(vs) >= 2:
            line["spread"] = spread(vs)
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
