"""Mixed-workload soak bench: run a configs/soak*.toml scenario in two
cells — faults OFF (the fairness-gated baseline) and faults ON (live
straggler/crash/bit-rot while traffic runs) — and emit one JSON blob
with per-workload p50/p99/throughput, Jain fairness, the gate verdicts,
and the worst-p99 tail-sampled trace.

    python -m t3fs_torch.benchmarks.soak_bench --config configs/soak.toml \
        --cells both --repeat 3 --json
    python -m t3fs_torch.benchmarks.soak_bench --config \
        configs/soak_smoke.toml --cpu --json   # the harness on the host

Cells repeat `--repeat` times; scalar metrics report the median run
(per docs/bench_protocol.md), picked by fairness so the reported
p50/p99/fairness numbers all come from ONE coherent run rather than a
per-metric mix.

The port of benchmarks/soak_bench.py, with the same arguments, cells,
JSON keys and exit code (1 when a gate fails).  The runner's cluster puts
every node's CRCs on the CUDA checksum backend and every EC client's codec
on the card; --device is accepted and names that default; --cpu runs the
host CRC and the codec's plain versions.  Without a GPU and without --cpu
the bench raises.
"""

from __future__ import annotations

import argparse
import asyncio
import copy
import json
import sys

from t3fs_torch import resolve_device


def median_run(reports: list[dict]) -> dict:
    """The run whose fairness is the median of the cell's repeats."""
    ranked = sorted(reports, key=lambda r: r["fairness"])
    return ranked[len(ranked) // 2]


async def run_cell(spec, faults_on: bool, repeat: int,
                   verbose: bool, checksum_backend: str = "cuda") -> dict:
    from t3fs_torch.soak.runner import SoakRunner
    reports = []
    trace = ""
    for i in range(repeat):
        s = copy.deepcopy(spec)
        if not faults_on:
            s.faults = []
        s.seed = spec.seed + i          # fresh arrival pattern per repeat
        progress = (lambda m: print(f"# {m}", file=sys.stderr)) \
            if verbose else (lambda m: None)
        runner = SoakRunner(s, progress=progress,
                            checksum_backend=checksum_backend)
        rep = await runner.run(require_fairness=not faults_on)
        d = rep.to_dict()
        reports.append(d)
        if rep.worst_trace_rendered:
            trace = rep.worst_trace_rendered
        print(f"# cell {'on' if faults_on else 'off'} run {i + 1}/"
              f"{repeat}: fairness={d['fairness']} "
              f"wrong_bytes={d['wrong_bytes']} passed={d['passed']}",
              file=sys.stderr)
    med = median_run(reports)
    med["fairness_runs"] = [r["fairness"] for r in reports]
    med["p99_spread_ms"] = {
        name: sorted(round(r["workloads"][name]["p99_ms"], 1)
                     for r in reports)
        for name in med["workloads"]}
    med["worst_trace_excerpt"] = "\n".join(trace.splitlines()[:12])
    return med


async def amain(args) -> dict:
    from t3fs_torch.soak import load_spec
    spec = load_spec(args.config)
    if args.duration:
        spec.duration_s = args.duration
    out = {"config": args.config, "duration_s": spec.duration_s,
           "repeat": args.repeat}
    backend = "cpu" if args.cpu else "cuda"
    if args.cells in ("both", "off"):
        out["faults_off"] = await run_cell(spec, False, args.repeat,
                                           args.verbose, backend)
    if args.cells in ("both", "on"):
        out["faults_on"] = await run_cell(spec, True, args.repeat,
                                          args.verbose, backend)
    # headline: did every cell pass its gates?
    out["passed"] = all(out[c]["passed"]
                        for c in ("faults_off", "faults_on") if c in out)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--config", default="configs/soak.toml")
    ap.add_argument("--cells", choices=("both", "off", "on"),
                    default="both")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--duration", type=float, default=0.0,
                    help="override spec duration_s")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--verbose", action="store_true")
    ap.add_argument("--device", action="store_true",
                    help="every node's CRCs and the EC codecs on the card "
                         "(the default)")
    ap.add_argument("--cpu", action="store_true",
                    help="the nodes' CRCs on the host, the codec on its "
                         "plain versions")
    args = ap.parse_args(argv)
    # the card unless asked for the CPU: raises where no GPU is present
    resolve_device("cpu" if args.cpu else "cuda")
    result = asyncio.run(amain(args))
    if args.json:
        print(json.dumps(result))
    else:
        print(json.dumps(result, indent=1))
    if not result["passed"]:
        sys.exit(1)


if __name__ == "__main__":
    main()
