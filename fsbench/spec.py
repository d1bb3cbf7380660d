"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (its file in BENCHMARK.json) and a traffic mix
(fsbench/traffic/<name>.json); a per-layer metric is read by
fsbench/metrics/<name>.py, whose `read(ctx)` returns a number or None.
Adding a cell, a configuration, a mix or a metric adds files and entries and
edits none."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_bench(root: Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _named(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def workload(bench: dict, name: str) -> dict:
    return _named(bench["workloads"], name, "workload")


def config(bench: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(bench["configs"], name, "config")
    with open(root / entry["file"]) as f:
        return json.load(f)


def traffic(name: str) -> dict:
    with open(HERE / "traffic" / f"{name}.json") as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def end_to_end(bench: dict, cell: str) -> list[dict]:
    return [m for m in bench["end_to_end"] if _applies(m, cell)]


def per_layer(bench: dict, cell: str) -> list[dict]:
    reported = {m["name"] for m in end_to_end(bench, cell)}
    return [m for m in bench["per_layer"]
            if _applies(m, cell) and m["moves"] in reported]


def reader(name: str):
    """fsbench/metrics/<name>.py's read(ctx)."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fsbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
