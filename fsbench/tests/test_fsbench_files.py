"""BENCHMARK.json and every file the harness finds by name."""

import json
import re

import pytest

from fsbench import spec

BENCH = spec.load_bench()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
        assert (spec.ROOT / p).is_dir()


def test_names_and_units():
    names = [e["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for e in BENCH[key]]
    assert all(NAME.match(n) for n in names)
    for key in ("configs", "workloads"):
        assert len({e["name"] for e in BENCH[key]}) == len(BENCH[key])
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"]) and w["chips"] in (1, 4)
    for c in BENCH["configs"]:
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])


def test_entries_have_just_their_keys():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"}}
    for section, want in keys.items():
        assert all(set(e) == want for e in BENCH[section])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
        assert _line(m["layer"])
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_finds_its_files_and_reports(cell):
    w = spec.workload(BENCH, cell)
    assert isinstance(spec.config(BENCH, w["config"]), dict)
    traffic = spec.traffic(w["traffic"])
    from fsbench.seams import OPS
    assert traffic["op"] in OPS
    e2e = {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec.per_layer(BENCH, cell)
    for m in spec.per_layer(BENCH, cell):
        assert callable(spec.reader(m["name"]))


def test_every_file_loads():
    for c in BENCH["configs"]:
        path = spec.ROOT / c["file"]
        assert any(path.is_relative_to(spec.ROOT / p) for p in BENCH["paths"])
        assert isinstance(json.loads(path.read_text()), dict)
    for path in (spec.HERE / "traffic").glob("*.json"):
        assert "op" in json.loads(path.read_text())
    for path in (spec.HERE / "metrics").glob("*.py"):
        assert callable(spec.reader(path.stem))
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
