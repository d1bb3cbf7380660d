"""The port's structured traces (t3fs_torch.analytics.{trace_log,
trace_query}, the storage service's StorageEventTrace hook and
MetaEventLog's Parquet sink) against the JAX package's: the same rows give
Parquet files that read back equal in either package, trace_query answers
alike, a seeded CRAQ update sequence through each package's fabric writes
the same StorageEventTrace rows on every node, and a seeded namespace
sequence writes the same MetaEventTrace rows.

The trace's wall stamps (ts) are pinned in both packages with monkeypatch;
the latency columns (latency_s, forward_s, apply_s) are timings and are
checked for sign only.  Nothing in either package changes for it."""

import asyncio
import dataclasses
import os

import numpy as np
import pytest

pytest.importorskip("pyarrow")

import t3fs.analytics.trace_log as ref_tl          # noqa: E402
import t3fs.analytics.trace_query as ref_tq        # noqa: E402
import t3fs.storage.service as ref_service          # noqa: E402
import t3fs_torch.analytics.trace_log as port_tl   # noqa: E402
import t3fs_torch.analytics.trace_query as port_tq  # noqa: E402
import t3fs_torch.storage.service as port_service   # noqa: E402
import torch_storage_diff as sd                    # noqa: E402
from test_torch_meta import PKGS as META_PKGS     # noqa: E402
from test_torch_meta import make_ops as meta_ops  # noqa: E402
from test_torch_meta import pin                   # noqa: E402,F401
from test_torch_meta import run_sequence as meta_sequence  # noqa: E402

TL = {"ref": ref_tl, "port": port_tl}
TQ = {"ref": ref_tq, "port": port_tq}
TIMED = ("latency_s", "forward_s", "apply_s")


def _rows(tl, n: int = 60, seed: int = 5) -> list:
    rng = np.random.default_rng(seed)
    return [tl.StorageEventTrace(
        ts=1_700_000_000.0 + i, node_id=1 + i % 3, target_id=101 + i % 3,
        chain_id=1 + i % 2, chunk_id=f"7.{i}",
        update_ver=int(rng.integers(1, 9)), commit_ver=i,
        update_type=("write", "truncate", "remove")[i % 3],
        length=int(rng.integers(0, 1 << 20)),
        checksum=int(rng.integers(0, 1 << 32)),
        forward_status=0, commit_status=0 if i % 10 else 5016,
        latency_s=0.001 * (1 + i % 3), forward_s=0.0005, apply_s=0.0002)
        for i in range(n)]


def _write(tl, path: str, rows) -> None:
    log = tl.StructuredTraceLog(tl.StorageEventTrace, path, rows_per_group=16,
                                flush_interval_s=0.05)
    for r in rows:
        log.append(r)
    log.close()
    assert log.rows_written == len(rows) and log.rows_dropped == 0


@pytest.mark.parametrize("writer,reader", [("ref", "port"), ("port", "ref"),
                                           ("port", "port")])
def test_parquet_rows_read_back_equal(tmp_path, writer, reader):
    rows = _rows(TL[writer])
    path = str(tmp_path / "ev.parquet")
    _write(TL[writer], path, rows)
    want = [dataclasses.asdict(r) for r in rows]
    got = list(TL[reader].read_trace(path, TL[reader].StorageEventTrace))
    assert [dataclasses.asdict(r) for r in got] == want
    assert list(TL[reader].read_trace(path)) == want


def test_parquet_files_equal_across_packages(tmp_path):
    tables = {}
    for pkg, tl in TL.items():
        path = str(tmp_path / f"{pkg}.parquet")
        _write(tl, path, _rows(tl))
        import pyarrow.parquet as pq
        tables[pkg] = pq.read_table(path, use_threads=False)
    assert tables["port"].schema == tables["ref"].schema
    assert tables["port"].equals(tables["ref"])


def test_trace_query_answers_equal(tmp_path):
    for pkg, tl in TL.items():
        d = tmp_path / pkg
        d.mkdir()
        _write(tl, str(d / "ev.parquet"), _rows(tl))
        # a meta events file beside it: the schema gate skips it
        mlog = tl.StructuredTraceLog(
            META_PKGS[0 if pkg == "ref" else 1].events.MetaEventTrace,
            str(d / "meta_events.parquet"))
        mlog.append(META_PKGS[0 if pkg == "ref" else 1].events.MetaEventTrace(
            ts=1.0, event="mkdir"))
        mlog.close()

    def answers(pkg):
        tq, d = TQ[pkg], str(tmp_path / pkg)
        out = {}
        for by in ("node", "target", "chain"):
            out[by] = [dataclasses.asdict(g) for g in tq.top([d], by=by)]
        out["errors_n2"] = list(tq.iter_rows([d], node=2, errors_only=True))
        out["chain1"] = len(list(tq.iter_rows([d], chain=1)))
        return out

    ref, port = answers("ref"), answers("port")
    assert sum(g["count"] for g in ref["node"]) == 60
    assert ref["errors_n2"] and ref["chain1"] == 30
    assert port == ref


# ------------------------------------------------ the storage service hook

class _WallClock:
    """storage.service's time module with time() pinned: perf_counter
    stays real (the timing columns), time() is one instant."""
    perf_counter = staticmethod(__import__("time").perf_counter)
    monotonic = staticmethod(__import__("time").monotonic)

    @staticmethod
    def time() -> float:
        return 1_700_000_123.0


async def _fabric_trace(fabric, tl, types, crc32c, ops, tmp: str) -> dict:
    await fabric.start()
    logs = []
    try:
        for i, node in enumerate(fabric.nodes):
            node.trace_log = tl.StructuredTraceLog(
                tl.StorageEventTrace, os.path.join(tmp, f"n{i}.parquet"),
                flush_interval_s=0.05)
            logs.append(node.trace_log)
        result = await sd.drive(fabric, types, crc32c, ops)
    finally:
        for log in logs:
            log.close()
        await fabric.stop()
    rows = []
    for log in logs:
        node_rows = [dataclasses.asdict(r) for r in
                     tl.read_trace(log.path, tl.StorageEventTrace)]
        for r in node_rows:
            assert r["latency_s"] > 0 and r["apply_s"] >= 0
            for k in TIMED:
                r.pop(k)
        rows.append(node_rows)
    return {"rows": rows, "result": result}


def test_storage_event_trace_rows_match_reference(tmp_path, monkeypatch):
    monkeypatch.setattr(ref_service, "_time", _WallClock)
    monkeypatch.setattr(port_service, "_time", _WallClock)
    ops = sd.make_ops(7)
    runs = {}
    for pkg in ("ref", "port"):
        d = tmp_path / pkg
        d.mkdir()
        if pkg == "ref":
            fab = sd.RefFabric(num_nodes=3, replicas=3,
                               checksum_backend="cpu")
            types, crc = sd.ref_types, sd.ref_codec.crc32c
        else:
            fab = sd.PortFabric(num_nodes=3, replicas=3,
                                checksum_backend="cpu")
            types, crc = sd.port_types, sd.port_codec.crc32c
        runs[pkg] = asyncio.run(_fabric_trace(fab, TL[pkg], types, crc, ops,
                                              str(d)))
    ref, port = runs["ref"], runs["port"]
    # one row per update hop on each of the three replicas
    assert [len(r) for r in ref["rows"]] == [len(ops)] * 3
    assert {r["update_type"] for r in ref["rows"][0]} == {
        "write", "truncate", "remove"}
    assert all(r["ts"] == _WallClock.time() for r in ref["rows"][2])
    assert port["result"] == ref["result"]
    assert port["rows"] == ref["rows"]


# ------------------------------------------------------ the meta events sink

def test_meta_event_parquet_rows_match_reference(tmp_path, monkeypatch, pin):
    """A seeded namespace sequence through each package's MetaStore, its
    MetaEventLog writing Parquet: the same rows, which either package
    reads."""
    ops = meta_ops(1)
    rows = {}
    for p, pkg in zip(META_PKGS, ("ref", "port")):
        pin()
        path = str(tmp_path / f"{pkg}.parquet")
        opened = []
        orig = p.events.MetaEventLog

        def factory(*a, _orig=orig, _path=path, _opened=opened, **kw):
            log = _orig(_path, **kw)
            _opened.append(log)
            return log
        monkeypatch.setattr(p.events, "MetaEventLog", factory)
        _, _, lines = asyncio.run(meta_sequence(p, ops))
        monkeypatch.setattr(p.events, "MetaEventLog", orig)
        for log in opened:
            log.close()
        assert len(opened) == 1 and opened[0].appended == len(lines)
        rows[pkg] = [dataclasses.asdict(r) for r in TL[pkg].read_trace(
            path, p.events.MetaEventTrace)]
        # and the other package reads the same rows from this file
        other = TL["port" if pkg == "ref" else "ref"]
        assert list(other.read_trace(path)) == rows[pkg]
    assert len(rows["ref"]) > 20
    assert rows["port"] == rows["ref"]


def test_trace_sink_without_pyarrow_fails_loudly(tmp_path, monkeypatch):
    """Where pyarrow is missing, opening a sink raises ImportError: the
    meta event log and the trace log never drop the trace without a word."""
    import builtins

    real = builtins.__import__

    def no_pyarrow(name, *a, **kw):
        if name == "pyarrow" or name.startswith("pyarrow."):
            raise ImportError("No module named 'pyarrow'")
        return real(name, *a, **kw)

    monkeypatch.setattr(builtins, "__import__", no_pyarrow)
    with pytest.raises(ImportError):
        port_tl.StructuredTraceLog(port_tl.StorageEventTrace,
                                   str(tmp_path / "x.parquet"))
    with pytest.raises(ImportError):
        META_PKGS[1].events.MetaEventLog(str(tmp_path / "m.parquet"))
    # the log-line-only setting needs no pyarrow
    assert META_PKGS[1].events.MetaEventLog("")._trace is None
