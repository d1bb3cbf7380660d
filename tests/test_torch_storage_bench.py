"""The port's storage_bench and codec_economics
(t3fs_torch/benchmarks/{storage_bench,codec_economics}.py) on the CPU: the
cases of tests/test_benchmarks.py's storage_bench tests and of
tests/test_write_pipeline.py's run_write_bench smoke, run on the host CRC
(--cpu) and on B1's plain version (CudaChecksumBackend on device="cpu");
one count-bounded storage_bench write through both packages' fabrics with
equal stored chunks and ChunkMeta on every target; and codec_economics'
model held equal to the reference's at the reference's constants."""

import asyncio
import json
import random

import pytest

import benchmarks.codec_economics as ref_ce
import benchmarks.storage_bench as ref_sb
import t3fs_torch.benchmarks.codec_economics as ce
import t3fs_torch.benchmarks.storage_bench as sb
from t3fs.testing.fabric import StorageFabric as RefFabric
from t3fs_torch.storage.codec_backend import CudaChecksumBackend
from t3fs_torch.testing.fabric import StorageFabric as PortFabric
from t3fs_torch.testing.spies import checked_before_stop


def plain_b1():
    return CudaChecksumBackend(device="cpu")


# "cpu": the host CRC; "plain": the batching backend on B1's plain version
BACKENDS = {"cpu": "cpu", "plain": plain_b1}


def bench_args(backend: str, *argv: str):
    args = sb.parse_args(["--seconds", "1", "--chunk-size", "65536",
                          "--concurrency", "4", "--num-chunks", "8", *argv])
    args.checksum_backend = BACKENDS[backend]
    return args


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_storage_bench_write_mode(backend):
    res = asyncio.run(sb.run_bench(bench_args(backend, "--mode", "write")))
    assert res["ops"] > 0 and res["errors"] == 0
    assert res["MB_s"] > 0 and res["p99_ms"] > 0


@pytest.mark.parametrize("backend", sorted(BACKENDS))
def test_storage_bench_read_mode_with_checksum_verify(backend):
    res = asyncio.run(sb.run_bench(bench_args(
        backend, "--mode", "read", "--verify-checksums")))
    assert res["ops"] > 0 and res["errors"] == 0


def test_storage_bench_survives_fault_injection():
    """DebugFlags-driven injected server errors do not stop the bench, and
    the bench counts each write they fail as an error, never as an op: the
    injected INTERNAL is not retryable, so write_chunk returns it in its
    IOResult (the port's bench checks that result; the reference's drops
    it and counts the write as done)."""
    from t3fs_torch.client.storage_client import StorageClient
    from t3fs_torch.testing.spies import spied
    from t3fs_torch.utils.status import StatusCode

    results = []
    with spied(StorageClient, "write_chunk", results, result=True):
        res = asyncio.run(sb.run_bench(bench_args(
            "plain", "--mode", "write", "--inject-server-error", "0.05")))
    failed = [r for r in results if r.status.code != int(StatusCode.OK)]
    assert all(r.status.message == "INTERNAL: injected server error"
               for r in failed)
    assert res["ops"] > 0 and res["errors"] == len(failed)
    assert res["ops"] + res["errors"] <= len(results)


def test_storage_bench_trace_ab():
    res = sb.trace_ab(value_size=65536, num_ops=6, checksum_backend=plain_b1)
    for label in ("off", "rate_0.01", "rate_1.0"):
        assert res[label]["ok"] == 6 and res[label]["errors"] == 0
    assert res["rate_1.0"]["p50_vs_off"] > 0
    # the bench must leave the process untraced
    from t3fs_torch.utils.tracing import get_config
    assert get_config().sample_rate == 0.0


def replicas_of(fabric) -> list[list[tuple]]:
    """Every target's chunks, in chunk order: (inode, index, length,
    update_ver, commit_ver, chain_ver, checksum, state, bytes)."""
    out = []
    for i, node in enumerate(fabric.nodes):
        engine = node.targets[fabric.target_id(i)].engine
        out.append(sorted(
            (m.chunk_id.inode, m.chunk_id.index, m.length, m.update_ver,
             m.commit_ver, m.chain_ver, m.checksum, int(m.state),
             engine.read(m.chunk_id)) for m in engine.all_metas()))
    return out


def test_streamed_smoke_via_bench():
    """The full streamed path through the bench harness: 3-replica 1 MiB
    writes, both off and streamed, on B1's plain version; every write acked
    and every replica's chunks equal (read before the fabric stops)."""
    for mode in ("off", "streamed"):
        seen = []
        with checked_before_stop(PortFabric,
                                 lambda fab: seen.append(replicas_of(fab))):
            out = sb.run_write_bench(value_size=1 << 20, num_ops=4,
                                     concurrency=1, replicas=3,
                                     write_pipeline=mode,
                                     checksum_backend=plain_b1)
        assert out["ok"] == out["num_ops"], out
        assert out["p50_ms"] > 0
        (reps,) = seen
        assert len(reps) == 3 and len(reps[0]) == 5
        assert reps[0] == reps[1] == reps[2]


def test_write_pipeline_ab_stores_equal_replicas():
    """The write-pipeline matrix (the Makefile's write-bench, cut to 64 KiB
    and 3 ops): each mode's replicas hold equal chunks (read before each
    fabric stops; the matrix runs its modes in this order)."""
    modes = ("off", "overlap", "streamed")
    seen = []
    with checked_before_stop(PortFabric,
                             lambda fab: seen.append(replicas_of(fab))):
        res = sb.write_pipeline_ab(value_size=65536, num_ops=3, replicas=3,
                                   checksum_backend=plain_b1)
    assert len(seen) == len(modes)
    stored = dict(zip(modes, seen))
    for mode in modes:
        assert res[mode]["ok"] == 3 and res[mode]["errors"] == 0, res[mode]
        reps = stored[mode]
        assert reps[0] == reps[1] == reps[2] and len(reps[0]) == 4
    assert res["overlap"]["p50_vs_off"] > 0


class TaskClock:
    """time.perf_counter by task: each asyncio task's k-th reading is k, so
    storage_bench's timed loop runs a fixed count of ops in every writer,
    whatever the scheduling."""

    def __init__(self):
        self.calls: dict = {}

    def perf_counter(self) -> float:
        task = asyncio.current_task()
        n = self.calls.get(task, 0)
        self.calls[task] = n + 1
        return float(n)


class SeededOs:
    """os.urandom from one seeded generator."""

    def __init__(self, seed: int):
        self.rng = random.Random(seed)

    def urandom(self, n: int) -> bytes:
        return self.rng.randbytes(n)


async def bench_and_dump(mod, fabric_cls, backend) -> tuple[dict, list]:
    """storage_bench --mode write on mod's fabric, with every target's
    chunks dumped before the fabric stops."""
    dumped = []
    args = mod.parse_args(["--mode", "write", "--seconds", "3",
                           "--chunk-size", "98304", "--concurrency", "4",
                           "--num-chunks", "8"])
    args.checksum_backend = backend
    with checked_before_stop(fabric_cls,
                             lambda fab: dumped.append(replicas_of(fab))):
        res = await mod.run_bench(args)
    return res, dumped[0]


def test_count_bounded_write_matches_reference(monkeypatch):
    """The same storage_bench write through both packages' fabrics, with its
    payloads (os.urandom) and its clock pinned by monkeypatch in both
    modules: every writer runs 3 ops, so both runs write the same chunks in
    the same order.  The ops and error counts, and every target's chunk
    bytes and ChunkMeta, are equal (the port on B1's plain version, the
    reference on its host CRC); each chunk's three replicas are equal."""
    out = {}
    for name, mod, fabric_cls, backend in (
            ("ref", ref_sb, RefFabric, "cpu"),
            ("port", sb, PortFabric, plain_b1)):
        monkeypatch.setattr(mod, "os", SeededOs(2026))
        monkeypatch.setattr(mod, "time", TaskClock())
        out[name] = asyncio.run(bench_and_dump(mod, fabric_cls, backend))
    (ref_res, ref_reps), (port_res, port_reps) = out["ref"], out["port"]
    assert (port_res["ops"], port_res["errors"]) == (ref_res["ops"],
                                                     ref_res["errors"]) == (12, 0)
    assert port_res.keys() == ref_res.keys()
    assert port_reps == ref_reps
    assert ref_reps[0] == ref_reps[1] == ref_reps[2]
    assert len(ref_reps[0]) == 8
    # each chunk written once by the populate; writer w writes chunk w
    # twice and chunk w + 4 once
    assert [c[3] for c in ref_reps[0]] == [3, 3, 3, 3, 2, 2, 2, 2]


@pytest.mark.parametrize("batch_bytes", [0, 4096, 65536, 478611, 10 << 20, 1 << 30])
@pytest.mark.parametrize("link", sorted(ref_ce.INTERCONNECTS))
def test_codec_model_matches_reference(batch_bytes, link):
    """The three model functions equal the reference's at the reference's
    constants (its TPU kernel rate and dispatch cost, passed in here only)."""
    bw = ref_ce.INTERCONNECTS[link]
    assert ce.INTERCONNECTS == ref_ce.INTERCONNECTS
    assert ce.LINE_RATE_GBPS == ref_ce.LINE_RATE_GBPS
    kw = dict(kernel_gbps=ref_ce.KERNEL_GBPS, launch_s=ref_ce.LAUNCH_S)
    assert ce.sustained_gbps(batch_bytes, bw, **kw) == ref_ce.sustained_gbps(
        batch_bytes, bw)
    assert ce.pipelined_gbps(batch_bytes, bw, **kw) == ref_ce.pipelined_gbps(
        batch_bytes, bw)
    assert ce.batch_for_line_rate(bw, **kw) == ref_ce.batch_for_line_rate(bw)


def test_codec_economics_cpu_measures_its_own_constants(capsys):
    """--cpu runs the whole bench on B1's plain version: the batcher's
    counters from a storage_bench write, the kernel rate and launch cost
    measured at each batch (no constant of the reference in the output),
    and the model table over the reference's interconnects."""
    assert ce.main(["--cpu", "--seconds", "0.5", "--chunk-sizes", "65536",
                    "--json"]) == 0
    res = json.loads(capsys.readouterr().out)
    m = res["measured"]["chunk_65536"]
    assert m["batches"] > 0 and m["batched_items"] >= m["batches"]
    assert m["items_per_batch"] >= 1 and m["write_MB_s"] > 0
    card = res["card"]["chunk_65536"]
    assert card["rows"] == max(1, round(m["items_per_batch"]))
    assert res["kernel_GBps"]["chunk_65536"] > 0
    assert res["kernel_GBps"]["chunk_65536"] != ref_ce.KERNEL_GBPS
    assert res["launch_overhead_us"]["chunk_65536"] != ref_ce.LAUNCH_S * 1e6
    assert res["h2d_GBps"] is None
    assert sorted(res["model"]["chunk_65536"]) == sorted(ref_ce.INTERCONNECTS)
    row = res["model"]["chunk_65536"]["pcie4x16"]
    assert row["pipelined_GBps_at_measured_batch"] == round(ce.pipelined_gbps(
        m["batch_bytes"], 24.0, card["kernel_GBps"], card["launch_us"] / 1e6), 2)
