"""The harness end to end at small sizes: on the CPU through the program's
plain versions, with faults planted under the timed path, with the control
in the program's place, and as a process without a card."""

import json
import os
import subprocess
import sys

import pytest
import torch

from fsbench import run, seams, spec, trace
from fsbench.control import control_seam

BENCH = spec.load_bench()
# a cell whose op and traffic the harness keeps for a later BENCHMARK.json
# entry: held to the same checks here
HELD = [{"name": "rs32-degraded-1m-c64", "config": "rs32-1m",
         "traffic": "degraded1-c64", "chips": 1}]
BENCH["workloads"] = BENCH["workloads"] + HELD
TIMEOUT_S = 300
CELLS = [w["name"] for w in BENCH["workloads"]]


def small(cell: str) -> tuple[dict, dict]:
    """The cell's config and traffic at a size a test run holds: 64 KiB
    chunks (the CRC seam's smallest device payload) or 4 KiB shards."""
    w = spec.workload(BENCH, cell)
    cfg = dict(spec.config(BENCH, w["config"]))
    if "chunk_bytes" in cfg:
        cfg.update(chunk_bytes=64 << 10, pool_buffers=16)
    else:
        cfg.update(shard_bytes=4096, pool_stripes=16)
    traffic = dict(spec.traffic(w["traffic"]), callers=8, warm_requests=16)
    return cfg, traffic


@pytest.fixture(autouse=True)
def _sample_half(monkeypatch):
    """At 16 stripes, hold half the answers' bytes against the reference."""
    monkeypatch.setattr(seams, "SAMPLE_RATE", 0.5)
    monkeypatch.setattr(seams, "SAMPLE_CAP", 16)


def run_small(cell: str, seed: int = 2**31 + 7, **kw) -> dict:
    cfg, traffic = small(cell)
    return run.run_cell(BENCH, cell, seed, 0.5, False, device="cpu",
                        config=cfg, traffic=traffic, **kw)


def _env() -> dict:
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return env


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    r = run_small(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert all(c["value"] == 0 for c in r["checks"].values())
    assert set(r["metrics"]) == {m["name"] for m in spec.end_to_end(BENCH, cell)}
    assert r["metrics"]["payload_GBps"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
    r = run_small(cell, seam=control_seam)
    assert not r["correct"]


def _flip_first_row(fn):
    def faulty(x, *a):
        out = fn(x, *a).clone()
        out[0] ^= 1
        return out
    return faulty


def _first_half(fn):
    def faulty(x, *a):
        out = fn(x, *a).clone()
        out[len(out) // 2:] = 0
        return out
    return faulty


def _unchanged(name):
    def faulty(x, *a):
        if name == "crc_words_raw":
            return torch.zeros(x.shape[0], dtype=torch.int32, device=x.device)
        rows = 2 if name == "rs_raid6_words" else 1
        return x[:, :rows].clone()
    return faulty


FAULTS = {
    # an answer altered where it is produced
    "altered": _flip_first_row,
    # half of the batch left out: its answers never computed
    "half_batch": _first_half,
    # a step that hands back what it was given, or nothing it computed
    "unchanged": None,
}
KERNELS = {"craq-crc-4m-c128": ["crc_words_raw"],
           "rs32-encode-1m-c64": ["crc_words_raw", "rs_raid6_words"],
           "rs32-degraded-1m-c64": ["crc_words_raw", "rs_reconstruct_words"]}


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell,kernel",
                         [(c, k) for c, ks in KERNELS.items() for k in ks])
def test_a_fault_under_the_timed_path_is_caught(cell, kernel, fault, monkeypatch):
    from t3fs_torch.ops import cuda_codec

    orig = getattr(cuda_codec, kernel)
    make = FAULTS[fault]
    monkeypatch.setattr(cuda_codec, kernel,
                        _unchanged(kernel) if make is None else make(orig))
    r = run_small(cell)
    assert not r["correct"], r["checks"]


def test_run_without_a_card_prints_no_result():
    p = subprocess.run([sys.executable, "-m", "fsbench.run", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=spec.ROOT, env=_env(), capture_output=True,
                       text=True, timeout=TIMEOUT_S)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
    assert "no result" in p.stderr.strip().splitlines()[-1]


def test_harness_and_reference_load_no_jax_and_the_reference_no_program():
    code = (
        "import sys, json\n"
        "import fsbench.reference\n"
        "ref = sorted({m.split('.')[0] for m in sys.modules})\n"
        "import fsbench.run, fsbench.seams, fsbench.spec, fsbench.trace, "
        "fsbench.control, fsbench.sets, fsbench.stats, fsbench.roofline\n"
        "from fsbench import spec\n"
        "b = spec.load_bench()\n"
        "[spec.reader(m['name']) for m in b['per_layer']]\n"
        "print(json.dumps([ref, sorted({m.split('.')[0] for m in sys.modules})]))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=_env(),
                       capture_output=True, text=True, timeout=TIMEOUT_S)
    assert p.returncode == 0, p.stderr
    ref, harness = json.loads(p.stdout.strip().splitlines()[-1])
    assert not {"jax", "jaxlib", "flax", "t3fs", "t3fs_torch"} & set(ref)
    assert not {"jax", "jaxlib", "flax", "t3fs"} & set(harness)


def test_trace_summary_of_a_window():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_MARK,
         "ts": 100.0, "dur": 1000.0},
        {"ph": "X", "cat": "kernel", "name": "void crc_mma_kernel<true>(int)",
         "ts": 150.0, "dur": 100.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD (Pinned -> Device)",
         "ts": 200.0, "dur": 100.0, "args": {"bytes": 4096}},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 1200.0, "dur": 5.0},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaEventSynchronize",
         "ts": 300.0, "dur": 500.0},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 350.0,
         "dur": 100.0},
    ]
    t = trace.summarize(ev)
    assert t.window_s == pytest.approx(1e-3)
    assert t.busy_s == pytest.approx(150e-6)
    assert t.h2d_bytes == 4096
    assert t.kernel_seconds(("crc_mma_kernel",)) == pytest.approx(100e-6)
    # a gap's time goes to the innermost host op running in it, the rest
    # to no traced op
    assert t.gaps == pytest.approx({trace.UNTRACED: 50e-6 + 300e-6,
                                    "host: aten::copy_": 100e-6,
                                    "host: cudaEventSynchronize": 400e-6})
    assert [n for n, _s in t.breakdown()["device_ops"]] == [
        "crc_mma_kernel<true>", "Memcpy HtoD (Pinned -> Device)"]


@pytest.mark.cuda
def test_cells_and_control_on_the_card_at_small_sizes():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        cfg, traffic = small(cell)
        r = run.run_cell(BENCH, cell, 11, 0.5, False, device="cuda",
                         config=cfg, traffic=traffic)
        assert r["correct"], r["checks"]
        r = run.run_cell(BENCH, cell, 11, 0.5, False, device="cuda",
                         config=cfg, traffic=traffic, seam=control_seam)
        assert not r["correct"]
