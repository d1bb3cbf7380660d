"""Device-time micro-benchmark harness on the GPU: twin of
benchmarks/devbench.py.

A chained pass runs `iters` dependent iterations of an op: each iteration
XOR-perturbs the working input with the running scalar `acc`, runs the op,
and folds the first and last element of every output tensor into `acc`
(then `acc |= 1`), so no iteration can be skipped or reordered.  `acc`
stays a 0-d device tensor: nothing syncs inside the loop, and each pass is
timed with CUDA events on the current stream.  The perturbation costs one
elementwise r+w pass over the input; a chain of H1 (`make_copy3d`, x + 1 in
a hand-written kernel, csrc/copy3d.cu) is two identical such passes, so
half its time per iteration calibrates that overhead.  Each timed pass is
captured once in a CUDA graph and replayed, one launch a pass.

    python -m t3fs_torch.benchmarks.devbench   # one r+w pass over 16 x 8 x 1 MiB
"""

from __future__ import annotations

import subprocess
import sys
import time

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.ops.cuda_codec import _check_cuda, _check_words, _stream

# launches of H1 by make_copy3d (kernel launches only, never the plain
# version)
launches: dict[str, int] = {"copy3d": 0}


def reset_launches() -> None:
    launches["copy3d"] = 0


# --- H1: the calibration pass -------------------------------------------------

def copy3d_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of make_copy3d: x + 1 on the int32 view (wraps as u32)."""
    return x + 1


def make_copy3d(x: torch.Tensor) -> torch.Tensor:
    """(n, k, W) int32 words -> (n, k, W) int32, each word + 1 as uint32,
    wrapping at 2^32: the calibration op.  Returns the array's own shape,
    not the JAX version's (n, k, W // 2048, 2048) view, which was the TPU's
    tiling."""
    _check_words(x, 3, "make_copy3d")
    if x.device.type == "cpu":
        return copy3d_plain(x)
    _check_cuda(x, "make_copy3d", aligned=False)
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    from t3fs_torch.ops._build import check, library

    lib = library("copy3d")
    check(lib, lib.t3fs_copy3d(x.data_ptr(), out.data_ptr(), x.numel(), _stream(x)),
          "make_copy3d")
    launches["copy3d"] += 1
    return out


# --- the chained harness ------------------------------------------------------

def _fold(out) -> torch.Tensor:
    """One iteration's acc: XOR of the first and last element of every output
    tensor (one element alone could sit in a part of a concat that the op
    computed without the rest), then | 1."""
    acc = None
    for leaf in out if isinstance(out, (tuple, list)) else (out,):
        flat = leaf.reshape(-1)
        v = flat[0].to(torch.int32) ^ flat[-1].to(torch.int32)
        acc = v if acc is None else acc ^ v
    return acc | 1


def _chain(op, x: torch.Tensor, iters: int) -> torch.Tensor:
    """The chained loop over the working tensor x, perturbed in place;
    returns acc, a 0-d int32 tensor on x's device."""
    acc = torch.zeros((), dtype=torch.int32, device=x.device)
    for _ in range(iters):
        x ^= acc
        acc = _fold(op(x))
    return acc


def _build_chained(op, iters: int):
    """run(x0) -> acc of `iters` chained iterations; x0 is not mutated (the
    loop perturbs a clone)."""
    def run(x0: torch.Tensor) -> torch.Tensor:
        return _chain(op, x0.clone(), iters)
    return run


def chained_acc(op, x: torch.Tensor, iters: int) -> int:
    """The final acc of a chained pass as a uint32 int, on any device: the
    value the JAX harness's _build_chained(op, iters)(x) returns."""
    return int(_build_chained(op, iters)(x)) & 0xFFFFFFFF


def _need_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError("the harness times with CUDA events on the card; got a "
                         f"tensor on {x.device}")


def _events() -> tuple[torch.cuda.Event, torch.cuda.Event]:
    return (torch.cuda.Event(enable_timing=True),
            torch.cuda.Event(enable_timing=True))


def chained_timer(op, x: torch.Tensor, iters: int = 100):
    """A zero-arg callable timing ONE chained pass, in seconds, so callers
    can interleave measurement and calibration reps.

    The pass is captured once in a CUDA graph and replayed: one launch for
    the whole loop, as the JAX harness's jitted fori_loop is one dispatch,
    so the host's enqueue of the loop's dozen-odd launches an iteration
    (chained_enqueue) cannot pace the card.  The capture is checked against
    an eager pass's acc.  Python launch counters run during that eager pass
    and the capture, not on replays."""
    _need_cuda(x)
    want = chained_acc(op, x, iters)            # builds the kernels, warms
    xw = x.clone()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        acc = _chain(op, xw, iters)
    start, end = _events()

    def one() -> float:
        xw.copy_(x)                             # the same input every pass
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    one()
    if int(acc) & 0xFFFFFFFF != want:
        raise RuntimeError("the captured chained pass disagrees with the eager one")
    return one


def chained_time(op, x: torch.Tensor, iters: int = 100, reps: int = 5) -> float:
    """Seconds per iteration of [xor-perturb pass + op(x)] on the card: the
    best of `reps` passes."""
    one = chained_timer(op, x, iters)
    return min(one() for _ in range(reps)) / iters


def op_time(op, x: torch.Tensor, xor_pass_s: float, iters: int = 100) -> float:
    """Seconds per op(x), with the xor-perturb pass subtracted."""
    return max(chained_time(op, x, iters) - xor_pass_s, 1e-12)


def copy_calibrate(make_copy, x: torch.Tensor, iters: int = 100, reps: int = 5) -> float:
    """The xor-pass time for tensors shaped like x: the copy loop is two
    identical r+w passes, so each is half the per-iteration time."""
    return chained_time(make_copy, x, iters, reps) / 2.0


def chained_enqueue(op, x: torch.Tensor, iters: int) -> tuple[float, float]:
    """(host seconds to enqueue one eager chained pass, the pass's device
    seconds).  Keep iters * launches per iteration under the launch queue's
    depth, or the host waits for the card and the enqueue reads as device
    time."""
    _need_cuda(x)
    xw = x.clone()
    _chain(op, xw, iters)                       # warm
    xw.copy_(x)
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    t0 = time.perf_counter()
    _chain(op, xw, iters)
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return host, start.elapsed_time(end) / 1e3


# --- plain CUDA-event times and the bench's inputs ----------------------------

def event_ms(fn, iters: int, warm: int) -> float:
    """ms per call of fn on the current stream, CUDA events around `iters`
    calls after `warm` untimed ones."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start, end = _events()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _captured(fn, calls: int) -> torch.cuda.CUDAGraph:
    """`calls` calls of fn captured once in a CUDA graph (after one call
    outside the capture, which builds and loads)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    return graph


def graph_samples(fn, calls: int = 20, reps: int = 5) -> list[float]:
    """ms per call of fn, sorted: `reps` samples, each a replay of `calls`
    calls captured once in a CUDA graph, so the host's launch overhead is
    out of calls too short to hide it."""
    graph = _captured(fn, calls)
    return sorted(event_ms(graph.replay, 1, warm=1 if i == 0 else 0) / calls
                  for i in range(reps))


def interleaved_graph_samples(fns: dict, calls: int = 20,
                              reps: int = 5) -> dict[str, list[float]]:
    """graph_samples of several fns taken in turns (a, b, a, b, ...), so a
    drift of the card's clocks falls on all of them alike: name -> sorted ms
    per call."""
    graphs = {name: _captured(fn, calls) for name, fn in fns.items()}
    for graph in graphs.values():
        event_ms(graph.replay, 1, warm=1)
    samples: dict[str, list[float]] = {name: [] for name in fns}
    for _ in range(reps):
        for name, graph in graphs.items():
            samples[name].append(event_ms(graph.replay, 1, warm=0) / calls)
    return {name: sorted(v) for name, v in samples.items()}


def median_ms(fn) -> float:
    """The median of 5 event_ms samples of 20 calls each (2 warm-up calls
    before the first)."""
    return sorted(event_ms(fn, 20, warm=2 if i == 0 else 0) for i in range(5))[2]


def bench_words(shape: tuple[int, ...],
                device: str | torch.device = "cuda") -> torch.Tensor:
    """Random uint32 words from numpy's generator at seed 0 (the reference
    bench's inputs), as int32 on `device`."""
    dev = resolve_device(device)
    words = np.random.default_rng(0).integers(0, 2**32, shape, dtype=np.uint32)
    return torch.from_numpy(words.view(np.int32)).to(dev)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def main(device: str | torch.device = "cuda") -> int:
    x = bench_words((16, 8, (1 << 20) // 4), device=device)
    nbytes = x.numel() * 4
    xor_s = copy_calibrate(make_copy3d, x)
    print(f"one r+w pass over {nbytes >> 20} MiB: {xor_s * 1e3:.3f} ms -> "
          f"{2 * nbytes / xor_s / 1e9:.0f} GB/s of device memory on {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
