"""The measurements that chose the designs of B1, B6 and B3
(t3fs_torch/csrc/crc_words.cu, crc_bytes.cu, rs_reconstruct_words.cu).

    python3 -m t3fs_torch.benchmarks.b1_probe [--csrc DIR [--caps 1,2,3]]

1. With --csrc, the kernels of an older checkout as built from the sources
   in DIR (its t3fs_torch/csrc/, e.g. `git archive a69e274
   t3fs_torch/csrc`, unpacked under _archive/, which .gitignore lists),
   against this checkout's:
   - B3 (RAID-6 word decode) through its C entry t3fs_rs_reconstruct_words,
     DIR's and this checkout's, in turns, twice over, at (12, 8, 256Ki
     words) and five patterns: want (0, 9), (0, 1), (0, 5), (4, 8), (3,);
   - where DIR's B1 is still the nibble-lookup design (`bc5a43a`): B1
     through its C entry t3fs_crc32c_words_raw, at 64 x 4 MiB (from HBM)
     and at 2 x 4 MiB (8 MiB, which stays in the 50 MB L2 across calls).
     With --caps, scratch copies of DIR whose `kBlocksPerSm = N` line is set
     to each N are timed too (the grid-size cap of that design in
     crc_common.cuh); DIR is not changed;
   - where DIR's B6 is still the nibble-lookup design (`6ba1fb3`): B6
     through its C entry t3fs_crc32c_bytes_raw against this checkout's B6
     (cuda_codec.crc_bytes_raw), in turns new, old, new, old, at 64 x
     4 MiB (rows aligned) and 64 x (4 MiB - 5) (rows at all 16
     misalignments).
   Each library's ptxas registers and spills are printed and kept.
2. mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc: which bit of
   a .b32 register of A pairs with which bit of B (random fragments against
   the host under PTX's fragment layout, and one-hot A against one-hot B),
   and its sustained rate in mma per clock per SM (clock64 around a loop of
   independent chains, one block an SM), beside m16n8k32 s8 for scale.

Times are CUDA events, the median of 5 samples of 20 calls (the L2-resident
one also replayed from a CUDA graph, without the host's launch overhead).
Prints one JSON line last, with the card's name and power limit.  Needs a GPU and
nvcc; the libraries go to t3fs_torch/_build/probe/.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from t3fs_torch import resolve_device
from t3fs_torch.benchmarks.devbench import card_line, graph_samples, median_ms
from t3fs_torch.ops import _build
from t3fs_torch.ops.blocks import pick_block
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.ops.tables import (
    SEG_BYTES, SEG_WORDS, _crc_word_weights, _pack_columns, codec_tables,
    crc_bytes_tables, crc_nseg)

PROBE_DIR = _build.BUILD_DIR / "probe"
# B3's patterns (chip_smoke.py's phase 10): (0, 9), the decode bench's (0, 1),
# phase 7's double erasures, a single data erasure
B3_WANTS = ((0, 9), (0, 1), (0, 5), (4, 8), (3,))
HBM_BYTES_PER_S = 3.35e12
_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int

MMA_SRC = r"""
#include <cstdint>

#define MMA_B1(c, a, b)                                                      \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "          \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"               \
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))
#define MMA_S8(c, a, b)                                                      \
  asm volatile(                                                             \
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "                    \
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};"               \
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])                      \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]))

// one warp: a (32 lanes x 4 regs), b (32 x 2) -> d (32 x 4), as the lanes hold them
__global__ void pairing_kernel(const uint32_t* a, const uint32_t* b, int* d) {
  const int l = threadIdx.x;
  uint32_t ra[4] = {a[4 * l], a[4 * l + 1], a[4 * l + 2], a[4 * l + 3]};
  uint32_t rb[2] = {b[2 * l], b[2 * l + 1]};
  int c[4] = {0, 0, 0, 0};
  MMA_B1(c, ra, rb);
  for (int i = 0; i < 4; ++i) d[4 * l + i] = c[i];
}

template <int CH, bool kB1>
__global__ void rate_kernel(int iters, long long* cycles, int* sink) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + 1) * 0x9E3779B9u * (i + 3);
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x + 7) * 0x85EBCA6Bu * (i + 5);
  int c[CH][4];
  for (int j = 0; j < CH; ++j)
    for (int i = 0; i < 4; ++i) c[j][i] = 0;
  __syncthreads();
  const long long t0 = clock64();
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      if (kB1) MMA_B1(c[j], a, b); else MMA_S8(c[j], a, b);
    }
  }
  __syncthreads();
  const long long t1 = clock64();
  if (threadIdx.x == 0) cycles[blockIdx.x] = t1 - t0;
  int s = 0;
  for (int j = 0; j < CH; ++j) s += c[j][0] ^ c[j][1] ^ c[j][2] ^ c[j][3];
  if (s == 0x7fffffff) sink[0] = s;
}

extern "C" {
int probe_pairing(const void* a, const void* b, void* d) {
  pairing_kernel<<<1, 32>>>((const uint32_t*)a, (const uint32_t*)b, (int*)d);
  return (int)cudaGetLastError();
}
int probe_rate(int b1, int chains, int blocks, int warps, int iters, void* cycles,
               void* sink) {
  long long* cy = (long long*)cycles;
  int* s = (int*)sink;
  const int t = 32 * warps;
  if (b1) {
    if (chains == 2) rate_kernel<2, true><<<blocks, t>>>(iters, cy, s);
    else if (chains == 4) rate_kernel<4, true><<<blocks, t>>>(iters, cy, s);
    else rate_kernel<8, true><<<blocks, t>>>(iters, cy, s);
  } else {
    if (chains == 2) rate_kernel<2, false><<<blocks, t>>>(iters, cy, s);
    else if (chains == 4) rate_kernel<4, false><<<blocks, t>>>(iters, cy, s);
    else rate_kernel<8, false><<<blocks, t>>>(iters, cy, s);
  }
  return (int)cudaGetLastError();
}
}
"""


def _nvcc_all(jobs: list[tuple[Path, Path]]) -> dict[str, list[str]]:
    """Compile each (source, library) pair, all at once; each library's
    ptxas lines of registers and spills, by its directory's name."""
    nvcc = _build._nvcc()
    procs = [(src, subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS, "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for src, lib in jobs]
    ptxas = {}
    for src, proc in procs:
        log, _ = proc.communicate()
        lines = [line.strip() for line in log.strip().splitlines()]
        for line in lines:
            print(f"nvcc {src.parent.name}/{src.name}: {line}", flush=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {src}")
        ptxas[src.parent.name] = [line for line in lines
                                  if "registers" in line or "spill" in line]
    return ptxas


def _scratch(csrc: Path, name: str, label: str,
             cap: int | None = None) -> tuple[Path, Path]:
    """A copy of csrc's `name`.cu and headers under PROBE_DIR/label, with
    its `kBlocksPerSm = ` line (in the source or a header) set to `cap` if
    given."""
    d = PROBE_DIR / label
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for f in [csrc / f"{name}.cu", *csrc.glob("*.cuh")]:
        text = f.read_text()
        if cap is not None and "kBlocksPerSm = " in text:
            head, tail = text.split("kBlocksPerSm = ", 1)
            text = head + f"kBlocksPerSm = {cap};" + tail.split(";", 1)[1]
        (d / f.name).write_text(text)
    return d / f"{name}.cu", d / f"lib{name}.so"


def nibble_table() -> np.ndarray:
    """The table of the nibble-lookup designs of B1 and B6: entry
    [j][v][w % 4][w // 4] is the XOR of the packed CRC columns of the set
    bits of nibble value v at bits 4j..4j+3 of word w."""
    cols = _pack_columns(_crc_word_weights().transpose(1, 2, 0)).view(np.uint32)
    table = np.zeros((8, 16, 4, 32), dtype=np.uint32)
    for j in range(8):
        for v in range(16):
            acc = np.zeros(SEG_WORDS, dtype=np.uint32)
            for t in range(4):
                if (v >> t) & 1:
                    acc ^= cols[:, 4 * j + t]
            table[j, v] = acc.reshape(32, 4).T
    return table.reshape(-1).view(np.int32)


def time_b1(lib: ctypes.CDLL, words: torch.Tensor, tables, table: torch.Tensor,
            shift_cols: torch.Tensor) -> tuple[float, float, torch.Tensor]:
    """Median ms of the lookup design's t3fs_crc32c_words_raw over `words`,
    called from the host and replayed from a CUDA graph, and its output."""
    fn = lib.t3fs_crc32c_words_raw
    fn.argtypes = [_P, _LL, _I, _I, _P, _P, _P, _P, _P, _P]
    n = words.shape[0]
    spw = pick_block(tables.nseg, 16)
    partial = torch.empty(n * (tables.nseg // spw), dtype=torch.int32, device=words.device)
    out = torch.empty(n, dtype=torch.int32, device=words.device)

    def call():
        rc = fn(words.data_ptr(), n, tables.nseg, spw, table.data_ptr(),
                tables.combine_cols.data_ptr(), shift_cols.data_ptr(),
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"t3fs_crc32c_words_raw: CUDA error {rc}")

    return median_ms(call), graph_samples(call)[2], out


def time_old_b6(lib: ctypes.CDLL, rows: torch.Tensor, tables, table: torch.Tensor,
                shift_cols: torch.Tensor) -> tuple[float, torch.Tensor]:
    """Median ms of the lookup design's t3fs_crc32c_bytes_raw over `rows`
    (runs of pick_block(nseg, 16) segments, as its wrapper chose), and its
    output."""
    fn = lib.t3fs_crc32c_bytes_raw
    fn.argtypes = [_P, _LL, _LL, _I, _I, _P, _P, _P, _P, _P, _P]
    n, L = rows.shape
    spw = pick_block(tables.nseg, 16)
    partial = torch.empty(n * (tables.nseg // spw), dtype=torch.int32, device=rows.device)
    out = torch.empty(n, dtype=torch.int32, device=rows.device)

    def call():
        rc = fn(rows.data_ptr(), n, L, tables.nseg, spw, table.data_ptr(),
                tables.combine_cols.data_ptr(), shift_cols.data_ptr(),
                partial.data_ptr(), out.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"t3fs_crc32c_bytes_raw: CUDA error {rc}")

    return median_ms(call), out


def probe_b6(lib_path: Path) -> dict:
    """This checkout's B6 against the lookup B6 in `lib_path`, in turns new,
    old, new, old, at 64 x 4 MiB and 64 x (4 MiB - 5)."""
    from t3fs_torch.ops import cuda_codec as cc

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261017)
    lib = ctypes.CDLL(str(lib_path))
    table = torch.from_numpy(nibble_table()).to(dev)
    shift_cols = torch.from_numpy(
        _pack_columns(default_matrices().shift_matrix(SEG_BYTES))).to(dev)
    res = {}
    for label, L in (("64 x 4 MiB", 4 << 20), ("64 x (4 MiB - 5)", (4 << 20) - 5)):
        rows = torch.randint(0, 256, (64, L), dtype=torch.uint8, device=dev, generator=g)
        tables = crc_bytes_tables(crc_nseg(L), device=dev)
        ref = cc.crc_bytes_raw_plain(rows[:2], tables)
        times: dict[str, list[float]] = {"new": [], "old": []}
        exact = True
        for turn in ("new", "old", "new", "old"):
            if turn == "new":
                ms = median_ms(lambda: cc.crc_bytes_raw(rows, tables))
                out = cc.crc_bytes_raw(rows, tables)
            else:
                ms, out = time_old_b6(lib, rows, tables, table, shift_cols)
            torch.cuda.synchronize()
            exact &= torch.equal(out[:2], ref)
            times[turn].append(ms)
        bound_us = rows.numel() / HBM_BYTES_PER_S * 1e6
        res[label] = {"new_ms": times["new"], "old_ms": times["old"], "exact": exact,
                      "bound_us": bound_us}
        print(f"B6 {label} (bound {bound_us:.1f} us): new "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times['new'])} us, old "
              f"{', '.join(f'{t * 1e3:.1f}' for t in times['old'])} us (turns new, "
              f"old, new, old); new / old {times['new'][0] / times['old'][0]:.3f}, "
              f"{times['new'][1] / times['old'][1]:.3f}; exact against plain: {exact}",
              flush=True)
        del rows
    return res


def time_b3(lib: ctypes.CDLL, words: torch.Tensor, out: torch.Tensor, dec) -> float:
    """Median ms of a library's t3fs_rs_reconstruct_words on `words` by the
    decode pattern `dec`, through its C entry (out filled)."""
    fn = lib.t3fs_rs_reconstruct_words
    fn.argtypes = _build.SIGNATURES["rs_reconstruct_words"]["t3fs_rs_reconstruct_words"]
    n, k, w = words.shape
    flat = [c for row in dec.coeff_rows for c in row]
    coeffs = (ctypes.c_uint8 * len(flat))(*flat)

    def call():
        rc = fn(words.data_ptr(), out.data_ptr(), n, k, dec.rows, w, coeffs,
                dec.poly_low, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"t3fs_rs_reconstruct_words: CUDA error {rc}")

    return median_ms(call)


def probe_b3(libs: dict[str, Path]) -> dict:
    """B3 libraries (label -> path) in turns, twice over, at (12, 8, 256Ki
    words) and the five patterns of chip_smoke's phase 10, each output held
    against the plain version."""
    from t3fs_torch.ops import cuda_codec as cc
    from t3fs_torch.ops.rs import default_rs
    from t3fs_torch.ops.tables import decode_tables

    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261018)
    k, w = 8, (1 << 20) // 4
    words = torch.randint(-2**31, 2**31, (12, k, w), dtype=torch.int32, device=dev,
                          generator=g)
    loaded = {label: ctypes.CDLL(str(path)) for label, path in libs.items()}
    res = {}
    for want in B3_WANTS:
        present = tuple(s for s in range(k + 2) if s not in want)[:k]
        dec = decode_tables(present, want, default_rs(k, 2), dev)
        ref = cc.rs_reconstruct_words_plain(words, dec)
        out = torch.empty_like(ref)
        times: dict[str, list[float]] = {label: [] for label in loaded}
        exact = {label: True for label in loaded}
        for _ in range(2):
            for label, lib in loaded.items():
                out.zero_()
                times[label].append(time_b3(lib, words, out, dec))
                torch.cuda.synchronize()
                exact[label] &= torch.equal(out, ref)
        bound_us = (k + len(want)) * w * 4 * 12 / HBM_BYTES_PER_S * 1e6
        res[str(want)] = {"bound_us": bound_us, "ms": times, "exact": exact}
        print(f"B3 want={want} (12, {k}, {w}) (bound {bound_us:.1f} us): " + "; ".join(
            f"{label} {', '.join(f'{t * 1e3:.1f}' for t in ts)} us"
            f" ({bound_us / (ts[0] * 1e3) * 100:.1f}%, exact {exact[label]})"
            for label, ts in times.items()) + " (in turns, twice)", flush=True)
    return res


def probe_b1(jobs: list[tuple[Path, Path]], caps: list[int]) -> dict:
    from t3fs_torch.ops import cuda_codec as cc

    variants = [None, *caps]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev)
    g.manual_seed(20261016)
    chunk = (4 << 20) // 4
    tables = codec_tables(chunk // SEG_WORDS, device=dev)
    table = torch.from_numpy(nibble_table()).to(dev)
    shift_cols = torch.from_numpy(
        _pack_columns(default_matrices().shift_matrix(SEG_BYTES))).to(dev)
    words = torch.randint(-2**31, 2**31, (64, chunk), dtype=torch.int32, device=dev,
                          generator=g)
    ref = cc.crc_words_raw_plain(words[:2], tables)
    res = {}
    for cap, (_src, path) in zip(variants, jobs):
        lib = ctypes.CDLL(str(path))
        name = "as built" if cap is None else f"grid capped at {cap} blocks/SM"
        hbm, _, out = time_b1(lib, words, tables, table, shift_cols)
        l2, l2_graph, out2 = time_b1(lib, words[:2], tables, table, shift_cols)
        ok = torch.equal(out[:2], ref) and torch.equal(out2, ref)
        res[name] = {"hbm_64x4MiB_ms": hbm, "l2_2x4MiB_ms": l2,
                     "l2_2x4MiB_graph_ms": l2_graph, "exact": ok}
        print(f"B1 {name}: 64 x 4 MiB {hbm * 1e3:.1f} us "
              f"({words.numel() * 4 / HBM_BYTES_PER_S * 1e6 / (hbm * 1e3) * 100:.1f}% "
              f"of the 80.1 us byte bound); 2 x 4 MiB (L2-resident) {l2 * 1e3:.1f} us, "
              f"{l2_graph * 1e3:.1f} us replayed from a CUDA graph; exact against "
              f"plain: {ok}", flush=True)
    return res


def _frag_host(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """D = popc(A AND B) of m16n8k256 from the lanes' registers, read by
    PTX's fragment layout with bit i of a register as element i of its
    32: a[lane, r]: row g (+8 for r odd), k = 32 t (+128 for r >= 2) + i;
    b[lane, r]: k = 32 t (+128 for r = 1) + i, column g; d[lane, r]: row
    g (+8 for r >= 2), column 2 t + (r & 1); g = lane // 4, t = lane % 4."""
    A = np.zeros((16, 256), dtype=np.int64)
    B = np.zeros((256, 8), dtype=np.int64)
    bits = np.arange(32)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            row, k0 = g + 8 * (r & 1), 32 * t + 128 * (r >> 1)
            A[row, k0:k0 + 32] = (int(a[lane, r]) >> bits) & 1
        for r in range(2):
            k0 = 32 * t + 128 * r
            B[k0:k0 + 32, g] = (int(b[lane, r]) >> bits) & 1
    D = A @ B
    d = np.zeros((32, 4), dtype=np.int64)
    for lane in range(32):
        g, t = divmod(lane, 4)
        for r in range(4):
            d[lane, r] = D[g + 8 * (r >> 1), 2 * t + (r & 1)]
    return d


def probe_mma(lib: ctypes.CDLL) -> dict:
    dev = torch.device("cuda")
    lib.probe_pairing.argtypes = [_P, _P, _P]
    lib.probe_rate.argtypes = [_I, _I, _I, _I, _I, _P, _P]

    def run(a: np.ndarray, b: np.ndarray) -> np.ndarray:
        ta = torch.from_numpy(a.view(np.int32)).to(dev)
        tb = torch.from_numpy(b.view(np.int32)).to(dev)
        d = torch.zeros(32, 4, dtype=torch.int32, device=dev)
        if lib.probe_pairing(ta.data_ptr(), tb.data_ptr(), d.data_ptr()):
            raise RuntimeError("probe_pairing launch failed")
        torch.cuda.synchronize()
        return d.cpu().numpy().astype(np.int64)

    rng = np.random.default_rng(7)
    random_ok = all(
        np.array_equal(run(a, b), _frag_host(a, b))
        for a, b in ((rng.integers(0, 2**32, (32, 4), dtype=np.uint32),
                      rng.integers(0, 2**32, (32, 2), dtype=np.uint32))
                     for _ in range(8)))
    # one-hot: bit p of lane 0's a0 (row 0) against bit q of lane 0's b0 (column 0)
    onehot_ok = True
    for p in range(32):
        for q in (p, (p + 1) % 32, 31 - p):
            a = np.zeros((32, 4), dtype=np.uint32)
            b = np.zeros((32, 2), dtype=np.uint32)
            a[0, 0], b[0, 0] = np.uint32(1 << p), np.uint32(1 << q)
            onehot_ok &= int(run(a, b)[0, 0]) == int(p == q)
    print(f"mma b1 pairing: random fragments match PTX's layout with bit i of "
          f"a register as element i: {random_ok}; one-hot bit p of A pairs "
          f"with bit p of B only: {onehot_ok}", flush=True)

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cycles = torch.zeros(sms, dtype=torch.int64, device=dev)
    sink = torch.zeros(1, dtype=torch.int32, device=dev)
    iters = 4096
    rates = {}
    for b1, label in ((1, "b1 m16n8k256"), (0, "s8 m16n8k32")):
        for warps in (4, 8, 16):
            for chains in (2, 4, 8):
                if lib.probe_rate(b1, chains, sms, warps, iters, cycles.data_ptr(),
                                  sink.data_ptr()):
                    raise RuntimeError("probe_rate launch failed")
                torch.cuda.synchronize()
                per_sm = warps * chains * iters
                rate = per_sm / float(cycles.max().item())
                rates[f"{label} warps={warps} chains={chains}"] = rate
                print(f"mma {label}: {warps} warps x {chains} chains an SM: "
                      f"{rate:.4f} mma per clock per SM", flush=True)
    best = max(v for k, v in rates.items() if k.startswith("b1"))
    return {"pairing_random": random_ok, "pairing_onehot": onehot_ok,
            "rates": rates, "b1_best_per_clock_per_sm": best}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", type=Path,
                    help="csrc/ of an older checkout: its B3 (and lookup B1 / B6) "
                         "against this one's")
    ap.add_argument("--caps", default="",
                    help="comma-separated kBlocksPerSm caps to time as scratch copies")
    args = ap.parse_args(argv)
    try:
        resolve_device("cuda")
    except RuntimeError as e:            # no GPU: nothing to probe
        print(json.dumps({"card": None, "error": str(e)}))
        return 1
    card = card_line()
    print(card, flush=True)
    PROBE_DIR.mkdir(parents=True, exist_ok=True)
    caps = [int(c) for c in args.caps.split(",") if c]
    out = {"card": card}
    if args.csrc:
        csrc = args.csrc.resolve()
        # the nibble-lookup designs' C entries take the lookup table
        lookup = {name: "const void* table" in (csrc / f"{name}.cu").read_text()
                  for name in ("crc_words", "crc_bytes")}
        b1_jobs = ([_scratch(csrc, "crc_words", f"b1_{'as_is' if cap is None else f'cap{cap}'}",
                             cap) for cap in [None, *caps]]
                   if lookup["crc_words"] else [])
        b6_jobs = [_scratch(csrc, "crc_bytes", "b6_old")] if lookup["crc_bytes"] else []
        b3_jobs = {"new": _scratch(_build.SRC_DIR, "rs_reconstruct_words", "b3_new"),
                   "old": _scratch(csrc, "rs_reconstruct_words", "b3_old")}
        out["ptxas"] = _nvcc_all([*b1_jobs, *b6_jobs, *b3_jobs.values()])
        if b1_jobs:
            out["b1"] = probe_b1(b1_jobs, caps)
        if b6_jobs:
            out["b6"] = probe_b6(b6_jobs[0][1])
        out["b3"] = probe_b3({label: lib for label, (_src, lib) in b3_jobs.items()})
    src = PROBE_DIR / "mma_probe.cu"
    src.write_text(MMA_SRC)
    lib = PROBE_DIR / "libmma_probe.so"
    _nvcc_all([(src, lib)])
    out["mma"] = probe_mma(ctypes.CDLL(str(lib)))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
