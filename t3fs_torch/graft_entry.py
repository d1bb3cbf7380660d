"""Entry points of the port's codec: the twin of __graft_entry__.py.

entry()               the write path's stripe step (RS(8+2) + CRC32C) with
                      example arguments, on one device.
dryrun_multichip(n)   n ranks in a (dp, cp) mesh on torch.distributed: the
                      four sharded steps of t3fs_torch/parallel/codec_mesh.py
                      (byte and word encode, byte and word decode, the word
                      decode for RAID-6 and for RS(6+3)) on tiny shapes,
                      every output checked against the numpy oracles and the
                      word path against the byte path.

    python3 -c "from t3fs_torch import graft_entry as g; g.dryrun_multichip(4)"

The ranks are processes started with the spawn method (the caller may have
initialised CUDA, after which fork is unsafe) and meet through a file in a
temporary directory.  The backend follows from the box's card count, and
is named in the result, never swapped quietly: gloo on the CPU; NCCL when
every rank has a GPU of its own; else gloo with every rank on cuda:0 (NCCL
refuses two ranks on one card): the kernels still run on the card, and
gloo stages the collective's (n, shards, 32) rows through the host.
"""

from __future__ import annotations

import json
import tempfile
import time
from datetime import timedelta
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from t3fs_torch import resolve_device
from t3fs_torch.benchmarks.devbench import event_ms
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.crc32c import crc32c_ref
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.torch_codec import make_stripe_encode_step
from t3fs_torch.parallel.codec_mesh import (
    make_mesh, make_sharded_encode_step, make_sharded_encode_step_words,
    make_sharded_reconstruct_step, make_sharded_reconstruct_step_words,
    mesh_shape, shard, _tail_combine)

K, M = 8, 2
# the second code of the word decode: RS(6+3) (HDFS's RS-6-3-1024k policy)
# losing three shards, which B5 decodes
K63, M63 = 6, 3
LOST63 = (1, 4, 7)
JOIN_TIMEOUT_S = 120


def entry(device: str | torch.device = "cuda"):
    """(fn, args): on the card the word stripe step (B2 + B1) on a seeded
    (2, 8, 16384) int32 word tensor, the reference's 64 KiB chunks; on the
    CPU the plain bit-matmul step on seeded bytes, as the reference's CPU
    branch."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    chunk_len = 64 * 1024
    if dev.type == "cuda":
        W = chunk_len // 4
        words = rng.integers(0, 2**32, (2, K, W), dtype=np.uint32)
        return (cc.make_stripe_encode_step_words(W, device=dev),
                (torch.from_numpy(words.view(np.int32)).to(dev),))
    stripes = rng.integers(0, 256, (2, K, chunk_len), dtype=np.uint8)
    return make_stripe_encode_step(chunk_len, device=dev), (torch.from_numpy(stripes),)


def present_of(want: tuple[int, ...], k: int, m: int) -> tuple[int, ...]:
    """The first k shards not in `want`: the survivors a decode reads."""
    return tuple(s for s in range(k + m) if s not in want)[:k]


def mesh_backend(n: int, device: str | torch.device = "cuda"
                 ) -> tuple[str, list[str], int]:
    """(backend, each rank's device, ranks per card, 0 on the CPU) for n
    ranks on `device`, by the box's card count alone: gloo on the CPU;
    NCCL, rank r on cuda:r, when every rank has a card of its own; else
    gloo with every rank on cuda:0 (NCCL refuses two ranks on one card)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return "gloo", ["cpu"] * n, 0
    if torch.cuda.device_count() >= n:
        return "nccl", [f"cuda:{r}" for r in range(n)], 1
    return "gloo", ["cuda:0"] * n, n


def want_tag(want: tuple[int, ...]) -> str:
    """The name part of a decode's outputs in run_mesh's result: (0, 9) ->
    "0_9" (outputs "rec0_9", "wrec0_9", "rec0_9_crcs", ...)."""
    return "_".join(map(str, want))


def _to_np(t: torch.Tensor) -> np.ndarray:
    a = t.cpu().numpy()
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _rank_steps(mesh, stripes: np.ndarray, surv63: np.ndarray,
                wants: tuple[tuple[int, ...], ...], timed: bool) -> tuple[dict, dict]:
    """One rank's part: every sharded step once on its block (the counted
    run); then, if `timed`, the times of _rank_times."""
    chunk_len = stripes.shape[2]
    x = shard(torch.from_numpy(stripes), mesh)
    s63 = shard(torch.from_numpy(surv63), mesh)
    enc = make_sharded_encode_step(mesh, chunk_len, K, M)
    wenc = make_sharded_encode_step_words(mesh, chunk_len // 4, K, M)
    rec = {w: make_sharded_reconstruct_step(mesh, chunk_len, present_of(w, K, M), w)
           for w in wants}
    wrec = {w: make_sharded_reconstruct_step_words(
        mesh, chunk_len, present_of(w, K, M), w) for w in wants}
    wrec63 = make_sharded_reconstruct_step_words(
        mesh, chunk_len, present_of(LOST63, K63, M63), LOST63, K63, M63)

    cc.reset_launches()
    out = {}
    out["enc_parity"], out["enc_crcs"] = enc(x)
    full = torch.cat([x, out["enc_parity"]], dim=1)
    surv = {w: full[:, list(present_of(w, K, M))].contiguous() for w in wants}
    for w in wants:
        out[f"rec{want_tag(w)}"], out[f"rec{want_tag(w)}_crcs"] = rec[w](surv[w])
        out[f"wrec{want_tag(w)}"], out[f"wrec{want_tag(w)}_crcs"] = wrec[w](surv[w])
    words = x.view(torch.int32)
    out["wenc_parity"], out["wenc_crcs"] = wenc(words)
    out["wrec63"], out["wrec63_crcs"] = wrec63(s63)
    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    meta = {"dp_index": mesh.dp_index, "cp_index": mesh.cp_index,
            "device": str(mesh.device), "launches": dict(cc.launches), "ms": {}}
    if timed:
        steps = {"byte encode": lambda: enc(x), "word encode": lambda: wenc(words),
                 f"word decode RS({K63}+{M63}) want={LOST63}": lambda: wrec63(s63)}
        for w in wants:
            steps[f"byte decode want={w}"] = lambda w=w: rec[w](surv[w])
            steps[f"word decode want={w}"] = lambda w=w: wrec[w](surv[w])
        meta["ms"] = _rank_times(mesh, steps, words, out["wenc_parity"], surv, s63)
    return {name: _to_np(t) for name, t in out.items()}, meta


def _rank_times(mesh, steps: dict, words: torch.Tensor, parity: torch.Tensor,
                surv: dict, s63: torch.Tensor) -> dict[str, float]:
    """ms a call on the card (CUDA events, 5 calls after 1) of each step,
    and of its parts alone at this rank's block: B2, B1 on the encode's
    n * 10 rows and on a decode's n * |want| rows, B3 for each want, B5
    for RS(6+3), the CRC combine (float tail product, all_reduce, pack)
    and its all_reduce."""
    n, _, lw = words.shape
    rs = default_rs(K, M)
    b1 = cc.make_crc32c_words_raw(lw, mesh.device)
    b2 = cc.make_rs_encode_words(rs, mesh.device)
    rows = torch.cat([words, parity], dim=1).reshape(n * (K + M), lw)
    parts = {"B2 alone": lambda: b2(words),
             f"B1 alone ({n * (K + M)} rows)": lambda: b1(rows)}
    for w, sv in surv.items():
        b3 = cc.make_rs_reconstruct_words(present_of(w, K, M), w, rs, mesh.device)
        parts[f"B3 alone want={w}"] = lambda b3=b3, sv=sv: b3(sv.view(torch.int32))
        parts[f"B1 alone ({n * len(w)} rows)"] = \
            lambda r=rows[:n * len(w)]: b1(r)
    b5 = cc.make_rs_reconstruct_bytes(present_of(LOST63, K63, M63), LOST63,
                                      default_rs(K63, M63), mesh.device)
    parts[f"B5 alone RS({K63}+{M63}) want={LOST63}"] = lambda: b5(s63)
    combine = _tail_combine(mesh, 4 * lw, 4 * lw * mesh.cp)
    bits = torch.zeros(n * (K + M), 32, dtype=torch.int32, device=mesh.device)
    parts[f"CRC combine ({n}, {K + M})"] = lambda: combine(bits, n, K + M)
    parts[f"all_reduce ({n * (K + M)}, 32) int32"] = lambda: dist.all_reduce(
        bits, group=mesh.cp_group)
    return {name: event_ms(fn, 5, 1) for name, fn in {**steps, **parts}.items()}


def _rank_main(rank: int, world: int, dp: int, backend: str, devices: list[str],
               tmp: str, wants: tuple[tuple[int, ...], ...], timed: bool) -> None:
    """A spawned rank: join the group, run _rank_steps, write its outputs
    to <tmp>/rank<r>.npz and its meta to <tmp>/rank<r>.json."""
    torch.set_num_threads(1)
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"file://{tmp}/rdzv",
                            world_size=world, rank=rank,
                            timeout=timedelta(seconds=JOIN_TIMEOUT_S))
    try:
        out, meta = _rank_steps(make_mesh(dp, dev), np.load(f"{tmp}/stripes.npy"),
                                np.load(f"{tmp}/surv63.npy"), wants, timed)
        np.savez(f"{tmp}/rank{rank}.npz", **out)
        Path(f"{tmp}/rank{rank}.json").write_text(json.dumps(meta))
    finally:
        dist.destroy_process_group()


def _join(ctx, timeout_s: float) -> None:
    """Wait for every rank; a rank's failure or the deadline fails the call,
    and no rank outlives it."""
    deadline = time.monotonic() + timeout_s
    try:
        while not ctx.join(timeout=1.0):
            if time.monotonic() > deadline:
                raise TimeoutError(f"mesh ranks still running after {timeout_s} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join(10)


def _assemble(parts: dict[tuple[int, int], np.ndarray], dp: int, cp: int,
              name: str) -> np.ndarray:
    """The global array from the ranks' blocks: (n, s, L) outputs sharded
    over dp and cp; (n, s) CRCs, which every cp rank of a row must hold
    alike."""
    rows = []
    for i in range(dp):
        blocks = [parts[(i, j)] for j in range(cp)]
        if blocks[0].ndim == 3:
            rows.append(np.concatenate(blocks, axis=2))
            continue
        if any(not np.array_equal(b, blocks[0]) for b in blocks[1:]):
            raise AssertionError(f"{name}: the cp ranks of row {i} disagree")
        rows.append(blocks[0])
    return np.concatenate(rows, axis=0)


def run_mesh(n: int, stripes: np.ndarray, surv63: np.ndarray,
             wants: tuple[tuple[int, ...], ...], dp: int | None = None,
             device: str | torch.device = "cuda", timed: bool = False,
             timeout_s: float = JOIN_TIMEOUT_S) -> dict:
    """Spawn n ranks in a (dp, cp) mesh; each runs every sharded step on its
    block of the global inputs: RAID-6 `stripes` (N, 8, L) uint8 (encoded
    on both paths, then decoded for each of `wants` on both paths from the
    survivors of its own parity) and RS(6+3) survivors `surv63` (N, 6, L)
    of LOST63 (the word decode).  Returns the backend, the mesh shape, the
    global outputs (name -> array; uint32 for CRCs and words) and each
    rank's meta: launches of the counted run and, if `timed` on the card,
    the times of each step and of its kernels and combine alone."""
    backend, devices, per_card = mesh_backend(n, device)
    dp, cp = mesh_shape(n, dp)
    if devices[0] != "cpu":
        from t3fs_torch.ops import _build

        _build.build_all()          # once here, not in every rank
    with tempfile.TemporaryDirectory(prefix="t3fs_mesh_") as tmp:
        np.save(f"{tmp}/stripes.npy", stripes)
        np.save(f"{tmp}/surv63.npy", surv63)
        ctx = mp.start_processes(
            _rank_main, args=(n, dp, backend, devices, tmp, wants,
                              timed and devices[0] != "cpu"), nprocs=n,
            join=False, start_method="spawn")
        _join(ctx, timeout_s)
        metas = [json.loads(Path(f"{tmp}/rank{r}.json").read_text()) for r in range(n)]
        parts: dict[str, dict] = {}
        for r, meta in enumerate(metas):
            with np.load(f"{tmp}/rank{r}.npz") as z:
                for name in z.files:
                    parts.setdefault(name, {})[
                        (meta["dp_index"], meta["cp_index"])] = z[name]
    return {"backend": backend, "ranks_per_card": per_card, "dp": dp, "cp": cp,
            "outputs": {name: _assemble(p, dp, cp, name) for name, p in parts.items()},
            "ranks": metas}


def _expect(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


DRYRUN_WANT = (3, 9)


def dryrun_stripes(dp: int, cp: int) -> tuple[np.ndarray, np.ndarray]:
    """The dryrun's whole stripes, data then parity by RSCode.encode_ref,
    seed 0: RS(8+2) (dp, 10, 512 * cp) and RS(6+3) (dp, 9, 512 * cp)."""
    rng = np.random.default_rng(0)
    L = 512 * cp
    out = []
    for k, m in ((K, M), (K63, M63)):
        rs = default_rs(k, m)
        data = rng.integers(0, 256, (dp, k, L), dtype=np.uint8)
        out.append(np.stack([np.concatenate([d, rs.encode_ref(d)]) for d in data]))
    return out[0], out[1]


def dryrun_multichip(n: int, dp: int | None = None,
                     device: str | torch.device = "cuda") -> dict:
    """The n-rank mesh on tiny shapes (one stripe a dp row, one 512-byte
    segment a cp rank), every parity, rebuilt byte and CRC checked against
    RSCode and crc32c_ref, and the word path against the byte path.
    Returns run_mesh's result."""
    resolve_device(device)
    dp, cp = mesh_shape(n, dp)
    full, full63 = dryrun_stripes(dp, cp)
    stripes, L = full[:, :K], full.shape[2]
    want = DRYRUN_WANT
    res = run_mesh(n, stripes, full63[:, list(present_of(LOST63, K63, M63))],
                   (want,), dp, device)
    out = res["outputs"]

    def crcs_of(shards: np.ndarray) -> np.ndarray:
        return np.array([[crc32c_ref(s.tobytes()) for s in row] for row in shards],
                        dtype=np.uint32)

    _expect(np.array_equal(out["enc_parity"], full[:, K:]), "byte encode parity")
    _expect(np.array_equal(out["enc_crcs"], crcs_of(full)), "byte encode CRCs")
    t = want_tag(want)
    _expect(np.array_equal(out[f"rec{t}"], full[:, list(want)]), "byte decode")
    _expect(np.array_equal(out[f"rec{t}_crcs"], crcs_of(full[:, list(want)])),
            "byte decode CRCs")
    _expect(np.array_equal(out["wenc_parity"].view(np.uint8), out["enc_parity"]),
            "word encode parity != byte encode parity")
    _expect(np.array_equal(out["wenc_crcs"], out["enc_crcs"]),
            "word encode CRCs != byte encode CRCs")
    _expect(np.array_equal(out[f"wrec{t}"], out[f"rec{t}"])
            and np.array_equal(out[f"wrec{t}_crcs"], out[f"rec{t}_crcs"]),
            "word decode != byte decode")
    lost = full63[:, list(LOST63)]
    _expect(np.array_equal(out["wrec63"], lost)
            and np.array_equal(out["wrec63_crcs"], crcs_of(lost)),
            f"RS({K63}+{M63}) word decode")
    print(f"dryrun_multichip OK: mesh dp={dp} cp={cp}, backend {res['backend']}"
          f" ({res['ranks_per_card']} rank(s) a card; 0 = CPU), chunk_len={L}: "
          f"encode and decode (want {want}; RS({K63}+{M63}) want {LOST63}) with "
          f"CRCs verified on both codec paths, the plain bit-matmul steps and "
          f"the word kernels", flush=True)
    return res
