"""The control: the plain reference put in the program's place with one
guarantee of the configuration broken, the shortcut a later change could be
tempted by.  A run on it has to come out not correct.

  payload_crc           CRC-32 (IEEE 802.3, zlib's) in place of CRC32C: the
                        chunk checksum's format, which every replica and
                        reader checks against
  encode_verified       Q left out, P written in its place (RAID-5 parity):
                        half the parity work, and a second loss no longer
                        recoverable
  reconstruct_verified  the survivors' and the rebuilt shard's checksums in
                        CRC-32 (IEEE): the rebuilt bytes are right, the
                        verification is not CRC32C

It batches like the seams (up to max_batch requests a call, one worker
thread), so it runs at the cell's own load.

    python3 -m fsbench.control --workload <name> --seeds <a,b,c> --seconds <s>

runs the cell on the control once per seed in one process, on the card, and
prints each run's compared numbers and `correct`.  The benchmark's own runs
never run it.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from fsbench import reference


class ControlSeam:
    """The seams' calls, answered by the broken reference."""

    def __init__(self, device: torch.device, max_batch: int = 32,
                 max_wait_us: int = 300):
        self.device = device
        self.max_batch = max_batch
        self.max_wait_s = max_wait_us / 1e6
        self.flushes = self.batches = self.batched_items = 0
        self._q: asyncio.Queue | None = None
        self._worker: asyncio.Task | None = None
        self._pool = ThreadPoolExecutor(1, thread_name_prefix="fsbench-control")

    async def payload_crc(self, data) -> int:
        return await self._submit("crc", (data,))

    async def encode_verified(self, rows: np.ndarray, k: int, m: int):
        return await self._submit("enc", (rows,))

    async def reconstruct_verified(self, rows: np.ndarray, present, want, k, m):
        return await self._submit("rec", (rows,))

    async def close(self) -> None:
        if self._worker is not None:
            self._worker.cancel()
            await asyncio.gather(self._worker, return_exceptions=True)
        self._pool.shutdown(wait=True)

    async def _submit(self, kind: str, args: tuple):
        loop = asyncio.get_running_loop()
        if self._q is None:
            self._q = asyncio.Queue()
            self._worker = loop.create_task(self._work())
        fut = loop.create_future()
        await self._q.put((kind, args, fut))
        return await fut

    async def _work(self) -> None:
        loop = asyncio.get_running_loop()
        while True:
            batch = [await self._q.get()]
            await asyncio.sleep(self.max_wait_s)
            while len(batch) < self.max_batch and not self._q.empty():
                batch.append(self._q.get_nowait())
            self.flushes += 1
            self.batches += len({kind for kind, _a, _f in batch})
            self.batched_items += len(batch)
            try:
                out = await loop.run_in_executor(self._pool, self._compute, batch)
            except Exception as e:     # every caller of the batch hears of it
                for _k, _a, fut in batch:
                    if not fut.done():
                        fut.set_exception(e)
                continue
            for (_k, _a, fut), answer in zip(batch, out):
                if not fut.done():
                    fut.set_result(answer)

    def _compute(self, batch: list) -> list:
        kind = batch[0][0]
        if kind == "crc":
            return [zlib.crc32(a[0]) for _k, a, _f in batch]
        rows = torch.from_numpy(np.stack([a[0] for _k, a, _f in batch])).to(
            self.device)
        n, k, length = rows.shape
        if kind == "enc":
            p = reference.raid6_p(rows)
            parity = torch.stack([p, p], dim=1)
            crcs = reference.crc32c_rows(
                torch.cat([rows, parity], dim=1).reshape(-1, length))
            parity = parity.cpu().numpy()
            crcs = crcs.reshape(n, k + 2).cpu().numpy().astype(np.uint32)
            return [(parity[i], crcs[i]) for i in range(n)]
        rebuilt = rows[:, 0].clone()
        for s in range(1, k):          # the survivors hold P: XOR them all
            rebuilt ^= rows[:, s]
        host = torch.cat([rows, rebuilt[:, None]], dim=1).cpu().numpy()
        return [(host[i, k:], np.array([zlib.crc32(r) for r in host[i]],
                                       dtype=np.uint32)) for i in range(n)]


def control_seam(op) -> None:
    """Install the control as `op`'s seam (run_cell's `seam` hook)."""
    op.seam = ControlSeam(op.device)


def main(argv: list[str] | None = None) -> int:
    from fsbench import run, spec

    ap = argparse.ArgumentParser(prog="fsbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("fsbench.control: no CUDA card", file=sys.stderr)
        return 2
    bench = spec.load_bench()
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run.run_cell(bench, args.workload, seed, args.seconds, False,
                         seam=control_seam)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "correct": r["correct"], "attempted": r["attempted"],
                          "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
