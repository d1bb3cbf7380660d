"""The program's codec seams as the benchmark drives them, one class a kind of
operation, and the comparison of what they answered with the reference.

A traffic file names its operation (`op`); the class of that name makes the
inputs from the seed, opens the seam at the program's defaults, makes one
call per request, keeps what each call answered, and after the window holds
every answer against the plain reference (fsbench/reference.py) on inputs
made again from the seed.  Every comparison is exact, so every limit is 0.
"""

from __future__ import annotations

import numpy as np
import torch

from fsbench import reference, roofline

# the sampling mask covers this many requests of a run, far more than any
# window completes
MAX_REQUESTS = 1 << 20
# the share of an EC cell's requests whose parity or rebuilt bytes are held
# against the reference (every answer's CRCs always are), and at most this
# many of them
SAMPLE_RATE = 1 / 16
SAMPLE_CAP = 512
# inputs are made, and made again for the reference, in blocks of about this
BLOCK_BYTES = 1 << 30
B1_KERNELS = ("crc_mma_kernel", "crc_fold_kernel")
B2_KERNELS = ("rs_raid6_kernel",)
B3_KERNELS = ("rs_reconstruct_kernel",)


def seed_bits(seed: int) -> int:
    return seed % (1 << 63)


def data_blocks(seed: int, shape: tuple[int, ...], device: torch.device):
    """Yield (start, block) over an (N, *row) uint8 pool, each block made on
    `device` by one call of a generator seeded from `seed`.  The same seed,
    shape and device give the same bytes, block by block."""
    row = int(np.prod(shape[1:]))
    per = max(1, BLOCK_BYTES // row)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_bits(seed))
    for start in range(0, shape[0], per):
        n = min(per, shape[0] - start)
        yield start, torch.empty((n, *shape[1:]), dtype=torch.uint8,
                                 device=device).random_(generator=gen)


def _host(shape: tuple[int, ...]) -> np.ndarray:
    return torch.empty(shape, dtype=torch.uint8).numpy()


def _fill(pool: np.ndarray, start: int, blk: torch.Tensor) -> None:
    """Copy a block made on the card straight into the host pool."""
    torch.from_numpy(pool[start:start + len(blk)]).copy_(blk)


class Op:
    """One kind of request against one seam."""

    # the seam's counters that the per-layer metrics read
    COUNTERS = ("batches", "batched_items")

    def __init__(self, config: dict, seed: int,
                 device: torch.device):
        self.config = config
        self.seed = seed
        self.device = torch.device(device)
        rng = np.random.default_rng([seed_bits(seed), 1])
        self._sampled = rng.random(MAX_REQUESTS) < SAMPLE_RATE
        self.answers: dict[int, object] = {}
        self.samples: dict[int, np.ndarray] = {}
        self.seam = None

    # bytes of user data a completed request counts toward payload_GBps
    bytes_per_request = 0
    # layer -> (kernel names, least bytes a batched item moves through them)
    kernels: dict[str, tuple[tuple[str, ...], int]] = {}

    def make_inputs(self) -> None:
        raise NotImplementedError

    def open(self) -> None:
        raise NotImplementedError

    async def call(self, seq: int):
        raise NotImplementedError

    def keep(self, seq: int, answer) -> None:
        raise NotImplementedError

    def check(self, requests: list[int]) -> dict[str, tuple[int, int]]:
        """{name: (value, limit)} over every request made."""
        raise NotImplementedError

    def counters(self) -> dict[str, int]:
        return {c: int(getattr(self.seam, c)) for c in self.COUNTERS}

    def settings(self) -> dict:
        return {"max_batch": self.seam.max_batch,
                "max_wait_us": round(self.seam.max_wait_s * 1e6)}

    async def close(self) -> None:
        if self.seam is not None:
            await self.seam.close()
            self.seam = None

    def _sample(self, seq: int) -> bool:
        return bool(self._sampled[seq % MAX_REQUESTS]) \
            and len(self.samples) < SAMPLE_CAP

    def _missing(self, requests: list[int]) -> int:
        return sum(1 for s in requests if s not in self.answers)


class PayloadCrc(Op):
    """CudaChecksumBackend.payload_crc on the next payload of the pool: the
    CRAQ write hop's chunk checksum."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.chunk = int(self.config["chunk_bytes"])
        self.n = int(self.config["pool_buffers"])
        self.bytes_per_request = self.chunk
        self.kernels = {"crc": (B1_KERNELS, roofline.crc_bytes(1, self.chunk))}

    def make_inputs(self) -> None:
        self.pool = _host((self.n, self.chunk))
        for start, blk in data_blocks(self.seed, self.pool.shape, self.device):
            _fill(self.pool, start, blk)

    def open(self) -> None:
        from t3fs_torch.storage.codec_backend import CudaChecksumBackend

        self.seam = CudaChecksumBackend(device=self.device)
        self.seam.warmup([self.chunk])

    async def call(self, seq: int):
        return await self.seam.payload_crc(self.pool[seq % self.n])

    def keep(self, seq: int, answer) -> None:
        self.answers[seq] = int(answer)

    def check(self, requests: list[int]) -> dict[str, tuple[int, int]]:
        want = np.empty(self.n, dtype=np.int64)
        for start, blk in data_blocks(self.seed, (self.n, self.chunk), self.device):
            want[start:start + len(blk)] = reference.crc32c_rows(blk).cpu().numpy()
        wrong = sum(1 for s, v in self.answers.items() if v != want[s % self.n])
        return {"missing": (self._missing(requests), 0), "crc_wrong": (wrong, 0)}


class _Stripes(Op):
    COUNTERS = ("flushes", "batches", "batched_items")

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.k = int(self.config["k"])
        self.m = int(self.config["m"])
        self.shard = int(self.config["shard_bytes"])
        self.n = int(self.config["pool_stripes"])
        self.bytes_per_request = self.k * self.shard

    def open(self) -> None:
        from t3fs_torch.client.ec_codec import TorchECCodec

        self.seam = TorchECCodec(device=self.device)

    def keep(self, seq: int, answer) -> None:
        shards, crcs = answer
        self.answers[seq] = np.array(crcs, dtype=np.uint32)
        if self._sample(seq):
            self.samples[seq] = np.array(shards, dtype=np.uint8)

    def _stripes(self):
        return data_blocks(self.seed, (self.n, self.k, self.shard), self.device)


class EncodeVerified(_Stripes):
    """TorchECCodec.encode_verified on the next stripe of the pool: the EC
    client's stripe write (parity and the CRC32C of all k+m shards)."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.kernels = {
            "crc": (B1_KERNELS, roofline.crc_bytes(self.k + self.m, self.shard)),
            "rs": (B2_KERNELS, roofline.raid6_encode_bytes(self.k, self.m,
                                                           self.shard))}

    def make_inputs(self) -> None:
        self.pool = _host((self.n, self.k, self.shard))
        for start, blk in self._stripes():
            _fill(self.pool, start, blk)

    async def call(self, seq: int):
        return await self.seam.encode_verified(self.pool[seq % self.n],
                                               self.k, self.m)

    def check(self, requests: list[int]) -> dict[str, tuple[int, int]]:
        k, m = self.k, self.m
        want_crcs = np.empty((self.n, k + m), dtype=np.int64)
        parity_wrong = 0
        for start, blk in self._stripes():
            parity = reference.raid6_parity(blk)
            shards = torch.cat([blk, parity], dim=1).reshape(-1, self.shard)
            want_crcs[start:start + len(blk)] = reference.crc32c_rows(
                shards).reshape(len(blk), k + m).cpu().numpy()
            for s, got in self.samples.items():
                i = s % self.n - start
                if 0 <= i < len(blk):
                    parity_wrong += not np.array_equal(got, parity[i].cpu().numpy())
        crc_wrong = sum(1 for s, v in self.answers.items()
                        if not np.array_equal(v, want_crcs[s % self.n]))
        return {"missing": (self._missing(requests), 0),
                "shard_crc_wrong": (crc_wrong, 0),
                "parity_wrong": (parity_wrong, 0)}


class ReconstructVerified(_Stripes):
    """TorchECCodec.reconstruct_verified of one lost data shard of the next
    stripe of the pool: the EC client's degraded read.  The survivors are
    those ECStorageClient's first-k read decodes from with every other shard
    alive: the other k-1 data shards and P.  Each pool entry loses one data
    position, every position as often as the others, in an order drawn from
    the seed."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        k = self.k
        rng = np.random.default_rng([seed_bits(self.seed), 2])
        self.lost = rng.permutation(np.arange(self.n) % k)
        self.present = [tuple(s for s in range(k) if s != j) + (k,)
                        for j in self.lost]
        self.kernels = {
            "crc": (B1_KERNELS, roofline.crc_bytes(k + 1, self.shard)),
            "rs": (B3_KERNELS, roofline.raid6_decode_bytes(k, 1, self.shard))}

    def make_inputs(self) -> None:
        self.pool = _host((self.n, self.k, self.shard))
        for start, blk in self._stripes():
            rows = torch.cat([blk, reference.raid6_p(blk)[:, None]], dim=1)
            index = torch.tensor(self.present[start:start + len(blk)],
                                 device=blk.device)
            _fill(self.pool, start, torch.stack(
                [rows[i, index[i]] for i in range(len(blk))]))

    async def call(self, seq: int):
        i = seq % self.n
        return await self.seam.reconstruct_verified(
            self.pool[i], self.present[i], (int(self.lost[i]),), self.k, self.m)

    def check(self, requests: list[int]) -> dict[str, tuple[int, int]]:
        k = self.k
        want_crcs = np.empty((self.n, k + 1), dtype=np.int64)
        rebuilt_wrong = 0
        for start, blk in self._stripes():
            rows = torch.cat([blk, reference.raid6_p(blk)[:, None]], dim=1)
            crcs = reference.crc32c_rows(rows.reshape(-1, self.shard)).reshape(
                len(blk), k + 1).cpu().numpy()
            for i in range(len(blk)):
                e = start + i
                want_crcs[e] = [*crcs[i, list(self.present[e])], crcs[i, self.lost[e]]]
            for s, got in self.samples.items():
                e = s % self.n
                if start <= e < start + len(blk):
                    truth = blk[e - start, int(self.lost[e])].cpu().numpy()
                    rebuilt_wrong += not np.array_equal(got.reshape(-1), truth)
        crc_wrong = sum(1 for s, v in self.answers.items()
                        if not np.array_equal(v, want_crcs[s % self.n]))
        return {"missing": (self._missing(requests), 0),
                "shard_crc_wrong": (crc_wrong, 0),
                "rebuilt_wrong": (rebuilt_wrong, 0)}


OPS = {"payload_crc": PayloadCrc, "encode_verified": EncodeVerified,
       "reconstruct_verified": ReconstructVerified}
