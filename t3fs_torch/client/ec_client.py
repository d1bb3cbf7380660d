"""Erasure-coded storage client: RS(k+m) stripes over a chain group.

This is the capability t3fs ADDS over the reference (BASELINE.json configs
#3/#4): the reference has EC only as a *placement* option in its chain-table
solver (deploy/data_placement/src/model/data_placement.py:484) with no
encode/decode data path.  Here a stripe of k data chunks gets m parity
chunks, each of the k+m shards on a different chain (replication factor 1 —
parity replaces replication), encoded/decoded by the hand-written CUDA
kernels behind t3fs_torch.client.ec_codec.TorchECCodec (the same
configuration t3fs_torch.bench measures) on the co-located GPU, with
concurrent stripes micro-batched per launch.
Reconstruction runs the fused decode+verify step: one launch rebuilds the
missing shards AND returns their CRC32Cs, which repair write-back hands to
write_chunk so rebuilt full chunks skip the host crc32c entirely.

Addressing: data chunk j of stripe s  -> ChunkId(inode, s*k + j)
            parity chunk p of stripe s -> ChunkId(inode | PARITY_NS, s*m + p)
Chain placement walks the layout's chain list stripe-by-stripe so recovery
load spreads (the data_placement balanced-design goal).

The port of t3fs/client/ec_client.py over the port's StorageClient: the
default codec is TorchECCodec() on "cuda" (raising where no GPU is
present); use_device_codec=False keeps the numpy oracle, as in the
reference.
"""

from __future__ import annotations

import asyncio
import logging
from dataclasses import dataclass, field

import numpy as np

from t3fs_torch.client.ec_codec import TorchECCodec
from t3fs_torch.ops.msr import default_msr, msr_code_id
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.storage.types import ChunkId, IOResult, ReadIO, UpdateType
from t3fs_torch.utils import tracing
from t3fs_torch.utils.serde import serde_struct
from t3fs_torch.utils.status import StatusCode, StatusError, make_error

log = logging.getLogger("t3fs_torch.client.ec")

PARITY_NS = 1 << 62   # parity chunk-id namespace bit
LOCAL_NS = 1 << 61    # local-group (LRC) parity chunk-id namespace bit

# Single source of truth for ECLayout.local_scheme values.  Layout
# validation, chunk-id namespacing (num_local_groups decides whether
# LOCAL_NS chunks exist), and the admin `gen-chains` help text all read
# THIS tuple, so adding a scheme cannot skew the three.
SUPPORTED_LOCAL_SCHEMES = ("", "lrc-xor", "pm-msr")
# The subset that adds local-group parity chunks in the LOCAL_NS
# namespace; pm-msr keeps the plain k+m slot set (its repair savings come
# from sub-packetization, not extra parity chunks).
GROUP_PARITY_SCHEMES = ("lrc-xor",)


def subshard_r(chunk_size: int, r_max: int = 4) -> int:
    """Sub-shard split factor for reduced-read repair: the largest r <= r_max
    with chunk_size % r == 0 and a 512-multiple slice (so every sub-shard
    stays on the fused word-kernel path and CRC segment grid).  r > 1 frames
    each helper read as r smaller ReadIOs — finer pacing quanta for the
    scrub budget and natural micro-batch shape for the repair kernel."""
    r = r_max
    while r > 1 and (chunk_size % r or (chunk_size // r) % 512):
        r -= 1
    return r


# Format id assumed for layouts serialized before code_id existed: the
# round-1 generator was row-reduced Vandermonde over the default polynomial.
# Deserializing such a blob must NOT inherit the current default generator —
# decoding rrvand parity with the raid6 matrix reconstructs garbage silently.
LEGACY_CODE_ID = "rrvand-11d"


@serde_struct
@dataclass
class ECLayout:
    k: int = 8
    m: int = 2
    chunk_size: int = 1 << 20
    chains: list[int] = field(default_factory=list)   # >= k+m distinct chains
    # parity format id (RSCode.code_id): persisted with the layout so a
    # change of generator coefficients fails LOUDLY at decode time instead
    # of silently reconstructing garbage from old parity.  Dataclass default
    # (= what a pre-versioning serialized layout deserializes to) is the
    # LEGACY id; new layouts get the current id via create().
    code_id: str = LEGACY_CODE_ID
    # Opt-in LRC local parities (ROADMAP item 4, "regenerating/LRC-style"):
    # "" = pure RS(k+m) (every pre-existing layout deserializes to this);
    # "lrc-xor" partitions the k+m base shards into contiguous groups of
    # ~local_group_size and stores one XOR parity chunk per group (in the
    # LOCAL_NS namespace, rotated onto chains like any other shard).  A
    # single lost shard then rebuilds from its GROUP (group_size reads)
    # instead of k survivors — the repair-bandwidth trade bought with
    # G/(k+m) extra storage.  Scalar-MDS information theory forces the
    # trade: ANY (k+m, k) MDS code needs >= k full shards' worth of bytes
    # per single-shard repair under raw reads (see docs/codec_economics.md).
    # "pm-msr" sidesteps that bound by sub-packetizing: each shard is
    # alpha = 2^((k+m)/2) sub-chunks of a coupled-layer MSR code
    # (ops/msr.py), data shards stay RAW bytes (systematic — healthy
    # first-k reads are byte-identical to plain RS), and a single lost
    # shard rebuilds from every survivor's beta = alpha/2 selected
    # sub-chunks: d*beta/alpha = 0.5625x of k full chunks, at the SAME
    # 1.25x storage (no extra parity chunks — slots == k+m).
    local_scheme: str = ""
    local_group_size: int = 3

    def __post_init__(self):
        if len(self.chains) < self.slots:
            raise make_error(
                StatusCode.INVALID_ARG,
                f"EC({self.k}+{self.m}"
                f"{'+' + str(self.num_local_groups) + 'l' if self.local_scheme else ''}"
                f") needs >= {self.slots} chains")
        if self.local_scheme not in SUPPORTED_LOCAL_SCHEMES:
            raise make_error(
                StatusCode.INVALID_ARG,
                f"unknown local scheme {self.local_scheme!r} "
                f"(supported: {SUPPORTED_LOCAL_SCHEMES})")
        if self.local_scheme == "pm-msr":
            try:
                code = default_msr(self.k, self.m)
            except ValueError as e:
                raise make_error(StatusCode.INVALID_ARG, str(e)) from e
            if self.chunk_size % code.alpha:
                raise make_error(
                    StatusCode.INVALID_ARG,
                    f"pm-msr sub-packetization needs chunk_size divisible "
                    f"by alpha={code.alpha} (got {self.chunk_size})")

    @classmethod
    def create(cls, k: int = 8, m: int = 2, chunk_size: int = 1 << 20,
               chains: list[int] | None = None, local_scheme: str = "",
               local_group_size: int = 3) -> "ECLayout":
        """Layout-creation factory: stamps the CURRENT parity format id
        (the pm-msr coupled generator has its OWN id — its parity bytes
        are not plain RS parity)."""
        if local_scheme == "pm-msr":
            try:
                code_id = msr_code_id(k, m)
            except ValueError as e:
                raise make_error(StatusCode.INVALID_ARG, str(e)) from e
        else:
            code_id = default_rs(k, m).code_id
        return cls(k=k, m=m, chunk_size=chunk_size, chains=chains or [],
                   code_id=code_id,
                   local_scheme=local_scheme,
                   local_group_size=local_group_size)

    @property
    def num_local_groups(self) -> int:
        if self.local_scheme not in GROUP_PARITY_SCHEMES:
            return 0
        return -(-(self.k + self.m) // self.local_group_size)

    @property
    def slots(self) -> int:
        """Chain-rotation period: base shards + one slot per local parity."""
        return self.k + self.m + self.num_local_groups

    def local_groups(self) -> list[tuple[int, ...]]:
        """Balanced contiguous partition of the k+m base shards, e.g.
        10 shards at group size 3 -> (0,1,2) (3,4,5) (6,7) (8,9)."""
        n, g = self.k + self.m, self.num_local_groups
        if not g:
            return []
        base, rem = divmod(n, g)
        out, at = [], 0
        for i in range(g):
            size = base + (1 if i < rem else 0)
            out.append(tuple(range(at, at + size)))
            at += size
        return out

    def group_of(self, shard: int) -> int:
        """Local group index of a base shard (0..k+m-1)."""
        for g, members in enumerate(self.local_groups()):
            if shard in members:
                return g
        raise make_error(StatusCode.INVALID_ARG,
                         f"shard {shard} has no local group")

    def check_code(self, rs) -> None:
        if rs.code_id != self.code_id:
            raise make_error(
                StatusCode.EC_FORMAT_MISMATCH,
                f"stripe parity was written with code {self.code_id!r} but "
                f"this build decodes with {rs.code_id!r} — refusing to mix "
                f"formats")

    def shard_chain(self, stripe: int, shard: int) -> int:
        """Chain of slot `shard` (0..slots-1: base shards, then one slot per
        local-group parity) of a stripe; rotates per stripe."""
        n = len(self.chains)
        return self.chains[(stripe * self.slots + shard) % n]

    def data_chunk(self, inode: int, stripe: int, j: int) -> ChunkId:
        return ChunkId(inode, stripe * self.k + j)

    def parity_chunk(self, inode: int, stripe: int, p: int) -> ChunkId:
        return ChunkId(inode | PARITY_NS, stripe * self.m + p)

    def local_chunk(self, inode: int, stripe: int, g: int) -> ChunkId:
        return ChunkId(inode | LOCAL_NS,
                       stripe * self.num_local_groups + g)

    def shard_chunk(self, inode: int, stripe: int, s: int) -> ChunkId:
        """ChunkId of slot s: data, RS parity, or local-group parity."""
        if s < self.k:
            return self.data_chunk(inode, stripe, s)
        if s < self.k + self.m:
            return self.parity_chunk(inode, stripe, s - self.k)
        return self.local_chunk(inode, stripe, s - self.k - self.m)

    def data_file_layout(self):
        """A FileLayout whose chain_of() reproduces THIS layout's data-chunk
        placement: data chunk idx (= stripe*k + j) lives on
        chains[((idx//k)*slots + idx%k) % n], which is periodic in idx with
        period k*n — so plain StorageClient.read_file_ranges serves healthy
        EC reads (e.g. resharded checkpoint restore) with no EC-aware
        plumbing; only stripes with failed shards need read_stripe."""
        from t3fs_torch.client.layout import FileLayout
        n = len(self.chains)
        chains = [self.chains[((i // self.k) * self.slots + i % self.k) % n]
                  for i in range(self.k * n)]
        return FileLayout(chunk_size=self.chunk_size, chains=chains)


@dataclass
class StripeEncoding:
    """One encoded stripe, ready to write shard-by-shard: the k data shards
    (tail-trimmed to their true lengths; b"" for zero holes) followed by the
    m full-size parity shards — and, when the layout carries a local scheme,
    one full-size XOR local parity per group — with the CRC32C each chunk
    will carry once stored (device-computed by the fused encode+CRC step for
    full shards; host crc32c only for the at-most-one trimmed tail shard;
    0 for holes)."""
    lens: list[int]             # per data shard true length (0 = hole)
    contents: list[bytes]       # `slots` stored contents in slot order
    crcs: list[int]             # CRC32C of contents[i]; 0 for holes


@dataclass
class RepairIOStats:
    """Per-run repair IO accounting (RepairDriver/scrub surface): how many
    bytes came off the wire to rebuild how many, and which path served."""
    bytes_read: int = 0         # survivor/helper payload bytes fetched
    bytes_repaired: int = 0     # rebuilt bytes written back
    sub_reads: int = 0          # sub-range helper ReadIOs issued
    reduced_shards: int = 0     # shards rebuilt by the reduced-read path
    fallback_shards: int = 0    # shards that fell back to full-k decode


class ChainAdmission:
    """Per-chain admission window: bounds in-flight chunk writes per chain so
    one slow chain backpressures only its own shards, not the whole fan-out
    (the checkpoint writer's per-chain window; the fleet-wide stripe window
    is the caller's own semaphore)."""

    def __init__(self, per_chain: int = 2):
        self.per_chain = per_chain
        self._sems: dict[int, asyncio.Semaphore] = {}

    def sem(self, chain_id: int) -> asyncio.Semaphore:
        sem = self._sems.get(chain_id)
        if sem is None:
            sem = self._sems[chain_id] = asyncio.Semaphore(self.per_chain)
        return sem


class ECStorageClient:
    """Stripe-granular EC write/read/repair over a StorageClient."""

    def __init__(self, storage_client, use_device_codec: bool = True,
                 fast_read_retries: int = 4,
                 codec: "TorchECCodec | None" = None):
        self.sc = storage_client
        self.use_device = use_device_codec
        # device path: the word-packed CUDA kernels (t3fs_torch.bench's measured
        # configuration) with stripe micro-batching; None = numpy oracle
        self.codec = (codec or TorchECCodec()) if use_device_codec else None
        # degraded reads must not wait out long retry tails on dead chains:
        # parity covers a fast-failed shard, so EC reads use a bounded-retry
        # view of the same client (shared sockets + routing), falling back
        # to the patient client only when reconstruction lacks shards
        self._fast = self._bounded_view(storage_client, fast_read_retries)

    @staticmethod
    def _bounded_view(sc, max_retries: int):
        import copy

        fast = copy.copy(sc)
        fast.cfg = copy.copy(sc.cfg)
        fast.cfg.max_retries = max_retries
        fast.cfg.retry_backoff_s = min(sc.cfg.retry_backoff_s, 0.03)
        return fast

    def _routed_out(self, chain_id: int) -> bool:
        """True when CURRENT routing shows no serving target for the chain:
        a read could only burn its whole retry/backoff budget, so degraded
        paths count the shard as lost immediately.  A stale verdict is safe
        — the patient wave in _reconstruct_shards re-reads want-shards
        directly and recovers them without decoding."""
        chain = self.sc.routing().chain(chain_id)
        return chain is None or not chain.serving()

    # --- codec (CUDA word kernels by default; numpy oracle fallback) ---
    # Device calls go through TorchECCodec: concurrent stripes micro-batch
    # into one kernel launch on the codec's own thread (the kernel build takes
    # seconds and compute releases the GIL — nothing blocks the loop).

    async def _encode(self, data_shards: np.ndarray, k: int, m: int) -> np.ndarray:
        if self.codec is not None:
            return await self.codec.encode(data_shards, k, m)
        return await asyncio.to_thread(default_rs(k, m).encode_ref,
                                       data_shards)

    async def _encode_verified(self, data_shards: np.ndarray, k: int, m: int
                               ) -> tuple[np.ndarray, np.ndarray | None]:
        """Encode + shard CRCs in ONE device launch (the fused encode+CRC
        step); the numpy oracle has no fused CRC, so it returns None and
        callers fall back to the host crc32c."""
        if self.codec is not None:
            return await self.codec.encode_verified(data_shards, k, m)
        return await self._encode(data_shards, k, m), None

    async def _reconstruct(self, present_rows: np.ndarray,
                           present: tuple[int, ...], want: tuple[int, ...],
                           k: int, m: int) -> np.ndarray:
        if self.codec is not None:
            return await self.codec.reconstruct(present_rows, present, want,
                                                k, m)

        def run():
            shards = {idx: present_rows[i] for i, idx in enumerate(present)}
            return default_rs(k, m).decode_ref(shards, list(want))
        return await asyncio.to_thread(run)

    async def _reconstruct_verified(self, present_rows: np.ndarray,
                                    present: tuple[int, ...],
                                    want: tuple[int, ...], k: int, m: int
                                    ) -> tuple[np.ndarray, np.ndarray | None]:
        """Decode + shard CRCs in ONE device launch (the fused
        decode+verify step); the numpy oracle has no fused CRC, so it
        returns None and callers fall back to the host crc32c."""
        if self.codec is not None:
            return await self.codec.reconstruct_verified(
                present_rows, present, want, k, m)
        return await self._reconstruct(present_rows, present, want,
                                       k, m), None

    async def _msr_encode_verified(self, data_shards: np.ndarray, k: int,
                                   m: int
                                   ) -> tuple[np.ndarray, np.ndarray | None]:
        """pm-msr twin of _encode_verified: coupled-layer parity + fused
        shard CRCs in one launch; numpy oracle (no fused CRC) fallback."""
        if self.codec is not None:
            return await self.codec.msr_encode_verified(data_shards, k, m)
        code = default_msr(k, m)
        return await asyncio.to_thread(code.encode_np, data_shards), None

    async def _msr_decode_verified(self, present_rows: np.ndarray,
                                   present: tuple[int, ...],
                                   want: tuple[int, ...], k: int, m: int
                                   ) -> tuple[np.ndarray, np.ndarray | None]:
        """pm-msr twin of _reconstruct_verified: the multi-loss/degraded
        full-k decode (exactly k survivor shards — never more than RS)."""
        if self.codec is not None:
            return await self.codec.msr_decode_verified(
                present_rows, present, want, k, m)
        code = default_msr(k, m)
        return await asyncio.to_thread(
            code.decode_np, present, present_rows, want), None

    async def _msr_repair_eval(self, helper_rows: np.ndarray, f: int,
                               k: int, m: int) -> tuple[np.ndarray, int]:
        """One fused pm-msr projection rebuild: (d, beta_len) helper rows
        -> (full rebuilt chunk, device CRC32C of the whole chunk)."""
        if self.codec is not None:
            out, crc = await self.codec.msr_repair(helper_rows, f, k, m)
            return out, int(crc)
        from t3fs_torch.ops.codec import crc32c
        code = default_msr(k, m)
        sub = 2 * helper_rows.shape[-1] // code.alpha

        def run():
            subs = helper_rows.reshape(code.d, code.alpha // 2, sub)
            out = code.repair_np(f, subs)
            return out, crc32c(out.tobytes())
        return await asyncio.to_thread(run)

    async def close(self) -> None:
        if self.codec is not None:
            await self.codec.close()

    # --- write ---

    async def encode_stripe(self, layout: ECLayout, data: bytes
                            ) -> StripeEncoding:
        """Encode one stripe's data into its k+m stored shard contents plus
        the CRC32C each chunk will carry — via the fused encode+CRC step, so
        full shards (the hot path) never touch the host crc32c.  The result
        feeds write_encoded (possibly more than once: retries / resumed
        saves rewrite a shard subset without re-encoding)."""
        k, m, cs = layout.k, layout.m, layout.chunk_size
        assert len(data) <= k * cs
        lens = [max(0, min(cs, len(data) - j * cs)) for j in range(k)]
        arr = np.zeros((k, cs), dtype=np.uint8)
        flat = np.frombuffer(data, dtype=np.uint8)
        for j in range(k):
            if lens[j]:
                arr[j, :lens[j]] = flat[j * cs: j * cs + lens[j]]
        if layout.local_scheme == "pm-msr":
            layout.check_code(default_msr(k, m))
            parity, dev_crcs = await self._msr_encode_verified(arr, k, m)
        else:
            layout.check_code(default_rs(k, m))
            parity, dev_crcs = await self._encode_verified(arr, k, m)

        from t3fs_torch.ops.codec import crc32c
        contents: list[bytes] = []
        crcs: list[int] = []
        for j in range(k):
            content = bytes(arr[j, :lens[j]]) if lens[j] else b""
            contents.append(content)
            if lens[j] == 0:
                crcs.append(0)
            elif lens[j] == cs and dev_crcs is not None:
                crcs.append(int(dev_crcs[j]))
            else:
                # trimmed tail shard: the device CRC covers the padded full
                # chunk, not the stored bytes (at most one per file — cold)
                crcs.append(crc32c(content))
        for p in range(m):
            contents.append(bytes(parity[p]))
            crcs.append(int(dev_crcs[k + p]) if dev_crcs is not None
                        else crc32c(contents[-1]))
        if layout.num_local_groups:
            # local XOR parities over the PADDED member buffers (consistent
            # with absent == zeros on the repair side); the all-ones repair
            # program is exactly an XOR fold + CRC, so the device path
            # reuses it — local groups micro-batch alongside stripe encodes
            full = np.concatenate([arr, parity], axis=0)     # (k+m, cs)

            async def one_local(members: tuple[int, ...]) -> tuple[bytes, int]:
                rows = np.ascontiguousarray(full[list(members)])
                if self.codec is not None:
                    out, crc = await self.codec.repair(
                        rows, (1,) * len(members), k, m)
                    return bytes(out), int(crc)
                buf = rows[0].copy()
                for extra in rows[1:]:
                    buf ^= extra
                return bytes(buf), crc32c(buf.tobytes())

            for content, crc in await asyncio.gather(
                    *(one_local(g) for g in layout.local_groups())):
                contents.append(content)
                crcs.append(crc)
        return StripeEncoding(lens=lens, contents=contents, crcs=crcs)

    async def write_stripe(self, layout: ECLayout, inode: int, stripe: int,
                           data: bytes,
                           shards: tuple[int, ...] | None = None
                           ) -> list[IOResult]:
        """Write one full stripe (k*chunk_size bytes; shorter data is
        zero-padded on the wire but chunk lengths preserve the true size).
        Returns per-shard IOResults aligned with `shards` (default: all k+m,
        data shards first then parity) — a partial failure names exactly the
        shards to retry, via write_encoded, without rewriting the stripe."""
        enc = await self.encode_stripe(layout, data)
        return await self.write_encoded(layout, inode, stripe, enc, shards)

    async def write_encoded(self, layout: ECLayout, inode: int, stripe: int,
                            enc: StripeEncoding,
                            shards: tuple[int, ...] | None = None,
                            admission: ChainAdmission | None = None
                            ) -> list[IOResult]:
        """Write a subset of an encoded stripe's shards (default all k+m).
        Results align with `shards` order, so callers retry exactly the
        failed entries.  Stored CRCs ride along as write_chunk checksums:
        the server cross-checks the payload against the device-computed CRC
        and the host crc32c never runs.

        Whole-chunk REPLACE (not splice-write) so a shorter re-write of the
        stripe cannot leave stale tail bytes that disagree with the new
        parity; shards emptied by the re-write are REMOVEd for the same
        reason (absent == zeros is the decode contract)."""
        k, m, cs = layout.k, layout.m, layout.chunk_size
        if shards is None:
            shards = tuple(range(layout.slots))

        async def one(s: int) -> IOResult:
            chain = layout.shard_chain(stripe, s)
            cid = layout.shard_chunk(inode, stripe, s)
            if s < k and enc.lens[s] == 0:
                kwargs = dict(update_type=UpdateType.REMOVE)
                content: bytes = b""
            else:
                kwargs = dict(update_type=UpdateType.REPLACE,
                              checksum=enc.crcs[s])
                content = enc.contents[s]
            if admission is None:
                return await self.sc.write_chunk(chain, cid, 0, content,
                                                 chunk_size=cs, **kwargs)
            async with admission.sem(chain):
                return await self.sc.write_chunk(chain, cid, 0, content,
                                                 chunk_size=cs, **kwargs)

        return list(await asyncio.gather(*(one(s) for s in shards)))

    # --- read with reconstruct-on-unavailability ---

    async def read_stripe(self, layout: ECLayout, inode: int, stripe: int,
                          stripe_len: int) -> bytes:
        """Read a stripe's data, reconstructing any unavailable data chunks
        from surviving shards (the EC-decode recovery path, BASELINE #4)."""
        data, _crcs = await self.read_stripe_with_crcs(layout, inode, stripe,
                                                       stripe_len)
        return data

    async def read_stripe_with_crcs(self, layout: ECLayout, inode: int,
                                    stripe: int, stripe_len: int
                                    ) -> tuple[bytes, list[int | None]]:
        """read_stripe + per-data-shard CRC32C of the STORED chunk content,
        aligned with shard index 0..k-1: a directly-read shard reports the
        storage layer's stored CRC (IOResult.checksum); a reconstructed full
        shard reports the fused decode+verify step's device CRC; None where
        neither applies (zero holes, trimmed reconstructed tails, the numpy
        oracle).  Manifest-verified restores (t3fs.ckpt) compare these
        against committed CRCs without hashing a byte on the host.

        First-k fan-out: ALL k+m shards are requested concurrently and the
        read completes as soon as every live data shard has landed OR any k
        shards (zero holes count for free) can feed the fused decode+verify
        step — a straggling data shard becomes an erasure the parity
        covers, never a wait."""
        k, m, cs = layout.k, layout.m, layout.chunk_size
        lens = [max(0, min(cs, stripe_len - j * cs)) for j in range(k)]
        zero_shards = frozenset(j for j in range(k) if lens[j] == 0)
        needed = [j for j in range(k) if lens[j]]
        got: dict[int, tuple[bytes, int]] = {}   # shard -> (content, crc)
        tasks: dict[asyncio.Task, int] = {}
        for s in range(k + m):
            if s < k and lens[s] == 0:
                continue   # zero hole: free decode input, never read
            chain = layout.shard_chain(stripe, s)
            if self._routed_out(chain):
                continue   # fast-fail: no serving target routed
            cid = (layout.data_chunk(inode, stripe, s) if s < k
                   else layout.parity_chunk(inode, stripe, s - k))
            t = asyncio.create_task(self._fast.batch_read(
                [ReadIO(chunk_id=cid, chain_id=chain)]))
            tasks[t] = s
        pending = set(tasks)
        try:
            while pending:
                if all(j in got for j in needed):
                    break
                if len(got) + len(zero_shards) >= k:
                    break
                done, pending = await asyncio.wait(
                    pending, return_when=asyncio.FIRST_COMPLETED)
                for t in done:
                    try:
                        # t3fslint: allow(blocking-in-async) — t is a member of asyncio.wait's done set — result() cannot block
                        results, payloads = t.result()
                    except StatusError:
                        continue   # transport failure == shard missing
                    r = results[0]
                    if r.status.code == int(StatusCode.OK):
                        got[tasks[t]] = (payloads[0], int(r.checksum))
        finally:
            for t in pending:
                t.cancel()
            if pending:
                await asyncio.gather(*pending, return_exceptions=True)
        chunks: dict[int, bytes] = {}
        crcs: dict[int, int | None] = {}
        for j in needed:
            if j in got:
                chunks[j], crcs[j] = got[j]
        missing = tuple(j for j in needed if j not in got)
        if missing:
            have: dict[int, np.ndarray] = {}
            for s, (content, _crc) in got.items():
                buf = np.zeros(cs, dtype=np.uint8)
                buf[: len(content)] = np.frombuffer(content, dtype=np.uint8)
                have[s] = buf
            for j in zero_shards:
                have[j] = np.zeros(cs, dtype=np.uint8)
            if len(have) >= k:
                # enough landed before the stragglers: decode right here
                # from what the fan-out already paid for
                rec, rcrcs = await self._decode_from(layout, have,
                                                     missing, k, m)
            else:
                # the fan-out drained short of k: patient path (re-reads
                # survivors AND want-shards with full retry budget)
                rec, rcrcs = await self._reconstruct_shards(
                    layout, inode, stripe, missing, zero_shards,
                    known={s: content for s, (content, _) in got.items()})
            for j, content, rc in zip(missing, rec, rcrcs):
                chunks[j] = content[: lens[j]]
                # the device CRC covers the full chunk: it matches the
                # stored-content CRC only for untrimmed shards
                crcs[j] = rc if lens[j] == cs else None
        # bytes(): over the native transport a shard read arrives as a
        # memoryview of the pump's buffer, which has no ljust
        return (b"".join(bytes(chunks[j][: lens[j]]).ljust(lens[j], b"\x00")
                         for j in range(k) if lens[j]),
                [crcs.get(j) for j in range(k)])

    async def _reconstruct_shards(self, layout: ECLayout, inode: int,
                                  stripe: int, want: tuple[int, ...],
                                  zero_shards: frozenset[int],
                                  known: dict[int, bytes] | None = None,
                                  prefer: tuple[int, ...] | None = None,
                                  stats: RepairIOStats | None = None
                                  ) -> tuple[list[bytes], list[int | None]]:
        """Fetch enough surviving shards (data we already have + parity +
        other data) and decode the wanted shard indices (0..k+m-1 space).
        Returns (contents, crcs) aligned with `want`: crc is the DEVICE
        CRC32C of the full-chunk content when the fused decode+verify step
        produced the shard, else None (directly-recovered / oracle path).

        `zero_shards` lists data shards the CALLER knows were never written
        (short stripe) — only those may be substituted with zeros on
        CHUNK_NOT_FOUND.  Any other missing shard counts as lost; silently
        zero-filling it would decode garbage and, on the repair path, write
        that garbage back as if it were real (double-loss corruption).

        `prefer` restricts the FAST pass to those survivor shard indices
        (the repair planner's load-balanced k-pick); the patient retry
        wave ignores it, so a failed preferred read degrades to extra IO,
        never to a failed repair."""
        k, m, cs = layout.k, layout.m, layout.chunk_size
        known = dict(known or {})
        have: dict[int, np.ndarray] = {}
        for j, content in known.items():
            buf = np.zeros(cs, dtype=np.uint8)
            buf[: len(content)] = np.frombuffer(content, dtype=np.uint8)
            have[j] = buf

        # zero-hole shards bypass `prefer`: they cost no IO (substituted,
        # never read) and the patient wave never materializes them
        need_more = [s for s in range(k + m)
                     if s not in have and s not in want
                     and (prefer is None or s in prefer
                          or s in zero_shards)]
        ios, ids = [], []
        for s in need_more:
            if s in zero_shards:
                have[s] = np.zeros(cs, dtype=np.uint8)
                continue
            if self._routed_out(layout.shard_chain(stripe, s)):
                continue              # fast-fail; patient wave may still try
            cid = (layout.data_chunk(inode, stripe, s) if s < k
                   else layout.parity_chunk(inode, stripe, s - k))
            ios.append(ReadIO(chunk_id=cid,
                              chain_id=layout.shard_chain(stripe, s)))
            ids.append(s)
        if ios:
            results, payloads = await self._fast.batch_read(ios)
            for s, r, p in zip(ids, results, payloads):
                if r.status.code == int(StatusCode.OK):
                    if stats is not None:
                        stats.bytes_read += len(p)
                    buf = np.zeros(cs, dtype=np.uint8)
                    buf[: len(p)] = np.frombuffer(p, dtype=np.uint8)
                    have[s] = buf
        if len(have) < k:
            # not enough survivors after the fast pass: one PATIENT retry
            # wave over everything still missing — including the `want`
            # shards themselves (a transient blip, e.g. a reshape in
            # progress, may have fast-failed shards that a patient read
            # recovers directly, needing no decode at all)
            ios2, ids2 = [], []
            for s in range(k + m):
                if s in have or s in zero_shards:
                    continue
                cid = (layout.data_chunk(inode, stripe, s) if s < k
                       else layout.parity_chunk(inode, stripe, s - k))
                ios2.append(ReadIO(chunk_id=cid,
                                   chain_id=layout.shard_chain(stripe, s)))
                ids2.append(s)
            if ios2:
                results2, payloads2 = await self.sc.batch_read(ios2)
                for s, r, p in zip(ids2, results2, payloads2):
                    if r.status.code == int(StatusCode.OK):
                        if stats is not None:
                            stats.bytes_read += len(p)
                        buf = np.zeros(cs, dtype=np.uint8)
                        buf[: len(p)] = np.frombuffer(p, dtype=np.uint8)
                        have[s] = buf
        if len(have) < k:
            raise make_error(
                StatusCode.TARGET_OFFLINE,
                f"EC stripe {stripe}: only {len(have)} of {k + m} shards "
                f"available, need {k}")
        return await self._decode_from(layout, have, want, k, m)

    async def _decode_from(self, layout: ECLayout,
                           have: dict[int, np.ndarray],
                           want: tuple[int, ...], k: int, m: int
                           ) -> tuple[list[bytes], list[int | None]]:
        """Decode `want` shard indices from >= k available full-chunk-size
        buffers (`have`, keyed in 0..k+m shard space — zero holes included
        as zero buffers).  Returns (contents, crcs) aligned with `want`;
        crc is the fused decode+verify step's device CRC32C of the
        full-chunk content when that step produced the shard, else None.
        Want-shards already in `have` pass through without decoding."""
        msr = layout.local_scheme == "pm-msr"
        layout.check_code(default_msr(k, m) if msr else default_rs(k, m))
        # shards recovered directly need no decoding
        still_want = tuple(s for s in want if s not in have)
        decoded: dict[int, bytes] = {}
        crc_of: dict[int, int] = {}
        if still_want:
            # recovered want-shards may serve as decode inputs; only the
            # still-missing ones must stay out of the present set
            present = tuple(sorted(s for s in have.keys()
                                   if s not in still_want)[:k])
            rows = np.stack([have[s] for s in present])
            if msr:
                out, crcs = await self._msr_decode_verified(
                    rows, present, still_want, k, m)
            else:
                out, crcs = await self._reconstruct_verified(
                    rows, present, still_want, k, m)
            decoded = {s: bytes(out[i]) for i, s in enumerate(still_want)}
            if crcs is not None:
                # fused-step layout: k survivor CRCs, then the rebuilt
                # shards' CRCs in still_want order
                crc_of = {s: int(crcs[k + i])
                          for i, s in enumerate(still_want)}
        return ([decoded[s] if s in decoded else bytes(have[s])
                 for s in want],
                [crc_of.get(s) for s in want])

    # --- reduced-read repair (the repair-bandwidth path) ---

    def hot_repair_programs(self, layout: ECLayout) -> list[tuple[int, ...]]:
        """The coefficient rows single-shard repair will actually run under
        this layout — the warmup set.  With a local scheme: one all-ones
        program per group size (member and local rebuilds share it).
        Without: the k+m scheduled single-row programs over the canonical
        (no-holes, no-preference) survivor pick _plan_reduced makes."""
        rows: dict[tuple[int, ...], None] = {}
        if layout.local_scheme == "pm-msr":
            return []   # projection schedules precompile via warmup_msr
        if layout.local_scheme:
            for members in layout.local_groups():
                rows[(1,) * len(members)] = None
        else:
            base = layout.k + layout.m
            for s in range(base):
                plan = self._plan_reduced(layout, s, frozenset((s,)),
                                          frozenset(), None)
                if plan:
                    rows[tuple(c for _slot, c in plan)] = None
        return list(rows)

    def warmup_repair(self, layout: ECLayout,
                      batch_sizes: tuple[int, ...] = (1,)) -> None:
        """Precompile this layout's repair programs at the sub-shard length
        the reduced path uses (and, with a local scheme, at full chunk size
        for the encode-side local XOR) — RepairDriver-setup hook, so the
        first drill stripe never eats the kernel build (satellite of the
        same bug class warmup_decode fixed for degraded reads)."""
        if self.codec is None:
            return
        k, m, cs = layout.k, layout.m, layout.chunk_size
        if layout.local_scheme == "pm-msr":
            # each failed slot has its own projection schedule, so the
            # warmup set is one fused repair step per slot + the coupled
            # encode step (codec.warmup_msr)
            self.codec.warmup_msr(list(range(k + m)), cs, k, m, batch_sizes)
            return
        rows = self.hot_repair_programs(layout)
        sub = cs // subshard_r(cs)
        self.codec.warmup_repair(rows, sub, k, m, batch_sizes)
        if layout.local_scheme and sub != cs:
            self.codec.warmup_repair(rows, cs, k, m, batch_sizes)

    def _plan_reduced(self, layout: ECLayout, s: int,
                      lost: frozenset[int], zero_shards: frozenset[int],
                      read_shards: tuple[int, ...] | None
                      ) -> list[tuple[int, int]] | None:
        """Helper plan [(slot, gf_coeff), ...] rebuilding lost slot s with
        fewer than k full-chunk reads, or None when only the full-k decode
        applies.  Zero-hole members are pre-dropped (they contribute zero
        bytes for free); an empty plan means the rebuilt content is zeros.

        With a local scheme, a shard whose group (incl. its local parity)
        holds no OTHER loss rebuilds from the group — group_size reads
        instead of k.  Without one, a SINGLE lost shard still rides the
        scheduled single-row program over k survivors: same bytes as full-k,
        but sub-range framed (pacing quanta) and far fewer device ops.

        With "pm-msr", a SINGLE lost slot reads every survivor's repair
        projection — all d = k+m-1 helpers ship beta/alpha of a chunk each
        (0.5625x of k full chunks); coeff 0 marks a zero-hole helper whose
        projection is substituted as zeros without a read.  Multi-loss
        returns None: the joint decode reads exactly k full shards, never
        more than plain RS."""
        k, m = layout.k, layout.m
        base = k + m
        if layout.local_scheme == "pm-msr":
            if len(lost) > 1:
                return None                    # multi-loss: joint decode
            sch = default_msr(k, m).schedule(s)
            return [(x, 0 if x in zero_shards else 1) for x in sch.helpers]
        if layout.local_scheme:
            groups = layout.local_groups()
            if s >= base:                      # lost local parity
                members = groups[s - base]
                if lost & set(members):
                    return None
                return [(x, 1) for x in members if x not in zero_shards]
            g = layout.group_of(s)
            local_slot = base + g
            others = set(groups[g]) - {s} | {local_slot}
            if lost & others:
                return None                    # second loss in the group
            return [(x, 1) for x in sorted(others) if x not in zero_shards]
        if len(lost) > 1:
            return None                        # multi-loss: joint decode
        survivors = [x for x in range(base) if x not in lost]
        # zero holes first (free), then the planner's balanced pick
        pref = set(read_shards or ())

        def rank(x: int) -> tuple:
            return (x not in zero_shards, x not in pref, x)
        present = sorted(survivors, key=rank)[:k]
        row = default_rs(k, m).reconstruct_gfmatrix(sorted(present), [s])[0]
        return [(p, int(c)) for p, c in zip(sorted(present), row)
                if c and p not in zero_shards]

    async def _repair_eval(self, rows: np.ndarray, coeffs: tuple[int, ...],
                           k: int, m: int) -> tuple[bytes, int]:
        if self.codec is not None:
            out, crc = await self.codec.repair(rows, coeffs, k, m)
            return bytes(out), int(crc)
        from t3fs_torch.ops.codec import crc32c
        from t3fs_torch.ops.repair_program import (eval_program_np,
                                             schedule_repair_program)
        rs = default_rs(k, m)

        def run():
            out = eval_program_np(schedule_repair_program(coeffs), rows, rs)
            return bytes(out), crc32c(out.tobytes())
        return await asyncio.to_thread(run)

    async def _repair_reduced(self, layout: ECLayout, inode: int,
                              stripe: int, s: int,
                              plan: list[tuple[int, int]],
                              stats: RepairIOStats
                              ) -> tuple[bytes, int | None] | None:
        """Execute one reduced-repair plan: fetch each helper as r sub-range
        ReadIOs (existing offset/len wire fields — no new format), evaluate
        the scheduled program per sub-shard through the batched codec, and
        stitch the full-chunk CRC with crc32c_combine.  Returns None when
        any helper read fails — the caller falls back to full-k decode."""
        from t3fs_torch.ops.codec import crc32c_combine
        k, m, cs = layout.k, layout.m, layout.chunk_size
        if layout.local_scheme == "pm-msr":
            return await self._repair_msr(layout, inode, stripe, s, plan,
                                          stats)
        if not plan:
            return bytes(cs), None             # all-holes group: zeros
        r = subshard_r(cs)
        sub = cs // r
        ios = []
        for slot, _c in plan:
            for i in range(r):
                ios.append(ReadIO(
                    chunk_id=layout.shard_chunk(inode, stripe, slot),
                    chain_id=layout.shard_chain(stripe, slot),
                    offset=i * sub, length=sub))
        try:
            with tracing.span("ec.repair.subshard_read", helpers=len(plan),
                              sub_reads=len(ios)):
                results, payloads = await self._fast.batch_read(ios)
        except StatusError:
            return None
        h = len(plan)
        bufs = np.zeros((r, h, sub), dtype=np.uint8)
        for j, (res, p) in enumerate(zip(results, payloads)):
            if res.status.code != int(StatusCode.OK):
                return None                    # helper lost too: fall back
            # the server clamps reads past the stored length to SHORT
            # payloads (trimmed tails): zero-pad, absent == zeros
            stats.bytes_read += len(p)
            stats.sub_reads += 1
            hi, i = divmod(j, r)
            bufs[i, hi, : len(p)] = np.frombuffer(p, dtype=np.uint8)
        coeffs = tuple(c for _slot, c in plan)
        parts = await asyncio.gather(
            *(self._repair_eval(bufs[i], coeffs, k, m) for i in range(r)))
        content = b"".join(p for p, _crc in parts)
        crc = parts[0][1]
        for _p, sub_crc in parts[1:]:
            crc = crc32c_combine(crc, sub_crc, sub)
        return content, crc

    async def _repair_msr(self, layout: ECLayout, inode: int, stripe: int,
                          s: int, plan: list[tuple[int, int]],
                          stats: RepairIOStats
                          ) -> tuple[bytes, int | None] | None:
        """Execute one pm-msr projection-repair plan: every live helper
        ships only its beta = alpha/2 selected sub-chunks — merged into
        contiguous (offset, length) sub-range ReadIOs on the existing
        wire fields, no new RPCs — and the coupled-layer rebuild runs as
        ONE fused device step (stage A/C constant folds around the
        batched stage-B word fold, full-chunk CRC32C fused in).  Returns
        None when any live helper read fails: the caller falls back to
        the full-k joint decode, so a lost helper degrades to RS-cost IO,
        never to a failed repair."""
        k, m, cs = layout.k, layout.m, layout.chunk_size
        code = default_msr(k, m)
        sch = code.schedule(s)
        sub = code.subchunk_len(cs)
        runs = sch.read_runs()
        live = [slot for slot, c in plan if c]     # coeff 0 == zero hole
        ios = []
        for slot in live:
            cid = layout.shard_chunk(inode, stripe, slot)
            chain = layout.shard_chain(stripe, slot)
            for start, count in runs:
                ios.append(ReadIO(chunk_id=cid, chain_id=chain,
                                  offset=start * sub, length=count * sub))
        try:
            with tracing.span("ec.repair.msr_projection",
                              helpers=len(live), sub_reads=len(ios)):
                results, payloads = await self._fast.batch_read(ios)
        except StatusError:
            return None
        # helper rows: ascending slot order, planes in ascending selected-
        # plane order (the codec.msr_repair byte contract); run ri starts
        # at selected-plane position cum[ri]
        cum = [0]
        for _start, count in runs:
            cum.append(cum[-1] + count)
        hidx = {slot: j for j, slot in enumerate(sch.helpers)}
        bufs = np.zeros((code.d, sch.npl * sub), dtype=np.uint8)
        for j, (res, p) in enumerate(zip(results, payloads)):
            if res.status.code != int(StatusCode.OK):
                return None                # helper lost too: fall back
            # short payloads (trimmed tails / reads past the stored
            # length) zero-pad — absent == zeros is the decode contract
            stats.bytes_read += len(p)
            stats.sub_reads += 1
            hi, ri = divmod(j, len(runs))
            off = cum[ri] * sub
            bufs[hidx[live[hi]],
                 off: off + len(p)] = np.frombuffer(p, dtype=np.uint8)
        out, crc = await self._msr_repair_eval(bufs, s, k, m)
        return bytes(out), int(crc)

    async def repair_chunk(self, layout: ECLayout, inode: int, stripe: int,
                           shard: int, stripe_len: int) -> IOResult:
        """Decode-reconstruct one lost shard and write it back to its chain
        (target-resync EC recovery, BASELINE config #4).  stripe_len is the
        stripe's true data length — it determines which shards are legitimate
        zero holes vs genuinely lost."""
        return (await self.repair_stripe(layout, inode, stripe, (shard,),
                                         stripe_len))[0]

    async def repair_stripe(self, layout: ECLayout, inode: int, stripe: int,
                            shards: tuple[int, ...], stripe_len: int,
                            read_shards: tuple[int, ...] | None = None,
                            mode: str = "subshard",
                            stats: RepairIOStats | None = None
                            ) -> list[IOResult]:
        """Repair a stripe's lost shards (slot indices: base shards and,
        with a local scheme, local parities).

        mode="subshard" (default) tries the reduced-read path per shard
        first — LRC group rebuild (group_size reads instead of k) or, lacking
        a scheme, the scheduled single-row program — falling back per shard
        to the joint full-k decode on any helper failure or multi-loss in a
        group.  mode="full" is the classic path: survivors read once, one
        decode produces every wanted shard.

        `read_shards` (RepairDriver's balanced pick) orders the no-scheme
        survivor choice and restricts the full-k FAST pass to those shard
        indices; shortfalls still fall through to the unrestricted patient
        wave.  `stats` accrues bytes_read / bytes_repaired / path counts."""
        with tracing.start_root("ec.repair_stripe", inode=inode,
                                stripe=stripe, shards=len(shards)):
            return await self._repair_stripe_inner(
                layout, inode, stripe, shards, stripe_len, read_shards,
                mode, stats)

    async def _repair_stripe_inner(self, layout: ECLayout, inode: int,
                                   stripe: int, shards: tuple[int, ...],
                                   stripe_len: int,
                                   read_shards: tuple[int, ...] | None,
                                   mode: str,
                                   stats: RepairIOStats | None
                                   ) -> list[IOResult]:
        k, cs = layout.k, layout.chunk_size
        stats = stats if stats is not None else RepairIOStats()
        lens = [max(0, min(cs, stripe_len - j * cs)) for j in range(k)]
        zero_shards = frozenset(j for j in range(k) if lens[j] == 0)
        # zero-hole data shards are never materialized — absent == zeros is
        # the decode contract write_stripe enforces with REMOVE; "repairing"
        # one means ensuring absence, not REPLACE-writing an empty chunk
        holes = [s for s in shards if s in zero_shards]
        lost = tuple(s for s in shards if s not in zero_shards)
        rebuilt: dict[int, tuple[bytes, int | None]] = {}
        if mode == "subshard" and lost:
            lost_set = frozenset(lost)

            async def try_one(s: int) -> None:
                plan = self._plan_reduced(layout, s, lost_set, zero_shards,
                                          read_shards)
                if plan is None:
                    return
                res = await self._repair_reduced(layout, inode, stripe, s,
                                                 plan, stats)
                if res is not None:
                    rebuilt[s] = res
                    stats.reduced_shards += 1

            await asyncio.gather(*(try_one(s) for s in lost))
        remaining = tuple(s for s in lost if s not in rebuilt)
        if remaining:
            stats.fallback_shards += len(remaining)
            # local-parity slots can't ride the RS joint decode: rebuild
            # their group members' XOR directly once the base decode ran
            base_remaining = tuple(s for s in remaining if s < k + layout.m)
            rec, crcs = (await self._reconstruct_shards(
                layout, inode, stripe, base_remaining, zero_shards,
                prefer=read_shards, stats=stats)
                if base_remaining else ([], []))
            for s, c, crc in zip(base_remaining, rec, crcs):
                rebuilt[s] = (c, crc)
            for s in remaining:
                if s in rebuilt:
                    continue
                # lost local parity whose group ALSO lost a member: XOR the
                # group back together from the decode output + survivors
                members = layout.local_groups()[s - k - layout.m]
                plan = [(x, 1) for x in members if x not in zero_shards]
                known = {x: rebuilt[x][0] for x, _ in plan if x in rebuilt}
                need = tuple(x for x, _ in plan if x not in known)
                if need:
                    more, _ = await self._reconstruct_shards(
                        layout, inode, stripe, need, zero_shards,
                        known=known, stats=stats)
                    known.update(dict(zip(need, more)))
                buf = np.zeros(cs, dtype=np.uint8)
                for x, _ in plan:
                    row = np.frombuffer(known[x], dtype=np.uint8)
                    buf[: len(row)] ^= row
                rebuilt[s] = (bytes(buf), None)

        async def write_back(shard: int, content: bytes,
                             crc: int | None) -> IOResult:
            cid = layout.shard_chunk(inode, stripe, shard)
            if shard < k:
                content = content[: lens[shard]]
            if len(content) != cs:
                # truncated data shard: the device CRC covers the full
                # chunk, not the tail-trimmed bytes — let the client re-CRC
                crc = None
            stats.bytes_repaired += len(content)
            return await self.sc.write_chunk(
                layout.shard_chain(stripe, shard), cid, 0, bytes(content),
                chunk_size=cs, update_type=UpdateType.REPLACE,
                checksum=crc)

        async def remove_hole(shard: int) -> IOResult:
            return await self.sc.write_chunk(
                layout.shard_chain(stripe, shard),
                layout.data_chunk(inode, stripe, shard), 0, b"",
                chunk_size=cs, update_type=UpdateType.REMOVE)

        done = dict(zip(lost, await asyncio.gather(
            *(write_back(s, *rebuilt[s]) for s in lost))))
        done.update(zip(holes, await asyncio.gather(
            *(remove_hole(s) for s in holes))))
        return [done[s] for s in shards]
