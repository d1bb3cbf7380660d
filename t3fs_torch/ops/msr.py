"""PM-MSR regenerating code: sub-packetized repair at the cut-set floor.

The port's own copy of t3fs/ops/msr.py (t3fs_torch never imports the JAX
package); its schedules, generator and decode matrices must stay identical
with the reference's, since stripes written by either client repair and
decode under the other (tests/test_torch_msr.py holds the arrays equal).

The `pm-msr` ECLayout scheme stores each shard as alpha sub-chunks and
repairs a single lost shard by reading only a beta = alpha/(d-k+1)-sized
"repair projection" from each of the d = n-1 survivors: d*beta sub-symbols
rebuild the alpha lost ones, i.e. (d/(d-k+1))/k of the full-k read — for
RS(8+2)-class geometry (k=8, d=9) that is 4.5/8 = 0.5625x survivor bytes
at the SAME 1.25x storage (vs LRC-XOR's 0.329x at 1.75x).  This is the
optimal-access MSR bound; no scalar-MDS trick can beat 1.0x.

Construction: the coupled-layer ("product-matrix by pairwise coupling")
high-rate MSR code for m = d-k+1 = 2, following the transform view of the
fast-PM/Clay literature (arxiv 1412.3022 lineage).  The n = k+2 shards
(n even) sit on a (2 x t) grid, t = n/2: slot s is node (x, y) with
x = s & 1, y = s >> 1; sub-chunk indices are "planes" z in {0,1}^t
(alpha = 2^t, so alpha = 32 for RS(8+2)).  The stored code C couples an
uncoupled virtual code U in which every plane is an independent codeword
of the plain scalar RS(k+m) (the same RAID-6 generator the rest of t3fs
ships):

  * symbol (s=(x,y), z) is UNPAIRED iff digit y of z equals x: C = U;
  * otherwise it pairs with (s^1, z with digit y flipped), and the pair
    (A on node x=0, B on node x=1) stores C_A = U_A + g*U_B,
    C_B = g*U_A + U_B  (gamma = g, det = 1 + g^2 != 0).

Data shards store RAW bytes (the coupling is folded into the parity
computation), so healthy first-k reads are byte-identical to plain RS.
Repair of slot f = (x0, y0) reads, from every survivor, the beta planes
with digit y0 == x0, and runs three stages of scheduled GF(2^8) folds
(each a repair_program over the plane batch — this is where 2108.02692's
bit-plane scheduling is reused):

  A. uncouple the 8 helpers in other columns (2-coeff program per pair);
  B. per plane, one scalar-RS decode of the two column-y0 symbols from
     the 8 uncoupled ones (two k-coeff programs, same for every plane);
  C. selected-plane outputs are stage-B results verbatim; each
     non-selected output plane w is a 2-coeff program over the partner's
     stored symbol at w' = w ^ (1 << y0) and stage-B's U_partner(w').

Multi-loss (and degraded full-k reads) go through cached dense decode
matrices on the flattened (slot, plane) symbol space — never more than
the k full shards plain RS would read.

Everything here is host/numpy setup math + the bit-exact oracle; the
device paths live in t3fs_torch/ops/msr_codec.py and hand these schedules
to the CUDA kernels.  MDS and the repair identities are VERIFIED numerically in
tests/test_msr.py (every single-loss mask, all C(n,2) double masks).
"""

from __future__ import annotations

import functools

import numpy as np

from t3fs_torch.ops.gf256 import GF256, default_field
from t3fs_torch.ops.repair_program import (RepairProgram, eval_program_np,
                                           schedule_repair_program)
from t3fs_torch.ops.rs import default_rs

# Coupling constant gamma: any value outside {0, 1} keeps the pair
# transform invertible (det = (1+g)^2); g = 2 (the field generator) is
# verified MDS for the shipped geometries in tests/test_msr.py.
MSR_GAMMA = 2


def _fast_mat_inv(gf: GF256, A: np.ndarray) -> np.ndarray:
    """Gauss-Jordan inverse with whole-matrix row elimination per column
    (gf256.mat_inv loops rows in Python — too slow for the 256x256
    systems the decode-matrix cache solves)."""
    A = np.asarray(A, dtype=np.uint8)
    n = A.shape[0]
    assert A.shape == (n, n)
    aug = np.concatenate([A, np.eye(n, dtype=np.uint8)], axis=1)
    for col in range(n):
        piv = col + int(np.argmax(aug[col:, col] != 0))
        if aug[piv, col] == 0:
            raise np.linalg.LinAlgError("singular GF256 matrix")
        if piv != col:
            aug[[col, piv]] = aug[[piv, col]]
        aug[col] = gf.mul(aug[col], gf.inv(aug[col, col]))
        factors = aug[:, col].copy()
        factors[col] = 0
        aug ^= gf.mul(factors[:, None], aug[col][None, :])
    return aug[:, n:]


class MSRRepairSchedule:
    """Static single-loss repair plan for failed slot f (host-built once).

    Consumed by the numpy oracle (repair_np) and the device step
    (msr_codec.make_msr_repair_step) — both execute this identical
    schedule.
    Index convention: helper input H is (d, npl) sub-chunks, helpers in
    ascending slot order, planes in ascending selected-plane order;
    `flat(j, p) = j * npl + p` addresses the flattened input.
    """

    def __init__(self, code: "MSRCode", f: int):
        self.f = f
        n, t, alpha = code.n, code.t, code.alpha
        x0, y0 = f & 1, f >> 1
        self.selected = tuple(z for z in range(alpha)
                              if (z >> y0) & 1 == x0)
        self.npl = len(self.selected)
        pos = {z: p for p, z in enumerate(self.selected)}
        self.helpers = tuple(s for s in range(n) if s != f)
        hidx = {s: j for j, s in enumerate(self.helpers)}
        self.partner = f ^ 1
        self.partner_hidx = hidx[self.partner]
        # stage A: uncouple the 8 helpers outside column y0
        self.present8 = tuple(s for s in self.helpers if s >> 1 != y0)
        self.prog_pair = schedule_repair_program(
            (code.inv_delta, code.g_inv_delta))
        copy_mask = np.zeros((code.k, self.npl), dtype=bool)
        src_own = np.zeros((code.k, self.npl), dtype=np.int32)
        src_pair = np.zeros((code.k, self.npl), dtype=np.int32)
        for i, s in enumerate(self.present8):
            x, y = s & 1, s >> 1
            for p, z in enumerate(self.selected):
                src_own[i, p] = hidx[s] * self.npl + p
                if (z >> y) & 1 == x:
                    copy_mask[i, p] = True
                    src_pair[i, p] = src_own[i, p]
                else:
                    src_pair[i, p] = (hidx[s ^ 1] * self.npl
                                      + pos[z ^ (1 << y)])
        self.copy_mask, self.src_own, self.src_pair = (
            copy_mask, src_own, src_pair)
        # stage B: scalar-RS decode rows for the two column-y0 slots,
        # identical for every selected plane; zero coefficients are
        # compressed out before scheduling (schedule_repair_program
        # requires 1..255) and idx_* keeps the surviving helper indices
        W2 = code.rs.reconstruct_gfmatrix(list(self.present8),
                                          [f, self.partner])
        self.idx_f, self.prog_f = _nonzero_program(W2[0])
        self.idx_p, self.prog_p = _nonzero_program(W2[1])
        # stage C: output plane map.  out_sel[z] >= 0 gives the stage-B
        # plane position for selected output planes; non-selected plane w
        # combines the partner's stored symbol at w' and U_partner(w')
        self.prog_out = schedule_repair_program(
            (code.inv_gamma, code.gf_mul_const(code.inv_gamma, code.delta)))
        out_sel = np.full(alpha, -1, dtype=np.int32)
        nonsel = []      # (out plane w, plane pos of w', flat idx of C_p(w'))
        for z in range(alpha):
            if (z >> y0) & 1 == x0:
                out_sel[z] = pos[z]
            else:
                p2 = pos[z ^ (1 << y0)]
                nonsel.append((z, p2, self.partner_hidx * self.npl + p2))
        self.out_sel = out_sel
        self.nonsel = tuple(nonsel)
        # survivor-byte accounting: d helpers x beta sub-chunks
        self.read_subchunks = len(self.helpers) * self.npl

    def read_runs(self) -> tuple[tuple[int, int], ...]:
        """Selected planes as merged (start, count) runs of on-disk
        sub-chunk indices — each helper ships exactly these ranges."""
        runs: list[tuple[int, int]] = []
        for z in self.selected:
            if runs and runs[-1][0] + runs[-1][1] == z:
                runs[-1] = (runs[-1][0], runs[-1][1] + 1)
            else:
                runs.append((z, 1))
        return tuple(runs)


def _nonzero_program(row: np.ndarray) -> tuple[tuple[int, ...], RepairProgram]:
    idx = tuple(int(i) for i in np.nonzero(row)[0])
    if not idx:
        raise ValueError("all-zero decode row")
    return idx, schedule_repair_program(tuple(int(row[i]) for i in idx))


class MSRCode:
    """The coupled-layer MSR(n=k+m, d=n-1, alpha=2^(n/2)) code, m=2."""

    def __init__(self, k: int = 8, m: int = 2, gamma: int = MSR_GAMMA,
                 field: GF256 | None = None):
        if m != 2:
            raise ValueError(f"pm-msr requires m=2 (got m={m})")
        if (k + m) % 2:
            raise ValueError(f"pm-msr requires even n=k+m (got {k}+{m})")
        self.k, self.m = k, m
        self.n = k + m
        self.d = self.n - 1
        self.t = self.n // 2
        self.alpha = 1 << self.t          # sub-chunks per shard
        self.beta = self.alpha // 2       # sub-chunks read per helper
        self.gf = field or default_field()
        self.rs = default_rs(k, m)
        assert self.rs.raid6, "pm-msr couples the RAID-6 scalar code"
        g = int(gamma)
        if g in (0, 1):
            raise ValueError(f"gamma {g} gives a singular pair transform")
        self.gamma = g
        self.delta = 1 ^ int(self.gf.mul(g, g))          # det of the pair
        self.inv_gamma = int(self.gf.inv(g))
        self.inv_delta = int(self.gf.inv(self.delta))
        self.g_inv_delta = int(self.gf.mul(g, self.inv_delta))
        # parity FORMAT id: pm-msr parity bytes are NOT plain RS parity,
        # so layouts carry a distinct id and check_code rejects mixups
        self.code_id = f"pmmsr{self.alpha}-g{g:x}-{self.rs.code_id}"
        self._sched: dict[int, MSRRepairSchedule] = {}
        self._decode_cache: dict = {}
        self._gen: np.ndarray | None = None

    # --- plane/pairing helpers ---

    def unpaired(self, s: int, z: int) -> bool:
        return (z >> (s >> 1)) & 1 == (s & 1)

    def pair(self, s: int, z: int) -> tuple[int, int]:
        """Partner symbol of a paired (slot, plane)."""
        return s ^ 1, z ^ (1 << (s >> 1))

    def schedule(self, f: int) -> MSRRepairSchedule:
        sch = self._sched.get(f)
        if sch is None:
            sch = self._sched[f] = MSRRepairSchedule(self, f)
        return sch

    def subchunk_len(self, chunk_size: int) -> int:
        if chunk_size % self.alpha:
            raise ValueError(
                f"chunk_size {chunk_size} not a multiple of alpha={self.alpha}")
        return chunk_size // self.alpha

    # --- numpy oracle: encode ---

    def encode_np(self, data: np.ndarray) -> np.ndarray:
        """(k, L) uint8 raw data shards -> (m, L) uint8 pm-msr parity."""
        gf, k, alpha, t = self.gf, self.k, self.alpha, self.t
        data = np.asarray(data, dtype=np.uint8)
        assert data.shape[0] == k, data.shape
        sub = self.subchunk_len(data.shape[1])
        C = data.reshape(k, alpha, sub)
        # uncouple the data columns
        U = np.zeros((self.n, alpha, sub), dtype=np.uint8)
        for s in range(k):
            for z in range(alpha):
                if self.unpaired(s, z):
                    U[s, z] = C[s, z]
                else:
                    s2, z2 = self.pair(s, z)
                    U[s, z] = (gf.mul(self.inv_delta, C[s, z])
                               ^ gf.mul(self.g_inv_delta, C[s2, z2]))
        # per-plane scalar RS parity (vectorized across planes)
        G = self.rs.G
        for j in range(self.m):
            acc = np.zeros((alpha, sub), dtype=np.uint8)
            for s in range(k):
                acc ^= gf.mul(G[k + j, s], U[s])
            U[k + j] = acc
        # couple the parity column (y = t-1; slot k is x=0, k+1 is x=1)
        P = np.zeros((self.m, alpha, sub), dtype=np.uint8)
        top = 1 << (t - 1)
        for z in range(alpha):
            if z & top:
                P[0, z] = U[k, z] ^ gf.mul(self.gamma, U[k + 1, z ^ top])
                P[1, z] = U[k + 1, z]
            else:
                P[0, z] = U[k, z]
                P[1, z] = gf.mul(self.gamma, U[k, z ^ top]) ^ U[k + 1, z]
        return P.reshape(self.m, alpha * sub)

    # --- numpy oracle: single-loss repair (the scheduled stages) ---

    def repair_np(self, f: int, helper_subs: np.ndarray) -> np.ndarray:
        """helper_subs: (d, npl, sub) uint8 — per helper (ascending slot
        order, failed slot skipped) the selected sub-chunks in ascending
        plane order -> rebuilt (alpha * sub,) uint8 chunk bytes.

        Every stage runs through eval_program_np, so this oracle pins
        both device dispatch paths to the 2108.02692 schedules."""
        sch = self.schedule(f)
        H = np.asarray(helper_subs, dtype=np.uint8)
        d, npl, sub = H.shape
        assert (d, npl) == (self.d, sch.npl), (H.shape, sch.npl)
        flat = H.reshape(d * npl, sub)
        # stage A
        U = np.zeros((self.k, npl, sub), dtype=np.uint8)
        for i in range(self.k):
            for p in range(npl):
                if sch.copy_mask[i, p]:
                    U[i, p] = flat[sch.src_own[i, p]]
                else:
                    U[i, p] = eval_program_np(
                        sch.prog_pair,
                        flat[[sch.src_own[i, p], sch.src_pair[i, p]]],
                        self.rs)
        # stage B
        Uf = np.zeros((npl, sub), dtype=np.uint8)
        Up = np.zeros((npl, sub), dtype=np.uint8)
        for p in range(npl):
            Uf[p] = eval_program_np(sch.prog_f, U[list(sch.idx_f), p], self.rs)
            Up[p] = eval_program_np(sch.prog_p, U[list(sch.idx_p), p], self.rs)
        # stage C
        out = np.zeros((self.alpha, sub), dtype=np.uint8)
        for z in range(self.alpha):
            if sch.out_sel[z] >= 0:
                out[z] = Uf[sch.out_sel[z]]
        for w, p2, cidx in sch.nonsel:
            out[w] = eval_program_np(
                sch.prog_out, np.stack([flat[cidx], Up[p2]]), self.rs)
        return out.reshape(self.alpha * sub)

    # --- full generator + multi-loss decode ---

    def generator(self) -> np.ndarray:
        """(n*alpha, k*alpha) GF(2^8) map from data sub-symbols (slot-major)
        to ALL stored sub-symbols; top k*alpha rows are the identity."""
        if self._gen is not None:
            return self._gen
        gf, k, alpha, t = self.gf, self.k, self.alpha, self.t
        ka = k * alpha
        # uncouple map on data symbols
        Pu = np.zeros((ka, ka), dtype=np.uint8)
        for s in range(k):
            for z in range(alpha):
                r = s * alpha + z
                if self.unpaired(s, z):
                    Pu[r, r] = 1
                else:
                    s2, z2 = self.pair(s, z)
                    Pu[r, r] = self.inv_delta
                    Pu[r, s2 * alpha + z2] = self.g_inv_delta
        # per-plane scalar parity map
        E = np.zeros((self.m * alpha, ka), dtype=np.uint8)
        for j in range(self.m):
            for z in range(alpha):
                for s in range(k):
                    E[j * alpha + z, s * alpha + z] = self.rs.G[k + j, s]
        # couple the parity column
        Pc = np.zeros((self.m * alpha, self.m * alpha), dtype=np.uint8)
        top = 1 << (t - 1)
        for z in range(alpha):
            if z & top:
                Pc[z, z] = 1
                Pc[z, alpha + (z ^ top)] = self.gamma
                Pc[alpha + z, alpha + z] = 1
            else:
                Pc[z, z] = 1
                Pc[alpha + z, z ^ top] = self.gamma
                Pc[alpha + z, alpha + z] = 1
        Gfull = np.zeros((self.n * alpha, ka), dtype=np.uint8)
        Gfull[:ka] = np.eye(ka, dtype=np.uint8)
        Gfull[ka:] = gf.matmul(gf.matmul(Pc, E), Pu)
        self._gen = Gfull
        return Gfull

    def decode_matrix(self, present: tuple[int, ...],
                      want: tuple[int, ...]) -> np.ndarray:
        """(len(want)*alpha, k*alpha) GF matrix rebuilding the `want`
        slots' stored sub-symbols from the k present slots' (slot-major
        flattening on both sides).  Cached per mask; invertibility of
        every mask == the MDS property (asserted in tests)."""
        present, want = tuple(present), tuple(want)
        M = self._decode_cache.get((present, want))
        if M is None:
            assert len(present) == self.k, present
            G = self.generator()
            alpha = self.alpha
            rows = np.concatenate(
                [np.arange(s * alpha, (s + 1) * alpha) for s in present])
            inv = _fast_mat_inv(self.gf, G[rows])
            wrows = np.concatenate(
                [np.arange(s * alpha, (s + 1) * alpha) for s in want])
            M = self.gf.matmul(G[wrows], inv)
            self._decode_cache[(present, want)] = M
        return M

    def decode_np(self, present: tuple[int, ...], shards: np.ndarray,
                  want: tuple[int, ...]) -> np.ndarray:
        """shards: (k, L) stored bytes of the `present` slots ->
        (len(want), L) rebuilt stored bytes (oracle; device path in
        ops/msr_codec.py shares the same decode_matrix)."""
        shards = np.asarray(shards, dtype=np.uint8)
        sub = self.subchunk_len(shards.shape[1])
        M = self.decode_matrix(tuple(present), tuple(want))
        rows = shards.reshape(self.k * self.alpha, sub)
        out = np.zeros((len(want) * self.alpha, sub), dtype=np.uint8)
        for r in range(out.shape[0]):
            nz = np.nonzero(M[r])[0]
            acc = np.zeros(sub, dtype=np.uint8)
            for c in nz:
                acc ^= self.gf.mul(M[r, c], rows[c])
            out[r] = acc
        return out.reshape(len(want), self.alpha * sub)

    # --- misc helpers ---

    def gf_mul_const(self, a: int, b: int) -> int:
        return int(self.gf.mul(a, b))

    def verify_mds(self, masks: list[tuple[int, ...]] | None = None) -> None:
        """Raise if any erasure mask (pairs by default) is undecodable."""
        import itertools
        if masks is None:
            masks = [tuple(c) for c in
                     itertools.combinations(range(self.n), self.m)]
        for lost in masks:
            present = tuple(s for s in range(self.n) if s not in lost)[:self.k]
            self.decode_matrix(present, tuple(lost))   # raises if singular


@functools.lru_cache(maxsize=8)
def default_msr(k: int = 8, m: int = 2) -> MSRCode:
    return MSRCode(k, m)


def msr_code_id(k: int = 8, m: int = 2) -> str:
    return default_msr(k, m).code_id
