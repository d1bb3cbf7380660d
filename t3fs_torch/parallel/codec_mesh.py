"""Mesh-sharded RS + CRC32C encode and decode on torch.distributed: the twin
of t3fs/parallel/codec_mesh.py, the multi-device data plane.

The codec shards two ways:

  dp  the stripe batch (independent stripes, no communication)
  cp  the chunk length.  RS parity and decode are byte-position-local, so
      they need no communication under cp.  CRC is a GF(2) linear scan, so
      each rank takes the raw CRC of its local span, multiplies it by its
      tail-shift matrix Mb^(bytes after its span), and the chunk CRC is a
      sum over cp, mod 2, of (n, shards, 32) 0/1 rows.

JAX's mesh is one process holding global arrays under `shard_map`.  The
twin is one process per mesh position in an initialised process group:
`make_mesh` lays the ranks out row-major as (dp, cp), `shard` cuts a rank's
block out of a global tensor (the twin of `in_sharding`), and every step
takes and returns the rank's LOCAL blocks, the shapes of the reference's
`local_step`s.  Outputs sharded P('dp', None, 'cp') come back as the
rank's block; the CRCs, P('dp', None), are the same on every cp rank of a
row.

The word steps run the port's kernels on the local span: B2 and B1 to
encode, B3 and B1 (RAID-6) or B5 and B1 (any other code) to decode.  The
byte steps run the plain bit-matmul twins of the reference's XLA programs.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from t3fs_torch import resolve_device
from t3fs_torch.ops import cuda_codec as cc
from t3fs_torch.ops.crc32c import default_matrices
from t3fs_torch.ops.rs import default_rs
from t3fs_torch.ops.tables import SEG_WORDS
from t3fs_torch.ops.torch_codec import (
    DEFAULT_SEG_BYTES, i32, make_crc32c_raw, make_rs_encode_matmul,
    make_rs_reconstruct, pack_bits_u32)


@dataclass(frozen=True)
class Mesh:
    """This rank's place in the (dp, cp) mesh and its cp row's group."""
    dp: int
    cp: int
    dp_index: int
    cp_index: int
    cp_group: dist.ProcessGroup
    device: torch.device


def mesh_shape(world: int, dp: int | None = None) -> tuple[int, int]:
    """(dp, cp) of a mesh of `world` ranks: cp is the first of 4, 2, 1 that
    divides `world` (favouring the chunk axis, so the CRC combine runs
    widely), unless dp is given."""
    if dp is None:
        dp = world // next(c for c in (4, 2, 1) if world % c == 0)
    if dp < 1 or world % dp:
        raise ValueError(f"dp={dp} must divide the world size {world}")
    return dp, world // dp


def make_mesh(dp: int | None = None,
              device: str | torch.device = "cuda") -> Mesh:
    """The (dp, cp) mesh over the ranks of the initialised default process
    group, shaped by mesh_shape as the reference shapes it.  Rank r sits
    at (r // cp, r % cp).  Every rank creates every row's cp group, in the
    same order (new_group is collective)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "torch.distributed.init_process_group first")
    rank = dist.get_rank()
    dp, cp = mesh_shape(dist.get_world_size(), dp)
    group = None
    for row in range(dp):
        g = dist.new_group([row * cp + j for j in range(cp)])
        if row == rank // cp:
            group = g
    return Mesh(dp, cp, rank // cp, rank % cp, group, dev)


def shard(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The global (n, s, L) tensor -> this rank's contiguous block
    [dp_i * n/dp : ..., :, cp_j * L/cp : ...] on the mesh's device."""
    n, _, L = x.shape
    if n % mesh.dp or L % mesh.cp:
        raise ValueError(f"shape {tuple(x.shape)} does not split over "
                         f"dp={mesh.dp}, cp={mesh.cp}")
    bn, bl = n // mesh.dp, L // mesh.cp
    block = x[mesh.dp_index * bn:(mesh.dp_index + 1) * bn, :,
              mesh.cp_index * bl:(mesh.cp_index + 1) * bl]
    return block.to(mesh.device).contiguous()


def _tail_combine(mesh: Mesh, local_bytes: int, total_bytes: int):
    """The shift-weighted cp sum: raw-CRC bit rows (n * nshards, 32) of
    this rank's span -> chunk CRCs (n, nshards) int32.  Shared by the byte
    and word steps, so the tail-shift and affine math cannot diverge.

    The 32 x 32 product runs in float32 (sums <= 32 are exact; CUDA has no
    integer matmul); the all_reduce sums int32 0/1 rows, the reference's
    psum (NCCL has no bitwise XOR reduction)."""
    mats = default_matrices()
    tail = torch.from_numpy(mats.shift_matrix(
        local_bytes * (mesh.cp - 1 - mesh.cp_index)).astype(np.float32)
    ).to(mesh.device)
    affine = i32(mats.affine_const(total_bytes))

    def combine(raw: torch.Tensor, n: int, nshards: int) -> torch.Tensor:
        shifted = (raw.float() @ tail.T).to(torch.int32) & 1
        dist.all_reduce(shifted, op=dist.ReduceOp.SUM, group=mesh.cp_group)
        return (pack_bits_u32(shifted & 1) ^ affine).reshape(n, nshards)

    return combine


def _unpack_u32(words: torch.Tensor) -> torch.Tensor:
    """(R,) int32 packed CRCs -> (R, 32) int32 0/1 bit rows, LSB first."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    return (words.unsqueeze(-1) >> shifts) & 1


def _local_len(mesh: Mesh, chunk_len: int, unit: int) -> int:
    if chunk_len % mesh.cp or (chunk_len // mesh.cp) % unit:
        raise ValueError(f"chunk length {chunk_len} must split into "
                         f"{mesh.cp} cp spans of whole {unit}-unit segments")
    return chunk_len // mesh.cp


def make_sharded_encode_step(mesh: Mesh, chunk_len: int, k: int = 8, m: int = 2,
                             seg_bytes: int = DEFAULT_SEG_BYTES):
    """Byte path: local stripes (n, k, L/cp) uint8 -> (parity (n, m, L/cp)
    uint8, crcs (n, k+m) int32), the plain bit-matmul twins of the
    reference's XLA step."""
    local_len = _local_len(mesh, chunk_len, seg_bytes)
    raw_local = make_crc32c_raw(local_len, seg_bytes, mesh.device)
    combine = _tail_combine(mesh, local_len, chunk_len)
    rs_encode = make_rs_encode_matmul(default_rs(k, m), mesh.device)

    def step(stripes: torch.Tensor):
        n = stripes.shape[0]
        parity = rs_encode(stripes)
        allsh = torch.cat([stripes, parity], dim=1)
        return parity, combine(raw_local(allsh.reshape(n * (k + m), local_len)),
                               n, k + m)

    return step


def make_sharded_encode_step_words(mesh: Mesh, chunk_words: int,
                                   k: int = 8, m: int = 2):
    """Word path: local words (n, k, W/cp) int32 -> (parity (n, 2, W/cp)
    int32, crcs (n, k+2) int32): B2, then B1 on the data and the parity.
    B1 returns packed raw CRCs; they unpack to bit rows for the combine,
    whose tail exponents are in bytes (4 a word)."""
    if m != 2:
        raise ValueError("the word path is RAID-6 (m=2); use "
                         "make_sharded_encode_step")
    local_words = _local_len(mesh, chunk_words, SEG_WORDS)
    rs_enc = cc.make_rs_encode_words(default_rs(k, m), mesh.device)
    raw = cc.make_crc32c_words_raw(local_words, mesh.device)
    combine = _tail_combine(mesh, 4 * local_words, 4 * chunk_words)

    def step(words: torch.Tensor):
        n = words.shape[0]
        parity = rs_enc(words)
        dcrc = raw(words.reshape(n * k, local_words)).reshape(n, k)
        pcrc = raw(parity.reshape(n * m, local_words)).reshape(n, m)
        bits = _unpack_u32(torch.cat([dcrc, pcrc], dim=1).reshape(-1))
        return parity, combine(bits, n, k + m)

    return step


def make_sharded_reconstruct_step_words(mesh: Mesh, chunk_len: int,
                                        present: tuple[int, ...],
                                        want: tuple[int, ...],
                                        k: int = 8, m: int = 2):
    """Word-kernel decode: local survivors (n, k, L/cp) uint8 -> (rebuilt
    (n, |want|, L/cp) uint8, crcs (n, |want|) int32).  RAID-6 decodes with
    B3 on the survivors' int32 view (the twin of the reference's
    bitcast_convert_type); any other code with B5 on the bytes.  Then B1 on
    the rebuilt shards' words."""
    local_len = _local_len(mesh, chunk_len, 4 * SEG_WORDS)
    local_words = local_len // 4
    raw = cc.make_crc32c_words_raw(local_words, mesh.device)
    combine = _tail_combine(mesh, local_len, chunk_len)
    rs = default_rs(k, m)
    w = len(want)
    if rs.raid6:
        rec = cc.make_rs_reconstruct_words(present, want, rs, mesh.device)

        def decode(survivors: torch.Tensor) -> torch.Tensor:
            return rec(survivors.view(torch.int32)).view(torch.uint8)
    else:
        decode = cc.make_rs_reconstruct_bytes(present, want, rs, mesh.device)

    def step(survivors: torch.Tensor):
        n = survivors.shape[0]
        rebuilt = decode(survivors)
        crcs = raw(rebuilt.view(torch.int32).reshape(n * w, local_words))
        return rebuilt, combine(_unpack_u32(crcs), n, w)

    return step


def make_sharded_reconstruct_step(mesh: Mesh, chunk_len: int,
                                  present: tuple[int, ...],
                                  want: tuple[int, ...],
                                  k: int = 8, m: int = 2,
                                  seg_bytes: int = DEFAULT_SEG_BYTES):
    """Byte path: local survivors (n, k, L/cp) uint8 -> (rebuilt
    (n, |want|, L/cp) uint8, crcs (n, |want|) int32), the plain bit-matmul
    decode and CRC."""
    local_len = _local_len(mesh, chunk_len, seg_bytes)
    raw_local = make_crc32c_raw(local_len, seg_bytes, mesh.device)
    combine = _tail_combine(mesh, local_len, chunk_len)
    reconstruct = make_rs_reconstruct(present, want, default_rs(k, m),
                                      mesh.device)

    def step(survivors: torch.Tensor):
        n = survivors.shape[0]
        rebuilt = reconstruct(survivors)
        return rebuilt, combine(
            raw_local(rebuilt.reshape(n * len(want), local_len)), n, len(want))

    return step
