"""File layout: how a file's bytes map onto chunks and chains.

Reference analogs: fbs/meta/Schema.h:331-399 (layout = chainTable + chunkSize
+ stripeSize + shuffle seed) and meta/components/ChainAllocator.h:48-81
(round-robin + seeded shuffle chain selection).  Clients compute chunk->chain
placement with zero metadata involvement (docs/design_notes.md:57-59).
"""

from __future__ import annotations

import random
from dataclasses import dataclass, field

from t3fs_torch.storage.types import ChunkId
from t3fs_torch.utils.serde import serde_struct


@serde_struct
@dataclass
class FileLayout:
    chunk_size: int = 1 << 20
    stripe_size: int = 1
    chains: list[int] = field(default_factory=list)   # selected chain ids
    seed: int = 0

    def __post_init__(self):
        if self.seed and self.chains:
            rng = random.Random(self.seed)
            chains = list(self.chains)
            rng.shuffle(chains)
            self.chains = chains
            self.seed = 0  # shuffle applied once; layout stored post-shuffle

    def chain_of(self, chunk_index: int) -> int:
        return self.chains[chunk_index % len(self.chains)]

    def chunk_span(self, offset: int, length: int) -> list[tuple[int, int, int]]:
        """Split [offset, offset+length) into per-chunk (chunk_index,
        chunk_offset, span_length) pieces."""
        out = []
        pos = offset
        end = offset + length
        while pos < end:
            idx = pos // self.chunk_size
            coff = pos - idx * self.chunk_size
            span = min(end - pos, self.chunk_size - coff)
            out.append((idx, coff, span))
            pos += span
        return out
